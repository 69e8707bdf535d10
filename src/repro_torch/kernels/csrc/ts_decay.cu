// ts_decay: the time-surface decay read over a whole slot pool, with the
// STCF comparator optionally fused.
//
// Replaces the TPU kernel in src/repro/kernels/ts_decay.py
// (_uniform_kernel, _varied_kernel, driven by ts_decay_pallas), which the
// reference vmaps over the leading slot/polarity dims.  Here the slot and
// polarity axes are simply part of one flat cell range: one launch reads
// every cell of an (S, P, H, W) pool, or of a (K, bh, bw) stack of
// gathered dirty tiles.
//
// Bound: device-memory bytes.  Per cell it reads 4 B and writes 4 B (one
// more byte with the mask) against ~12 float operations, far below the
// card's operations-per-byte balance.  So the design only has to stream:
// a grid-stride loop of 16-byte float4 loads and stores (neighbouring
// threads on neighbouring addresses), with a scalar loop for an unaligned
// pointer and for the ragged tail.  The decay arithmetic is
// decay.cuh's, op for op the plain PyTorch version.
#include <cuda_runtime.h>

#include <cstdint>

#include "decay.cuh"

namespace {

constexpr int kThreads = 256;

int grid_for(int64_t work) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sms) * 16;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : int(blocks);
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads)
    decay_uniform_kernel(const float* __restrict__ sae, float* __restrict__ out,
                         uint8_t* __restrict__ mask, int64_t n, float t_now,
                         DecayConsts c, float v_tw, bool vec4) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if (vec4) {
    const int64_t n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(sae);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = first; i < n4; i += stride) {
      const float4 s = s4[i];
      float4 v;
      v.x = decay_cell(s.x, t_now, c);
      v.y = decay_cell(s.y, t_now, c);
      v.z = decay_cell(s.z, t_now, c);
      v.w = decay_cell(s.w, t_now, c);
      o4[i] = v;
      if (kMask) {
        reinterpret_cast<uchar4*>(mask)[i] =
            make_uchar4(v.x > v_tw, v.y > v_tw, v.z > v_tw, v.w > v_tw);
      }
    }
    tail = n4 << 2;
  }
  for (int64_t i = tail + first; i < n; i += stride) {
    const float v = decay_cell(sae[i], t_now, c);
    out[i] = v;
    if (kMask) mask[i] = v > v_tw;
  }
}

// Per-cell parameter planes of size `plane` (= H*W), broadcast over the
// leading dims; time constants are clamped at 1e-9 s as the TPU kernel's
// driver clamps them.
template <bool kMask>
__global__ void __launch_bounds__(kThreads)
    decay_planes_kernel(const float* __restrict__ sae, float* __restrict__ out,
                        uint8_t* __restrict__ mask, int64_t n, int64_t plane,
                        float t_now, const float* __restrict__ a1,
                        const float* __restrict__ tau1,
                        const float* __restrict__ a2,
                        const float* __restrict__ tau2,
                        const float* __restrict__ b, float v_tw) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t k = i % plane;
    const float v = decay_cell(sae[i], t_now, a1[k], fmaxf(tau1[k], 1e-9f),
                               a2[k], fmaxf(tau2[k], 1e-9f), b[k]);
    out[i] = v;
    if (kMask) mask[i] = v > v_tw;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// `mask` may be null (no comparator).  Returns cudaGetLastError().
int ts_decay_uniform(const float* sae, float* out, uint8_t* mask, long long n,
                     float t_now, float a1, float tau1, float a2, float tau2,
                     float b, float v_tw, void* stream) {
  const DecayConsts c{a1, tau1, a2, tau2, b};
  const bool vec4 = (reinterpret_cast<uintptr_t>(sae) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(mask) % 4 == 0);
  const int grid = grid_for(vec4 ? (n >> 2) : n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask) {
    decay_uniform_kernel<true><<<grid, kThreads, 0, s>>>(sae, out, mask, n,
                                                         t_now, c, v_tw, vec4);
  } else {
    decay_uniform_kernel<false><<<grid, kThreads, 0, s>>>(
        sae, out, mask, n, t_now, c, v_tw, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

int ts_decay_planes(const float* sae, float* out, uint8_t* mask, long long n,
                    long long plane, float t_now, const float* a1,
                    const float* tau1, const float* a2, const float* tau2,
                    const float* b, float v_tw, void* stream) {
  const int grid = grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask) {
    decay_planes_kernel<true><<<grid, kThreads, 0, s>>>(
        sae, out, mask, n, plane, t_now, a1, tau1, a2, tau2, b, v_tw);
  } else {
    decay_planes_kernel<false><<<grid, kThreads, 0, s>>>(
        sae, out, mask, n, plane, t_now, a1, tau1, a2, tau2, b, v_tw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
