// stcf_support: the STCF patch-support count of every pixel of a stack of
// (H, W) planes -- the number of set cells in the (2r+1)^2 patch around
// it, the pixel itself excluded unless include_self, zero outside the
// plane.  The plain form counts a bool mask; the fused form decays an SAE
// plane and compares v > v_tw on load (decay.cuh, the arithmetic of
// ts_decay), so fused == ts_decay_with_mask -> stcf_support bitwise.
//
// Replaces the TPU kernel in src/repro/kernels/stcf.py (_support_kernel,
// driven by stcf_support_pallas), which streams three row blocks per step
// and so needs r <= block height.  Here any r up to kMaxRadius works.
//
// Bound: device-memory bytes.  The fused form reads 4 B and writes 4 B per
// pixel (the mask form 1 B and 4 B); the patch sum is integer adds.  One
// block owns a kTileH x kTileW output tile of one plane: it stages the
// tile plus an r-wide halo of 0/1 flags in shared memory (each cell read
// from device memory once per block, coalesced along rows), then sums the
// patch separably, (2r+1) adds along the row and (2r+1) down the column
// instead of (2r+1)^2.  Integer sums are exact in any order.
#include <cuda_runtime.h>

#include <cstdint>

#include "decay.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kMaxRadius = 16;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__host__ __device__ constexpr int flags_bytes(int r) {
  return ((kTileH + 2 * r) * (kTileW + 2 * r) + 15) / 16 * 16;
}

template <bool kFused, typename In>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    support_kernel(const In* __restrict__ in, int* __restrict__ out, int h,
                   int w, int r, bool include_self, float t_now, DecayConsts c,
                   float v_tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sw = kTileW + 2 * r;
  const int sh = kTileH + 2 * r;
  uint8_t* flag = smem;                                    // sh x sw
  int* rowsum = reinterpret_cast<int*>(smem + flags_bytes(r));  // sh x kTileW

  const int64_t base = int64_t(blockIdx.z) * h * w;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;

  for (int k = tid; k < sh * sw; k += nthreads) {
    const int gy = y0 + k / sw - r;
    const int gx = x0 + k % sw - r;
    uint8_t f = 0;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const In v = in[base + int64_t(gy) * w + gx];
      if constexpr (kFused) {
        f = decay_cell(v, t_now, c) > v_tw;
      } else {
        f = v != 0;
      }
    }
    flag[k] = f;
  }
  __syncthreads();

  for (int k = tid; k < sh * kTileW; k += nthreads) {
    const uint8_t* row = flag + (k / kTileW) * sw + k % kTileW;
    int s = 0;
    for (int d = 0; d <= 2 * r; ++d) s += row[d];
    rowsum[k] = s;
  }
  __syncthreads();

  for (int k = tid; k < kTileH * kTileW; k += nthreads) {
    const int ly = k / kTileW;
    const int lx = k % kTileW;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    if (gy >= h || gx >= w) continue;
    int s = 0;
    for (int d = 0; d <= 2 * r; ++d) s += rowsum[(ly + d) * kTileW + lx];
    if (!include_self) s -= flag[(ly + r) * sw + lx + r];
    out[base + int64_t(gy) * w + gx] = s;
  }
}

template <bool kFused, typename In>
int launch(const In* in, int* out, int planes, int h, int w, int r,
           int include_self, float t_now, DecayConsts c, float v_tw,
           void* stream) {
  if (r < 0 || r > kMaxRadius) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  planes);
  const dim3 block(kThreadsX, kThreadsY);
  const int smem = flags_bytes(r) + (kTileH + 2 * r) * kTileW * 4;
  support_kernel<kFused, In><<<grid, block, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      in, out, h, w, r, include_self != 0, t_now, c, v_tw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stcf_max_radius() { return kMaxRadius; }

// Support count of a bool mask: (planes, h, w) uint8 -> int32.
int stcf_support_mask(const uint8_t* mask, int* out, int planes, int h, int w,
                      int r, int include_self, void* stream) {
  return launch<false>(mask, out, planes, h, w, r, include_self, 0.0f,
                       DecayConsts{0, 1, 0, 1, 0}, 0.0f, stream);
}

// Fused: (planes, h, w) float32 SAE -> decay -> v > v_tw -> support count.
int stcf_support_fused(const float* sae, int* out, int planes, int h, int w,
                       int r, int include_self, float t_now, float a1,
                       float tau1, float a2, float tau2, float b, float v_tw,
                       void* stream) {
  return launch<true>(sae, out, planes, h, w, r, include_self, t_now,
                      DecayConsts{a1, tau1, a2, tau2, b}, v_tw, stream);
}

}  // extern "C"
