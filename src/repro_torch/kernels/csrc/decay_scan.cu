// decay_scan: the input-driven decay recurrence s_t = a_t * s_{t-1} + x_t
// over (B, T, C), elementwise in C, returning every state and the last.
//
// Replaces the TPU kernel in src/repro/kernels/decay_scan.py
// (_decay_kernel, driven by decay_scan_pallas).  That kernel walks T as a
// sequential grid axis with the carry in VMEM scratch and a log-step
// associative scan inside each 128-step chunk.  Here the parallelism is in
// C instead: in the Mamba-2 SSD block C = heads * headdim * state (655,360
// at mamba2-2.7b's full width) while T is the number of SSD chunks (16 for
// a 2048-token prompt), so one thread owns (b, 4 consecutive channels)
// and walks t = 0..T-1 with the carry in registers.  Neighbouring threads
// own neighbouring channels, so every step's loads and stores are
// coalesced 16-byte float4s; a scalar variant, one channel per thread,
// takes a C that is not a multiple of 4 or a pointer not 16-byte aligned.
//
// Bound: device-memory bytes.  Per (b, t, c) it reads a and x and writes
// the state (12 B) against 2 float operations; plus s0 and the final
// state per (b, c).  At the smoke's prefill shapes (B = 8, T = 16,
// C = 655,360) that is ~1.03 GB, ~0.31 ms at 3.35 TB/s.
//
// The step is __fadd_rn(__fmul_rn(a, s), x), built with -fmad=false: two
// IEEE roundings, the arithmetic of the plain PyTorch version
// (s = a[:, t] * s + x[:, t]), so the two agree bitwise.  A null s0 starts
// from zeros, which equals the reference's identity-step fold of s0.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float step(float a, float s, float x) {
  return __fadd_rn(__fmul_rn(a, s), x);
}

__global__ void __launch_bounds__(kThreads)
    decay_scan_vec4_kernel(const float4* __restrict__ a,
                           const float4* __restrict__ x,
                           const float4* __restrict__ s0,
                           float4* __restrict__ out, float4* __restrict__ fin,
                           int64_t b, int64_t t, int64_t c4) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b * c4) return;
  const int64_t bi = i / c4, ci = i - bi * c4;
  float4 s = s0 ? s0[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t k = bi * t * c4 + ci;
#pragma unroll 4
  for (int64_t ti = 0; ti < t; ++ti, k += c4) {
    const float4 av = a[k], xv = x[k];
    s.x = step(av.x, s.x, xv.x);
    s.y = step(av.y, s.y, xv.y);
    s.z = step(av.z, s.z, xv.z);
    s.w = step(av.w, s.w, xv.w);
    out[k] = s;
  }
  fin[i] = s;
}

__global__ void __launch_bounds__(kThreads)
    decay_scan_scalar_kernel(const float* __restrict__ a,
                             const float* __restrict__ x,
                             const float* __restrict__ s0,
                             float* __restrict__ out, float* __restrict__ fin,
                             int64_t b, int64_t t, int64_t c) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b * c) return;
  const int64_t bi = i / c, ci = i - bi * c;
  float s = s0 ? s0[i] : 0.f;
  int64_t k = bi * t * c + ci;
#pragma unroll 4
  for (int64_t ti = 0; ti < t; ++ti, k += c) {
    s = step(a[k], s, x[k]);
    out[k] = s;
  }
  fin[i] = s;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// a, x, out: (B, T, C) float32, contiguous; s0 (may be null), fin: (B, C).
// Returns cudaGetLastError().
int decay_scan(const float* a, const float* x, const float* s0, float* out,
               float* fin, long long b, long long t, long long c,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 && aligned16(a) && aligned16(x) &&
                    aligned16(out) && aligned16(fin) &&
                    (s0 == nullptr || aligned16(s0));
  if (vec4) {
    const int64_t n = b * (c / 4);
    const int grid = int((n + kThreads - 1) / kThreads);
    decay_scan_vec4_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(x),
        reinterpret_cast<const float4*>(s0), reinterpret_cast<float4*>(out),
        reinterpret_cast<float4*>(fin), b, t, c / 4);
  } else {
    const int64_t n = b * c;
    const int grid = int((n + kThreads - 1) / kThreads);
    decay_scan_scalar_kernel<<<grid, kThreads, 0, st>>>(a, x, s0, out, fin, b,
                                                        t, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
