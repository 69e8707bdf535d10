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
//
// decay_scan_bwd is its backward, the adjoint recurrence walked from the
// end: with G the gradient of the states and G_f that of the final state,
//   lam_{T-1} = G_{T-1} + G_f,   lam_t = G_t + a_{t+1} * lam_{t+1},
//   dx_t = lam_t,   da_t = lam_t * s_{t-1} (s_{-1} = s0, or 0),
//   ds0 = a_0 * lam_0.
// The same layout (one thread per (b, 4 channels), lam in registers, t
// from T-1 down to 0) and the same float4/scalar split.  Per (b, t, c) it
// reads a, G and s_{t-1} and writes dx and da (20 B).  Each sum has two
// terms and each product two factors, rounded once, so the plain
// PyTorch loop (kernels/ref.py, decay_scan_bwd_ref) and autograd through
// the plain forward agree with it bitwise (autograd may give +0 where
// this gives -0: it sums each step's slice into a zero buffer).
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

__device__ __forceinline__ float4 adjoint(float4 a, float4 lam, float4 g) {
  return make_float4(__fadd_rn(g.x, __fmul_rn(a.x, lam.x)),
                     __fadd_rn(g.y, __fmul_rn(a.y, lam.y)),
                     __fadd_rn(g.z, __fmul_rn(a.z, lam.z)),
                     __fadd_rn(g.w, __fmul_rn(a.w, lam.w)));
}

__device__ __forceinline__ float4 mul4(float4 u, float4 v) {
  return make_float4(__fmul_rn(u.x, v.x), __fmul_rn(u.y, v.y),
                     __fmul_rn(u.z, v.z), __fmul_rn(u.w, v.w));
}

__global__ void __launch_bounds__(kThreads)
    decay_scan_bwd_vec4_kernel(const float4* __restrict__ a,
                               const float4* __restrict__ st,
                               const float4* __restrict__ s0,
                               const float4* __restrict__ g,
                               const float4* __restrict__ gf,
                               float4* __restrict__ da, float4* __restrict__ dx,
                               float4* __restrict__ ds0, int64_t b, int64_t t,
                               int64_t c4) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b * c4 || t == 0) return;
  const int64_t bi = i / c4, ci = i - bi * c4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t k = (bi * t + t - 1) * c4 + ci;
  float4 lam = g[k];
  if (gf) {
    const float4 f = gf[i];
    lam = make_float4(__fadd_rn(lam.x, f.x), __fadd_rn(lam.y, f.y),
                      __fadd_rn(lam.z, f.z), __fadd_rn(lam.w, f.w));
  }
  float4 a_t = a[k];
#pragma unroll 4
  for (int64_t ti = t - 1; ti > 0; --ti, k -= c4) {
    dx[k] = lam;
    da[k] = mul4(lam, st[k - c4]);
    const float4 a_prev = a[k - c4];
    lam = adjoint(a_t, lam, g[k - c4]);
    a_t = a_prev;
  }
  dx[k] = lam;
  da[k] = s0 ? mul4(lam, s0[i]) : mul4(lam, zero);
  if (ds0) ds0[i] = mul4(a_t, lam);
}

__global__ void __launch_bounds__(kThreads)
    decay_scan_bwd_scalar_kernel(const float* __restrict__ a,
                                 const float* __restrict__ st,
                                 const float* __restrict__ s0,
                                 const float* __restrict__ g,
                                 const float* __restrict__ gf,
                                 float* __restrict__ da, float* __restrict__ dx,
                                 float* __restrict__ ds0, int64_t b, int64_t t,
                                 int64_t c) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b * c || t == 0) return;
  const int64_t bi = i / c, ci = i - bi * c;
  int64_t k = (bi * t + t - 1) * c + ci;
  float lam = gf ? __fadd_rn(g[k], gf[i]) : g[k];
  float a_t = a[k];
#pragma unroll 4
  for (int64_t ti = t - 1; ti > 0; --ti, k -= c) {
    dx[k] = lam;
    da[k] = __fmul_rn(lam, st[k - c]);
    const float a_prev = a[k - c];
    lam = __fadd_rn(g[k - c], __fmul_rn(a_t, lam));
    a_t = a_prev;
  }
  dx[k] = lam;
  da[k] = __fmul_rn(lam, s0 ? s0[i] : 0.f);
  if (ds0) ds0[i] = __fmul_rn(a_t, lam);
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

// a, states, g, da, dx: (B, T, C) float32, contiguous; s0, gf, ds0:
// (B, C), each may be null (no initial state, no final-state gradient,
// no initial-state gradient wanted).  Returns cudaGetLastError().
int decay_scan_bwd(const float* a, const float* states, const float* s0,
                   const float* g, const float* gf, float* da, float* dx,
                   float* ds0, long long b, long long t, long long c,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 && aligned16(a) && aligned16(states) &&
                    aligned16(g) && aligned16(da) && aligned16(dx) &&
                    (s0 == nullptr || aligned16(s0)) &&
                    (gf == nullptr || aligned16(gf)) &&
                    (ds0 == nullptr || aligned16(ds0));
  if (vec4) {
    const int64_t n = b * (c / 4);
    const int grid = int((n + kThreads - 1) / kThreads);
    decay_scan_bwd_vec4_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(a),
        reinterpret_cast<const float4*>(states),
        reinterpret_cast<const float4*>(s0), reinterpret_cast<const float4*>(g),
        reinterpret_cast<const float4*>(gf), reinterpret_cast<float4*>(da),
        reinterpret_cast<float4*>(dx), reinterpret_cast<float4*>(ds0), b, t,
        c / 4);
  } else {
    const int64_t n = b * c;
    const int grid = int((n + kThreads - 1) / kThreads);
    decay_scan_bwd_scalar_kernel<<<grid, kThreads, 0, st>>>(
        a, states, s0, g, gf, da, dx, ds0, b, t, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
