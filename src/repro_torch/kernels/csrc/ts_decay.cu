// ts_decay: the time-surface decay read over a whole slot pool, with the
// STCF comparator optionally fused.
//
// Replaces the TPU kernels in src/repro/kernels/ts_decay.py: the uniform
// form replaces _uniform_kernel, the (H, W) parameter-plane form
// _varied_kernel (both driven by ts_decay_pallas, which vmaps them over
// the leading slot/polarity dims).  Here the leading dims are part of one
// launch: every cell of an (S, P, H, W) pool, or of a (K, bh, bw) stack
// of gathered dirty tiles.
//
// Bound: device-memory bytes.  A cell reads 4 B and writes 4 B (one more
// byte with the mask) against ~12 float operations, far below the card's
// operations-per-byte balance.  What bound each form on an H100 was
// measured with tools/kernel_variants.py --decay (PERF.md), where
// an `arith=copy` variant keeps a kernel's loads and stores and drops its
// arithmetic:
//   * Uniform form: bytes, not issue.  The first version (a grid-stride
//     loop capped at 16 blocks of 256 threads an SM, one 16-byte load in
//     flight a thread; 936 SASS instructions, 275 in its loop of 4 cells)
//     ran within 6 % of a copy of its own pattern.  More loads in flight
//     a thread did not help; the pattern did: one pass of one float4 a
//     thread, with streaming loads and stores (__ldcs / __stcs: each byte
//     is touched once), reaches the copy ceiling, as fast as PyTorch's
//     device-to-device copy of the same bytes.  The mask goes out as 4
//     bytes a store.  An unaligned tensor takes one cell a thread, and
//     the last n % 4 cells of an aligned one go to n % 4 extra threads.
//   * Plane form: the first version's indexing (a 64-bit `i % plane`, five
//     scalar parameter loads, two clamps a cell) ran at 60 % of its copy
//     ceiling.  Now a 2-D grid: blockIdx.x runs over the plane in float4
//     columns (single cells where the wrapper found the plane length not
//     a multiple of 4 or a pointer misaligned), blockIdx.y over groups of
//     `group` leading planes.  A thread loads and clamps its columns'
//     parameters once, then walks its group's planes with the next
//     plane's load in flight; no division by the plane length anywhere.
//     The wrapper picks the shape (ts_decay.py: planes_launch).  Holding
//     five parameters a cell in registers bounds its occupancy; it runs
//     within 7 % of a copy of its pattern.
//   * Division: the uniform form uses decay.cuh's corrected-reciprocal
//     quotient (reciprocals taken once, by the launcher); the plane form
//     keeps __fdiv_rn, since two more registers a cell cost it more than
//     the division saves.  Both are bitwise the plain version; the
//     quotient is gated against __fdiv_rn by decay_division_gate below.
#include <cuda_runtime.h>

#include <cstdint>

#include "decay.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 decay4(float4 s, float t_now,
                                         const DecayConsts& c) {
  return make_float4(decay_cell(s.x, t_now, c), decay_cell(s.y, t_now, c),
                     decay_cell(s.z, t_now, c), decay_cell(s.w, t_now, c));
}

__device__ __forceinline__ uint32_t mask4(float4 v, float v_tw) {
  return uint32_t(v.x > v_tw) | uint32_t(v.y > v_tw) << 8 |
         uint32_t(v.z > v_tw) << 16 | uint32_t(v.w > v_tw) << 24;
}

// One pass: thread i < n4 reads float4 i (vec4), the next n % 4 threads
// the cells past the last float4; without vec4 (n4 = 0) thread i reads
// cell i.
template <bool kMask>
__global__ void __launch_bounds__(kThreads)
    decay_uniform_kernel(const float* __restrict__ sae, float* __restrict__ out,
                         uint8_t* __restrict__ mask, int64_t n, int64_t n4,
                         float t_now, DecayConsts c, float v_tw) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 v =
        decay4(__ldcs(reinterpret_cast<const float4*>(sae) + i), t_now, c);
    __stcs(reinterpret_cast<float4*>(out) + i, v);
    if (kMask) __stcs(reinterpret_cast<uint32_t*>(mask) + i, mask4(v, v_tw));
    return;
  }
  const int64_t k = 4 * n4 + (i - n4);
  if (k < n) {
    const float v = decay_cell(__ldcs(sae + k), t_now, c);
    __stcs(out + k, v);
    if (kMask) mask[k] = v > v_tw;
  }
}

// Per-cell parameter planes of `plane` cells, broadcast over `lead`
// leading planes; time constants clamped at 1e-9 s, as the TPU kernel's
// driver clamps them.  kVec: a thread owns 4 neighbouring cells of the
// plane (plane % 4 == 0, every pointer aligned), else one.  It walks
// leading planes p0 .. p1 - 1 with the next plane's load in flight while
// it decays the current one, by __fdiv_rn (decay_cell_ieee): the
// corrected quotient's two reciprocals a cell cost 8 registers a thread
// here and measured slower (PERF.md).
template <bool kMask, bool kVec>
__global__ void __launch_bounds__(kThreads)
    decay_planes_kernel(const float* __restrict__ sae, float* __restrict__ out,
                        uint8_t* __restrict__ mask, int64_t lead,
                        int64_t plane, int group, float t_now,
                        const float* __restrict__ a1,
                        const float* __restrict__ tau1,
                        const float* __restrict__ a2,
                        const float* __restrict__ tau2,
                        const float* __restrict__ b, float v_tw) {
  constexpr int kW = kVec ? 4 : 1;
  const int64_t k = (int64_t(blockIdx.x) * kThreads + threadIdx.x) * kW;
  if (k >= plane) return;
  const int64_t p0 = int64_t(blockIdx.y) * group;
  const int64_t p1 = p0 + group < lead ? p0 + group : lead;
  auto load_plane = [&](int64_t p, float (&s)[kW]) {
    const float* src = sae + p * plane + k;
    if constexpr (kVec) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(src));
      s[0] = q.x;
      s[1] = q.y;
      s[2] = q.z;
      s[3] = q.w;
    } else {
      s[0] = __ldcs(src);
    }
  };
  float next[kW];
  load_plane(p0, next);   // in flight while the constants are made
  DecayConsts c[kW];
#pragma unroll
  for (int e = 0; e < kW; ++e) {
    c[e] = DecayConsts{a1[k + e], fmaxf(tau1[k + e], 1e-9f), a2[k + e],
                       fmaxf(tau2[k + e], 1e-9f), b[k + e], 0.0f, 0.0f};
  }
  for (int64_t p = p0; p < p1; ++p) {
    float v[kW];
#pragma unroll
    for (int e = 0; e < kW; ++e) v[e] = next[e];
    if (p + 1 < p1) load_plane(p + 1, next);
#pragma unroll
    for (int e = 0; e < kW; ++e) v[e] = decay_cell_ieee(v[e], t_now, c[e]);
    const int64_t at = p * plane + k;
    if constexpr (kVec) {
      const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
      __stcs(reinterpret_cast<float4*>(out + at), v4);
      if (kMask) {
        __stcs(reinterpret_cast<uint32_t*>(mask + at), mask4(v4, v_tw));
      }
    } else {
      __stcs(out + at, v[0]);
      if (kMask) mask[at] = v[0] > v_tw;
    }
  }
}

template <bool kMask, bool kVec>
void launch_planes(const float* sae, float* out, uint8_t* mask, int64_t lead,
                   int64_t plane, int group, int grid_x, int grid_y,
                   float t_now, const float* a1, const float* tau1,
                   const float* a2, const float* tau2, const float* b,
                   float v_tw, cudaStream_t s) {
  decay_planes_kernel<kMask, kVec>
      <<<dim3(grid_x, grid_y), kThreads, 0, s>>>(sae, out, mask, lead, plane,
                                                 group, t_now, a1, tau1, a2,
                                                 tau2, b, v_tw);
}

// splitmix64: the gate's counter-based source of random bits.
__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

__device__ __forceinline__ bool same_quotient(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a == 0.0f && b == 0.0f);
}

// mode 0: the dividends of cells 0 .. count - 1 are the float bit
// patterns of those indices (mod 2^32), every one against the launch's
// uniform constants `u` (reciprocals taken on the host).  mode 1: each
// cell draws a dividend and two positive time constants from `seed`
// (clamped at 1e-9 s, reciprocals taken on the card).  Counts the cells
// whose decay value (counts[0]) or either quotient (counts[1], +0 == -0)
// differs between decay_cell and the __fdiv_rn arithmetic.
__global__ void __launch_bounds__(kThreads)
    division_gate_kernel(int mode, DecayConsts u, uint64_t seed,
                         uint64_t count, unsigned long long* counts) {
  unsigned long long bad_v = 0, bad_q = 0;
  const uint64_t stride = uint64_t(gridDim.x) * kThreads;
  for (uint64_t i = uint64_t(blockIdx.x) * kThreads + threadIdx.x; i < count;
       i += stride) {
    float x;
    DecayConsts c = u;
    if (mode == 0) {
      x = __uint_as_float(uint32_t(i));
    } else {
      const uint64_t r1 = mix64(seed ^ (i << 1));
      const uint64_t r2 = mix64(seed ^ (i << 1 | 1));
      x = __uint_as_float(uint32_t(r1));
      c = decay_consts(u.a1, fmaxf(__uint_as_float(uint32_t(r1 >> 32) >> 1),
                                   1e-9f),
                       u.a2, fmaxf(__uint_as_float(uint32_t(r2) >> 1), 1e-9f),
                       u.b);
    }
    // t_now = 0: the cell's dividend -(0 - sae) is sae itself (-0 at 0)
    bad_v += __float_as_uint(decay_cell(x, 0.0f, c)) !=
             __float_as_uint(decay_cell_ieee(x, 0.0f, c));
    if (isfinite(x)) {
      const float xd = -__fsub_rn(0.0f, x);
      float q1, q2;
      decay_quotients(xd, c, q1, q2);
      bad_q += !same_quotient(q1, __fdiv_rn(xd, c.tau1)) ||
               !same_quotient(q2, __fdiv_rn(xd, c.tau2));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    bad_v += __shfl_xor_sync(0xffffffffu, bad_v, o);
    bad_q += __shfl_xor_sync(0xffffffffu, bad_q, o);
  }
  if ((threadIdx.x & 31) == 0 && (bad_v | bad_q)) {
    atomicAdd(counts, bad_v);
    atomicAdd(counts + 1, bad_q);
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
  const DecayConsts c = decay_consts(a1, tau1, a2, tau2, b);
  const bool vec4 = (reinterpret_cast<uintptr_t>(sae) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(mask) % 4 == 0);
  const int64_t n4 = vec4 ? n >> 2 : 0;
  const int64_t threads = n4 + (n - 4 * n4);
  const int64_t grid = (threads + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask) {
    decay_uniform_kernel<true><<<unsigned(grid), kThreads, 0, s>>>(
        sae, out, mask, n, n4, t_now, c, v_tw);
  } else {
    decay_uniform_kernel<false><<<unsigned(grid), kThreads, 0, s>>>(
        sae, out, mask, n, n4, t_now, c, v_tw);
  }
  return static_cast<int>(cudaGetLastError());
}

// `lead` planes of `plane` cells; the launch shape (vec4, group, grid)
// comes from the wrapper (ts_decay.py: planes_launch).
int ts_decay_planes(const float* sae, float* out, uint8_t* mask,
                    long long lead, long long plane, float t_now,
                    const float* a1, const float* tau1, const float* a2,
                    const float* tau2, const float* b, float v_tw, int vec4,
                    int group, int grid_x, int grid_y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask && vec4) {
    launch_planes<true, true>(sae, out, mask, lead, plane, group, grid_x,
                              grid_y, t_now, a1, tau1, a2, tau2, b, v_tw, s);
  } else if (mask) {
    launch_planes<true, false>(sae, out, mask, lead, plane, group, grid_x,
                               grid_y, t_now, a1, tau1, a2, tau2, b, v_tw, s);
  } else if (vec4) {
    launch_planes<false, true>(sae, out, mask, lead, plane, group, grid_x,
                               grid_y, t_now, a1, tau1, a2, tau2, b, v_tw, s);
  } else {
    launch_planes<false, false>(sae, out, mask, lead, plane, group, grid_x,
                                grid_y, t_now, a1, tau1, a2, tau2, b, v_tw, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The card check of decay.cuh's corrected quotient (division_gate_kernel):
// adds the mismatches of cells 0 .. count - 1 to counts[0] (decay values)
// and counts[1] (quotients), device memory.
int decay_division_gate(int mode, float a1, float tau1, float a2, float tau2,
                        float b, unsigned long long seed,
                        unsigned long long count, unsigned long long* counts,
                        void* stream) {
  const DecayConsts c = decay_consts(a1, tau1, a2, tau2, b);
  division_gate_kernel<<<4096, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      mode, c, seed, count, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
