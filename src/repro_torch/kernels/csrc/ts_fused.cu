// chunk_scatter: the engine's event write.  B padded AER chunks, each aimed
// at one slot of an (S, P, H, W) SAE pool, are max-combined into it, and
// in the same pass every other piece of slot state the write moves is
// updated: the dirty-tile marks of the readout cache, the polarity-merged
// event-counter plane, and each slot's t_last / n_events.
//
// Replaces the TPU kernel in src/repro/kernels/ts_fused.py
// (_scatter_kernel, driven by chunk_scatter_pallas) together with the rest
// of the reference engine's scatter body (src/repro/serve/ts_engine.py,
// _scatter_chunks).  The TPU kernel walks every event over every row
// block, O(N x rows); this one is O(N): one thread per event.
//
// Bound: the event stream (17 B per event) and the touched cells (read and
// write 4 B each, plus the counter and dirty byte) -- bytes, through L2
// atomics at random addresses.  Design:
//   * The float max is an integer atomic on the raw float bits, with the
//     order-preserving pair: atomicMax on the signed bits when the sign bit
//     is clear, atomicMin on the unsigned bits when it is set.  That orders
//     -inf and negative stamps correctly, and max never rounds, so the
//     result is bitwise the reference's .at[].max whatever the order the
//     atomics land in.
//   * The dirty mark is an idempotent store of 1; the counter an atomicAdd.
//   * t_last / n_events are reduced over the block (warp shuffles, then
//     shared memory) before one atomic per block.
//   * Invalid events, events outside [0,W) x [0,H) x [0,P) and rows aimed
//     outside [0,S) touch nothing.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

struct Pool {
  float* sae;      // (S, P, H, W)
  int s, p, h, w;
  uint8_t* dirty;  // (S, tiles_per_slot) or null
  int bh, bw, th, tw, tiles_per_slot;
  int* counts;     // (S, H, W) or null
  float* t_last;   // (S,) or null
  int* n_events;   // (S,) or null
};

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(Pool pool, const int* __restrict__ slot_ids,
                   const int* __restrict__ ex, const int* __restrict__ ey,
                   const int* __restrict__ ep, const float* __restrict__ et,
                   const bool* __restrict__ valid, int n) {
  const int row = blockIdx.y;
  const int slot = slot_ids[row];
  if (slot < 0 || slot >= pool.s) return;  // whole block: uniform branch

  const int j = blockIdx.x * kThreads + threadIdx.x;
  float t = -INFINITY;
  int hit = 0;
  if (j < n) {
    const int64_t e = int64_t(row) * n + j;
    const int x = ex[e];
    const int y = ey[e];
    const int p = pool.p == 1 ? 0 : ep[e];  // one plane: polarity merges
    if (valid[e] && x >= 0 && x < pool.w && y >= 0 && y < pool.h && p >= 0 &&
        p < pool.p) {
      t = et[e];
      hit = 1;
      atomic_max_float(
          pool.sae + ((int64_t(slot) * pool.p + p) * pool.h + y) * pool.w + x,
          t);
      if (pool.dirty) {
        pool.dirty[int64_t(slot) * pool.tiles_per_slot +
                   (p * pool.th + y / pool.bh) * pool.tw + x / pool.bw] = 1;
      }
      if (pool.counts) {
        atomicAdd(pool.counts + (int64_t(slot) * pool.h + y) * pool.w + x, 1);
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    t = fmaxf(t, __shfl_down_sync(0xffffffffu, t, off));
    hit += __shfl_down_sync(0xffffffffu, hit, off);
  }
  __shared__ float warp_t[kWarps];
  __shared__ int warp_hit[kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    warp_t[warp] = t;
    warp_hit[warp] = hit;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) {
      t = fmaxf(t, warp_t[k]);
      hit += warp_hit[k];
    }
    if (hit && pool.t_last) atomic_max_float(pool.t_last + slot, t);
    if (hit && pool.n_events) atomicAdd(pool.n_events + slot, hit);
  }
}

}  // namespace

extern "C" {

// sae (s, p, h, w) float32; events (b, n) int32 x/y/p, float32 t, bool
// valid; slot_ids (b,) int32.  dirty (bool, (s, tiles_per_slot)), counts
// (int32, (s, h, w)), t_last (float32, (s,)) and n_events (int32, (s,))
// may each be null.  Returns cudaGetLastError().
int chunk_scatter(float* sae, int s, int p, int h, int w, const int* slot_ids,
                  const int* ex, const int* ey, const int* ep, const float* et,
                  const bool* valid, int b, int n, uint8_t* dirty, int bh,
                  int bw, int* counts, float* t_last, int* n_events,
                  void* stream) {
  if (b == 0 || n == 0) return 0;
  Pool pool;
  pool.sae = sae;
  pool.s = s;
  pool.p = p;
  pool.h = h;
  pool.w = w;
  pool.dirty = dirty;
  pool.bh = bh;
  pool.bw = bw;
  pool.th = (h + bh - 1) / bh;
  pool.tw = (w + bw - 1) / bw;
  pool.tiles_per_slot = p * pool.th * pool.tw;
  pool.counts = counts;
  pool.t_last = t_last;
  pool.n_events = n_events;
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pool, slot_ids, ex, ey, ep, et, valid, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
