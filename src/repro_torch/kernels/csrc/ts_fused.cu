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
// block, O(N x rows); this one is O(N log N) per segment of one row.
//
// Bound: bytes -- the event stream (17 B per event slot) and the touched
// cells (read and write 4 B of SAE and 4 B of counter each, plus a dirty
// byte per tile), the cells at random addresses through L2 atomics.  An
// event stream repeats cells (an edge crossing a pixel fires it more than
// once, hot pixels fire all the time), so one block merges the repeats of
// its events before it touches the pool:
//   * One block of kThreads threads owns one segment of up to kSegment
//     event slots of one chunk row (longer rows split into segments); all
//     its events share one slot.  Each thread loads kItems (8)
//     consecutive slots of the five fields, with 16-byte vector loads
//     where they are aligned.
//   * Each event becomes key = (y*W + x) << pbits | p (pbits = ceil(log2
//     P), so the keys of one cell are adjacent) and the value t as a
//     monotone unsigned (ordered) integer; an event that fails the checks
//     gets the sentinel key H*W << pbits, which sorts last.
//   * cub::BlockRadixSort, a block-level building block, sorts the
//     (key, t) pairs in shared memory over only the bits the keys need (18
//     at 2 x 240 x 320: three passes of 6-bit digits).
//   * Each thread then holds 8 consecutive sorted items and walks them:
//     one atomic per run of equal keys on the SAE (the run's max t, as the
//     signed/unsigned bit pair below), one atomicAdd of the run length per
//     run of equal cells on the counter plane, and the run's tile set in a
//     shared bitmap of the slot's tiles, which is flushed to the dirty
//     marks once per block.  A run longer than a thread's 8 items (a hot
//     pixel) issues one atomic per thread it spans, so no thread walks
//     more than 8 items.  The atomics go out in address order.
//   * The float max is an integer atomic on the raw float bits, with the
//     order-preserving pair: atomicMax on the signed bits when the sign bit
//     is clear, atomicMin on the unsigned bits when it is set.  That orders
//     -inf and negative stamps correctly; the run's max is taken in the same
//     order, and max never rounds, so the result is bitwise the reference's
//     .at[].max whatever order the atomics land in.  Integer sums are exact.
//   * t_last / n_events are reduced over the block (warp shuffles, then
//     shared memory) before one atomic per block.
//   * Invalid events, events outside [0,W) x [0,H) x [0,P) and rows aimed
//     outside [0,S) touch nothing.
// On sensor traffic a segment repeats few cells (1.95 atomics per event
// after the merge, PERF.md), so the random read-modify-writes of the pool
// stay what bounds this kernel; where pixels repeat the merge cuts the
// atomics (0.21 per event on a duplicate-heavy push).
#include <cuda_runtime.h>

#include <cstdint>
#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                      // event slots per thread
constexpr int kSegment = kThreads * kItems;    // event slots per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 1 << 16;             // dirty tiles of one slot

constexpr int kRadixBits = 6;                  // 3 passes over 18 key bits
using BlockSort =
    cub::BlockRadixSort<uint32_t, kThreads, kItems, uint32_t, kRadixBits>;

// float bits -> unsigned integers in the order of the pair of atomics below
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

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
  int pbits;       // ceil(log2(p))
  int key_bits;    // bits of the sentinel key h*w << pbits
  uint8_t* dirty;  // (S, tiles_per_slot) or null
  int bh, bw, th, tw, tiles_per_slot;
  int* counts;     // (S, H, W) or null
  float* t_last;   // (S,) or null
  int* n_events;   // (S,) or null
};

struct Events {
  const int* slot_ids;
  const int* x;
  const int* y;
  const int* p;
  const float* t;
  const bool* valid;
  int n;
};

// The kItems event slots j0 .. of one row (e = row offset of j0).
template <bool kVec>
__device__ __forceinline__ void load_items(const Events& ev, int64_t e, int j0,
                                           int (&x)[kItems], int (&y)[kItems],
                                           int (&p)[kItems],
                                           float (&t)[kItems],
                                           bool (&valid)[kItems]) {
  if (kVec && j0 + kItems <= ev.n) {
    // aligned: n % kItems == 0 and every field pointer 16-byte aligned
    const int4* vx = reinterpret_cast<const int4*>(ev.x + e);
    const int4* vy = reinterpret_cast<const int4*>(ev.y + e);
    const int4* vp = reinterpret_cast<const int4*>(ev.p + e);
    const float4* vt = reinterpret_cast<const float4*>(ev.t + e);
    const uchar4* vv = reinterpret_cast<const uchar4*>(ev.valid + e);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 a = vx[q], b = vy[q], c = vp[q];
      const float4 d = vt[q];
      const uchar4 f = vv[q];
      const int i = 4 * q;
      x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
      y[i] = b.x; y[i + 1] = b.y; y[i + 2] = b.z; y[i + 3] = b.w;
      p[i] = c.x; p[i + 1] = c.y; p[i + 2] = c.z; p[i + 3] = c.w;
      t[i] = d.x; t[i + 1] = d.y; t[i + 2] = d.z; t[i + 3] = d.w;
      valid[i] = f.x; valid[i + 1] = f.y; valid[i + 2] = f.z;
      valid[i + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool in = j0 + i < ev.n;
    valid[i] = in && ev.valid[e + i];
    x[i] = in ? ev.x[e + i] : 0;
    y[i] = in ? ev.y[e + i] : 0;
    p[i] = in ? ev.p[e + i] : 0;
    t[i] = in ? ev.t[e + i] : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(Pool pool, Events ev) {
  __shared__ struct {
    typename BlockSort::TempStorage sort;
  } smem;
  __shared__ uint32_t tile_bits[kMaxTiles / 32];
  __shared__ uint32_t warp_t[kWarps];
  __shared__ int warp_hit[kWarps];

  const int row = blockIdx.y;
  const int slot = ev.slot_ids[row];
  if (slot < 0 || slot >= pool.s) return;  // whole block: uniform branch
  const int tid = threadIdx.x;
  const int tile_words = pool.dirty ? (pool.tiles_per_slot + 31) / 32 : 0;
  for (int k = tid; k < tile_words; k += kThreads) tile_bits[k] = 0;
  __syncthreads();

  const int j0 = blockIdx.x * kSegment + tid * kItems;
  int x[kItems], y[kItems], p[kItems];
  float t[kItems];
  bool valid[kItems];
  load_items<kVec>(ev, int64_t(row) * ev.n + j0, j0, x, y, p, t, valid);

  const uint32_t sentinel = uint32_t(pool.h) * pool.w << pool.pbits;
  uint32_t key[kItems], val[kItems];
  uint32_t t_max = 0;   // ordered(-NaN) is 0: below every stamp
  int hit = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pp = pool.p == 1 ? 0 : p[i];  // one plane: polarity merges
    const bool ok = valid[i] && x[i] >= 0 && x[i] < pool.w && y[i] >= 0 &&
                    y[i] < pool.h && pp >= 0 && pp < pool.p;
    key[i] = ok ? (uint32_t(y[i] * pool.w + x[i]) << pool.pbits) | pp
                : sentinel;
    val[i] = ordered(t[i]);
    if (ok) {
      t_max = max(t_max, val[i]);
      ++hit;
    }
  }

  // sorted, blocked: thread tid holds ranks 8 tid .. 8 tid + 7.  Each
  // thread merges the runs among its own 8 items, so a run that crosses
  // threads issues one atomic per thread it touches.
  BlockSort(smem.sort).Sort(key, val, 0, pool.key_bits);

  const int64_t hw = int64_t(pool.h) * pool.w;
  float* sae = pool.sae + int64_t(slot) * pool.p * hw;
  int* counts = pool.counts ? pool.counts + int64_t(slot) * hw : nullptr;
  const uint32_t pmask = (1u << pool.pbits) - 1;
  auto write_run = [&](uint32_t k, uint32_t run_max) {
    const uint32_t cell = k >> pool.pbits;
    const int pp = int(k & pmask);
    atomic_max_float(sae + pp * hw + cell, unordered(run_max));
    if (pool.dirty) {
      const int cy = int(cell) / pool.w;
      const int tile = (pp * pool.th + cy / pool.bh) * pool.tw +
                       (int(cell) - cy * pool.w) / pool.bw;
      atomicOr(&tile_bits[tile >> 5], 1u << (tile & 31));
    }
  };
  uint32_t run_key = key[0], run_max = val[0];
  int cell_len = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (key[i] == sentinel) break;   // the sentinel sorts last
    if (key[i] != run_key) {
      write_run(run_key, run_max);
      if ((key[i] >> pool.pbits) != (run_key >> pool.pbits)) {
        if (counts) atomicAdd(counts + (run_key >> pool.pbits), cell_len);
        cell_len = 0;
      }
      run_key = key[i];
      run_max = val[i];
    } else {
      run_max = max(run_max, val[i]);
    }
    ++cell_len;
  }
  if (cell_len) {
    write_run(run_key, run_max);
    if (counts) atomicAdd(counts + (run_key >> pool.pbits), cell_len);
  }
  __syncthreads();   // every tile bit is set

  for (int off = 16; off > 0; off >>= 1) {
    t_max = max(t_max, __shfl_down_sync(0xffffffffu, t_max, off));
    hit += __shfl_down_sync(0xffffffffu, hit, off);
  }
  const int lane = tid % 32;
  const int warp = tid / 32;
  if (lane == 0) {
    warp_t[warp] = t_max;
    warp_hit[warp] = hit;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kWarps; ++k) {
      t_max = max(t_max, warp_t[k]);
      hit += warp_hit[k];
    }
    if (hit && pool.t_last) atomic_max_float(pool.t_last + slot, unordered(t_max));
    if (hit && pool.n_events) atomicAdd(pool.n_events + slot, hit);
  }
  if (pool.dirty) {
    uint8_t* marks = pool.dirty + int64_t(slot) * pool.tiles_per_slot;
    for (int tile = tid; tile < pool.tiles_per_slot; tile += kThreads) {
      if ((tile_bits[tile >> 5] >> (tile & 31)) & 1u) marks[tile] = 1;
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// sae (s, p, h, w) float32; events (b, n) int32 x/y/p, float32 t, bool
// valid; slot_ids (b,) int32.  dirty (bool, (s, tiles_per_slot)), counts
// (int32, (s, h, w)), t_last (float32, (s,)) and n_events (int32, (s,))
// may each be null.  Needs (h*w << ceil(log2 p)) < 2^31 and at most
// 65536 dirty tiles per slot.  Returns cudaGetLastError().
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
  pool.pbits = 0;
  while ((1 << pool.pbits) < p) ++pool.pbits;
  const int64_t sentinel = (int64_t(h) * w) << pool.pbits;
  if (p < 1 || sentinel >= (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pool.key_bits = 0;
  while ((int64_t(1) << pool.key_bits) <= sentinel) ++pool.key_bits;
  pool.dirty = dirty;
  pool.bh = bh;
  pool.bw = bw;
  pool.th = (h + bh - 1) / bh;
  pool.tw = (w + bw - 1) / bw;
  pool.tiles_per_slot = p * pool.th * pool.tw;
  if (dirty && pool.tiles_per_slot > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pool.counts = counts;
  pool.t_last = t_last;
  pool.n_events = n_events;
  const Events ev{slot_ids, ex, ey, ep, et, valid, n};
  const dim3 grid((n + kSegment - 1) / kSegment, b);
  const bool vec = n % kItems == 0 && aligned(ex, 16) && aligned(ey, 16) &&
                   aligned(ep, 16) && aligned(et, 16) && aligned(valid, 4);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    scatter_kernel<true><<<grid, kThreads, 0, st>>>(pool, ev);
  } else {
    scatter_kernel<false><<<grid, kThreads, 0, st>>>(pool, ev);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
