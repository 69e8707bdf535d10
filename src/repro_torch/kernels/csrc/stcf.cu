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
// pixel (the mask form 1 B and 4 B); the patch count is integer work on
// bits.  The fused form also pays two expf and two divisions per cell it
// loads (decay.cuh's corrected-reciprocal quotients, the reciprocals
// taken once by the launcher), so every cell is loaded and decayed as few
// times as possible:
//   * One block owns one band of kBandRows output rows of one plane across
//     a span of up to kMaxWarps 32-column words (the whole width of a
//     plane up to 32 * kMaxWarps pixels; wider planes split into spans).
//     Only the 2r halo rows above and below a band are loaded twice
//     (1.15x the cells at 40 rows and r = 3).
//   * The band's rows are loaded in groups of 128 columns (four words,
//     the guards included), 4 columns a lane with one 16-byte (fused) or
//     4-byte (mask) vector load where the rows are aligned, kBatch rows'
//     loads in flight before their compares.  Each lane flags its 4 cells
//     and three shuffles OR the lanes' nibbles into 32-bit words in shared
//     memory: (kBandRows + 2r) rows x (words + 2 guard words) bits.  The
//     guard words hold the neighbouring spans' columns (zero past the
//     plane edge), which covers any r <= 16.
//   * The row count of pixel x is __popc of the window bits x-r..x+r,
//     cut out of two neighbouring words by one funnel shift and a mask
//     (r = 16, 33 bits, takes two 64-bit shifts over three words); each
//     lane then walks down its column with a running sum, adding the
//     entering row's count and subtracting the leaving row's, so a pixel
//     costs O(1) whatever r is.  Outputs are written one 128-byte line per
//     warp row.
// No runtime division in any per-cell loop; integer sums are exact.  A
// persistent grid feeding a two-stage cp.async ring of bands measured
// slower than these independent resident blocks (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "decay.cuh"

namespace {

constexpr int kMaxRadius = 16;
constexpr int kBandRows = 40;
constexpr int kMaxWarps = 16;
constexpr int kMinBlocks = 3;   // resident blocks per SM: <= 42 registers
constexpr int kBatch = 4;   // rows whose loads are in flight together
constexpr int kMaxRows = kBandRows + 2 * kMaxRadius;
constexpr int kMaxStride = kMaxWarps + 2;

struct Geometry {
  int h, w;        // plane
  int words;       // 32-column words of a span (= warps of the block)
  int r;
  bool include_self;
};

template <typename In>
struct Vec4;
template <>
struct Vec4<float> {
  using T = float4;
};
template <>
struct Vec4<uint8_t> {
  using T = uchar4;
};

// Bit rows row0, row0 + step, ... (plane rows gy0 + row) of word columns
// 4 grp .. 4 grp + 3 of the block's bit array (word column 0 is the left
// guard, at global column col0 - 32).  Lane l holds columns 4l .. 4l+3 of
// the 128, loaded as one 4-wide vector when kVec (w % 4 == 0 and the
// plane aligned), else one by one; it flags them (fused: decay_cell >
// v_tw; mask: != 0) and three shuffles OR the lanes' 4-bit nibbles into
// the four 32-bit words.  kBatch rows' loads are in flight together.
// Every lane of the warp runs this.
template <bool kFused, bool kVec, typename In>
__device__ __forceinline__ void load_group(const In* __restrict__ plane,
                                           uint32_t* bits, int stride,
                                           int grp, int col0, int gy0,
                                           int row0, int step, int rows,
                                           const Geometry& g, float t_now,
                                           const DecayConsts& c, float v_tw) {
  const int lane = threadIdx.x & 31;
  const int x = col0 - 32 + grp * 128 + lane * 4;   // the lane's 4 columns
  uint32_t col_ok = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    col_ok |= uint32_t(x + e >= 0 && x + e < g.w) << e;
  }
  const int jc = grp * 4 + (lane >> 3);             // this lane's word column
  const bool writer = (lane & 7) == 0 && jc < stride;
  for (; row0 < rows; row0 += kBatch * step) {
    In v[kBatch][4];
    uint32_t ok[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int row = row0 + i * step;
      const int gy = gy0 + row;
      ok[i] = (row < rows && gy >= 0 && gy < g.h) ? col_ok : 0;
      const In* src = plane + int64_t(gy) * g.w + x;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] = In(0);
      if constexpr (kVec) {
        if (ok[i]) {   // all four columns or none
          const auto q = *reinterpret_cast<const typename Vec4<In>::T*>(src);
          v[i][0] = q.x;
          v[i][1] = q.y;
          v[i][2] = q.z;
          v[i][3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((ok[i] >> e) & 1u) v[i][e] = src[e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      uint32_t nib = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool f;
        if constexpr (kFused) {
          f = decay_cell(v[i][e], t_now, c) > v_tw;
        } else {
          f = v[i][e] != 0;
        }
        nib |= uint32_t(f && ((ok[i] >> e) & 1u)) << e;
      }
      uint32_t word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      word |= __shfl_xor_sync(0xffffffffu, word, 4);
      const int row = row0 + i * step;
      if (writer && row < rows) bits[row * stride + jc] = word;
    }
  }
}

// Set cells among columns x-r..x+r of one bit row.  Lane l's window
// starts at bit 32+l-r of the 96-bit string of words j-1, j, j+1; `a`
// indexes the first of the two words that hold it and `sh` the bit in
// it.  r < 16: one funnel shift of those two words; r == 16 (33 bits):
// two 64-bit shifts over all three.
template <bool kWide>
__device__ __forceinline__ int row_count(const uint32_t* row, int j, int a,
                                         int sh, uint32_t mask, int lane,
                                         int r) {
  if constexpr (!kWide) {
    return __popc(__funnelshift_r(row[a], row[a + 1], sh) & mask);
  } else {
    const uint64_t mid = row[j];
    const uint64_t lo = (mid << 32) | row[j - 1];
    const uint64_t hi = (uint64_t(row[j + 1]) << 32) | mid;
    return __popcll((lo >> (32 + lane - r)) & ((uint64_t(1) << (r + 1)) - 1)) +
           __popcll((hi >> (lane + 1)) & ((uint64_t(1) << r) - 1));
  }
}

template <bool kFused, bool kVec, bool kWide, typename In>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    support_kernel(const In* __restrict__ in, int* __restrict__ out,
                   Geometry g, float t_now, DecayConsts c, float v_tw) {
  __shared__ uint32_t bits[kMaxRows * kMaxStride];
  const int stride = g.words + 2;
  const int r = g.r;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * g.words * 32;   // first column of the span
  const int y0 = blockIdx.y * kBandRows;        // first output row
  const int rows_out = min(kBandRows, g.h - y0);
  const int rows = rows_out + 2 * r;            // bit rows: y0-r ..
  const int64_t base = int64_t(blockIdx.z) * g.h * g.w;
  const In* plane = in + base;

  // the load phase: word columns -1 .. words in groups of four (128
  // columns); warp k loads group k % groups, rows k / groups + i *
  // per_group (one division per warp, none per cell)
  const int groups = (stride + 3) / 4;
  const int per_group = g.words / groups;   // >= 1 for any span
  if (warp < per_group * groups) {
    load_group<kFused, kVec>(plane, bits, stride, warp % groups, col0,
                             y0 - r, warp / groups, per_group, rows, g, t_now,
                             c, v_tw);
  }
  __syncthreads();

  const int j = warp + 1;
  const int gx = col0 + warp * 32 + lane;
  const int start = 32 + lane - r;               // window bits start..+2r
  const int a = j - 1 + (start >> 5);
  const int sh = start & 31;
  const uint32_t mask = (2 * r + 1 >= 32) ? 0xffffffffu
                                           : (1u << (2 * r + 1)) - 1;
  const uint32_t self_bit = 1u << lane;
  int sum = 0;
  for (int k = 0; k < 2 * r; ++k) {
    sum += row_count<kWide>(bits + k * stride, j, a, sh, mask, lane, r);
  }
  int* dst = out + base + int64_t(y0) * g.w + gx;
  for (int y = 0; y < rows_out; ++y) {
    sum += row_count<kWide>(bits + (y + 2 * r) * stride, j, a, sh, mask, lane,
                            r);
    const int self =
        g.include_self ? 0 : ((bits[(y + r) * stride + j] & self_bit) != 0);
    if (gx < g.w) dst[int64_t(y) * g.w] = sum - self;
    sum -= row_count<kWide>(bits + y * stride, j, a, sh, mask, lane, r);
  }
}

template <bool kFused, typename In>
int launch(const In* in, int* out, int planes, int h, int w, int r,
           int include_self, float t_now, DecayConsts c, float v_tw,
           void* stream) {
  if (r < 0 || r > kMaxRadius) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (w + 31) / 32;
  const int spans = (words + kMaxWarps - 1) / kMaxWarps;
  Geometry g{h, w, (words + spans - 1) / spans, r, include_self != 0};
  const dim3 grid(spans, (h + kBandRows - 1) / kBandRows, planes);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % (4 * sizeof(In)) == 0;
  const bool wide = 2 * r + 1 > 32;
  auto kernel = vec ? (wide ? support_kernel<kFused, true, true, In>
                            : support_kernel<kFused, true, false, In>)
                    : (wide ? support_kernel<kFused, false, true, In>
                            : support_kernel<kFused, false, false, In>);
  kernel<<<grid, g.words * 32, 0, st>>>(in, out, g, t_now, c, v_tw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stcf_max_radius() { return kMaxRadius; }

// Support count of a bool mask: (planes, h, w) uint8 -> int32.
int stcf_support_mask(const uint8_t* mask, int* out, int planes, int h, int w,
                      int r, int include_self, void* stream) {
  return launch<false>(mask, out, planes, h, w, r, include_self, 0.0f,
                       decay_consts(0, 1, 0, 1, 0), 0.0f, stream);
}

// Fused: (planes, h, w) float32 SAE -> decay -> v > v_tw -> support count.
int stcf_support_fused(const float* sae, int* out, int planes, int h, int w,
                       int r, int include_self, float t_now, float a1,
                       float tau1, float a2, float tau2, float b, float v_tw,
                       void* stream) {
  return launch<true>(sae, out, planes, h, w, r, include_self, t_now,
                      decay_consts(a1, tau1, a2, tau2, b), v_tw, stream);
}

}  // extern "C"
