// Serving-prefix encode kernel for Hopper (sm_90a): every one-hot slot (K4)
// and every bucketize slot (K5) of a serving batch in one launch, driven by a
// slot table.
//
// It replaces the Pallas kernels of transmogrifai_tpu/perf/kernels/encode.py,
// `onehot_codes` (:76) and `bucketize_right_encode` (:105), and computes
// exactly what they compute, with exact 0.0/1.0 stores, so the plain PyTorch
// versions in encode.py agree bit for bit:
//   K4: column `code` of the slot is 1 when 0 <= code < width; a negative or
//       out-of-range code gives a zero row (jax.nn.one_hot's rule);
//   K5: v0 = nan_to_num(x) (NaN -> 0, +-inf -> +-FLT_MAX); the bucket is
//       count(splits < v0) - 1 clipped to [0, S-2] — the TPU kernel's
//       compare-count (encode.py:136), equal to searchsorted(side="left") on
//       sorted splits, ties and +-inf included; the bucket's column is 1 only
//       when x is finite and s[0] < x <= s[S-1]; then the invalid column
//       (present and out of range) and the null column (NaN), in the order
//       of encode.py:140-148;
//   left-closed bucketize (kLeftClosed; NumericBucketizer, which the
//       reference computes in plain XLA, ops/scalers.py:115-138): v0 as
//       above; the bucket is count(splits <= v0) - 1 clipped to [0, S-2],
//       equal to searchsorted(side="right") - 1; in_range = present and
//       s[0] <= x <= s[S-1], compared on x (so +inf is in range when
//       s[S-1] is +inf); the bucket's column is 1 when in_range, or for any
//       present value without track_invalid (out of range clamps to the edge
//       bucket, and +-inf counts as present); then the invalid column
//       (present and out of range) and the null column (NaN).
// In both, a row of a slot has at most one column set (its "hot" column), so
// the kernel builds each piece of output in shared memory (zeros, then the
// hot columns) and stores it: every output element is written exactly once,
// with no memset of the output, no atomics and nothing that depends on
// scheduling.
//
// What bounds it on an H100: bytes.  The serving fixture's batch (1024 rows,
// 32 one-hot slots of 22 columns, 8 bucketize slots of 3 or 5) reads 40 x
// 1024 inputs and writes 1024 x 730 floats, ~3.15 MB: ~0.94 us at 3.35 TB/s,
// under the few microseconds a launch costs.  Launched once per slot, each
// launch would move under 100 KB and take ~1000x its bound; only a whole
// batch's slots give one launch enough work to approach it, which is why
// the table holds them all.
//
// Design: the slot table travels by value as a __grid_constant__ kernel
// parameter (within the classic 4 KB limit: kMaxSlots entries; a longer
// table launches in chunks), so a batch needs no copy of it.  A launch
// stages its splits in shared memory when they number kMaxSplits or fewer,
// and counts each value's splits below it by a compare-count there.  A
// bucketize slot with more splits (a tree bucketizer of many bins) is
// planned into a launch of its own (encode.py::SlotTable), which reads its
// splits from global memory by a binary search over them: a few dependent
// loads a value, from L2 once the first rows have touched them.  The slots of a
// launch write adjacent columns of one output, and the work is cut into
// items of kTileRows rows by kWin columns of that span, so a 1024-row batch
// of the fixture's 730 columns is 32 x 6 items and fills the card.  A CTA
// copies the table and its splits into shared memory once, all threads at
// a time (a walk through the parameter table one dependent load after
// another cost more than the stores); it finds the slots an item's columns
// overlap with two warp ballots over that copy, zeroes a shared-memory
// tile, reads those slots' inputs (coalesced along rows), sets each row's
// hot column to 1, and copies the tile out a warp per row, neighbouring
// lanes on neighbouring columns, as 16-byte float4 stores where the
// window's base and the row stride are 16-byte aligned and scalar stores
// elsewhere.  No per-element search or division: a store costs a
// shared-memory load.  Row offsets are 64-bit.
//
// Plain C interface (loaded with ctypes): the slots' input pointers, the
// table as rows of 5 int64 fields, sizes as int64/int, the stream as void*;
// the entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;      // a row is a lane of the staging loops: i & 31
constexpr int kWin = 128;          // columns of a work item
constexpr int kTileBytes = kTileRows * kWin * 4;  // 16 KB of the 48 KB a CTA takes
constexpr int kMaxSlots = 64;      // encode.py::MAX_SLOTS
// splits a launch stages in shared memory (16 KB); more take the global path
constexpr int kMaxSplits = 4096;   // encode.py::MAX_SPLITS
constexpr int kFields = 5;         // int64 fields of a table row

enum : int { kBucketize = 1, kTrackInvalid = 2, kTrackNulls = 4, kLeftClosed = 8 };

struct Slot {
  const void* in;      // int32 codes (one-hot) or float32 values (bucketize)
  int col;             // the slot's first column in the output
  int width;           // the slot's columns
  int kind;            // kBucketize | kTrackInvalid | kTrackNulls | kLeftClosed,
                       // 0 = one-hot
  int split_off;       // the slot's first split in the launch's splits
  int n_splits;
  int pad;
};

struct SlotTable {
  float* out;          // column 0 of row 0 of the output
  long long stride;    // the output's row stride, in floats
  long long n_rows;
  int n_slots;
  int n_splits;
  int col0;            // the launch's first column: slot[0].col
  int col_end;         // one past its last: slot[n_slots - 1].col + width
  Slot slot[kMaxSlots];
};
static_assert(sizeof(SlotTable) <= 4096, "the slot table must fit 4 KB of parameters");
static_assert(kTileBytes + kMaxSplits * 4 + kMaxSlots * sizeof(Slot) <= 48 * 1024,
              "tile, splits and table fit the shared memory a CTA takes without opting in");

// count(s[j] < v0) over S splits (kLe: count(s[j] <= v0), the left-closed
// twin): a compare-count over a shared-memory copy, or a binary search
// (lower bound, kLe: upper bound) over sorted splits in global memory --
// equal on sorted splits, ties and +-inf included
template <bool kLe>
__device__ __forceinline__ bool below(float s, float v0) {
  return kLe ? (s <= v0) : (s < v0);
}

template <bool kGlobal, bool kLe>
__device__ __forceinline__ int count_below(const float* s, int S, float v0) {
  if constexpr (kGlobal) {
    int lo = 0, hi = S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (below<kLe>(__ldg(s + mid), v0)) lo = mid + 1; else hi = mid;
    }
    return lo;
  } else {
    int lt = 0;
    for (int j = 0; j < S; ++j) lt += below<kLe>(s[j], v0) ? 1 : 0;
    return lt;
  }
}

template <bool kGlobal>
__device__ __forceinline__ float split_at(const float* s, int j) {
  if constexpr (kGlobal) return __ldg(s + j); else return s[j];
}

template <bool kGlobal>
__device__ __forceinline__ int bucket_hot(float xv, const float* s, int S, int kind) {
  const bool present = !isnan(xv);
  const bool finite = present && isfinite(xv);
  const float v0 = !present ? 0.0f : (finite ? xv : (xv > 0.0f ? FLT_MAX : -FLT_MAX));
  const int nb = S - 1;
  const int ti = (kind & kTrackInvalid) ? 1 : 0;
  if (kind & kLeftClosed) {
    const int le = count_below<kGlobal, true>(s, S, v0);
    const bool in_range = present && xv >= split_at<kGlobal>(s, 0)
                          && xv <= split_at<kGlobal>(s, S - 1);
    if (in_range || (present && !ti)) return min(max(le - 1, 0), nb - 1);
    if (present) return nb;
    return (kind & kTrackNulls) ? nb + ti : -1;
  }
  const int lt = count_below<kGlobal, false>(s, S, v0);
  if (finite && xv > split_at<kGlobal>(s, 0) && xv <= split_at<kGlobal>(s, S - 1))
    return min(max(lt - 1, 0), nb - 1);
  if (present) return ti ? nb : -1;
  return (kind & kTrackNulls) ? nb + ti : -1;
}

// kGlobal: the launch's splits stay in global memory (more than kMaxSplits)
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
encode_slots_kernel(const __grid_constant__ SlotTable t,
                    const float* __restrict__ splits) {
  extern __shared__ float4 s_dyn[];
  float4* s_tile4 = s_dyn;                       // kTileRows x kWin floats
  float* s_tile = reinterpret_cast<float*>(s_dyn);
  float* s_splits = s_tile + kTileRows * kWin;
  __shared__ Slot s_slot[kMaxSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_slots = t.n_slots;
  const int n_win = (t.col_end - t.col0 + kWin - 1) / kWin;
  {
    const int* src = reinterpret_cast<const int*>(t.slot);
    int* dst = reinterpret_cast<int*>(s_slot);
    for (int j = threadIdx.x; j < n_slots * (int)(sizeof(Slot) / 4); j += blockDim.x)
      dst[j] = src[j];
  }
  if (!kGlobal)
    for (int j = threadIdx.x; j < t.n_splits; j += blockDim.x) s_splits[j] = splits[j];
  const long long n_tiles = (t.n_rows + kTileRows - 1) / kTileRows;
  for (long long item = blockIdx.x; item < n_tiles * n_win; item += gridDim.x) {
    const long long tile = item / n_win;
    const int w = (int)(item - tile * n_win);
    __syncthreads();  // table and splits staged; the last item copied out
    const int lo = t.col0 + w * kWin;            // the window's first column
    const int wl = min(kWin, t.col_end - lo);
    // the slots it overlaps, [ka, kb): columns rise with the slot, so count
    // the slots ending at or before lo and those starting before lo + wl
    int ka = 0, kb = 0;
    for (int base = 0; base < n_slots; base += 32) {
      const int k = base + lane;
      ka += __popc(__ballot_sync(
          0xffffffffu, k < n_slots && s_slot[k].col + s_slot[k].width <= lo));
      kb += __popc(__ballot_sync(0xffffffffu, k < n_slots && s_slot[k].col < lo + wl));
    }
    const long long row0 = tile * kTileRows;
    const int rows = (int)min((long long)kTileRows, t.n_rows - row0);
    for (int r = warp; r < rows; r += kWarps)
      for (int q = lane; q < ((wl + 3) >> 2); q += 32)
        s_tile4[r * (kWin / 4) + q] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    // each (slot, row)'s hot column, set where it falls in the window;
    // consecutive threads read consecutive rows of a slot
    for (int i = threadIdx.x; i < (kb - ka) * kTileRows; i += blockDim.x) {
      const int k = ka + (i >> 5), r = i & 31;
      if (r >= rows) continue;
      const Slot& sl = s_slot[k];
      const int v = __ldg((const int*)sl.in + row0 + r);
      const int h = (sl.kind & kBucketize)
          ? bucket_hot<kGlobal>(__int_as_float(v),
                                (kGlobal ? splits : s_splits) + sl.split_off,
                                sl.n_splits, sl.kind)
          : ((v >= 0 && v < sl.width) ? v : -1);
      const int c = sl.col + h - lo;
      if (h >= 0 && c >= 0 && c < wl) s_tile[r * kWin + c] = 1.0f;
    }
    __syncthreads();
    float* base = t.out + lo;
    const bool vec = (((uintptr_t)base) & 15) == 0 && (t.stride & 3) == 0;
    for (int r = warp; r < rows; r += kWarps) {
      float* dst = base + (row0 + r) * t.stride;
      const float* src = s_tile + r * kWin;
      int j = lane;
      if (vec) {
        for (int q = lane; q < (wl >> 2); q += 32)
          reinterpret_cast<float4*>(dst)[q] = s_tile4[r * (kWin / 4) + q];
        j = (wl & ~3) + lane;
      }
      for (; j < wl; j += 32) dst[j] = src[j];
    }
  }
}

}  // namespace

extern "C" int tmog_encode_slots(const long long* ins, const long long* rows,
                                 int n_slots, long long n_rows, void* out,
                                 long long stride, const void* splits, int n_splits,
                                 long long max_blocks, void* stream) {
  if (n_rows <= 0 || n_slots <= 0) return 0;
  if (n_slots > kMaxSlots || n_splits < 0 || max_blocks < 1 || max_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SlotTable t = {};
  t.out = (float*)out;
  t.stride = stride;
  t.n_rows = n_rows;
  t.n_slots = n_slots;
  t.n_splits = n_splits;
  for (int k = 0; k < n_slots; ++k) {
    const long long* f = rows + (long long)kFields * k;
    Slot& s = t.slot[k];
    s.in = (const void*)(uintptr_t)ins[k];
    s.col = (int)f[0];
    s.width = (int)f[1];
    s.kind = (int)f[2];
    s.split_off = (int)f[3];
    s.n_splits = (int)f[4];
  }
  t.col0 = t.slot[0].col;
  t.col_end = t.slot[n_slots - 1].col + t.slot[n_slots - 1].width;
  if (t.col_end <= t.col0) return (int)cudaErrorInvalidValue;
  const long long n_win = (t.col_end - t.col0 + kWin - 1) / kWin;
  const long long items = (n_rows + kTileRows - 1) / kTileRows * n_win;
  // the grid cap (encode.py::DEFAULT_GRID_CAP, or the autotuner's winner):
  // a few CTAs per SM; larger row counts loop over tiles
  const unsigned grid = (unsigned)(items < max_blocks ? items : max_blocks);
  if (n_splits > kMaxSplits) {
    encode_slots_kernel<true><<<grid, kThreads, kTileBytes, (cudaStream_t)stream>>>(
        t, (const float*)splits);
  } else {
    const size_t smem = (size_t)kTileBytes + (size_t)n_splits * sizeof(float);
    encode_slots_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        t, (const float*)splits);
  }
  return (int)cudaGetLastError();
}
