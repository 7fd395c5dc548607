// Serving-prefix encode kernels for Hopper (sm_90a): level-code one-hot (K4)
// and right-inclusive bucketize one-hot (K5).
//
// K4 replaces the Pallas kernel transmogrifai_tpu/perf/kernels/encode.py
// `onehot_codes` (:76); K5 replaces `bucketize_right_encode` (:105).  Both
// compute exactly what the TPU kernels compute, with exact 0.0/1.0 stores, so
// the plain PyTorch versions in encode.py agree bit for bit.
//
// What bounds them on an H100: bytes.  K4 reads n int32 codes and writes
// n*width float32 (about 0 operations per byte); K5 reads n float32 values and
// S splits and writes n*width float32, with S compares per row.  At serving
// sizes (n = 1024 rows, width ~22) that is under 100 KB, a few hundredths of
// a microsecond at 3.35 TB/s, so each launch is bound by launch latency, not
// by the card: fusing the per-slot launches of a batch into one pass is the
// later gain, not a faster kernel body.
//
// Plain C interface (loaded with ctypes): pointers and the stream as void*,
// sizes as int; each entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// grid-stride loops: a few waves of blocks over the 132 SMs cover any size
constexpr long long kMaxBlocks = 132LL * 16;

// K4: one thread per output element of the flattened (n, width) block, so
// neighbouring threads store neighbouring floats (coalesced).  A code that is
// negative or >= width matches no column and leaves an all-zero row, which is
// jax.nn.one_hot's out-of-range rule (the untracked-null code -1).
__global__ void onehot_codes_kernel(const int* __restrict__ codes,
                                    float* __restrict__ out,
                                    long long total, int width) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / width;
    const int col = (int)(i - row * width);
    out[i] = (__ldg(codes + row) == col) ? 1.0f : 0.0f;
  }
}

// K5: the splits sit in shared memory; one thread per row.  The bucket index
// is count(splits < v0) - 1, clipped — the TPU kernel's compare-count
// (encode.py:136), equal to searchsorted(side="left") on sorted splits, ties
// and +-inf included — with v0 = nan_to_num(x) (NaN -> 0, +-inf -> +-FLT_MAX).
// The row then gets its one-hot (only when in range), the invalid column and
// the null column, in the order of encode.py:142-148.
__global__ void bucketize_right_kernel(const float* __restrict__ x,
                                       const float* __restrict__ splits,
                                       float* __restrict__ out, int n,
                                       int n_splits, int track_invalid,
                                       int track_nulls) {
  extern __shared__ float s[];
  for (int j = threadIdx.x; j < n_splits; j += blockDim.x) s[j] = splits[j];
  __syncthreads();
  const int n_buckets = n_splits - 1;
  const int width = n_buckets + track_invalid + track_nulls;
  const float lo = s[0];
  const float hi = s[n_splits - 1];
  const int stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    const float xv = x[row];
    const bool present = !isnan(xv);
    const bool finite = present && isfinite(xv);
    const float v0 = !present ? 0.0f : (finite ? xv : (xv > 0.0f ? FLT_MAX : -FLT_MAX));
    int lt = 0;
    for (int j = 0; j < n_splits; ++j) lt += (s[j] < v0) ? 1 : 0;
    const int idx = min(max(lt - 1, 0), n_buckets - 1);
    const bool in_range = finite && (xv > lo) && (xv <= hi);
    float* o = out + (long long)row * width;
    for (int j = 0; j < n_buckets; ++j) o[j] = (in_range && j == idx) ? 1.0f : 0.0f;
    int c = n_buckets;
    if (track_invalid) o[c++] = (present && !in_range) ? 1.0f : 0.0f;
    if (track_nulls) o[c] = present ? 0.0f : 1.0f;
  }
}

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int tmog_onehot_codes(const void* codes, void* out, int n, int width,
                                 void* stream) {
  const long long total = (long long)n * width;
  if (total <= 0) return 0;
  onehot_codes_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)codes, (float*)out, total, width);
  return (int)cudaGetLastError();
}

extern "C" int tmog_bucketize_right(const void* x, const void* splits, void* out,
                                    int n, int n_splits, int track_invalid,
                                    int track_nulls, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)n_splits * sizeof(float);
  bucketize_right_kernel<<<blocks_for(n), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)splits, (float*)out, n, n_splits,
      track_invalid, track_nulls);
  return (int)cudaGetLastError();
}
