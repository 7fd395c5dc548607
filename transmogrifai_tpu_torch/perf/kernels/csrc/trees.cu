// Tree-growth kernels for Hopper (sm_90a): the level histogram (K1), the
// split scan (K2) and the lane routing select (K3).
//
// K1 replaces the Pallas kernel transmogrifai_tpu/perf/kernels/histogram.py
// `hist_level_pallas` (:80), K2 `splitscan.py::split_scan_pallas` (:116), K3
// `routing.py::row_select_lanes_pallas` (:86).  Each computes what the TPU
// kernel computes; the plain PyTorch versions in histogram.py, splitscan.py
// and routing.py are the XLA formulas the tests hold them to.
//
// K1 does not carry the TPU's one-hot GEMM over: that was a workaround for
// slow scatters.  It is a shared-memory histogram, feature-parallel: a CTA
// owns (a group of lanes, a range of nodes, 32*W features, a slice of rows),
// thread t owns feature f0+t and walks the slice's rows in order, adding each
// row's grad/hess channels into its own accumulator column
// acc[lane][node][channel][bin][t].  No two threads touch one accumulator, so
// there are no atomics and, with the feature index innermost, a warp's 32
// stores always fall in 32 distinct banks.  The order of additions is fixed
// (rows ascending within a slice, slices ascending in the merge), so the
// float path gives the same bits on every run.  Row slices merge with integer
// atomics on the exact int8/int32 path (order-free) and through per-slice
// partials summed in slice order on the float path.
//
// K2 is one CTA per (lane, node): every thread scores candidates
// f*(n_bins-1)+b with the XGBoost gain, the CTA takes the argmax with the
// lowest index winning ties (as argmax does).  Its arithmetic uses the
// round-to-nearest intrinsics, which nvcc never contracts into FMA, in the
// reference's order of operations, so on integer-valued histograms it is
// bitwise equal to split_scan_xla.
//
// K3 is one thread per (lane, row): out = binned[i, idx] or 0 when idx lies
// outside [0, d) — the reference's compare-reduce semantics.
//
// Plain C interface (loaded with ctypes): pointers and the stream as void*,
// sizes as int; each entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns the cudaError_t of its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;
// rows staged per pass of a histogram CTA (lane node ids and gh channels)
constexpr int kStageRows = 128;
// rows whose bin codes a thread loads before it accumulates them
constexpr int kUnroll = 4;

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

// ---------------------------------------------------------------------------
// K1: level histogram
// ---------------------------------------------------------------------------

// merge modes of a CTA's finished accumulators
constexpr int kWriteDirect = 0;   // one row slice: store into out
constexpr int kAtomicAdd = 1;     // int path, several slices: atomicAdd into out
constexpr int kWritePartial = 2;  // float path, several slices: store the slice

template <typename GhT, typename AccT>
__global__ void hist_level_kernel(const int* __restrict__ local,
                                  const GhT* __restrict__ gh,
                                  const int* __restrict__ binned,
                                  AccT* __restrict__ out,
                                  int merge, int L, int n, int d, int nn,
                                  int two_k, int B, int G, int NT,
                                  int lane_groups, int node_tiles,
                                  int feat_tiles, int rows_per_slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int FT = blockDim.x;
  long long bid = blockIdx.x;
  const int lg = (int)(bid % lane_groups); bid /= lane_groups;
  const int ft = (int)(bid % feat_tiles); bid /= feat_tiles;
  const int nt = (int)(bid % node_tiles); bid /= node_tiles;
  const int slice = (int)bid;
  const int l0 = lg * G, n0 = nt * NT, f0 = ft * FT;
  const int g_cnt = min(G, L - l0);
  const int nt_cnt = min(NT, nn - n0);
  const int r0 = slice * rows_per_slice;
  const int r1 = min(n, r0 + rows_per_slice);

  AccT* acc = reinterpret_cast<AccT*>(smem_raw);          // [G][NT][2K][B][FT]
  const long long acc_elems = (long long)G * NT * two_k * B * FT;
  int* s_node = reinterpret_cast<int*>(acc + acc_elems);   // [G][R]
  AccT* s_gh = reinterpret_cast<AccT*>(s_node + G * kStageRows);  // [G][2K][R]

  for (long long i = threadIdx.x; i < acc_elems; i += FT) acc[i] = AccT(0);

  const int f = f0 + threadIdx.x;
  const bool f_ok = f < d;
  for (int rt = r0; rt < r1; rt += kStageRows) {
    const int rows = min(kStageRows, r1 - rt);
    // stage: the node (relative to this CTA's node range, -1 when the row
    // adds nothing here) and the gh channels of every (lane, row)
    for (int e = threadIdx.x; e < G * kStageRows; e += FT) {
      const int g = e / kStageRows, r = e - g * kStageRows;
      int nd = -1;
      if (g < g_cnt && r < rows) {
        const long long l = l0 + g;
        const long long row = rt + r;
        bool any = false;
        for (int c = 0; c < two_k; ++c) {
          const AccT v = (AccT)gh[(l * two_k + c) * n + row];
          s_gh[(g * two_k + c) * kStageRows + r] = v;
          any |= (v != AccT(0));
        }
        const int v = local[l * n + row] - n0;
        if (any && v >= 0 && v < nt_cnt) nd = v;
      }
      s_node[e] = nd;
    }
    __syncthreads();
    for (int rb = 0; rb < rows; rb += kUnroll) {
      int code[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rb + u;
        bool live = false;
        if (r < rows)
          for (int g = 0; g < g_cnt; ++g) live |= s_node[g * kStageRows + r] >= 0;
        code[u] = (live && f_ok) ? __ldg(binned + (long long)(rt + r) * d + f) : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rb + u;
        if ((unsigned)code[u] >= (unsigned)B) continue;
        for (int g = 0; g < g_cnt; ++g) {
          const int nd = s_node[g * kStageRows + r];
          if (nd < 0) continue;
          for (int c = 0; c < two_k; ++c) {
            AccT* a = acc + ((((long long)g * NT + nd) * two_k + c) * B + code[u]) * FT
                      + threadIdx.x;
            *a = *a + s_gh[(g * two_k + c) * kStageRows + r];
          }
        }
      }
    }
    __syncthreads();
  }

  if (!f_ok) return;
  const long long width = (long long)B * d;
  const long long slice_off = (merge == kWritePartial)
      ? (long long)slice * L * nn * two_k * width : 0;
  for (int g = 0; g < g_cnt; ++g)
    for (int nd = 0; nd < nt_cnt; ++nd)
      for (int c = 0; c < two_k; ++c) {
        const long long m = ((long long)(l0 + g) * nn + n0 + nd) * two_k + c;
        const AccT* a = acc + (((long long)g * NT + nd) * two_k + c) * B * FT + threadIdx.x;
        AccT* o = out + slice_off + m * width + f;
        for (int b = 0; b < B; ++b) {
          const AccT v = a[(long long)b * FT];
          if constexpr (sizeof(GhT) == 1) {
            if (merge == kAtomicAdd) {
              if (v != 0) atomicAdd(o + (long long)b * d, v);
              continue;
            }
          }
          o[(long long)b * d] = v;
        }
      }
}

// float path, several slices: out[i] = sum of partial[s][i], s ascending
__global__ void sum_slices_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, long long total,
                                  int slices) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    float s = partial[i];
    for (int k = 1; k < slices; ++k) s = __fadd_rn(s, partial[(long long)k * total + i]);
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// K2: split scan
// ---------------------------------------------------------------------------

// jnp.sign(g) * jnp.maximum(jnp.abs(g) - alpha, 0.0)
__device__ __forceinline__ float soft_threshold(float g, float alpha) {
  const float sg = isnan(g) ? g : (g > 0.0f ? 1.0f : (g < 0.0f ? -1.0f : 0.0f));
  const float m = __fsub_rn(fabsf(g), alpha);
  const float mx = isnan(m) ? m : (m > 0.0f ? m : 0.0f);
  return __fmul_rn(sg, mx);
}

// st(g)^2 / (h + lambda + eps), evaluated left to right as the reference does
__device__ __forceinline__ float gain_part(float g, float h, float lam,
                                           float alpha) {
  const float s = soft_threshold(g, alpha);
  return __fdiv_rn(__fmul_rn(s, s), __fadd_rn(__fadd_rn(h, lam), 1e-12f));
}

// jnp.maximum: NaN if either side is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  if (isnan(a) || isnan(b)) return nanf("");
  return a > b ? a : b;
}

// argmax order: NaN beats everything (first NaN wins), then larger, then the
// lower flat index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (isnan(bv)) return isnan(v) && i < bi;
  if (isnan(v)) return true;
  if (v > bv) return true;
  return v == bv && i < bi;
}

struct Cand {
  float gain, ml, mr;
  int idx;
};

// gain_mr / gain_ml of candidate (f, b) of one (lane, node):
// _gain_terms (splitscan.py:47) with left sums gl/hl (missing right) and
// gl+g_miss/hl+h_miss (missing left), summed over the K classes
__device__ void score_candidate(const float* __restrict__ hg,
                                const float* __restrict__ hh,
                                const float* __restrict__ Gt,
                                const float* __restrict__ Ht, int K, int d,
                                int B, int n_bins, int f, int b, float lam,
                                float alpha, float gamma, float mcw,
                                float* mr_out, float* ml_out) {
  float raw_r = 0.0f, raw_l = 0.0f;
  float hl_r = 0.0f, hr_r = 0.0f, hl_l = 0.0f, hr_l = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float* pg = hg + ((long long)k * d + f) * B;
    const float* ph = hh + ((long long)k * d + f) * B;
    // cumsum over bins 0..b, in bin order
    float gl = pg[0], hl = ph[0];
    for (int j = 1; j <= b; ++j) {
      gl = __fadd_rn(gl, pg[j]);
      hl = __fadd_rn(hl, ph[j]);
    }
    const float G = Gt[k], H = Ht[k];
    const float gm = pg[n_bins], hm = ph[n_bins];
    const float gl2 = __fadd_rn(gl, gm), hl2 = __fadd_rn(hl, hm);
    const float gr = __fsub_rn(G, gl), hr = __fsub_rn(H, hl);
    const float gr2 = __fsub_rn(G, gl2), hr2 = __fsub_rn(H, hl2);
    const float tot = gain_part(G, H, lam, alpha);
    const float tr = __fsub_rn(__fadd_rn(gain_part(gl, hl, lam, alpha),
                                         gain_part(gr, hr, lam, alpha)), tot);
    const float tl = __fsub_rn(__fadd_rn(gain_part(gl2, hl2, lam, alpha),
                                         gain_part(gr2, hr2, lam, alpha)), tot);
    if (k == 0) {
      raw_r = tr; raw_l = tl; hl_r = hl; hr_r = hr; hl_l = hl2; hr_l = hr2;
    } else {
      raw_r = __fadd_rn(raw_r, tr); raw_l = __fadd_rn(raw_l, tl);
      hl_r = __fadd_rn(hl_r, hl); hr_r = __fadd_rn(hr_r, hr);
      hl_l = __fadd_rn(hl_l, hl2); hr_l = __fadd_rn(hr_l, hr2);
    }
  }
  const float kf = (float)K;
  const bool ok_r = __fdiv_rn(hl_r, kf) >= mcw && __fdiv_rn(hr_r, kf) >= mcw;
  const bool ok_l = __fdiv_rn(hl_l, kf) >= mcw && __fdiv_rn(hr_l, kf) >= mcw;
  *mr_out = ok_r ? __fsub_rn(__fmul_rn(0.5f, raw_r), gamma) : -INFINITY;
  *ml_out = ok_l ? __fsub_rn(__fmul_rn(0.5f, raw_l), gamma) : -INFINITY;
}

__global__ void split_scan_kernel(const float* __restrict__ hist_g,
                                  const float* __restrict__ hist_h,
                                  const float* __restrict__ G,
                                  const float* __restrict__ H,
                                  const float* __restrict__ mask, int nn,
                                  int K, int d, int n_bins, float lam,
                                  float alpha, float gamma, float mcw,
                                  int* __restrict__ best_out,
                                  float* __restrict__ gain_out,
                                  unsigned char* __restrict__ bml_out) {
  __shared__ Cand s_best[kThreads];
  const int ln = blockIdx.x;           // lane * nn + node
  const int l = ln / nn;
  const int B = n_bins + 1;
  const int per_f = n_bins - 1;
  const int F = d * per_f;
  const long long off = (long long)ln * K * d * B;
  const float* hg = hist_g + off;
  const float* hh = hist_h + off;
  const float* Gt = G + (long long)ln * K;
  const float* Ht = H + (long long)ln * K;
  Cand best{-INFINITY, -INFINITY, -INFINITY, 0x7fffffff};
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const int f = i / per_f, b = i - f * per_f;
    float mr, ml;
    score_candidate(hg, hh, Gt, Ht, K, d, B, n_bins, f, b, lam, alpha, gamma,
                    mcw, &mr, &ml);
    float g = max_nan(mr, ml);
    if (!(mask[(long long)l * d + f] > 0.0f)) g = -INFINITY;
    if (better(g, i, best.gain, best.idx)) best = Cand{g, ml, mr, i};
  }
  s_best[threadIdx.x] = best;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const Cand o = s_best[threadIdx.x + s];
      const Cand m = s_best[threadIdx.x];
      if (better(o.gain, o.idx, m.gain, m.idx)) s_best[threadIdx.x] = o;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    Cand b = s_best[0];
    if (b.idx == 0x7fffffff) {  // F == 0 cannot happen (n_bins >= 2)
      b.idx = 0;
    }
    best_out[ln] = b.idx;
    gain_out[ln] = b.gain;
    bml_out[ln] = (b.ml >= b.mr) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K3: routing select
// ---------------------------------------------------------------------------

__global__ void row_select_lanes_kernel(const int* __restrict__ binned,
                                        const int* __restrict__ idx,
                                        int* __restrict__ out, long long total,
                                        int n, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long i = t % n;
    const int j = __ldg(idx + t);
    out[t] = (j >= 0 && j < d) ? __ldg(binned + i * d + j) : 0;
  }
}

template <typename GhT, typename AccT>
int launch_hist(const void* local, const void* gh, const void* binned,
                void* out, void* partial, int L, int n, int d, int nn,
                int two_k, int n_bins, int G, int NT, int warps, int slices,
                cudaStream_t stream) {
  const int B = n_bins + 1;
  const int FT = 32 * warps;
  const int lane_groups = (L + G - 1) / G;
  const int node_tiles = (nn + NT - 1) / NT;
  const int feat_tiles = (d + FT - 1) / FT;
  const int rows_per_slice = (n + slices - 1) / slices;
  const long long total = (long long)L * nn * two_k * B * d;
  const size_t smem = (size_t)G * NT * two_k * B * FT * sizeof(AccT)
      + (size_t)G * kStageRows * (sizeof(int) + two_k * sizeof(AccT));
  const long long grid = (long long)lane_groups * node_tiles * feat_tiles * slices;
  int merge = kWriteDirect;
  AccT* dst = (AccT*)out;
  if (slices > 1) {
    if (sizeof(GhT) == 1) {
      merge = kAtomicAdd;
      cudaError_t e = cudaMemsetAsync(out, 0, total * sizeof(AccT), stream);
      if (e != cudaSuccess) return (int)e;
    } else {
      merge = kWritePartial;
      dst = (AccT*)partial;
    }
  }
  auto kern = hist_level_kernel<GhT, AccT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)grid, FT, smem, stream>>>(
      (const int*)local, (const GhT*)gh, (const int*)binned, dst, merge, L, n,
      d, nn, two_k, B, G, NT, lane_groups, node_tiles, feat_tiles,
      rows_per_slice);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (merge == kWritePartial) {
    sum_slices_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        (const float*)partial, (float*)out, total, slices);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace

extern "C" int tmog_hist_level(const void* local, const void* gh,
                               const void* binned, void* out, void* partial,
                               int L, int n, int d, int nn, int two_k,
                               int n_bins, int int_exact, int lanes_per_cta,
                               int nodes_per_cta, int warps, int slices,
                               void* stream) {
  if ((long long)L * nn * two_k * d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) {
    const long long total = (long long)L * nn * two_k * (n_bins + 1) * d;
    return (int)cudaMemsetAsync(out, 0, total * 4, s);
  }
  if (int_exact)
    return launch_hist<int8_t, int>(local, gh, binned, out, partial, L, n, d,
                                    nn, two_k, n_bins, lanes_per_cta,
                                    nodes_per_cta, warps, slices, s);
  return launch_hist<float, float>(local, gh, binned, out, partial, L, n, d,
                                   nn, two_k, n_bins, lanes_per_cta,
                                   nodes_per_cta, warps, slices, s);
}

extern "C" int tmog_split_scan(const void* hist_g, const void* hist_h,
                               const void* G, const void* H, const void* mask,
                               int L, int nn, int K, int d, int n_bins,
                               float reg_lambda, float alpha, float gamma,
                               float min_child_weight, void* best, void* gain,
                               void* bml, void* stream) {
  if (L <= 0 || nn <= 0) return 0;
  split_scan_kernel<<<(unsigned)(L * nn), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)hist_g, (const float*)hist_h, (const float*)G,
      (const float*)H, (const float*)mask, nn, K, d, n_bins, reg_lambda, alpha,
      gamma, min_child_weight, (int*)best, (float*)gain, (unsigned char*)bml);
  return (int)cudaGetLastError();
}

extern "C" int tmog_row_select_lanes(const void* binned, const void* idx,
                                     void* out, int n, int d, int L,
                                     void* stream) {
  const long long total = (long long)L * n;
  if (total <= 0) return 0;
  row_select_lanes_kernel<<<blocks_for(total), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int*)binned, (const int*)idx, (int*)out, total, n, d);
  return (int)cudaGetLastError();
}
