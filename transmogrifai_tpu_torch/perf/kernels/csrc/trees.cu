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
// slow scatters.  It is a shared-memory histogram with two kernels, one per
// path, both over the same tiling: a CTA holds the accumulators of a group of
// lanes x a tile of nodes x a tile of features, acc[lane][node][ch][bin][f]
// with the feature innermost, and walks one slice of the rows.
//
// hist_int8_kernel (RandomForest classification: int8 grad/hess, int32 sums,
// exact in any order).  The level is bound by fetching each live row's codes
// and by the adds, not by the 1.5 GB the function must move, so the design
// fetches a row's codes only where they add something and keeps many fetches
// in flight.  Up to 32 warps share one accumulator set through shared-memory
// atomicAdd on int (ATOMS.ADD).  A warp reads the node ids and grad/hess of 32
// rows (coalesced), drops rows whose node is outside the CTA's tile or whose
// grad/hess are all 0, compacts the rest with a ballot, then fetches the codes
// of several live rows at once (FT features, one coalesced run each) and adds
// them: the 32 threads of the warp take 32 consecutive features of one row,
// so one atomic instruction hits 32 distinct banks.  A CTA that covers every
// row stores its accumulators; row slices merge with global atomicAdd after a
// memset.  The sums cannot overflow: |grad/hess| <= 127 and a cell sums at
// most n rows, and the wrapper refuses n > (2^31 - 1) / 127.
//
// hist_f32_kernel (GBT, forest regression: float32; its bits must not depend
// on scheduling).  No float atomics: each thread owns one (lane, node,
// feature) accumulator column and adds its slice's rows in row order, and the
// slices are summed in slice order (sum_slices_kernel), so two launches give
// the same bits.  Where every lane x node of the level fits one CTA (GBT: 3
// lanes x <= 2 nodes), each row's codes are read once per level and feature
// tile, not once per lane.  Blocks of rows (their codes, node ids and
// grad/hess) are staged into shared memory with cp.async, double-buffered,
// so the adds read shared memory only.  The level is bound by the adds'
// instructions, not by bytes, so each warp — one (lane, node, 32 features) —
// picks with a ballot the block's rows in its node whose grad/hess are not 0
// (adding 0.0 leaves a cell's bits as they are), and updates the cells of
// four rows at once (a cell two of them hit is merged in registers in row
// order); the channel loop is unrolled where there are two (one class).
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
// most threads of an int8 histogram CTA (the plan picks fewer where it fits)
constexpr int kHistMaxThreads = 1024;
// most threads of a float histogram CTA (histogram.py F32_MAX_THREADS): the
// bound leaves its threads up to 128 registers for the batched adds
constexpr int kF32MaxThreads = 512;
// live rows whose codes a warp of the int8 kernel fetches before adding them
constexpr int kRowsInFlight = 4;
// node id of a row that adds nothing in a CTA (int8 kernel's row stage)
constexpr unsigned char kDead = 0xFF;
// rows of its node whose cells a warp of the float kernel updates at once
constexpr int kBatch = 4;

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

// ---------------------------------------------------------------------------
// K1: level histogram
// ---------------------------------------------------------------------------

// The CTA's tile: lanes [l0, l0+g_cnt), nodes [n0, n0+nt_cnt), features
// [f0, f0+FT), rows [r0, r1).  blockIdx runs over lane groups fastest, so the
// CTAs resident together walk the same rows and share their codes in L2.
struct Tile {
  int l0, g_cnt, n0, nt_cnt, f0, r0, r1, slice;
};

__device__ __forceinline__ Tile tile_of(int L, int n, int nn, int G, int NT,
                                        int FT, int lane_groups,
                                        int node_tiles, int feat_tiles,
                                        int rows_per_slice) {
  long long bid = blockIdx.x;
  Tile t;
  const int lg = (int)(bid % lane_groups); bid /= lane_groups;
  const int nt = (int)(bid % node_tiles); bid /= node_tiles;
  const int ft = (int)(bid % feat_tiles); bid /= feat_tiles;
  t.slice = (int)bid;
  t.l0 = lg * G;
  t.g_cnt = min(G, L - t.l0);
  t.n0 = nt * NT;
  t.nt_cnt = min(NT, nn - t.n0);
  t.f0 = ft * FT;
  const long long r0 = (long long)t.slice * rows_per_slice;
  t.r0 = (int)min(r0, (long long)n);
  t.r1 = (int)min((long long)n, r0 + rows_per_slice);
  return t;
}

__global__ void __launch_bounds__(kHistMaxThreads, 1)
hist_int8_kernel(const int* __restrict__ local, const int8_t* __restrict__ gh,
                 const int* __restrict__ binned, int* __restrict__ out,
                 int atomic_merge, int L, int n, int d, int nn, int two_k,
                 int B, int G, int NT, int FT, int lane_groups, int node_tiles,
                 int feat_tiles, int rows_per_slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = tile_of(L, n, nn, G, NT, FT, lane_groups, node_tiles,
                         feat_tiles, rows_per_slice);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int FW = FT >> 5;                        // features per thread, <= 4
  const int unit = two_k * B * FT;               // words of one (lane, node)
  const int acc_elems = G * NT * unit;
  int* acc = reinterpret_cast<int*>(smem_raw);   // [G][NT][2K][B][FT]
  // each warp's row stage: node in the tile (kDead: adds nothing) and the
  // grad/hess channels of its 32 rows, per lane of the group
  unsigned char* my_node = reinterpret_cast<unsigned char*>(acc + acc_elems)
                           + warp * G * 32;     // [G][32]
  int8_t* my_gh = reinterpret_cast<int8_t*>(
      reinterpret_cast<unsigned char*>(acc + acc_elems) + warps * G * 32)
      + warp * G * two_k * 32;                   // [G][2K][32]

  for (int i = threadIdx.x; i < acc_elems; i += blockDim.x) acc[i] = 0;
  __syncthreads();

  for (int rt = t.r0 + warp * 32; rt < t.r1; rt += warps * 32) {
    const int r = rt + lane;
    bool live = false;
    for (int g = 0; g < t.g_cnt; ++g) {
      const long long l = t.l0 + g;
      int nd = -1;
      bool any = false;
      if (r < t.r1) {
        nd = __ldg(local + l * n + r) - t.n0;
        for (int c = 0; c < two_k; ++c) {
          const int8_t v = __ldg(gh + (l * two_k + c) * n + r);
          my_gh[(g * two_k + c) * 32 + lane] = v;
          any |= v != 0;
        }
      }
      const bool ok = any && nd >= 0 && nd < t.nt_cnt;
      my_node[g * 32 + lane] = ok ? (unsigned char)nd : kDead;
      live |= ok;
    }
    unsigned mask = __ballot_sync(0xffffffffu, live);
    __syncwarp();
    while (mask) {                               // warp-uniform
      int row[kRowsInFlight];
      int code[kRowsInFlight][4];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        row[u] = -1;
        if (mask) {
          row[u] = __ffs(mask) - 1;
          mask &= mask - 1;
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = t.f0 + lane + 32 * j;
          code[u][j] = (row[u] >= 0 && j < FW && f < d)
              ? __ldg(binned + (long long)(rt + row[u]) * d + f) : -1;
        }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        if (row[u] < 0) break;
        for (int g = 0; g < t.g_cnt; ++g) {
          const int nd = my_node[g * 32 + row[u]];
          if (nd == kDead) continue;
          int* a = acc + (g * NT + nd) * unit + lane;
          for (int c = 0; c < two_k; ++c) {
            const int v = my_gh[(g * two_k + c) * 32 + row[u]];
            if (v == 0) continue;
            int* ac = a + c * B * FT;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if ((unsigned)code[u][j] < (unsigned)B)
                atomicAdd(ac + code[u][j] * FT + 32 * j, v);
          }
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  const long long width = (long long)B * d;
  for (int i = threadIdx.x; i < acc_elems; i += blockDim.x) {
    const int fl = i % FT;
    int rest = i / FT;
    const int b = rest % B; rest /= B;
    const int c = rest % two_k; rest /= two_k;
    const int nd = rest % NT;
    const int g = rest / NT;
    const int f = t.f0 + fl;
    if (g >= t.g_cnt || nd >= t.nt_cnt || f >= d) continue;
    const long long m = ((long long)(t.l0 + g) * nn + t.n0 + nd) * two_k + c;
    int* o = out + m * width + (long long)b * d + f;
    const int v = acc[i];
    if (atomic_merge) {
      if (v != 0) atomicAdd(o, v);
    } else {
      *o = v;
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage R rows from rt of the float kernel's tile into one buffer: the codes
// of the tile's features [rows][FT], the node ids [G][rows] and grad/hess
// [G][2K][rows].  Every thread of the CTA issues its share of the copies.
__device__ __forceinline__ void stage_rows(
    const int* __restrict__ local, const float* __restrict__ gh,
    const int* __restrict__ binned, const Tile& t, int rt, int rows, int n,
    int d, int two_k, int FT, int R, int vec4, int* s_codes, int* s_local,
    float* s_gh) {
  const int seg = min(FT, d - t.f0);             // features the tile holds
  if (vec4) {
    const int q = seg >> 2;
    for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
      const int rr = e / q, k = e - rr * q;
      cp_async16(s_codes + rr * FT + 4 * k,
                 binned + (long long)(rt + rr) * d + t.f0 + 4 * k);
    }
  } else {
    for (int e = threadIdx.x; e < rows * seg; e += blockDim.x) {
      const int rr = e / seg, k = e - rr * seg;
      cp_async4(s_codes + rr * FT + k, binned + (long long)(rt + rr) * d + t.f0 + k);
    }
  }
  for (int e = threadIdx.x; e < t.g_cnt * rows; e += blockDim.x) {
    const int g = e / rows, rr = e - g * rows;
    cp_async4(s_local + g * R + rr, local + (long long)(t.l0 + g) * n + rt + rr);
  }
  for (int e = threadIdx.x; e < t.g_cnt * two_k * rows; e += blockDim.x) {
    const int gc = e / rows, rr = e - gc * rows;
    cp_async4(s_gh + gc * R + rr,
              gh + ((long long)t.l0 * two_k + gc) * n + rt + rr);
  }
}

// TK: the grad/hess channels when fixed at compile time (2: one class), else
// 0 and two_k at run time
template <int TK>
__global__ void __launch_bounds__(kF32MaxThreads, 1)
hist_f32_kernel(const int* __restrict__ local, const float* __restrict__ gh,
                const int* __restrict__ binned, float* __restrict__ dst,
                int partial, int L, int n, int d, int nn, int two_k_rt, int B,
                int G, int NT, int FT, int R, int lane_groups, int node_tiles,
                int feat_tiles, int rows_per_slice, int vec4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int two_k = TK ? TK : two_k_rt;
  const Tile t = tile_of(L, n, nn, G, NT, FT, lane_groups, node_tiles,
                         feat_tiles, rows_per_slice);
  const int acc_elems = G * NT * two_k * B * FT;
  float* acc = reinterpret_cast<float*>(smem_raw);           // [G*NT][2K][B][FT]
  int* s_codes = reinterpret_cast<int*>(acc + acc_elems);     // [2][R][FT]
  int* s_local = s_codes + 2 * R * FT;                        // [2][G][R]
  float* s_gh = reinterpret_cast<float*>(s_local + 2 * G * R);  // [2][G][2K][R]

  for (int i = threadIdx.x; i < acc_elems; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  // this thread's column: warp w is unit w / (FT/32), i.e. (lane g, node nd),
  // and 32 of its features
  const int wpu = FT >> 5;
  const int w = threadIdx.x >> 5;
  const int u = w / wpu;
  const int g = u / NT, nd = u - (u / NT) * NT;
  const int fl = (w - u * wpu) * 32 + (threadIdx.x & 31);
  const bool unit_live = g < t.g_cnt && nd < t.nt_cnt;    // warp-uniform
  const bool f_ok = t.f0 + fl < d;
  const int node = t.n0 + nd;
  float* a = acc + u * two_k * B * FT + fl;

  const int nblocks = (t.r1 - t.r0 + R - 1) / R;
  if (nblocks > 0)
    stage_rows(local, gh, binned, t, t.r0, min(R, t.r1 - t.r0), n, d, two_k,
               FT, R, vec4, s_codes, s_local, s_gh);
  cp_async_commit();
  for (int blk = 0; blk < nblocks; ++blk) {
    if (blk + 1 < nblocks) {
      const int nx = (blk + 1) & 1;
      const int rt = t.r0 + (blk + 1) * R;
      stage_rows(local, gh, binned, t, rt, min(R, t.r1 - rt), n, d, two_k, FT,
                 R, vec4, s_codes + nx * R * FT, s_local + nx * G * R,
                 s_gh + nx * G * two_k * R);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int st = blk & 1;
    const int rows = min(R, t.r1 - (t.r0 + blk * R));
    if (unit_live) {
      const int* sc = s_codes + st * R * FT + fl;
      const int* sl = s_local + st * G * R + g * R;
      const float* sg = s_gh + st * G * two_k * R + g * two_k * R;
      const int lane = threadIdx.x & 31;
      // the block's rows in this warp's node with a grad/hess not 0 (R <=
      // 32), ascending.  Adding +-0.0 to a cell leaves its bits as they are
      // (a cell starts at +0.0 and so is never -0.0), so skipping such a row
      // gives the bits of adding it.
      bool live = lane < rows && sl[lane] == node;
      if (live) {
        bool any = false;
#pragma unroll
        for (int c = 0; c < two_k; ++c) any |= sg[c * R + lane] != 0.0f;
        live = any;
      }
      unsigned mask = __ballot_sync(0xffffffffu, live);
      while (mask) {
        // kBatch rows at once: their codes, grad/hess and cells are loaded
        // together; a padding slot or an out-of-range code adds 0.0 to bin 0
        int rr[kBatch], code[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          rr[q] = 0;
          ok[q] = mask != 0;
          if (mask) {
            rr[q] = __ffs(mask) - 1;
            mask &= mask - 1;
          }
          const int cd = sc[rr[q] * FT];
          ok[q] = ok[q] && f_ok && (unsigned)cd < (unsigned)B;
          code[q] = ok[q] ? cd : 0;
        }
        // in row order: a cell that an earlier row of the batch hit
        // continues from that row's sum, so the bits are those of adding the
        // rows one after another
        bool same[kBatch][kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
#pragma unroll
          for (int j = 0; j < q; ++j) same[q][j] = code[j] == code[q];
#pragma unroll
        for (int c = 0; c < two_k; ++c) {
          float* p = a + c * B * FT;
          // every slot's grad/hess is loaded (rr lies in the block) and then
          // selected, so no load waits behind a branch
          float x[kBatch], y[kBatch], v[kBatch];
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            x[q] = p[code[q] * FT];
            v[q] = sg[c * R + rr[q]];
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) {
            float s = x[q];
#pragma unroll
            for (int j = 0; j < q; ++j)
              if (same[q][j]) s = y[j];
            y[q] = __fadd_rn(s, ok[q] ? v[q] : 0.0f);
          }
#pragma unroll
          for (int q = 0; q < kBatch; ++q) p[code[q] * FT] = y[q];
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();

  if (!unit_live || !f_ok) return;
  const long long width = (long long)B * d;
  const long long total = (long long)L * nn * two_k * width;
  float* o = dst + (partial ? (long long)t.slice * total : 0)
             + ((long long)(t.l0 + g) * nn + node) * two_k * width + t.f0 + fl;
  for (int c = 0; c < two_k; ++c)
    for (int b = 0; b < B; ++b)
      o[c * width + (long long)b * d] = a[(c * B + b) * FT];
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

// One K1 launch: the tiling comes from histogram.py::plan (G lanes x NT nodes
// x FT features per CTA, `threads` threads, R staged rows for the float
// kernel, `slices` row slices of rows_per_slice rows).
struct HistPlan {
  int G, NT, FT, threads, R, slices, rows_per_slice;
};

int launch_hist_int8(const void* local, const void* gh, const void* binned,
                     void* out, int L, int n, int d, int nn, int two_k, int B,
                     const HistPlan& p, cudaStream_t stream) {
  const int lane_groups = (L + p.G - 1) / p.G;
  const int node_tiles = (nn + p.NT - 1) / p.NT;
  const int feat_tiles = (d + p.FT - 1) / p.FT;
  const long long grid = (long long)lane_groups * node_tiles * feat_tiles * p.slices;
  const size_t smem = (size_t)p.G * p.NT * two_k * B * p.FT * sizeof(int)
      + (size_t)(p.threads / 32) * p.G * 32 * (1 + two_k);
  const int atomic_merge = p.slices > 1;
  cudaError_t e;
  if (atomic_merge) {
    e = cudaMemsetAsync(out, 0, (size_t)L * nn * two_k * B * d * sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaFuncSetAttribute(hist_int8_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  hist_int8_kernel<<<(unsigned)grid, p.threads, smem, stream>>>(
      (const int*)local, (const int8_t*)gh, (const int*)binned, (int*)out,
      atomic_merge, L, n, d, nn, two_k, B, p.G, p.NT, p.FT, lane_groups,
      node_tiles, feat_tiles, p.rows_per_slice);
  return (int)cudaGetLastError();
}

int launch_hist_f32(const void* local, const void* gh, const void* binned,
                    void* out, void* partial, int L, int n, int d, int nn,
                    int two_k, int B, const HistPlan& p, cudaStream_t stream) {
  const int lane_groups = (L + p.G - 1) / p.G;
  const int node_tiles = (nn + p.NT - 1) / p.NT;
  const int feat_tiles = (d + p.FT - 1) / p.FT;
  const long long grid = (long long)lane_groups * node_tiles * feat_tiles * p.slices;
  const size_t smem = ((size_t)p.G * p.NT * two_k * B * p.FT
                       + 2 * ((size_t)p.R * p.FT + (size_t)p.G * p.R
                              + (size_t)p.G * two_k * p.R)) * 4;
  const long long total = (long long)L * nn * two_k * B * d;
  const int use_partial = p.slices > 1;
  // 16-byte copies of the codes where every row's run starts 16-byte aligned
  const int vec4 = (d % 4 == 0) && ((uintptr_t)binned % 16 == 0);
  auto kernel = two_k == 2 ? hist_f32_kernel<2> : hist_f32_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, p.threads, smem, stream>>>(
      (const int*)local, (const float*)gh, (const int*)binned,
      (float*)(use_partial ? partial : out), use_partial, L, n, d, nn, two_k,
      B, p.G, p.NT, p.FT, p.R, lane_groups, node_tiles, feat_tiles,
      p.rows_per_slice, vec4);
  e = cudaGetLastError();
  if (e != cudaSuccess || !use_partial) return (int)e;
  sum_slices_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
      (const float*)partial, (float*)out, total, p.slices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tmog_hist_level(const void* local, const void* gh,
                               const void* binned, void* out, void* partial,
                               int L, int n, int d, int nn, int two_k,
                               int n_bins, int int_exact, int lanes_per_cta,
                               int nodes_per_cta, int feats_per_cta,
                               int threads, int stage_rows, int slices,
                               int rows_per_slice, void* stream) {
  if ((long long)L * nn * two_k * d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int B = n_bins + 1;
  if (n <= 0) {
    const long long total = (long long)L * nn * two_k * B * d;
    return (int)cudaMemsetAsync(out, 0, total * 4, s);
  }
  const HistPlan p{lanes_per_cta, nodes_per_cta, feats_per_cta, threads,
                   stage_rows, slices, rows_per_slice};
  if (int_exact)
    return launch_hist_int8(local, gh, binned, out, L, n, d, nn, two_k, B, p, s);
  return launch_hist_f32(local, gh, binned, out, partial, L, n, d, nn, two_k,
                         B, p, s);
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
