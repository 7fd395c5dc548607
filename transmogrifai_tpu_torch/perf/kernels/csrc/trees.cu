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
// Both kernels tile the grad/hess channels where one CTA cannot hold all of a
// (lane, node)'s (at 33 bins, 22 classes and more on the int8 path, 27 on the
// float one): a CTA then accumulates channels [c0, c0+CT) of its tile and
// reads its rows' node ids, grad/hess and codes once per channel tile.  A
// level whose channels fit one CTA keeps one channel tile (CT = 2K), and so
// the launch and the bits it had without the axis.
//
// K2 (split_scan_kernel<TK, STAGED>) gives one thread each (lane, node,
// feature).  The thread walks the bins in order, keeps the running left sums
// per class, and scores candidate f*(n_bins-1)+b with the XGBoost gain as it
// passes bin b: O(B) adds a feature, where scoring each candidate from
// scratch took O(B^2).  The running sum after bin b is the same chain of
// adds as the from-scratch one, and the arithmetic uses the round-to-nearest
// intrinsics (never contracted into FMA) in the reference's order, so the
// results are bitwise those of the reference's formula on integer-valued
// histograms and do not depend on the launch shape.  A CTA holds one or more
// (lane, node) blocks (splitscan.py::plan); each block's histograms are
// staged in shared memory with asynchronous copies, a feature tile at a time,
// at an odd row stride so the threads' reads of one bin hit 32 banks.  Each
// thread keeps its best candidate; warp shuffles and one step in shared
// memory reduce them by the argmax rule (NaN first, then larger, then the
// lower index), a total order, so the reduction's shape cannot change the
// winner.  The scan is bound by its instructions (four IEEE divisions a
// candidate), not by the histograms' bytes, so two shortcuts that keep every
// bit are taken where the inputs allow: alpha == 0 drops the soft threshold,
// and a feature whose missing bin is empty (no missing values) scores its
// missing-left direction as the missing-right one, which it equals.  On the
// GBT levels' few blocks, several threads share a feature's candidates.
//
// K3 (row_select_tile_kernel, row_select_direct_kernel) computes out[l, i] =
// binned[i, idx[l, i]], or 0 when idx lies outside [0, d) — the reference's
// compare-reduce semantics — by one of two kernels that routing.py::plan
// picks by the bytes each moves.  The tile kernel (many lanes: each row's
// codes serve them all) stages R rows of codes in shared memory once and
// serves every lane from them, so the table is read once, not once per lane.
// The direct kernel (few lanes) gives each row one thread that gathers its
// lanes' codes with their loads in flight together.
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

// The CTA's tile: lanes [l0, l0+g_cnt), grad/hess channels [c0, c0+ct_cnt),
// nodes [n0, n0+nt_cnt), features [f0, f0+FT), rows [r0, r1).  blockIdx runs
// over lane groups fastest, then channel tiles, so the CTAs resident together
// walk the same rows and share their codes in L2.  A level whose channels fit
// one CTA has one channel tile (CT = 2K).
struct Tile {
  int l0, g_cnt, c0, ct_cnt, n0, nt_cnt, f0, r0, r1, slice;
};

__device__ __forceinline__ Tile tile_of(int L, int n, int nn, int two_k,
                                        int G, int CT, int NT, int FT,
                                        int lane_groups, int chan_tiles,
                                        int node_tiles, int feat_tiles,
                                        int rows_per_slice) {
  long long bid = blockIdx.x;
  Tile t;
  const int lg = (int)(bid % lane_groups); bid /= lane_groups;
  const int ct = (int)(bid % chan_tiles); bid /= chan_tiles;
  const int nt = (int)(bid % node_tiles); bid /= node_tiles;
  const int ft = (int)(bid % feat_tiles); bid /= feat_tiles;
  t.slice = (int)bid;
  t.l0 = lg * G;
  t.g_cnt = min(G, L - t.l0);
  t.c0 = ct * CT;
  t.ct_cnt = min(CT, two_k - t.c0);
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
                 int B, int G, int CT, int NT, int FT, int lane_groups,
                 int chan_tiles, int node_tiles, int feat_tiles,
                 int rows_per_slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = tile_of(L, n, nn, two_k, G, CT, NT, FT, lane_groups,
                         chan_tiles, node_tiles, feat_tiles, rows_per_slice);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int FW = FT >> 5;                        // features per thread, <= 4
  const int unit = CT * B * FT;                  // words of one (lane, node)
  const int acc_elems = G * NT * unit;
  int* acc = reinterpret_cast<int*>(smem_raw);   // [G][NT][CT][B][FT]
  // each warp's row stage: node in the tile (kDead: adds nothing) and the
  // tile's grad/hess channels of its 32 rows, per lane of the group
  unsigned char* my_node = reinterpret_cast<unsigned char*>(acc + acc_elems)
                           + warp * G * 32;     // [G][32]
  int8_t* my_gh = reinterpret_cast<int8_t*>(
      reinterpret_cast<unsigned char*>(acc + acc_elems) + warps * G * 32)
      + warp * G * CT * 32;                      // [G][CT][32]

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
        for (int c = 0; c < t.ct_cnt; ++c) {
          const int8_t v = __ldg(gh + (l * two_k + t.c0 + c) * n + r);
          my_gh[(g * CT + c) * 32 + lane] = v;
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
          for (int c = 0; c < t.ct_cnt; ++c) {
            const int v = my_gh[(g * CT + c) * 32 + row[u]];
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
    const int c = rest % CT; rest /= CT;
    const int nd = rest % NT;
    const int g = rest / NT;
    const int f = t.f0 + fl;
    if (g >= t.g_cnt || c >= t.ct_cnt || nd >= t.nt_cnt || f >= d) continue;
    const long long m = ((long long)(t.l0 + g) * nn + t.n0 + nd) * two_k
                        + t.c0 + c;
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
// of the tile's features [rows][FT], the node ids [G][rows] and the tile's
// grad/hess channels [G][CT][rows].  Every thread of the CTA issues its share
// of the copies.
__device__ __forceinline__ void stage_rows(
    const int* __restrict__ local, const float* __restrict__ gh,
    const int* __restrict__ binned, const Tile& t, int rt, int rows, int n,
    int d, int two_k, int CT, int FT, int R, int vec4, int* s_codes,
    int* s_local, float* s_gh) {
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
  for (int e = threadIdx.x; e < t.g_cnt * t.ct_cnt * rows; e += blockDim.x) {
    const int gc = e / rows, rr = e - gc * rows;
    const int g = gc / t.ct_cnt, c = gc - g * t.ct_cnt;
    cp_async4(s_gh + (g * CT + c) * R + rr,
              gh + ((long long)(t.l0 + g) * two_k + t.c0 + c) * n + rt + rr);
  }
}

// TK: the channels of every channel tile when fixed at compile time (2: one
// class, one tile), else 0 and each tile's own count at run time
template <int TK>
__global__ void __launch_bounds__(kF32MaxThreads, 1)
hist_f32_kernel(const int* __restrict__ local, const float* __restrict__ gh,
                const int* __restrict__ binned, float* __restrict__ dst,
                int partial, int L, int n, int d, int nn, int two_k, int B,
                int G, int CT, int NT, int FT, int R, int lane_groups,
                int chan_tiles, int node_tiles, int feat_tiles,
                int rows_per_slice, int vec4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = tile_of(L, n, nn, two_k, G, CT, NT, FT, lane_groups,
                         chan_tiles, node_tiles, feat_tiles, rows_per_slice);
  const int tk = TK ? TK : t.ct_cnt;             // channels this CTA adds
  const int acc_elems = G * NT * CT * B * FT;
  float* acc = reinterpret_cast<float*>(smem_raw);           // [G*NT][CT][B][FT]
  int* s_codes = reinterpret_cast<int*>(acc + acc_elems);     // [2][R][FT]
  int* s_local = s_codes + 2 * R * FT;                        // [2][G][R]
  float* s_gh = reinterpret_cast<float*>(s_local + 2 * G * R);  // [2][G][CT][R]

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
  float* a = acc + u * CT * B * FT + fl;

  const int nblocks = (t.r1 - t.r0 + R - 1) / R;
  if (nblocks > 0)
    stage_rows(local, gh, binned, t, t.r0, min(R, t.r1 - t.r0), n, d, two_k,
               CT, FT, R, vec4, s_codes, s_local, s_gh);
  cp_async_commit();
  for (int blk = 0; blk < nblocks; ++blk) {
    if (blk + 1 < nblocks) {
      const int nx = (blk + 1) & 1;
      const int rt = t.r0 + (blk + 1) * R;
      stage_rows(local, gh, binned, t, rt, min(R, t.r1 - rt), n, d, two_k, CT,
                 FT, R, vec4, s_codes + nx * R * FT, s_local + nx * G * R,
                 s_gh + nx * G * CT * R);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int st = blk & 1;
    const int rows = min(R, t.r1 - (t.r0 + blk * R));
    if (unit_live) {
      const int* sc = s_codes + st * R * FT + fl;
      const int* sl = s_local + st * G * R + g * R;
      const float* sg = s_gh + st * G * CT * R + g * CT * R;
      const int lane = threadIdx.x & 31;
      // the block's rows in this warp's node with a grad/hess not 0 (R <=
      // 32), ascending.  Adding +-0.0 to a cell leaves its bits as they are
      // (a cell starts at +0.0 and so is never -0.0), so skipping such a row
      // gives the bits of adding it.
      bool live = lane < rows && sl[lane] == node;
      if (live) {
        bool any = false;
#pragma unroll
        for (int c = 0; c < tk; ++c) any |= sg[c * R + lane] != 0.0f;
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
        for (int c = 0; c < tk; ++c) {
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
             + (((long long)(t.l0 + g) * nn + node) * two_k + t.c0) * width
             + t.f0 + fl;
  for (int c = 0; c < tk; ++c)
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

// st(g)^2 / (h + lambda + eps), evaluated left to right as the reference does.
// A0 (alpha == 0): st(g)^2 is g*g bit for bit (st(-0) = +0 squares alike,
// and a NaN result is the canonical NaN either way), so the threshold's
// compares and selects are left out.
template <bool A0>
__device__ __forceinline__ float gain_part(float g, float h, float lam,
                                           float alpha) {
  const float s = A0 ? g : soft_threshold(g, alpha);
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

// most threads of a split-scan CTA (splitscan.py SCAN_MAX_THREADS)
constexpr int kScanMaxThreads = 512;

__device__ __forceinline__ Cand shfl_down_cand(const Cand& c, int off) {
  Cand o;
  o.gain = __shfl_down_sync(0xffffffffu, c.gain, off);
  o.ml = __shfl_down_sync(0xffffffffu, c.ml, off);
  o.mr = __shfl_down_sync(0xffffffffu, c.mr, off);
  o.idx = __shfl_down_sync(0xffffffffu, c.idx, off);
  return o;
}

// One class's part of a candidate: _gain_terms (splitscan.py:47) with left
// sums gl/hl (missing right) and gl+gm/hl+hm (missing left), in the
// reference's order; tot = gain_part(G, H).
struct ClassTerms {
  float tr, tl, hr, hl2, hr2;
};

template <bool V>
struct BoolTag {
  static constexpr bool value = V;
};

// NO_MISS: the feature's missing bin is +-0 in every class.  Then gl+gm and
// G-(gl+gm) differ from gl and G-gl at most in the sign of a zero, which
// neither the square nor h+lambda+eps keeps, so the missing-left terms are
// the missing-right ones bit for bit and are not computed again.
template <bool A0, bool NO_MISS>
__device__ __forceinline__ ClassTerms class_terms(float gl, float hl, float G,
                                                  float H, float tot, float gm,
                                                  float hm, float lam,
                                                  float alpha) {
  const float gr = __fsub_rn(G, gl), hr = __fsub_rn(H, hl);
  ClassTerms t;
  t.tr = __fsub_rn(__fadd_rn(gain_part<A0>(gl, hl, lam, alpha),
                             gain_part<A0>(gr, hr, lam, alpha)), tot);
  t.hr = hr;
  if (NO_MISS) {
    t.tl = t.tr;
    t.hl2 = hl;
    t.hr2 = hr;
    return t;
  }
  const float gl2 = __fadd_rn(gl, gm), hl2 = __fadd_rn(hl, hm);
  const float gr2 = __fsub_rn(G, gl2), hr2 = __fsub_rn(H, hl2);
  t.tl = __fsub_rn(__fadd_rn(gain_part<A0>(gl2, hl2, lam, alpha),
                             gain_part<A0>(gr2, hr2, lam, alpha)), tot);
  t.hl2 = hl2;
  t.hr2 = hr2;
  return t;
}

// The candidate's two directions from its class sums (summed over the K
// classes in class order), missing-right mr and missing-left ml; then the
// thread's best so far, by the argmax rule.  K == 1 skips the division of the
// class-mean hessian: x / 1 is x exactly.
template <int TK>
__device__ __forceinline__ void take_candidate(
    Cand& best, int i, bool on, float raw_r, float raw_l, float hl_r,
    float hr_r, float hl_l, float hr_l, float kf, float gamma, float mcw) {
  bool ok_r, ok_l;
  if (TK == 1) {
    ok_r = hl_r >= mcw && hr_r >= mcw;
    ok_l = hl_l >= mcw && hr_l >= mcw;
  } else {
    ok_r = __fdiv_rn(hl_r, kf) >= mcw && __fdiv_rn(hr_r, kf) >= mcw;
    ok_l = __fdiv_rn(hl_l, kf) >= mcw && __fdiv_rn(hr_l, kf) >= mcw;
  }
  const float mr = ok_r ? __fsub_rn(__fmul_rn(0.5f, raw_r), gamma) : -INFINITY;
  const float ml = ok_l ? __fsub_rn(__fmul_rn(0.5f, raw_l), gamma) : -INFINITY;
  float g = max_nan(mr, ml);
  if (!on) g = -INFINITY;
  if (better(g, i, best.gain, best.idx)) best = Cand{g, ml, mr, i};
}

// Copy cnt floats from src to shared dst with the nt threads numbered t:
// 16-byte asynchronous copies where the two addresses agree modulo 16 (the
// caller places dst so that they do), 4-byte ones for the head and the tail.
__device__ __forceinline__ void stage_run(float* dst, const float* src, int cnt,
                                          int t, int nt) {
  int lo = 0, hi = 0;                    // [lo, hi): the 16-byte body
  if ((((uintptr_t)dst ^ (uintptr_t)src) & 15) == 0) {
    lo = min(cnt, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
    hi = lo + ((cnt - lo) & ~3);
    for (int v = lo + 4 * t; v < hi; v += 4 * nt) cp_async16(dst + v, src + v);
  }
  for (int e = t; e < lo; e += nt) cp_async4(dst + e, src + e);
  for (int e = hi + t; e < cnt; e += nt) cp_async4(dst + e, src + e);
}

// Copy `rows` rows of B floats (contiguous at src) to shared rows of stride
// Bs = B + 1 with the nt threads numbered t: element e = r * B + j is
// followed from one copy to the next without a division.
__device__ __forceinline__ void stage_rows_padded(float* dst, const float* src,
                                                  int rows, int B, int Bs,
                                                  int t, int nt) {
  const int total = rows * B;
  int r = t / B, j = t - (t / B) * B;
  const int dr = nt / B, dj = nt - (nt / B) * B;
  for (int e = t; e < total; e += nt) {
    cp_async4(dst + r * Bs + j, src + e);
    r += dr;
    j += dj;
    if (j >= B) {
      j -= B;
      ++r;
    }
  }
}

// TK: the classes when fixed at compile time (1, 2), else 0 and K at run
// time, with the running sums in shared memory.  STAGED: the feature tile's
// histograms are copied to shared memory first (else read where they lie,
// for histograms too wide for shared memory).  A0: alpha == 0.  A CTA holds
// P = blockDim.x / (FT*S) (lane, node) blocks of FT*S threads; thread ft + s*FT
// of block p scores candidates [s*(n_bins-1)/S, (s+1)*(n_bins-1)/S) of
// features ft, ft + FT, ... of lane*nn+node = blockIdx.x*P + p.  S threads
// share a feature on a grid too small to fill the card, where one thread's
// serial walk over a feature's candidates would set the launch's time: each
// first adds the bins up to its first candidate in order, so every left sum
// is still the one chain of adds from bin 0.
template <int TK, bool STAGED, bool A0>
__global__ void __launch_bounds__(kScanMaxThreads)
split_scan_kernel(const float* __restrict__ hist_g,
                  const float* __restrict__ hist_h,
                  const float* __restrict__ G, const float* __restrict__ H,
                  const float* __restrict__ mask, int blocks, int nn, int K_rt,
                  int d, int n_bins, int FT, int S, int Bs, float lam, float alpha,
                  float gamma, float mcw, int* __restrict__ best_out,
                  float* __restrict__ gain_out,
                  unsigned char* __restrict__ bml_out) {
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ Cand s_warp[kScanMaxThreads / 32];
  const int K = TK ? TK : K_rt;
  const int B = n_bins + 1;
  const int per_f = n_bins - 1;
  const int per_block = FT * S;
  const int p = threadIdx.x / per_block;
  const int tb = threadIdx.x - p * per_block;
  const int ft = tb % FT;
  const int grp = tb / FT;
  const int b0 = grp * per_f / S, b1 = (grp + 1) * per_f / S;
  const int P = blockDim.x / per_block;
  const int ln = blockIdx.x * P + p;
  const bool live = ln < blocks;
  const int lnc = live ? ln : 0;
  const int l = lnc / nn;
  // [2K][FT rows of Bs] of this block, each (channel, class) run with 4
  // words of slack so its copy can start 16-byte aligned with its source
  const int seg = FT * Bs + 4;
  float* s_blk = s_dyn + (size_t)p * 2 * K * seg;
  float* s_run = s_dyn + (STAGED ? (size_t)P * 2 * K * seg : 0)
                 + threadIdx.x;                     // [2K][threads]
  const long long off = (long long)lnc * K * d * B;
  const float* Gt = G + (long long)lnc * K;
  const float* Ht = H + (long long)lnc * K;
  const float kf = (float)K;

  // run c (c < K: grad of class c, else hess of class c - K) of feature tile
  // f0, in device memory, and where this thread's feature row of it lies
  auto src_of = [&](int c, int f0) {
    return (c < K ? hist_g : hist_h) + off + ((long long)(c % K) * d + f0) * B;
  };
  auto row_of = [&](int c, int f0) -> const float* {
    const float* src = src_of(c, f0);
    if (!STAGED) return src + (long long)ft * B;
    const int shift = Bs == B ? (int)(((uintptr_t)src >> 2) & 3) : 0;
    return s_blk + c * seg + shift + ft * Bs;
  };

  constexpr int KR = TK ? TK : 1;
  float Gk[KR], Hk[KR], tot[KR];
  if (TK) {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      Gk[k] = __ldg(Gt + k);
      Hk[k] = __ldg(Ht + k);
      tot[k] = gain_part<A0>(Gk[k], Hk[k], lam, alpha);
    }
  }

  Cand best{-INFINITY, -INFINITY, -INFINITY, 0x7fffffff};
  for (int f0 = 0; f0 < d; f0 += FT) {
    const int fcnt = min(FT, d - f0);
    if (STAGED) {
      __syncthreads();                   // the last tile's rows are read
      if (live) {
        for (int c = 0; c < 2 * K; ++c) {
          const float* src = src_of(c, f0);
          float* dst = s_blk + c * seg;
          if (Bs == B)
            stage_run(dst + (((uintptr_t)src >> 2) & 3), src, fcnt * B, tb,
                      per_block);
          else
            stage_rows_padded(dst, src, fcnt, B, Bs, tb, per_block);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const int f = f0 + ft;
    const bool act = live && ft < fcnt;
    // an empty missing bin in every class, decided for the whole warp so
    // that its threads take one branch
    bool no_miss = true;
    if (TK && act) {
#pragma unroll
      for (int k = 0; k < KR; ++k)
        no_miss = no_miss && row_of(k, f0)[n_bins] == 0.0f
                  && row_of(K + k, f0)[n_bins] == 0.0f;
    }
    if (TK) no_miss = __all_sync(0xffffffffu, no_miss);
    if (!act) continue;
    const bool on = mask[(long long)l * d + f] > 0.0f;
    if (TK) {
      const float* rg[KR];
      const float* rh[KR];
      float gl[KR], hl[KR], gm[KR], hm[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        rg[k] = row_of(k, f0);
        rh[k] = row_of(K + k, f0);
        gl[k] = rg[k][0];
        hl[k] = rh[k][0];
        for (int j = 1; j <= b0; ++j) {  // bins up to the first candidate
          gl[k] = __fadd_rn(gl[k], rg[k][j]);
          hl[k] = __fadd_rn(hl[k], rh[k][j]);
        }
        gm[k] = rg[k][n_bins];
        hm[k] = rh[k][n_bins];
      }
      auto scan = [&](auto no_miss_tag) {
        constexpr bool NM = decltype(no_miss_tag)::value;
        for (int b = b0; b < b1; ++b) {
          float raw_r = 0.0f, raw_l = 0.0f, hl_r = 0.0f, hr_r = 0.0f;
          float hl_l = 0.0f, hr_l = 0.0f;
#pragma unroll
          for (int k = 0; k < KR; ++k) {
            if (b > b0) {                // the left sums of bins 0..b, in order
              gl[k] = __fadd_rn(gl[k], rg[k][b]);
              hl[k] = __fadd_rn(hl[k], rh[k][b]);
            }
            const ClassTerms t = class_terms<A0, NM>(
                gl[k], hl[k], Gk[k], Hk[k], tot[k], gm[k], hm[k], lam, alpha);
            if (k == 0) {
              raw_r = t.tr; raw_l = t.tl; hl_r = hl[k]; hr_r = t.hr;
              hl_l = t.hl2; hr_l = t.hr2;
            } else {
              raw_r = __fadd_rn(raw_r, t.tr); raw_l = __fadd_rn(raw_l, t.tl);
              hl_r = __fadd_rn(hl_r, hl[k]); hr_r = __fadd_rn(hr_r, t.hr);
              hl_l = __fadd_rn(hl_l, t.hl2); hr_l = __fadd_rn(hr_l, t.hr2);
            }
          }
          take_candidate<TK>(best, f * per_f + b, on, raw_r, raw_l, hl_r,
                             hr_r, hl_l, hr_l, kf, gamma, mcw);
        }
      };
      if (no_miss)
        scan(BoolTag<true>{});
      else
        scan(BoolTag<false>{});
    } else {
      const int stride = blockDim.x;
      for (int k = 0; k < K; ++k) {
        const float* rg = row_of(k, f0);
        const float* rh = row_of(K + k, f0);
        float gl = rg[0], hl = rh[0];
        for (int j = 1; j <= b0; ++j) {
          gl = __fadd_rn(gl, rg[j]);
          hl = __fadd_rn(hl, rh[j]);
        }
        s_run[(2 * k) * stride] = gl;
        s_run[(2 * k + 1) * stride] = hl;
      }
      for (int b = b0; b < b1; ++b) {
        float raw_r = 0.0f, raw_l = 0.0f, hl_r = 0.0f, hr_r = 0.0f;
        float hl_l = 0.0f, hr_l = 0.0f;
        for (int k = 0; k < K; ++k) {
          const float* rg = row_of(k, f0);
          const float* rh = row_of(K + k, f0);
          float gl = s_run[(2 * k) * stride], hl = s_run[(2 * k + 1) * stride];
          if (b > b0) {
            gl = __fadd_rn(gl, rg[b]);
            hl = __fadd_rn(hl, rh[b]);
            s_run[(2 * k) * stride] = gl;
            s_run[(2 * k + 1) * stride] = hl;
          }
          const float Gv = __ldg(Gt + k), Hv = __ldg(Ht + k);
          const ClassTerms t = class_terms<A0, false>(gl, hl, Gv, Hv,
                                               gain_part<A0>(Gv, Hv, lam, alpha),
                                               rg[n_bins], rh[n_bins], lam, alpha);
          if (k == 0) {
            raw_r = t.tr; raw_l = t.tl; hl_r = hl; hr_r = t.hr;
            hl_l = t.hl2; hr_l = t.hr2;
          } else {
            raw_r = __fadd_rn(raw_r, t.tr); raw_l = __fadd_rn(raw_l, t.tl);
            hl_r = __fadd_rn(hl_r, hl); hr_r = __fadd_rn(hr_r, t.hr);
            hl_l = __fadd_rn(hl_l, t.hl2); hr_l = __fadd_rn(hr_l, t.hr2);
          }
        }
        take_candidate<0>(best, f * per_f + b, on, raw_r, raw_l, hl_r, hr_r,
                          hl_l, hr_l, kf, gamma, mcw);
      }
    }
  }

  // the block's best: within each warp by shuffles, then across its warps
  for (int o = 16; o > 0; o >>= 1) {
    const Cand c = shfl_down_cand(best, o);
    if (better(c.gain, c.idx, best.gain, best.idx)) best = c;
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = best;
  __syncthreads();
  if (!live || tb != 0) return;
  const int w0 = threadIdx.x >> 5;
  Cand b = s_warp[w0];
  for (int w = 1; w < per_block / 32; ++w) {
    const Cand c = s_warp[w0 + w];
    if (better(c.gain, c.idx, b.gain, b.idx)) b = c;
  }
  if (b.idx == 0x7fffffff) b.idx = 0;    // d == 0: no candidate
  best_out[ln] = b.idx;
  gain_out[ln] = b.gain;
  bml_out[ln] = (b.ml >= b.mr) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K3: routing select
// ---------------------------------------------------------------------------

// lanes whose idx loads a thread keeps in flight: tile kernel, direct kernel
constexpr int kTileLanes = 8;
constexpr int kDirectLanes = 4;

// The tile path (routing.py::plan's "tile").  A CTA stages rows [r0, r0+R)
// of the codes in shared memory once — 4-byte asynchronous copies, a warp
// per row, so each copy instruction reads 128 contiguous bytes — and then
// serves every lane from them: thread t takes row t % R of lanes t / R,
// t / R + P, ... (P = blockDim.x / R lanes at a time), reads idx and writes
// out coalesced, with the idx loads of kTileLanes lanes in flight before
// their lookups.  The staged rows lie at an odd stride (d, or d + 1 where d
// is even), a padding rather than a column swizzle: when the 32 rows of a
// warp select one feature — at the root every row of a lane selects its
// node's feature — their words then fall in 32 distinct banks, where a
// stride of d = 128 would put all 32 in one bank; and a row's words stay
// contiguous, so the copies stay coalesced.
__global__ void __launch_bounds__(256)
row_select_tile_kernel(const int* __restrict__ binned,
                       const int* __restrict__ idx, int* __restrict__ out,
                       int n, int d, int L, int R, int stride) {
  extern __shared__ __align__(16) int s_codes[];   // [R][stride]
  const int r0 = blockIdx.x * R;
  const int rows = min(R, n - r0);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int* src = binned + (long long)r0 * d;
  for (int r = warp; r < rows; r += warps)
    for (int c = threadIdx.x & 31; c < d; c += 32)
      cp_async4(s_codes + r * stride + c, src + r * d + c);
  cp_async_wait_all();
  __syncthreads();
  const int r = threadIdx.x % R;
  const int q = threadIdx.x / R;
  const int P = blockDim.x / R;
  if (r >= rows) return;
  const int* row = s_codes + r * stride;
  const long long step = (long long)P * n;
  const int* pi = idx + (long long)q * n + r0 + r;
  int* po = out + (long long)q * n + r0 + r;
  for (int l = q; l < L; l += P * kTileLanes) {
    int j[kTileLanes];
#pragma unroll
    for (int u = 0; u < kTileLanes; ++u)
      j[u] = l + u * P < L ? __ldcs(pi + u * step) : -1;
#pragma unroll
    for (int u = 0; u < kTileLanes; ++u)
      if (l + u * P < L)
        __stcs(po + u * step, (unsigned)j[u] < (unsigned)d ? row[j[u]] : 0);
    pi += kTileLanes * step;
    po += kTileLanes * step;
  }
}

// The direct path (few lanes): one thread per row gathers its lanes' codes,
// the idx loads and then the gathers of kDirectLanes lanes in flight at once.
// Offsets are a 32-bit row index and 64-bit pointer steps: no 64-bit
// division or modulo.
__global__ void __launch_bounds__(256)
row_select_direct_kernel(const int* __restrict__ binned,
                         const int* __restrict__ idx, int* __restrict__ out,
                         int n, int d, int L) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (unsigned)n) return;
  const int* row = binned + (long long)i * d;
  const long long step = n;
  const int* pi = idx + i;
  int* po = out + i;
  for (int l = 0; l < L; l += kDirectLanes) {
    int j[kDirectLanes], v[kDirectLanes];
#pragma unroll
    for (int u = 0; u < kDirectLanes; ++u)
      j[u] = l + u < L ? __ldcs(pi + u * step) : -1;
#pragma unroll
    for (int u = 0; u < kDirectLanes; ++u)
      v[u] = (unsigned)j[u] < (unsigned)d ? __ldg(row + j[u]) : 0;
#pragma unroll
    for (int u = 0; u < kDirectLanes; ++u)
      if (l + u < L) __stcs(po + u * step, v[u]);
    pi += kDirectLanes * step;
    po += kDirectLanes * step;
  }
}

// One K1 launch: the tiling comes from histogram.py::plan (G lanes x CT
// channels x NT nodes x FT features per CTA, `threads` threads, R staged rows
// for the float kernel, `slices` row slices of rows_per_slice rows).
struct HistPlan {
  int G, CT, NT, FT, threads, R, slices, rows_per_slice;
};

int launch_hist_int8(const void* local, const void* gh, const void* binned,
                     void* out, int L, int n, int d, int nn, int two_k, int B,
                     const HistPlan& p, cudaStream_t stream) {
  const int lane_groups = (L + p.G - 1) / p.G;
  const int chan_tiles = (two_k + p.CT - 1) / p.CT;
  const int node_tiles = (nn + p.NT - 1) / p.NT;
  const int feat_tiles = (d + p.FT - 1) / p.FT;
  const long long grid = (long long)lane_groups * chan_tiles * node_tiles
                         * feat_tiles * p.slices;
  const size_t smem = (size_t)p.G * p.NT * p.CT * B * p.FT * sizeof(int)
      + (size_t)(p.threads / 32) * p.G * 32 * (1 + p.CT);
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
      atomic_merge, L, n, d, nn, two_k, B, p.G, p.CT, p.NT, p.FT, lane_groups,
      chan_tiles, node_tiles, feat_tiles, p.rows_per_slice);
  return (int)cudaGetLastError();
}

int launch_hist_f32(const void* local, const void* gh, const void* binned,
                    void* out, void* partial, int L, int n, int d, int nn,
                    int two_k, int B, const HistPlan& p, cudaStream_t stream) {
  const int lane_groups = (L + p.G - 1) / p.G;
  const int chan_tiles = (two_k + p.CT - 1) / p.CT;
  const int node_tiles = (nn + p.NT - 1) / p.NT;
  const int feat_tiles = (d + p.FT - 1) / p.FT;
  const long long grid = (long long)lane_groups * chan_tiles * node_tiles
                         * feat_tiles * p.slices;
  const size_t smem = ((size_t)p.G * p.NT * p.CT * B * p.FT
                       + 2 * ((size_t)p.R * p.FT + (size_t)p.G * p.R
                              + (size_t)p.G * p.CT * p.R)) * 4;
  const long long total = (long long)L * nn * two_k * B * d;
  const int use_partial = p.slices > 1;
  // 16-byte copies of the codes where every row's run starts 16-byte aligned
  const int vec4 = (d % 4 == 0) && ((uintptr_t)binned % 16 == 0);
  // two channels in every tile (CT = 2, 2K even) take the unrolled loop
  auto kernel = p.CT == 2 ? hist_f32_kernel<2> : hist_f32_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, p.threads, smem, stream>>>(
      (const int*)local, (const float*)gh, (const int*)binned,
      (float*)(use_partial ? partial : out), use_partial, L, n, d, nn, two_k,
      B, p.G, p.CT, p.NT, p.FT, p.R, lane_groups, chan_tiles, node_tiles,
      feat_tiles, p.rows_per_slice, vec4);
  e = cudaGetLastError();
  if (e != cudaSuccess || !use_partial) return (int)e;
  sum_slices_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
      (const float*)partial, (float*)out, total, p.slices);
  return (int)cudaGetLastError();
}

using ScanKernel = decltype(&split_scan_kernel<0, true, false>);

// K2's instantiation for K classes: one, two, or any (running sums in shared
// memory)
template <bool STAGED, bool A0>
ScanKernel scan_kernel(int K) {
  return K == 1 ? split_scan_kernel<1, STAGED, A0>
       : K == 2 ? split_scan_kernel<2, STAGED, A0>
                : split_scan_kernel<0, STAGED, A0>;
}

}  // namespace

extern "C" int tmog_hist_level(const void* local, const void* gh,
                               const void* binned, void* out, void* partial,
                               int L, int n, int d, int nn, int two_k,
                               int n_bins, int int_exact, int lanes_per_cta,
                               int chans_per_cta, int nodes_per_cta,
                               int feats_per_cta, int threads, int stage_rows,
                               int slices, int rows_per_slice, void* stream) {
  if ((long long)L * nn * two_k * d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int B = n_bins + 1;
  if (n <= 0) {
    const long long total = (long long)L * nn * two_k * B * d;
    return (int)cudaMemsetAsync(out, 0, total * 4, s);
  }
  const HistPlan p{lanes_per_cta, chans_per_cta, nodes_per_cta, feats_per_cta,
                   threads, stage_rows, slices, rows_per_slice};
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
                               void* bml, int staged, int feats_per_block,
                               int threads_per_feat, int blocks_per_cta,
                               int row_stride, void* stream) {
  if (L <= 0 || nn <= 0) return 0;
  const int FT = feats_per_block, S = threads_per_feat, P = blocks_per_cta;
  const int blocks = L * nn;
  const int threads = FT * S * P;
  const size_t smem =
      ((staged ? (size_t)P * 2 * K * ((size_t)FT * row_stride + 4) : 0)
       + (K > 2 ? (size_t)2 * K * threads : 0)) * sizeof(float);
  const bool a0 = alpha == 0.0f;
  const ScanKernel kernel =
      staged ? (a0 ? scan_kernel<true, true>(K) : scan_kernel<true, false>(K))
             : (a0 ? scan_kernel<false, true>(K) : scan_kernel<false, false>(K));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((blocks + P - 1) / P), threads, smem,
           (cudaStream_t)stream>>>(
      (const float*)hist_g, (const float*)hist_h, (const float*)G,
      (const float*)H, (const float*)mask, blocks, nn, K, d, n_bins, FT, S,
      row_stride, reg_lambda, alpha, gamma, min_child_weight, (int*)best,
      (float*)gain, (unsigned char*)bml);
  return (int)cudaGetLastError();
}

extern "C" int tmog_row_select_lanes(const void* binned, const void* idx,
                                     void* out, int n, int d, int L, int tile,
                                     int rows_per_cta, int row_stride,
                                     int threads, void* stream) {
  if ((long long)L * n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile) {
    const int R = rows_per_cta;
    const size_t smem = (size_t)R * row_stride * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        row_select_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    row_select_tile_kernel<<<(unsigned)((n + (long long)R - 1) / R), threads,
                             smem, s>>>((const int*)binned, (const int*)idx,
                                        (int*)out, n, d, L, R, row_stride);
  } else {
    row_select_direct_kernel<<<(unsigned)((n + (long long)threads - 1) / threads),
                               threads, 0, s>>>(
        (const int*)binned, (const int*)idx, (int*)out, n, d, L);
  }
  return (int)cudaGetLastError();
}
