// One cyclic Gauss-Seidel sweep of the Lasso  min ||Ax - b||^2 + c||x||_1,
// for sm_90a.
//
// Replaces no TPU kernel: the reference runs each sweep as one device
// program, a lax.fori_loop over the n coordinates
// (src/repro/baselines/gauss_seidel.py:37-50), and this kernel is the
// port's form of that program.  Eager torch would make about six launches
// per coordinate, 600k per sweep at n = 100000.  For i = 0 .. n-1, against
// the residual r = Ax - b as the earlier coordinates left it:
//
//     g_i = 2 a_i^T r,   d_i = 2 colsq_i,   z_i = soft(x_i - g_i/d_i, c/d_i)
//     delta = z_i - x_i,   r += a_i * delta,   x_i = z_i
//
// and max |delta| over the sweep into one device scalar.  x and r are
// updated in place.  The quotients are true fp32 divisions (__fdiv_rn)
// and r's update rounds the product and the sum on their own (__fmul_rn,
// __fadd_rn), as the plain torch version (kernels/ref.py) does; the dot
// products sum in another order, so the two agree to rounding, not bits.
//
// What bounds it on an H100: the sweep reads A once (n * m * 4 bytes,
// 2 GB at fig1d: 0.6 ms at 3.35 TB/s), but it is sequential by
// construction: coordinate i's dot product needs r after coordinate i-1's
// update.  Done one coordinate at a time by one block (the first kernel),
// each coordinate cost a 20 KB row read, a block reduction and a
// broadcast: 1.3 us, 130 ms per fig1d sweep on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md gives this design's time beside it).
//
// What this design does about it: blocks of kB = 32 consecutive
// coordinates, Gram-corrected, across a thread-block cluster.
//  * The algebra.  For a block J, against r as the previous block left it,
//    q_j = a_j^T r and G_jk = a_j^T a_k (k < j, both in J).  Walking j in
//    order, g_j = 2 (q_j + sum_{k<j} G_jk delta_k) is 2 a_j^T r after the
//    block's earlier coordinates, in exact arithmetic; z_j and delta_j are
//    then formed exactly as before (response, __fdiv_rn, the NaN-sticky
//    max |delta|).  r += a_j delta_j follows for j in J in order, each
//    product and sum rounded as before, skipped where delta_j = 0.  The
//    Gram correction rounds otherwise than r's per-coordinate update,
//    within the gates' 1e-5.
//  * The layout.  One cluster of 16 CTAs (8 where the card cannot place
//    16) on neighbouring SMs.  CTA q holds slice q of r (ceil(m / C) rows,
//    rounded up to 4) in shared memory for the whole sweep.  The matching
//    slice of the block's 32 rows of A^T, with the block's x and colsq,
//    comes in by cp.async into a ring of three tiles: blocks b (q and the
//    update), b + 1 (G) and b + 2 (in flight).
//  * Per block each CTA forms its partial q (lane j of each warp owns a
//    row) and strict lower G (36 register tiles of 4 x 4 over 6 subsets of
//    the rows; the tile's rows are stored 8 apart so a warp's loads fall
//    in distinct bank groups) over its slice, and sums them in a fixed
//    order.  The 528 sums are reduced over the cluster through distributed
//    shared memory: each CTA stores each sum into the inbox of the CTA
//    that owns it, one barrier.cluster, each owner adds its entries over
//    the ranks in order and stores the totals into every CTA, a second
//    barrier.  Every CTA then holds the same bits, walks the 32
//    coordinates itself (one warp, lane j holding coordinate j, lane k's
//    delta broadcast by shuffle) and updates its own slice of r.  G does
//    not depend on r, so warps 1-7 form block b + 1's G, and stage block
//    b + 2, while warp 0 walks block b.  Two cluster barriers per 32
//    coordinates replace 32 x 2 block barriers and 32 broadcasts.
//  * A slice longer than kMaxChunk rows (or three tiles that do not fit)
//    is staged in chunks through two slots, read twice per block (q and
//    G, then the update), without the overlap.  m <= kMaxRows = 57344, as
//    before.
//  * Fixed-order sums everywhere and no atomics: the same inputs give the
//    same bits on every launch (for one cluster size; the launcher picks
//    the size from the card and the shared memory, the same for every
//    call at one m).
//
// Plain C interface, bound with ctypes: pointers are raw device addresses,
// the stream is the caller's current CUDA stream, and the launcher returns
// cudaGetLastError() after its launch (0 = success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 32;                     // coordinates per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTri = kB * (kB - 1) / 2;    // strict lower Gram entries
constexpr int kPart = kTri + kB;           // and the 32 dot products with r
constexpr int kMaxRows = 57344;            // as the first kernel took
constexpr int kMaxChunk = 640;             // rows of A^T staged at a time
constexpr int kClusters[] = {16, 8};       // sizes tried, in order
constexpr int kMaxCluster = 16;
constexpr int kMinCluster = 8;
constexpr int kMaxShare = (kPart + kMinCluster - 1) / kMinCluster;
constexpr int kMaxSlots = 3;               // staged tiles in flight
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int tri(int j, int k) {
  return j * (j - 1) / 2 + k;
}

struct Params {
  const float* At;
  const float* colsq;
  float* x;
  float* r;
  float c;
  float* max_delta;
  long long n;
  int m;
  int slice;   // rows of r per CTA (a multiple of 4)
  int chunk;   // rows per staged tile (a multiple of 4)
  int nch;     // chunks per slice
  int ldt;     // row stride of a staged tile, floats (4 mod 8)
  int slots;   // staged tiles in the ring: 3 (one chunk, if they fit) or 2
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// Physical row of a staged tile that holds the block's row j: rows 4t ..
// 4t + 3 of a Gram register tile land 8 rows apart, so the 8 tiles' loads
// of one warp fall in 8 different bank groups (the row stride is an odd
// number of 16-byte units).
__host__ __device__ constexpr int phys(int j) { return (j & 3) * 8 + (j >> 2); }
__host__ __device__ constexpr int logical(int P) {
  return (P & 7) * 4 + (P >> 3);
}

// Rows j < 32 of block blk (zeros past n), columns [c0, c0 + chunk) of
// this CTA's slice of A^T (zeros past its rows), into a staged tile: the
// w-th of nw copying warps takes rows w, w + nw, ..., its lanes along the
// row.
template <bool kVec>
__device__ __forceinline__ void stage_rows(const Params& p, float* dst,
                                           long long blk, int c0, int i0,
                                           int rows, int w, int nw,
                                           int lane) {
  const int beff = (int)min((long long)kB, p.n - blk * kB);
  const int crows = max(0, min(p.chunk, rows - c0));
  const float* src = p.At + blk * kB * (long long)p.m + i0 + c0;
  for (int j = w; j < kB; j += nw) {
    const float* srow = src + (long long)j * p.m;
    float* drow = dst + phys(j) * p.ldt;
    if (kVec) {
      for (int u = 4 * lane; u < p.chunk; u += 128) {
        const bool ok = j < beff && u < crows;
        cp_async16(smem_addr(drow + u), ok ? srow + u : p.At, ok ? 16 : 0);
      }
    } else {
      for (int u = lane; u < p.chunk; u += 32) {
        const bool ok = j < beff && u < crows;
        cp_async4(smem_addr(drow + u), ok ? srow + u : p.At, ok ? 4 : 0);
      }
    }
  }
}

// x and colsq of block blk (zeros past n) into xs, cs: lane j of a warp
// copies coordinate j's.
__device__ __forceinline__ void stage_xc(const Params& p, float* xs,
                                         float* cs, long long blk, int lane) {
  const long long j = blk * kB + lane;
  const bool ok = j < p.n;
  cp_async4(smem_addr(xs + lane), ok ? p.x + j : p.x, ok ? 4 : 0);
  cp_async4(smem_addr(cs + lane), ok ? p.colsq + j : p.colsq, ok ? 4 : 0);
}

// Partial q_j = sum a_j r over rows [0, crows) of a staged tile, r from
// rc: lane L of each warp owns physical row L (the block's row
// logical(L)), warp w takes the groups of 4 rows w, w + 8, ... (four
// chains, added in order at the end).
__device__ __forceinline__ float q_partial(const float* tile, int ldt,
                                           const float* rc, int crows,
                                           int warp, int lane) {
  const int ng = (crows + 3) / 4;
  const float* own = tile + lane * ldt;
  float q[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g0 = warp; g0 < ng; g0 += 4 * kWarps) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = g0 + i * kWarps;
      if (gi < ng) {
        const float4 a = *reinterpret_cast<const float4*>(own + 4 * gi);
        const float4 rv = *reinterpret_cast<const float4*>(rc + 4 * gi);
        q[i] = fmaf(a.x, rv.x, q[i]);
        q[i] = fmaf(a.y, rv.y, q[i]);
        q[i] = fmaf(a.z, rv.z, q[i]);
        q[i] = fmaf(a.w, rv.w, q[i]);
      }
    }
  }
  return ((q[0] + q[1]) + q[2]) + q[3];
}

// The strict lower Gram matrix of a staged tile's 32 rows, in 36 register
// tiles of 4 x 4 (rows 4 jt + r, columns 4 kt + c, kt <= jt) over 6
// subsets of its groups of 4 columns: thread t < 216 of warps 1-7 takes
// tile t % 36 and groups t / 36, t / 36 + 6, ... (rows [0, crows)),
// accumulating into g.
constexpr int kGramTiles = 36, kGramSubsets = 6;
constexpr int kGramThreads = kGramTiles * kGramSubsets;
__device__ __forceinline__ void gram_tile(int t, int& jt, int& kt) {
  const int tau = t % kGramTiles;
  jt = 0;
  while ((jt + 1) * (jt + 2) / 2 <= tau) ++jt;
  kt = tau - jt * (jt + 1) / 2;
}
__device__ __forceinline__ void gram_partial(const float* tile, int ldt,
                                             int crows, int t,
                                             float (&g)[4][4]) {
  int jt, kt;
  gram_tile(t, jt, kt);
  const int ng = (crows + 3) / 4;
  const float* aj = tile + jt * ldt;         // row 4 jt + r is at 8 r + jt
  const float* ak = tile + kt * ldt;
#pragma unroll 2
  for (int gi = t / kGramTiles; gi < ng; gi += kGramSubsets) {
    const int u = 4 * gi;
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = *reinterpret_cast<const float4*>(aj + 8 * r * ldt + u);
      y[r] = *reinterpret_cast<const float4*>(ak + 8 * r * ldt + u);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        g[r][c] = fmaf(x[r].x, y[c].x, g[r][c]);
        g[r][c] = fmaf(x[r].y, y[c].y, g[r][c]);
        g[r][c] = fmaf(x[r].z, y[c].z, g[r][c]);
        g[r][c] = fmaf(x[r].w, y[c].w, g[r][c]);
      }
  }
}
// A thread's Gram partial into its subset's row of pg (strict lower only).
__device__ __forceinline__ void gram_store(const float (&g)[4][4], int t,
                                           float (*pg)[kTri]) {
  int jt, kt;
  gram_tile(t, jt, kt);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * jt + r, k = 4 * kt + c;
      if (k < j) pg[t / kGramTiles][tri(j, k)] = g[r][c];
    }
}

// The block's 528 partials summed in a fixed order (G over its 6 subsets,
// q over its 8 warps), then over the cluster in rank order, leaving the
// same bits in every CTA's tot.  Entry t is owned by CTA t / share: each
// CTA stores its sum of t into the owner's inbox row (a remote store);
// after a cluster barrier each owner sums its entries' rows in rank order
// and stores the totals into every CTA's tot; a second barrier publishes
// them.  Remote stores never wait on a round trip.  The inbox and tot are
// free to be written again: a CTA reaches either barrier only after it
// has read what the last block left there.
__device__ __forceinline__ void publish(cg::cluster_group& cluster,
                                        float (*pg)[kTri], float (*pq)[kB],
                                        float (*inbox)[kMaxShare],
                                        float* tot, int rank, int nrank,
                                        int tid) {
  const int share = (kPart + nrank - 1) / nrank;
  __syncthreads();
  for (int t = tid; t < kPart; t += kThreads) {
    float s;
    if (t < kTri) {
      s = pg[0][t];
#pragma unroll
      for (int w = 1; w < kGramSubsets; ++w) s += pg[w][t];
    } else {
      s = pq[0][t - kTri];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += pq[w][t - kTri];
    }
    const int o = t / share;
    *cluster.map_shared_rank(&inbox[rank][t - o * share], o) = s;
  }
  cluster.sync();
  for (int e = tid; e < share * nrank; e += kThreads) {
    const int i = e / nrank, q = e % nrank;
    const int t = rank * share + i;
    if (t >= kPart) continue;
    float v[kMaxCluster];
#pragma unroll
    for (int w = 0; w < kMaxCluster; ++w) v[w] = w < nrank ? inbox[w][i] : 0.f;
    float s = v[0];
#pragma unroll
    for (int w = 1; w < kMaxCluster; ++w)
      if (w < nrank) s += v[w];
    *cluster.map_shared_rank(&tot[t], q) = s;
  }
  cluster.sync();
}

// The block's serial walk on one warp, lane j holding coordinate j: its
// cc_j = q_j + sum_{k<j} G_jk delta_k, x_j, d_j = 2 colsq_j and c / d_j.
// At step k every lane forms its response; lane k's delta is broadcast
// and every later lane adds G_jk delta_k (fma).  Lane j then writes
// delta_j to dl and (rank 0) z_j to x; max |delta| (NaN sticky) joins
// maxd in every lane.
__device__ __forceinline__ void walk(const Params& p, const float* tot,
                                     const float* xs, const float* cs,
                                     float* dl, long long j0, int beff,
                                     int rank, int lane, float& maxd) {
  float g[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) g[k] = k < lane ? tot[tri(lane, k)] : 0.f;
  float cc = tot[kTri + lane];
  const float xj = xs[lane];
  const float dj = 2.f * cs[lane];
  const float tj = __fdiv_rn(p.c, dj);
  float mine = 0.f, zj = xj;
  // straight-line code: steps past beff (a ragged last block) broadcast
  // delta 0, which leaves every lane below beff as it was (G_jk = 0 for
  // k >= j), so no branch sits between the shuffles
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const float z = response(xj, 2.f * cc, dj, tj);
    const float sk = __shfl_sync(0xffffffffu, __fsub_rn(z, xj), k);
    const float dk = k < beff ? sk : 0.f;
    mine = lane == k ? dk : mine;
    zj = lane == k ? z : zj;
    cc = fmaf(g[k], dk, cc);           // g[k] = 0 for lanes <= k
  }
  const bool mineok = lane < beff;
  dl[lane] = mineok ? mine : 0.f;
  if (mineok && rank == 0) p.x[j0 + lane] = zj;
  float ad = fabsf(mineok ? mine : 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, ad, off);
    if (o > ad || o != o) ad = o;
  }
  if (ad > maxd || ad != ad) maxd = ad;   // NaN sticks, as jnp.maximum
}

// r += a_j delta_j for j in the block, in order, each product and sum
// rounded on its own and skipped where delta_j = 0, over rows [0, crows)
// of a staged tile (r from rc); a thread takes two rows at a time.
__device__ __forceinline__ void update(const float* tile, int ldt, float* rc,
                                       int crows, const float* dl, int tid) {
  float d[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) d[j] = dl[j];
  for (int u = tid; u < crows; u += 2 * kThreads) {
    const bool two = u + kThreads < crows;
    const int v = two ? u + kThreads : u;
    float ru = rc[u], rv = rc[v];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const float* row = tile + phys(j) * ldt;
      const float nu = __fadd_rn(ru, __fmul_rn(row[u], d[j]));
      const float nv = __fadd_rn(rv, __fmul_rn(row[v], d[j]));
      ru = d[j] != 0.f ? nu : ru;
      rv = d[j] != 0.f ? nv : rv;
    }
    rc[u] = ru;
    if (two) rc[v] = rv;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    gauss_seidel_sweep_kernel(Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nrank = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gt = tid - 32;                     // thread of warps 1-7
  const bool gram = warp > 0 && gt < kGramThreads;
  const int S = p.slice, ldt = p.ldt;
  const int i0 = rank * S;
  const int rows = max(0, min(S, p.m - i0));   // this CTA's rows of r

  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);   // [slots][kB][ldt]
  float* rs = tiles + p.slots * kB * ldt;            // [S] slice of r
  __shared__ float pg[kGramSubsets][kTri];           // Gram partials
  __shared__ float pq[kWarps][kB];                   // q partials
  __shared__ float inbox[kMaxCluster][kMaxShare];    // owned entries' rows
  __shared__ float tot[kPart];                       // summed over the cluster
  __shared__ float xs[kMaxSlots][kB], cs[kMaxSlots][kB], dl[kB];

  for (int i = tid; i < S; i += kThreads) rs[i] = i < rows ? p.r[i0 + i] : 0.f;

  const long long nb = (p.n + kB - 1) / kB;
  const int tsz = kB * ldt;
  float maxd = 0.f;
  float g[4][4];

  if (p.slots == 3) {
    // The slice is one tile, which serves the block's q, G and update;
    // three slots hold blocks b (q, update), b + 1 (G) and b + 2 (in
    // flight).  While warp 0 walks block b, warps 1-7 form block b + 1's
    // G and stage block b + 2 (A^T rows; x and colsq by warp 1) into the
    // slot block b - 1 left.
    if (warp > 0) {
      for (int t = 0; t < 2; ++t) {
        if (t < nb) {
          stage_rows<kVec>(p, tiles + t * tsz, t, 0, i0, rows, warp - 1,
                           kWarps - 1, lane);
          if (warp == 1) stage_xc(p, xs[t], cs[t], t, lane);
        }
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    if (gram) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
      gram_partial(tiles, ldt, rows, gt, g);
      gram_store(g, gt, pg);
    }
    for (long long blk = 0; blk < nb; ++blk) {
      const int slot = (int)(blk % 3);
      const float* tile = tiles + slot * tsz;
      pq[warp][logical(lane)] = q_partial(tile, ldt, rs, rows, warp, lane);
      publish(cluster, pg, pq, inbox, tot, rank, nrank, tid);
      if (warp > 0) cp_async_wait<0>();   // block b + 1's tile landed
      __syncthreads();
      if (warp == 0) {
        walk(p, tot, xs[slot], cs[slot], dl, blk * kB,
             (int)min((long long)kB, p.n - blk * kB), rank, lane, maxd);
      } else {
        if (gram && blk + 1 < nb) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
          gram_partial(tiles + (int)((blk + 1) % 3) * tsz, ldt, rows, gt, g);
          gram_store(g, gt, pg);
        }
        if (blk + 2 < nb) {
          // block b + 2's x and colsq have landed at block b + 1's wait,
          // before block b + 2's cluster barriers, after which rank 0
          // writes them
          const int s2 = (int)((blk + 2) % 3);
          stage_rows<kVec>(p, tiles + s2 * tsz, blk + 2, 0, i0, rows,
                           warp - 1, kWarps - 1, lane);
          if (warp == 1) stage_xc(p, xs[s2], cs[s2], blk + 2, lane);
        }
        cp_async_commit();
      }
      __syncthreads();
      update(tile, ldt, rs, rows, dl, tid);
      __syncthreads();
    }
  } else {
    // A slice of several chunks, or three tiles that do not fit: per
    // block the chunks stream through two slots for q and G, then again
    // for the update (tile t is chunk t % nch of block t / (2 nch)); no
    // overlap of walk and G.
    const int L = 2 * p.nch;
    const long long n_tiles = nb * L;
    auto stage_tile = [&](long long t) {
      if (t < n_tiles)
        stage_rows<kVec>(p, tiles + (t & 1) * tsz, t / L,
                         (int)(t % p.nch) * p.chunk, i0, rows, warp, kWarps,
                         lane);
      cp_async_commit();
    };
    long long t = 0;                   // the next tile to consume
    stage_tile(0);
    for (long long blk = 0; blk < nb; ++blk) {
      const long long j0 = blk * kB;
      const int beff = (int)min((long long)kB, p.n - j0);
      if (tid < kB) {                  // read before this block's barrier
        xs[0][tid] = tid < beff ? p.x[j0 + tid] : 0.f;
        cs[0][tid] = tid < beff ? p.colsq[j0 + tid] : 1.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
      float qa = 0.f;
      for (int ch = 0; ch < p.nch; ++ch, ++t) {
        stage_tile(t + 1);
        cp_async_wait<1>();
        __syncthreads();
        const int c0 = ch * p.chunk;
        const int crows = max(0, min(p.chunk, rows - c0));
        const float* tile = tiles + (t & 1) * tsz;
        qa += q_partial(tile, ldt, rs + c0, crows, warp, lane);
        if (gram) gram_partial(tile, ldt, crows, gt, g);
        __syncthreads();
      }
      pq[warp][logical(lane)] = qa;
      if (gram) gram_store(g, gt, pg);
      publish(cluster, pg, pq, inbox, tot, rank, nrank, tid);
      if (warp == 0) walk(p, tot, xs[0], cs[0], dl, j0, beff, rank, lane, maxd);
      __syncthreads();
      for (int ch = 0; ch < p.nch; ++ch, ++t) {
        stage_tile(t + 1);
        cp_async_wait<1>();
        __syncthreads();
        const int c0 = ch * p.chunk;
        update(tiles + (t & 1) * tsz, ldt, rs + c0,
               max(0, min(p.chunk, rows - c0)), dl, tid);
        __syncthreads();
      }
    }
  }
  for (int i = tid; i < rows; i += kThreads) p.r[i0 + i] = rs[i];
  if (rank == 0 && tid == 0) *p.max_delta = maxd;
  cluster.sync();                      // no CTA leaves while written remotely
}

using Kern = void (*)(Params);

struct Plan {
  Kern fn;
  int cluster;
  size_t smem;
};

// The launch of a single cluster of C CTAs (the whole grid) with smem
// bytes of dynamic shared memory; attr is the config's cluster attribute.
cudaLaunchConfig_t one_cluster(int C, size_t smem, cudaLaunchAttribute* attr,
                               cudaStream_t st) {
  return cluster_config(dim3(C), C, kThreads, smem, attr, st);
}

// The kernel, cluster size and shared memory of a sweep at m rows: the
// first of kClusters the card can place, with p's slice, chunk and tile
// stride filled in.
int plan(const float* At, int m, Params* p, Plan* out) {
  const bool vec = m % 4 == 0 && (reinterpret_cast<uintptr_t>(At) & 15u) == 0;
  Kern fn = vec ? gauss_seidel_sweep_kernel<true>
                : gauss_seidel_sweep_kernel<false>;
  int rc = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != 0) return rc;
  cudaFuncAttributes fa;
  rc = (int)cudaFuncGetAttributes(&fa, fn);
  if (rc != 0) return rc;
  const size_t room = kMaxSmem - fa.sharedSizeBytes;   // for dynamic
  for (int C : kClusters) {
    int S = ((m + C - 1) / C + 3) / 4 * 4;   // rows of r per CTA
    if (S < 4) S = 4;
    const int chunk = S < kMaxChunk ? S : kMaxChunk;
    const int nch = (S + chunk - 1) / chunk;
    const int ldt = chunk + (chunk % 8 == 0 ? 4 : 8);
    // three slots (walk beside G) for one chunk that fits, else two
    auto bytes = [&](int slots) {
      return (size_t)(slots * kB * ldt + S) * sizeof(float);
    };
    int slots = nch == 1 && bytes(kMaxSlots) <= room ? kMaxSlots : 2;
    const size_t smem = bytes(slots);
    if (smem > room) continue;
    rc = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = one_cluster(C, smem, &attr, nullptr);
    int clusters = 0;
    rc = (int)cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (rc != 0) {
      cudaGetLastError();              // a size the card refuses: next
      continue;
    }
    if (clusters < 1) continue;
    p->slice = S;
    p->chunk = chunk;
    p->nch = nch;
    p->ldt = ldt;
    p->slots = slots;
    *out = {fn, C, smem};
    return 0;
  }
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

// One sweep over the n coordinates: At (n, m) fp32 contiguous (row i is
// column a_i of A), colsq (n,), x (n,) and r (m,) fp32, x and r updated in
// place; max |delta| into max_delta (one fp32).  m <= 57344.
extern "C" int gauss_seidel_sweep_launch(const float* At, const float* colsq,
                                         float* x, float* r, float c,
                                         float* max_delta, long long n,
                                         int m, void* stream) {
  if (n <= 0 || m < 0 || m > kMaxRows) return (int)cudaErrorInvalidValue;
  Params p{At, colsq, x, r, c, max_delta, n, m, 0, 0, 0, 0, 0};
  Plan pl;
  int rc = plan(At, m, &p, &pl);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = one_cluster(
      pl.cluster, pl.smem, &attr, static_cast<cudaStream_t>(stream));
  rc = (int)cudaLaunchKernelEx(&cfg, pl.fn, p);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// What the compiler and the card made of the sweep at m rows (16-byte
// aligned A^T): out[0..9] = registers per thread, local (spill) bytes per
// thread, static shared memory, dynamic shared memory (bytes), CTAs per
// cluster, clusters the card can hold at once, threads per CTA, rows of r
// per CTA, rows per staged tile, tiles in the ring.  Returns a CUDA error
// code.
extern "C" int gauss_seidel_kernel_info(int m, long long* out) {
  if (m < 0 || m > kMaxRows) return (int)cudaErrorInvalidValue;
  Params p{};
  Plan pl;
  int rc = plan(reinterpret_cast<const float*>(256), m, &p, &pl);
  if (rc != 0) return rc;
  cudaFuncAttributes fa;
  rc = (int)cudaFuncGetAttributes(&fa, pl.fn);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = one_cluster(pl.cluster, pl.smem, &attr,
                                             nullptr);
  int clusters = 0;
  rc = (int)cudaOccupancyMaxActiveClusters(&clusters, pl.fn, &cfg);
  if (rc != 0) return rc;
  out[0] = fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  out[2] = (long long)fa.sharedSizeBytes;
  out[3] = (long long)pl.smem;
  out[4] = pl.cluster;
  out[5] = clusters;
  out[6] = kThreads;
  out[7] = p.slice;
  out[8] = p.chunk;
  out[9] = p.slots;
  return 0;
}
