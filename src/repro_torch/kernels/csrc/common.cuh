// Device helpers shared by the sources of csrc/: the soft threshold of the
// FLEXA best response, and the fixed-order block, grid and cluster sums
// that keep z equal to the plain torch version bit for bit and give e2 the
// same bits on every launch (flexa_prox.cu, compact_rows.cu,
// gauss_seidel.cu); the launch of a grid of thread-block clusters
// (flexa_prox.cu, compact_rows.cu, gauss_seidel.cu) and the card's
// largest cluster of a kernel (flexa_prox.cu, compact_rows.cu); cp.async
// staging (gauss_seidel.cu, flash_attention.cu, ssd_scan.cu,
// ssd_scan_bwd.cu), the staged bf16 tiles of the SSD scans and their row
// stride (flash_attention.cu's too); and the tensor-core pieces of the
// bf16 bodies (flash_attention.cu, ssd_scan.cu, ssd_scan_bwd.cu):
// ldmatrix, mma.sync m16n8k16 and the exact three-term bf16 split of fp32
// values.  Included by those sources, not built on its own
// (kernels/build.py builds *.cu).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// soft(w, t) = sign(w) * max(|w| - t, 0), as torch.sign * clamp_min.  The
// subtraction rounds on its own: a product in t must not fuse into an FMA.
__device__ __forceinline__ float soft(float w, float t) {
  const float a = __fsub_rn(fabsf(w), t);
  const float m = a > 0.f ? a : 0.f;
  const float s = w > 0.f ? 1.f : (w < 0.f ? -1.f : 0.f);
  return s * m;
}

// w = x - g / d, then soft(w, t): the quotient a true fp32 division.
__device__ __forceinline__ float response(float xf, float gf, float d,
                                          float t) {
  return soft(__fsub_rn(xf, __fdiv_rn(gf, d)), t);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block (blockDim.x a multiple of 32), a fixed
// warp-shuffle tree, then one over the warps; valid in thread 0.  sh holds
// one float per warp.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? sh[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

// A grid's sum without float atomics: each block writes its block_sum of
// acc to partials[blockIdx.x]; the last block to arrive (a ticket counter,
// zeroed before the launch) sums the gridDim.x partials in index order
// (thread j takes j, j + blockDim.x, ... in turn, then block_sum) into
// *out.  The order depends only on the grid, so the same inputs give the
// same bits on every launch.  Every thread calls it, as the kernel's last
// statement.
__device__ __forceinline__ void grid_sum(float acc, float* partials,
                                         unsigned* ticket, float* out) {
  __shared__ float sh[32];
  __shared__ bool last;
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();                      // partial visible before ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float p = 0.f;
  for (unsigned j = threadIdx.x; j < gridDim.x; j += blockDim.x)
    p += __ldcg(partials + j);
  __syncthreads();                        // sh is reused
  p = block_sum(p, sh);
  if (threadIdx.x == 0) *out = p;
}

// ------------------------------------------------------ cp.async staging

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes into shared memory; src_bytes 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------ thread-block clusters

// The launch of a grid of clusters of C CTAs along x (grid.x a multiple of
// C) with smem bytes of dynamic shared memory; attr is the config's
// cluster attribute.  A size above 8 needs the kernel's
// cudaFuncAttributeNonPortableClusterSizeAllowed set first.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int C, int threads,
                                         size_t smem,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The most devices whose cluster attributes allow_wide_clusters remembers.
constexpr int kMaxClusterDevices = 64;

// Clusters above 8 CTAs allowed for kernel fn on the current device, set
// on the first call there; done holds one flag per device.  Returns a
// CUDA error code.
inline int allow_wide_clusters(const void* fn, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxClusterDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxClusterDevices) done[dev] = true;
  return 0;
}

// The largest cluster, 16 CTAs where the current device can place one of
// every kernel fns[k] (k < n) at `threads` threads per CTA, else 8, into
// *out; done[k] is fns[k]'s flags for allow_wide_clusters.  Returns a
// CUDA error code.
inline int largest_cluster(const void* const* fns,
                           bool (*done)[kMaxClusterDevices], int n,
                           int threads, int* out) {
  int C = 16;
  for (int k = 0; k < n; ++k) {
    int rc = allow_wide_clusters(fns[k], done[k]);
    if (rc != 0) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(16), 16, threads, 0, &attr, nullptr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, fns[k], &cfg) !=
            cudaSuccess ||
        clusters < 1) {
      cudaGetLastError();              // a size the card refuses
      C = 8;
    }
  }
  *out = C;
  return 0;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// barrier.cluster in halves.  The arrival is relaxed: it orders no memory
// (a release would cost a MEMBAR), and only tells the others that this
// CTA runs and, after fence.mbarrier_init, that its mbarrier is set up.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared state of cluster_sum: rank 0's mbarrier, which counts the
// bytes of the other ranks' partials, and the partials by rank.
struct ClusterInbox {
  uint64_t bar;
  float slot[32];
};
__device__ __forceinline__ ClusterInbox& cluster_inbox() {
  __shared__ ClusterInbox box;
  return box;
}

// The address of p (this CTA's shared memory) in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(const void* p,
                                                unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// A cluster's sum without global scratch, atomics or fences, in two
// calls.  cluster_sum_begin, by every thread at the kernel's start: rank
// 0 sets up its mbarrier to expect 4 bytes from each other rank, and every
// CTA arrives (relaxed) at the cluster barrier.  cluster_sum, by every
// thread as the kernel's last statement: each CTA's block_sum of acc; the
// barrier's wait (long complete by then: it only guards the mbarrier's
// set-up); each rank q > 0 sends its partial into slot q of rank 0's
// shared memory by st.async, which counts its bytes on rank 0's mbarrier
// when they land; rank 0's first warp waits for them, reads the slots
// (lane q takes slot q, zeros past the size) and sums them by the fixed
// warp-shuffle tree into *out.  The order depends only on the cluster's
// size, so the same inputs give the same bits on every launch.  A cluster
// of one CTA passes no barrier.
__device__ __forceinline__ void cluster_sum_begin() {
  if (cluster_size() == 1) return;
  if (threadIdx.x == 0 && cluster_rank() == 0) {
    const uint32_t bar = smem_addr(&cluster_inbox().bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar),
        "r"(4 * (cluster_size() - 1))
        : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();
}

__device__ __forceinline__ void cluster_sum(float acc, float* out) {
  __shared__ float sh[32];
  const float s = block_sum(acc, sh);
  const unsigned C = cluster_size();
  if (C == 1) {
    if (threadIdx.x == 0) *out = s;
    return;
  }
  ClusterInbox& box = cluster_inbox();
  const unsigned rank = cluster_rank();
  cluster_wait();
  if (rank != 0) {
    if (threadIdx.x == 0)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
          "[%0], %1, [%2];\n" ::"r"(cluster_map(&box.slot[rank], 0)),
          "r"(__float_as_uint(s)), "r"(cluster_map(&box.bar, 0))
          : "memory");
    return;
  }
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) box.slot[0] = s;
    const uint32_t bar = smem_addr(&box.bar);
    while (!mbar_try_wait(bar, 0)) {
    }
    __syncwarp();
    const float p = warp_sum(threadIdx.x < C ? box.slot[threadIdx.x] : 0.f);
    if (threadIdx.x == 0) *out = p;
  }
}

// ------------------------------------------------- tensor cores (bf16 in)

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------- staged bf16 tiles (ssd_scan*)

// Row stride of a staged bf16 tile of `width` (a multiple of 16) values:
// width + 8, an odd number of 16-byte units, so ldmatrix reads 8 rows
// without bank conflicts.
__host__ __device__ constexpr int ld_bf(int width) { return width + 8; }

// Rows [0, rows) of a (., cols) bf16 strided source (src at its row 0)
// into a staged tile (row stride ld), rows at or past `valid` zero, by the
// whole block.  With v16 (cols a multiple of 8, s_col 1, every row 16-byte
// aligned): cp.async of 16 bytes, zero-filling, and columns [cols, width)
// stay as zero_cols left them.  Else plain loads, eight in flight per
// thread before their stores, zeros up to `width`.
__device__ __forceinline__ void stage_bf(__nv_bfloat16* dst, int ld,
                                         const __nv_bfloat16* src,
                                         long long s_row, long long s_col,
                                         int rows, int valid, int cols,
                                         int width, bool v16) {
  const int nt = blockDim.x;
  if (v16) {
    const int nc = cols / 8;
    for (int e = threadIdx.x; e < rows * nc; e += nt) {
      const int r = e / nc, cc = 8 * (e % nc);
      const bool ok = r < valid;
      cp_async16(smem_addr(dst + r * ld + cc), ok ? src + r * s_row + cc : src,
                 ok ? 16 : 0);
    }
    return;
  }
  const int total = rows * width;
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * nt) {
    __nv_bfloat16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * nt, r = e / width, cc = e % width;
      v[k] = e < total && r < valid && cc < cols ? src[r * s_row + cc * s_col]
                                                 : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * nt;
      if (e < total) dst[(e / width) * ld + e % width] = v[k];
    }
  }
}

// Columns [cols, width) of `rows` staged rows: zero (the cp.async path
// never writes them).
__device__ __forceinline__ void zero_cols(__nv_bfloat16* dst, int ld,
                                          int rows, int cols, int width) {
  const int n = width - cols;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x)
    dst[(e / n) * ld + cols + e % n] = __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The exact three-way split of two fp32 values (x in the low half, as the
// mma fragments order columns): x == h1 + h2 + h3 in each half.  Each step
// takes one 8-bit slice of the 24-bit significand, and each remainder is an
// exact fp32 subtraction, so the split is exact for |x| >= 2^-110 (below,
// the third term can underflow bf16 and is off by less than 2^-133), for
// either sign.
__device__ __forceinline__ void split3(float x, float y, uint32_t& h1,
                                       uint32_t& h2, uint32_t& h3) {
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(x, y);
  const float2 f1 = __bfloat1622float2(b1);
  const float rx = __fsub_rn(x, f1.x), ry = __fsub_rn(y, f1.y);
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(rx, ry);
  const float2 f2 = __bfloat1622float2(b2);
  h1 = bits(b1);
  h2 = bits(b2);
  h3 = bits(__floats2bfloat162_rn(__fsub_rn(rx, f2.x), __fsub_rn(ry, f2.y)));
}

}  // namespace
