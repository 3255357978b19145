// Causal or non-causal GQA flash attention, for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py:86 (flash_attention,
// pallas_call at :103).  For q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D),
// query head h reads kv head h / (Hq / Hkv), and query row i sits at key
// position qpos = (Skv - Sq) + i (queries aligned to the end of the keys):
//
//   s[i, j] = (q_i . k_j) * scale                     masked to -1e30 where
//                                                     j >= Skv, or j > qpos
//                                                     when causal
//   o_i     = sum_j softmax_j(s[i, :]) v_j            fp32, stored in q's
//                                                     dtype
//
// computed as the TPU kernel computes it: q, k and v read as fp32, an
// online softmax over tiles of keys with the (m, l, acc) carry in fp32, p
// kept in fp32 for the P.V product, and o = acc / max(l, 1e-30).  Unlike
// the TPU kernel it also masks key positions past Skv in a ragged last
// tile (as chunked_attention does), and Sq need not be a tile multiple.
//
// What bounds it on an H100: operations.  Per (b, h) each of the two
// products takes Sq * Skv * D multiply-adds (about half of that when
// causal), against (Sq + 2 Skv) * D values read and Sq * D written.  At
// stablelm-3b's prefill (4 x 32 heads, 4096 x 4096, D = 80, causal, bf16)
// each is 1.7e11 flops.
//
// bf16 q, k, v (the prefill's case) run on the tensor cores
// (flash_attention_fwd_mma, mma.sync.m16n8k16 bf16 x bf16 -> fp32):
//
//  * q.k^T: bf16 q and k fragments straight into mma.  A product of two
//    bf16 values is exact in fp32, so only the order of the sums differs
//    from the fp32 function.
//  * P.V with p still fp32: each fp32 p is split exactly into three bf16
//    terms, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2).  Each
//    step takes one 8-bit slice of p's 24-bit significand (the remainders
//    are exact fp32 subtractions), so p1 + p2 + p3 == p for every
//    p >= 2^-110; below that p3 can underflow and such a p adds less than
//    1e-33.  v is bf16, so every p_i * v is exact and three mma into one
//    fp32 accumulator give P.V of the fp32 p up to summation order: three
//    products at the bf16 rate (989 TFLOP/s) in place of one at the fp32
//    rate (66.9).  Rounding p to one bf16 term would change the function.
//    The bound is q.k^T plus the three P.V products at the bf16 rate, 0.70
//    ms at stablelm-3b's shape on an H100 SXM's published peaks (the fp32
//    P.V bound of the first kernel, 2.74 ms, beside it in chip_smoke.py).
//  * One block of 4 warps per (b, h, tile of 64 query rows); each warp owns
//    16 rows.  q, k and v tiles stay bf16 in shared memory (rows padded by
//    16 bytes: ldmatrix reads them without bank conflicts; D padded with
//    zeros to the mma depth of 16).  Tiles of 64 keys and values come in
//    with cp.async into a two-stage ring: tile t + 1 is in flight while
//    tile t is multiplied.
//  * The scores stay in registers: the mma C fragment of s is, slice by
//    slice, the A fragment of P.V (the FlashAttention-2 relayout), so p
//    never goes through shared memory.  Row max and row sum are 2-step
//    shuffles among the 4 lanes of a quad.  ~56 KB of shared memory at
//    D = 80 (3 blocks per SM, as its 134 registers allow), ~87 KB at
//    D = 128 (2 blocks).
//
// fp32 q, k, v keep the first kernel's body (flash_attention_fwd): fp32
// FMAs on the CUDA cores, where a bf16 mma would round the operands and
// TF32 would change the result.  One block of 256 threads, a 16 x 16
// grid, per (b, h, tile of 64 query rows); q, k and V^T tiles in shared
// memory as fp32, p through shared memory between the products.
//
// Both: tiles of keys wholly above the causal diagonal are never loaded
// or computed, and blocks take the query tiles from the last (the most
// key tiles) to the first.  Any strides of q, k, v and the output with
// the D axis contiguous, so the model passes its (B, S, H, D) projections
// as they are and gets the output in the layout the output projection
// reads.  Every sum runs in a fixed order and there are no atomics: a
// second launch gives the same bits.  Built without --use_fast_math
// (expf, IEEE division).
//
// Plain C interface, bound with ctypes: pointers are raw device addresses,
// strides are in elements, the stream is the caller's current CUDA stream,
// and the launcher returns a CUDA error code (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kSide = 16;            // fp32 body: threads are a 16 x 16 grid
constexpr int kThreads = kSide * kSide;
constexpr int kRows = kBQ / kSide;   // 4 query rows per thread
constexpr int kCols = kBK / kSide;   // 4 keys per thread
constexpr int kMaxD = 128;
constexpr int kLdp = kBK + 16;       // row stride of p: 16-bank offset
constexpr int kLdvt = kBK + 4;       // row stride of V^T: 4 x 17 floats
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // what one block may opt into
constexpr int kMmaThreads = 128;     // bf16 body: 4 warps x 16 query rows

// dtype codes shared with repro_torch/kernels/flash_attention.py
enum DType { kF32 = 0, kBF16 = 1 };

// Row stride of staged q and k: D + 4 floats, which with D a multiple of
// 8 is 4 x an odd number, so 8 lanes reading 16 bytes from 8 consecutive
// rows hit 8 distinct bank groups.
__host__ __device__ inline int ld_qk(int D) { return D + 4; }

size_t smem_floats(int D) {
  const size_t kp = (size_t)kBK * ld_qk(D) > (size_t)kBQ * kLdp
                        ? (size_t)kBK * ld_qk(D)
                        : (size_t)kBQ * kLdp;
  return (size_t)kBQ * ld_qk(D) + kp + (size_t)D * kLdvt;
}

// bf16 body: D padded to Dp = 16 * NK; a staged row is ld_bf(Dp) = Dp + 8
// values (common.cuh), and the q tile, two k and two v tiles are 5 x 64
// rows.
size_t mma_smem_bytes(int Dp) {
  return (size_t)5 * kBK * ld_bf(Dp) * sizeof(__nv_bfloat16);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, rep, Sq, Skv, D, causal, n_qtiles;
  float scale;
  long long sq_b, sq_h, sq_s;
  long long sk_b, sk_h, sk_s;
  long long sv_b, sv_h, sv_s;
  long long so_b, so_h, so_s;
  int v16;   // bf16 body: every row start 16-byte aligned (cp.async 16)
};

// 4 consecutive fp32 values (16-byte aligned), also from shared memory.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Rows [row0, row0 + 64) of a (rows, D) strided source into shared memory,
// zero past `rows`: as 64 x D row-major with stride ld (transposed = false)
// or as D x 64 with stride kLdvt (transposed = true, V^T).  Lane order runs
// over rows first, so both layouts are stored without bank conflicts.
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long s_row, int row0, int rows,
                                      int D, int tid) {
  const int n4 = D / 4;
  for (int e = tid; e < kBK * n4; e += kThreads) {
    const int r = e % kBK, d = 4 * (e / kBK);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) v = load4(src + (long long)(row0 + r) * s_row + d);
    if (kTransposed) {
      dst[(d + 0) * kLdvt + r] = v.x;
      dst[(d + 1) * kLdvt + r] = v.y;
      dst[(d + 2) * kLdvt + r] = v.z;
      dst[(d + 3) * kLdvt + r] = v.w;
    } else {
      *reinterpret_cast<float4*>(dst + r * ld + d) = v;
    }
  }
}

// max or sum over the 16 lanes that share ty (lanes 0-15 or 16-31 of the
// warp), in a fixed order
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_fwd(Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.rep;
  const int qt = a.n_qtiles - 1 - (int)blockIdx.y;  // longest tiles first
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int D = a.D, ldq = ld_qk(D);
  const int offset = a.Skv - a.Sq;

  extern __shared__ float4 sm4[];   // float4: 16-byte aligned
  float* Qs = reinterpret_cast<float*>(sm4);   // (64, ldq) q tile
  float* Ks = Qs + kBQ * ldq;                  // (64, ldq) k tile, then p
  float* Ps = Ks;                              // (64, kLdp) p over k
  const int kp = kBK * ldq > kBQ * kLdp ? kBK * ldq : kBQ * kLdp;
  float* Vt = Ks + kp;                         // (D, kLdvt) V^T tile

  const T* q = static_cast<const T*>(a.q) + b * a.sq_b + h * a.sq_h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk_b + hk * a.sk_h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv_b + hk * a.sv_h;
  T* o = static_cast<T*>(a.o) + b * a.so_b + h * a.so_h;

  // key tiles this query tile needs: all, or those reaching no further
  // than the last valid query row's position
  int kv_end = a.Skv;
  if (a.causal) {
    const int q_last = min(q0 + kBQ, a.Sq) - 1;
    kv_end = min(kv_end, offset + q_last + 1);
  }
  const int n_kt = (kv_end + kBK - 1) / kBK;

  stage<T, false>(Qs, ldq, q, a.sq_s, q0, a.Sq, D, tid);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's p and V^T are read
    stage<T, false>(Ks, ldq, k, a.sk_s, k0, a.Skv, D, tid);
    stage<T, true>(Vt, 0, v, a.sv_s, k0, a.Skv, D, tid);
    __syncthreads();

    // s[i][j]: query row ty + 16 i against key tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = load4(Qs + (ty + kSide * i) * ldq + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = load4(Ks + (tx + kSide * j) * ldq + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

    // scale, mask and the online softmax; p stays in s
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = offset + q0 + ty + kSide * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kSide * j;
        const bool valid = kpos < a.Skv && (!a.causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done with the k tile
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        Ps[(ty + kSide * i) * kLdp + tx + kSide * j] = s[i][j];
    __syncthreads();

    // acc[i][c] += sum_u p[row i][u] * v[u][column tx + 16 c]
    for (int u = 0; u < kBK; u += 4) {
      float4 pv[kRows], vv[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = load4(Ps + (ty + kSide * i) * kLdp + u);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + kSide * c;
        vv[c] = col < D ? load4(Vt + col * kLdvt + u)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c] += pv[i].x * vv[c].x;
          acc[i][c] += pv[i].y * vv[c].y;
          acc[i][c] += pv[i].z * vv[c].z;
          acc[i][c] += pv[i].w * vv[c].w;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + kSide * i;
    if (r >= a.Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + kSide * c;
      if (col < D) store1(o + (long long)r * a.so_s + col, acc[i][c] * inv_l);
    }
  }
}


// ------------------------------------------------------------ bf16 body

// cp.async of 8 bytes (rows not 16-byte aligned); src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// Rows [row0, row0 + 64) of a (rows, D) bf16 strided source into a staged
// tile (row stride ld values) with cp.async, zeros past `rows`.  Columns D
// to Dp stay as zeroed at the start.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long s_row, int row0, int rows,
                                          int D, int v16, int tid) {
  const int nc = D / 8;                       // 16-byte chunks per row
  for (int e = tid; e < kBK * nc; e += kMmaThreads) {
    const int r = e / nc, c = 8 * (e % nc);
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* s = ok ? src + (long long)(row0 + r) * s_row + c
                                : src;
    const uint32_t d = smem_addr(dst + r * ld + c);
    if (v16) {
      cp_async16(d, s, ok ? 16 : 0);
    } else {
      cp_async8(d, s, ok ? 8 : 0);
      cp_async8(d + 8, ok ? s + 4 : s, ok ? 8 : 0);
    }
  }
}

template <int NK>   // D padded to 16 * NK
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_fwd_mma(Args a) {
  constexpr int Dp = 16 * NK;
  constexpr int LD = ld_bf(Dp);
  constexpr int kTile = kBK * LD;
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.rep;
  const int qt = a.n_qtiles - 1 - (int)blockIdx.y;  // longest tiles first
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int D = a.D;
  const int offset = a.Skv - a.Sq;

  extern __shared__ uint4 smem_bf[];   // uint4: 16-byte aligned
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf);
  __nv_bfloat16* Ks = Qs + kTile;        // two stages
  __nv_bfloat16* Vs = Ks + 2 * kTile;    // two stages

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           b * a.sq_b + h * a.sq_h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) +
                           b * a.sk_b + hk * a.sk_h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) +
                           b * a.sv_b + hk * a.sv_h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.so_b +
                     h * a.so_h;

  int kv_end = a.Skv;
  if (a.causal) {
    const int q_last = min(q0 + kBQ, a.Sq) - 1;
    kv_end = min(kv_end, offset + q_last + 1);
  }
  const int n_kt = (kv_end + kBK - 1) / kBK;

  // zero the D padding of all five tiles once; cp.async never writes it
  if (D < Dp) {
    for (int e = tid; e < 5 * kBK; e += kMmaThreads)
      for (int c = D; c < Dp; c += 8)
        *reinterpret_cast<uint4*>(Qs + e * LD + c) = make_uint4(0, 0, 0, 0);
  }
  load_tile(Qs, LD, q, a.sq_s, q0, a.Sq, D, a.v16, tid);
  load_tile(Ks, LD, k, a.sk_s, 0, a.Skv, D, a.v16, tid);
  load_tile(Vs, LD, v, a.sv_s, 0, a.Skv, D, a.v16, tid);
  cp_async_commit();

  // this lane's two query rows (g and g + 8 of the warp's 16)
  const int qpos0 = offset + q0 + warp * 16 + g;
  const int qpos1 = qpos0 + 8;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[NK][4];

  // ldmatrix row addresses: lane l feeds row (l & 7) of matrix l >> 3
  const int lrow = lane & 7, lmat = lane >> 3;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile(Ks + (st ^ 1) * kTile, LD, k, a.sk_s, (kt + 1) * kBK, a.Skv,
                D, a.v16, tid);
      load_tile(Vs + (st ^ 1) * kTile, LD, v, a.sv_s, (kt + 1) * kBK, a.Skv,
                D, a.v16, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {
      // q fragments: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(Qs + (warp * 16 + lrow +
                                            (lmat & 1) * 8) * LD +
                                      kk * 16 + (lmat >> 1) * 8));
    }
    const __nv_bfloat16* Kt = Ks + st * kTile;
    const __nv_bfloat16* Vt = Vs + st * kTile;
    const int k0 = kt * kBK;

    // s = q k^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices: keys (0-7 | 8-15 of the pair) x d (0-7 | 8-15)
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(Kt + (np * 16 + (lmat >> 1) * 8 + lrow) *
                                           LD +
                                  kk * 16 + (lmat & 1) * 8));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask and the online softmax; element (n, e) is key
    // k0 + 8 n + 2 t4 + (e & 1) of row g (e < 2) or g + 8
    const bool whole = k0 + kBK <= a.Skv &&
                       (!a.causal || k0 + kBK - 1 <= offset + q0 + warp * 16);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * n + 2 * t4 + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const bool valid = whole || (kpos < a.Skv &&
                                     (!a.causal || kpos <= qpos));
        s[n][e] = valid ? s[n][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new[r]);
      m_r[r] = m_new[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_new[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p v: per slice of 16 keys, n-tiles 2j and 2j+1 of s are the
    // A fragment, split into three exact bf16 terms
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t p1[4], p2[4], p3[4];
      split3(s[2 * j][0], s[2 * j][1], p1[0], p2[0], p3[0]);
      split3(s[2 * j][2], s[2 * j][3], p1[1], p2[1], p3[1]);
      split3(s[2 * j + 1][0], s[2 * j + 1][1], p1[2], p2[2], p3[2]);
      split3(s[2 * j + 1][2], s[2 * j + 1][3], p1[3], p2[3], p3[3]);
#pragma unroll
      for (int dp = 0; dp < NK; ++dp) {
        // matrices: keys (0-7 | 8-15) x d (0-7 | 8-15), transposed
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(Vt + (j * 16 + (lmat & 1) * 8 +
                                              lrow) * LD +
                                        dp * 16 + (lmat >> 1) * 8));
        mma_bf16(acc[2 * dp], p1, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], p2, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], p3, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], p1, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], p2, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], p3, bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage st is refilled at the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.Sq) continue;
    const float inv_l = 1.f / fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)row * a.so_s +
                                           col) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv_l,
                                  acc[n][2 * r + 1] * inv_l);
    }
  }
}

// --------------------------------------------------------------- launch

using Kern = void (*)(Args);

struct Choice {
  Kern fn;
  int threads;
  size_t smem;
};

template <int NC>
Choice fp32_choice(int D) {
  return {flash_attention_fwd<float, NC>, kThreads,
          smem_floats(D) * sizeof(float)};
}

template <int NK>
Choice mma_choice() {
  return {flash_attention_fwd_mma<NK>, kMmaThreads, mma_smem_bytes(16 * NK)};
}

// The kernel and its launch shape for (dtype, D), or fn = nullptr.
Choice choose(int dtype, int D) {
  const int n16 = (D + 15) / 16;
  if (dtype == kF32) {
    switch (n16) {
      case 1: return fp32_choice<1>(D);
      case 2: return fp32_choice<2>(D);
      case 3: return fp32_choice<3>(D);
      case 4: return fp32_choice<4>(D);
      case 5: return fp32_choice<5>(D);
      case 6: return fp32_choice<6>(D);
      case 7: return fp32_choice<7>(D);
      case 8: return fp32_choice<8>(D);
    }
  } else if (dtype == kBF16) {
    switch (n16) {
      case 1: return mma_choice<1>();
      case 2: return mma_choice<2>();
      case 3: return mma_choice<3>();
      case 4: return mma_choice<4>();
      case 5: return mma_choice<5>();
      case 6: return mma_choice<6>();
      case 7: return mma_choice<7>();
      case 8: return mma_choice<8>();
    }
  }
  return {nullptr, 0, 0};
}

// The choice with its shared memory opted into, or an error code.
int prepare(int dtype, int D, Choice* c) {
  if (D < 8 || D > kMaxD || D % 8 != 0) return (int)cudaErrorInvalidValue;
  *c = choose(dtype, D);
  if (c->fn == nullptr || c->smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      c->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c->smem);
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and o in that order;
// the D axis of each is contiguous.  Every base address is 16-byte
// aligned and every stride a multiple of 4 (the wrapper makes a copy
// otherwise).  Returns cudaErrorInvalidValue for what the kernel does not
// take: D not a multiple of 8 in [8, 128], Hq not a multiple of Hkv, an
// empty key axis, or a causal call with Sq > Skv.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Hq, int Hkv, int Sq, int Skv,
                                      int D, int causal, float scale,
                                      const long long* strides, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      D < 8 || D > kMaxD || D % 8 != 0 || (causal && Sq > Skv))
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  if (n_qtiles > 65535) return (int)cudaErrorInvalidValue;
  // cp.async moves 16 bytes when every row start of q, k and v is 16-byte
  // aligned (bf16: strides a multiple of 8), else 8
  bool v16 = true;
  for (int i = 0; i < 9; ++i) v16 = v16 && strides[i] % 8 == 0;
  v16 = v16 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                 reinterpret_cast<uintptr_t>(v)) & 15u) == 0;
  Args a{q, k, v, o, Hq, Hq / Hkv, Sq, Skv, D, causal, n_qtiles, scale,
         strides[0], strides[1], strides[2],
         strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8],
         strides[9], strides[10], strides[11], (int)v16};
  Choice c;
  const int rc = prepare(dtype, D, &c);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((long long)B * Hq), (unsigned)n_qtiles);
  c.fn<<<grid, c.threads, c.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of the fp32 body at D;
// flash_attention_kernel_info gives either body's.
extern "C" size_t flash_attention_smem_bytes(int D) {
  return smem_floats(D) * sizeof(float);
}

// What the compiler made of the kernel that takes (dtype, D): out[0..5] =
// registers per thread, local (spill) bytes per thread, static shared
// memory, dynamic shared memory (bytes), resident blocks per SM, threads
// per block.  Returns a CUDA error code.
extern "C" int flash_attention_kernel_info(int dtype, int D, long long* out) {
  Choice c;
  int rc = prepare(dtype, D, &c);
  if (rc != 0) return rc;
  cudaFuncAttributes fa;
  rc = (int)cudaFuncGetAttributes(&fa, c.fn);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.fn,
                                                          c.threads, c.smem);
  if (rc != 0) return rc;
  out[0] = fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  out[2] = (long long)fa.sharedSizeBytes;
  out[3] = (long long)c.smem;
  out[4] = blocks;
  out[5] = c.threads;
  return 0;
}
