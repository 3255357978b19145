// Mamba2 SSD ("state-space duality") chunked scan, for sm_90a.
//
// Replaces src/repro/kernels/ssd_scan.py:83 (ssd_scan, pallas_call at
// :97).  Per batch row b and head h, with A = A[h] < 0 and the (N, P)
// state carried across chunks of L rows in order:
//
//   s       = cumsum(dt * A)                       over the chunk
//   G[t,u]  = C_t . B_u
//   W[t,u]  = G[t,u] * exp(s_t - s_u) * dt_u       for u <= t, else 0
//   y_t     = sum_u W[t,u] x_u + exp(s_t) * (C_t . h)
//   h       = exp(s_L) h + sum_u (exp(s_L - s_u) dt_u B_u)^T x_u
//
// x (Bt, S, H, P) and B, C (Bt, S, N) in one input dtype (fp32, bf16 or
// fp16), read through the strides they come with (the model passes
// last-axis slices of one (Bt, S, d_inner + 2N) buffer); dt (Bt, S, H)
// fp32 strided; A (H,) fp32.  Writes y (Bt, S, H, P) contiguous in the
// input dtype and the final state h (Bt, H, N, P) fp32.  S need not be
// a multiple of L: the last chunk's missing rows count as dt = 0 (the
// state is unchanged by them) and are neither read nor written, which
// is what padding with dt = 0 and slicing gives.
//
// Masking: exp(s_t - s_u) is evaluated only for u <= t.  For u > t the
// exponent is positive and, at L = 256 and A = -16, overflows; the
// kernel never uses it (the TPU kernel masks with jnp.where before the
// product, ssd_scan.py:58).
//
// What bounds it on an H100: operations.  At mamba2-1.3b's prefill (Bt 4,
// S 4096, H 64, P 64, N 128, L 256) the function needs 26.1 G
// multiply-adds (G once per (b, chunk) over the lower triangle; per head
// W.X over the triangle, C.h and the state update) against 86 us of
// bytes.  The products whose factors are all bf16 (G) run on the tensor
// cores exactly at the bf16 rate; the three with an fp32 factor (W, h and
// the weighted B) run as three bf16 products each (below): 77.7 G
// multiply-adds, 0.157 ms at 989 TFLOP/s, against 0.78 ms for the same
// function on the CUDA cores (66.9 TFLOP/s).
//
// The first kernel walked every chunk of one (b, h) in one block of fp32
// FMAs.  What held it back, and what this design does about each:
//
//  * Few blocks (one per (b, h): 64 for 132 SMs at batch 1, a 32k
//    sequence walked serially).  The scan is split into three launches on
//    the caller's stream, two of them over (chunk, head, batch row):
//      (a) ssd_chunk_state: per chunk the cumsum s (kept in scratch) and
//          the chunk's own state Hc = (exp(s_L - s) dt B)^T X, from zero;
//      (b) ssd_state_pass: h_c = exp(s_L,c) h_{c-1} + Hc_c, a short
//          sequential scan over chunks run by one thread per (b, h, n, p)
//          element; it overwrites Hc_c in place with the state entering
//          chunk c and writes the final h;
//      (c) ssd_chunk_out: per chunk y = W.X + exp(s) (C.h_prev).
//    4 x 64 x 16 = 4096 blocks for (a) and (c) at the prefill shape, 8192
//    at 1 x 32768.  The scratch (the wrapper allocates it, the kernels
//    allocate nothing) is Hc / h_prev (Bt, nc, H, N, P) fp32 and s
//    (Bt, H, nc, L) fp32.
//  * No tensor cores.  bf16 inputs run every product as mma.sync m16n8k16
//    bf16 x bf16 -> fp32 (8 warps per block):
//      - G = C.B^T: bf16 fragments straight into mma; a product of two
//        bf16 values is exact in fp32.
//      - W, h_prev and the state update's weights exp(s_L - s_u) dt_u B_u
//        are fp32.  Each is split exactly into three bf16 terms (split3,
//        common.cuh), so each of those products is three mma of exact
//        bf16 products into one fp32 accumulator: the fp32 function up to
//        the order of its sums.  Rounding them to one bf16 term would
//        change the function.
//      - W is built in registers from the G accumulator fragment, masked,
//        split and fed to W.X as the A fragment (the FlashAttention-2
//        relayout): it never goes through shared memory.  The weighted B
//        of (a) is formed the same way from an ldmatrix.trans fragment of
//        B; h_prev is split into three bf16 planes in shared memory.
//    fp32 and fp16 inputs keep fp32 FMAs on the CUDA cores (the first
//    kernel's register tiles, now over the same three passes): a bf16 mma
//    would round fp32 operands, and fp16's narrow range has no exact
//    three-term split.
//  * G once per head.  G is recomputed per head in (c), on the tensor
//    cores: that is 17.2 G multiply-adds more at the prefill shape, 0.035
//    ms at 989 TFLOP/s, where keeping it in an (Bt, nc, L, L) fp32
//    scratch would have every head read its triangle back, 539 MB per
//    call (0.16 ms at 3.35 TB/s, and L2 does not hold it).
//  * No overlap of loads.  The B, C and x tiles are staged bf16 with
//    cp.async into a two-stage ring: tile k + 1 is in flight while tile k
//    is multiplied.  Staged rows are padded by 16 bytes to an odd number
//    of 16-byte units, so ldmatrix reads them without bank conflicts.
//    (Rows that are not 16-byte aligned, or N or P not a multiple of 8,
//    are staged with plain loads at the same place in the ring.)
//
// Tiles: (a) 64 rows of u per staged tile, each warp 16 state rows n
// (N padded to a multiple of 16 with zeros) by all of P (padded to 16).
// (c) 128 rows of t per output tile (a warp owns 16) against 64-row
// tiles of u; a warp skips the u tiles and 16-column slices above its
// last row.  Tails are zero: rows past the chunk's data are read as zero
// with dt = 0, so they add nothing and are never written.  Occupancy:
// (a) holds two blocks of 8 warps per SM; so does (c), whose latency
// from G to W to W.X only other warps can hide: h_prev's planes and the
// u ring take turns in one region of its shared memory (92 KB at full
// width), and its C fragments are read from the staged tile where they
// are used rather than kept (128 registers).
//
// Every sum runs in a fixed order (the chunk cumsum as per-lane runs plus
// a shuffle scan, the products in a fixed mma order, the state pass over
// chunks in order) and there are no atomics: two launches give the same
// bits.  Built without --use_fast_math (expf).
//
// Plain C interface, bound with ctypes: pointers are raw device
// addresses, strides are in elements, the stream is the caller's current
// CUDA stream, and the launcher returns a CUDA error code (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr size_t kMaxSmem = 232448; // what one block may opt into
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kPassThreads = 256;   // (b): threads per block

// dtype codes shared with repro_torch/kernels/ssd_scan.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
// the three passes, as ssd_scan_kernel_info numbers them
enum Pass { kState = 0, kStatePass = 1, kOut = 2 };

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* h;
  float* hc;     // (Bt, nc, H, N, P): Hc, then h entering each chunk
  float* sc;     // (Bt, H, nc, L): s of every chunk
  long long S;
  int H, P, N, L, nc;
  int v16;       // bf16 staging by cp.async 16 (see ssd_scan_launch)
  long long sx_b, sx_t, sx_h, sx_p;
  long long sdt_b, sdt_t, sdt_h;
  long long sB_b, sB_t, sB_n;
  long long sC_b, sC_t, sC_n;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Inclusive cumsum of dt * A over the chunk, by warp 0 in a fixed order:
// each lane runs over its own slice, then a shuffle scan of the slices'
// totals adds each lane's offset.
__device__ void chunk_cumsum(const float* Ds, float* Ss, float A, int L,
                             int lane) {
  const int per = (L + 31) / 32;
  const int lo = min(lane * per, L), hi = min(lo + per, L);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += Ds[t] * A;
    Ss[t] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int t = lo; t < hi; ++t) Ss[t] += excl;
}

// Ds[t] = dt_t for the Lc rows with data, 0 up to n; then warp 0 forms
// Ss = cumsum(Ds * A) over the L rows of the chunk.  Ends synchronised.
__device__ void chunk_decay(float* Ds, float* Ss, const float* dt,
                            long long sdt_t, float A, int Lc, int L, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    Ds[t] = t < Lc ? dt[t * sdt_t] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(Ds, Ss, A, L, threadIdx.x);
  __syncthreads();
}

// ---------------------------------------------------------------- (b)

// One thread per element (n, p) of one (b, h) state: over the chunks in
// order, Hc_c is replaced by the state entering chunk c and the state is
// carried on, h = exp(s_L,c) h + Hc_c.  The loads of kAhead chunks are
// issued before the carried product uses the first of them.
constexpr int kAhead = 16;

__global__ void __launch_bounds__(kPassThreads) ssd_state_pass(Args a) {
  const int NP = a.N * a.P;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= NP) return;
  const int hd = blockIdx.y;
  const long long b = blockIdx.z;
  const long long cs = (long long)a.H * NP;            // chunk stride
  float* hc = a.hc + (b * a.nc * a.H + hd) * (long long)NP + e;
  const float* sl = a.sc + (b * a.H + hd) * (long long)a.nc * a.L + a.L - 1;
  float h = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += kAhead) {
    float v[kAhead], d[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c0 + q < a.nc) {
        v[q] = hc[(c0 + q) * cs];
        d[q] = expf(sl[(long long)(c0 + q) * a.L]);
      }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c0 + q < a.nc) {
        hc[(c0 + q) * cs] = h;
        h = d[q] * h + v[q];
      }
  }
  a.h[(b * a.H + hd) * NP + e] = h;
}

// ------------------------------------------------- fp32 and fp16 bodies

constexpr int kTile = 64;           // rows of t or u per tile
constexpr int kSide = 16;           // threads are a 16 x 16 grid
constexpr int kThreads = kSide * kSide;
constexpr int kTI = kTile / kSide;  // 4
constexpr int kNI = kMaxN / kSide;  // 8
constexpr int kLdw = kTile + 4;     // row stride of the W tile (17 x 4)

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float to(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half from(float v) {
    return __float2half_rn(v);
  }
};

// N rounded up to a multiple of 4, and the row stride of staged B and C:
// 4 x an odd number of floats, so 8 threads reading 16 bytes from 8
// consecutive rows hit 8 distinct bank groups.
__host__ __device__ inline int row_stride(int N) {
  const int n4 = round_up(N, 4);
  return n4 + ((n4 / 4) % 2 == 0 ? 4 : 8);
}

// (a): B and x tiles, s and dt of the chunk, the u weights of a tile
size_t state_floats(int N, int L) {
  return (size_t)kTile * row_stride(N) + (size_t)kTile * kMaxP +
         2 * (size_t)L + kTile;
}
// (c): the state, C, B, x and W tiles, s and dt of the chunk
size_t out_floats(int N, int L) {
  return (size_t)round_up(N, 4) * kMaxP + 2 * (size_t)kTile * row_stride(N) +
         (size_t)kTile * kMaxP + (size_t)kTile * kLdw + 2 * (size_t)L;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[q] += s * v[q]
__device__ __forceinline__ void fma4(float (&acc)[4], float s, float4 v) {
  acc[0] += s * v.x;
  acc[1] += s * v.y;
  acc[2] += s * v.z;
  acc[3] += s * v.w;
}

// rows [row0, row0 + rows) of a (., cols) strided source into a
// (kTile, width) fp32 tile with row stride ld, width <= 16 * CPT; rows
// past `rows` and columns past `cols` are zero.  Thread (ty, tx) moves
// rows ty + 16 k and columns tx + 16 m: all its loads are issued before
// any store, so their latency is paid once per tile, not once per value.
template <typename T, int CPT>
__device__ void stage(float* dst, int ld, const T* src, long long s_row,
                      long long s_col, long long row0, int rows, int cols,
                      int width, int ty, int tx) {
  float v[kTI][CPT];
#pragma unroll
  for (int k = 0; k < kTI; ++k) {
    const int r = ty + kSide * k;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = tx + kSide * m;
      v[k][m] = r < rows && c < cols
                    ? Cvt<T>::to(src[(row0 + r) * s_row + c * s_col])
                    : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kTI; ++k)
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int c = tx + kSide * m;
      if (c < width) dst[(ty + kSide * k) * ld + c] = v[k][m];
    }
}

// (a) on the CUDA cores: one block of 16 x 16 threads per (chunk, head,
// batch row); thread (ty, tx) owns state rows ty + 16 i, columns 4 tx ..
// 4 tx + 3.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(Args a) {
  const int c = blockIdx.x, hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int N = a.N, P = a.P, L = a.L;
  const int N4 = round_up(N, 4), ldb = row_stride(N), p0 = 4 * tx;
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);   // rows with data

  extern __shared__ float4 sm4[];   // float4: 16-byte aligned
  float* Bs = reinterpret_cast<float*>(sm4);  // (kTile, ldb) B rows
  float* Xs = Bs + kTile * ldb;     // (kTile, kMaxP) x rows
  float* Ss = Xs + kTile * kMaxP;   // (L) cumsum of dt * A
  float* Ds = Ss + L;               // (L) dt, 0 past the data
  float* Us = Ds + L;               // (kTile) exp(s_L - s_u) * dt_u

  const T* x = static_cast<const T*>(a.x) + b * a.sx_b + hd * a.sx_h;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sB_b;
  chunk_decay(Ds, Ss, a.dt + b * a.sdt_b + hd * a.sdt_h + c0 * a.sdt_t,
              a.sdt_t, a.A[hd], Lc, L, L);
  float* sc = a.sc + ((b * a.H + hd) * a.nc + c) * (long long)L;
  for (int t = tid; t < L; t += kThreads) sc[t] = Ss[t];
  const float s_last = Ss[L - 1];

  // hacc[i][q] is state row n = ty + 16 i, column p0 + q
  float hacc[kNI][4];
#pragma unroll
  for (int i = 0; i < kNI; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) hacc[i][q] = 0.f;
  for (int u0 = 0; u0 < Lc; u0 += kTile) {
    const int nu = min(kTile, Lc - u0);
    __syncthreads();
    stage<T, kNI>(Bs, ldb, Bg, a.sB_t, a.sB_n, c0 + u0, nu, N, N4, ty, tx);
    stage<T, kMaxP / kSide>(Xs, kMaxP, x, a.sx_t, a.sx_p, c0 + u0, nu, P,
                            kMaxP, ty, tx);
    for (int u = tid; u < nu; u += kThreads)
      Us[u] = expf(s_last - Ss[u0 + u]) * Ds[u0 + u];
    __syncthreads();
    for (int u = 0; u < nu; ++u) {
      const float wu = Us[u];
      const float4 xv = ld4(Xs + u * kMaxP + p0);
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int n = ty + kSide * i;
        fma4(hacc[i], n < N ? wu * Bs[u * ldb + n] : 0.f, xv);
      }
    }
  }
  float* hc = a.hc + ((b * a.nc + c) * a.H + hd) * (long long)N * P;
#pragma unroll
  for (int i = 0; i < kNI; ++i) {
    const int n = ty + kSide * i;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p0 + q < P) hc[n * P + p0 + q] = hacc[i][q];
  }
}

// (c) on the CUDA cores: one block of 16 x 16 threads per (chunk, head,
// batch row) with the chunk's entering state in shared memory.  A tile of
// 64 rows of t: the C rows are staged once, then every tile of u <= t
// stages its B and x rows and a (64, 64) tile of W.  Each thread computes
// a 4 x 4 register tile (rows ty + 16 i, columns 4 tx ..) and reads its
// operands 16 bytes at a time along the reduced axis.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_out(Args a) {
  const int c = blockIdx.x, hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int N = a.N, P = a.P, L = a.L;
  const int N4 = round_up(N, 4), ldb = row_stride(N), p0 = 4 * tx;
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);

  extern __shared__ float4 sm4[];
  float* Hs = reinterpret_cast<float*>(sm4);  // (N4, kMaxP) h entering
  float* Cs = Hs + N4 * kMaxP;      // (kTile, ldb) C rows of the t tile
  float* Bs = Cs + kTile * ldb;     // (kTile, ldb) B rows of the u tile
  float* Xs = Bs + kTile * ldb;     // (kTile, kMaxP) x rows of the u tile
  float* Ws = Xs + kTile * kMaxP;   // (kTile, kLdw) W tile
  float* Ss = Ws + kTile * kLdw;    // (L) cumsum of dt * A
  float* Ds = Ss + L;               // (L) dt, 0 past the data

  const T* x = static_cast<const T*>(a.x) + b * a.sx_b + hd * a.sx_h;
  const float* dt = a.dt + b * a.sdt_b + hd * a.sdt_h + c0 * a.sdt_t;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sB_b;
  const T* Cg = static_cast<const T*>(a.C) + b * a.sC_b;
  const long long y_t = (long long)a.H * P;
  T* y = static_cast<T*>(a.y) + ((b * a.S + c0) * a.H + hd) * P;
  const float* hp = a.hc + ((b * a.nc + c) * a.H + hd) * (long long)N * P;
  const float* sc = a.sc + ((b * a.H + hd) * a.nc + c) * (long long)L;

  for (int e = tid; e < N4 * kMaxP; e += kThreads) {
    const int n = e / kMaxP, p = e % kMaxP;
    Hs[e] = n < N && p < P ? hp[n * P + p] : 0.f;
  }
  for (int t = tid; t < L; t += kThreads) {
    Ss[t] = sc[t];
    Ds[t] = t < Lc ? dt[t * a.sdt_t] : 0.f;
  }

  for (int t0 = 0; t0 < Lc; t0 += kTile) {
    __syncthreads();
    stage<T, kNI>(Cs, ldb, Cg, a.sC_t, a.sC_n, c0 + t0,
                  min(kTile, Lc - t0), N, N4, ty, tx);
    __syncthreads();
    // inter-chunk term: exp(s_t) * (C_t . h); acc[i][q] is row
    // ty + 16 i, column p0 + q
    float acc[kTI][4];
#pragma unroll
    for (int i = 0; i < kTI; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    for (int n = 0; n < N4; n += 4) {
      float4 cv[kTI];
#pragma unroll
      for (int i = 0; i < kTI; ++i)
        cv[i] = ld4(Cs + (ty + kSide * i) * ldb + n);
      const float4 h0 = ld4(Hs + (n + 0) * kMaxP + p0);
      const float4 h1 = ld4(Hs + (n + 1) * kMaxP + p0);
      const float4 h2 = ld4(Hs + (n + 2) * kMaxP + p0);
      const float4 h3 = ld4(Hs + (n + 3) * kMaxP + p0);
#pragma unroll
      for (int i = 0; i < kTI; ++i) {
        fma4(acc[i], cv[i].x, h0);
        fma4(acc[i], cv[i].y, h1);
        fma4(acc[i], cv[i].z, h2);
        fma4(acc[i], cv[i].w, h3);
      }
    }
#pragma unroll
    for (int i = 0; i < kTI; ++i) {
      const float e = expf(Ss[min(t0 + ty + kSide * i, L - 1)]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] *= e;
    }
    // intra-chunk term over the tiles of u <= t
    for (int u0 = 0; u0 <= t0; u0 += kTile) {
      const int nu = min(kTile, Lc - u0);
      __syncthreads();
      stage<T, kNI>(Bs, ldb, Bg, a.sB_t, a.sB_n, c0 + u0, nu, N, N4,
                    ty, tx);
      stage<T, kMaxP / kSide>(Xs, kMaxP, x, a.sx_t, a.sx_p, c0 + u0, nu,
                              P, kMaxP, ty, tx);
      __syncthreads();
      // g[i][j] = C_t . B_u for t = t0 + ty + 16 i, u = u0 + tx + 16 j
      float g[kTI][kTI];
#pragma unroll
      for (int i = 0; i < kTI; ++i)
#pragma unroll
        for (int j = 0; j < kTI; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N4; n += 4) {
        float4 cv[kTI], bv[kTI];
#pragma unroll
        for (int i = 0; i < kTI; ++i) {
          cv[i] = ld4(Cs + (ty + kSide * i) * ldb + n);
          bv[i] = ld4(Bs + (tx + kSide * i) * ldb + n);
        }
#pragma unroll
        for (int i = 0; i < kTI; ++i)
#pragma unroll
          for (int j = 0; j < kTI; ++j) {
            g[i][j] += cv[i].x * bv[j].x;
            g[i][j] += cv[i].y * bv[j].y;
            g[i][j] += cv[i].z * bv[j].z;
            g[i][j] += cv[i].w * bv[j].w;
          }
      }
#pragma unroll
      for (int i = 0; i < kTI; ++i) {
        const int t = t0 + ty + kSide * i;
#pragma unroll
        for (int j = 0; j < kTI; ++j) {
          const int u = u0 + tx + kSide * j;
          float w = 0.f;
          if (u <= t && t < Lc)  // masked before exp: no overflow
            w = g[i][j] * expf(Ss[t] - Ss[u]) * Ds[u];
          Ws[(ty + kSide * i) * kLdw + tx + kSide * j] = w;
        }
      }
      __syncthreads();
      // rows of W past nu are 0 and rows of x past nu are staged as 0
      for (int u = 0; u < round_up(nu, 4); u += 4) {
        float4 wv[kTI];
#pragma unroll
        for (int i = 0; i < kTI; ++i)
          wv[i] = ld4(Ws + (ty + kSide * i) * kLdw + u);
        const float4 x0 = ld4(Xs + (u + 0) * kMaxP + p0);
        const float4 x1 = ld4(Xs + (u + 1) * kMaxP + p0);
        const float4 x2 = ld4(Xs + (u + 2) * kMaxP + p0);
        const float4 x3 = ld4(Xs + (u + 3) * kMaxP + p0);
#pragma unroll
        for (int i = 0; i < kTI; ++i) {
          fma4(acc[i], wv[i].x, x0);
          fma4(acc[i], wv[i].y, x1);
          fma4(acc[i], wv[i].z, x2);
          fma4(acc[i], wv[i].w, x3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTI; ++i) {
      const int t = t0 + ty + kSide * i;
      if (t >= Lc) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p0 + q < P) y[t * y_t + p0 + q] = Cvt<T>::from(acc[i][q]);
    }
  }
}

// ------------------------------------------------------------ bf16 body

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;    // 8 warps
constexpr int kTU = 64;             // rows of u per staged tile
constexpr int kTT = 128;            // rows of t per output tile (8 x 16)

// (a): two stages of B and x tiles; dt, s and the u weights of the chunk
// (rows padded to kTT)
size_t mma_state_bytes(int N, int P, int L) {
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  return 2 * sizeof(bf16) * kTU * ((size_t)ld_bf(Np) + ld_bf(Pp)) +
         3 * sizeof(float) * (size_t)round_up(L, kTT);
}
// (c): a C tile; the three bf16 planes of h_prev, then (in the same
// place) two stages of B and x tiles; dt and s of the chunk
__host__ __device__ inline int out_union(int Np, int Pp) {
  const int planes = 3 * Np * ld_bf(Pp), ring = 2 * kTU * (ld_bf(Np) + ld_bf(Pp));
  return planes > ring ? planes : ring;
}
size_t mma_out_bytes(int N, int P, int L) {
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  return sizeof(bf16) * ((size_t)kTT * ld_bf(Np) + out_union(Np, Pp)) +
         2 * sizeof(float) * (size_t)round_up(L, kTT);
}

// (a) on the tensor cores: one block of 8 warps per (chunk, head, batch
// row).  Warp w owns state rows n in [16 w, 16 w + 16) and all of P:
//   Hc[n, p] = sum_u (w_u B[u, n]) x[u, p],   w_u = exp(s_L - s_u) dt_u
// as an (N x L) . (L x P) product.  The A fragment (w B)^T comes from an
// ldmatrix.trans of the staged B rows; each fp32 product w_u B[u, n] is
// split into three bf16 terms, each an mma against the x fragments.
__global__ void __launch_bounds__(kMmaThreads) ssd_chunk_state_mma(Args a) {
  const int c = blockIdx.x, hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lrow = lane & 7, lmat = lane >> 3;
  const int N = a.N, P = a.P, L = a.L;
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  const int LDN = ld_bf(Np), LDP = ld_bf(Pp), Lt = round_up(L, kTT);
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);

  extern __shared__ uint4 smem_u4[];   // uint4: 16-byte aligned
  bf16* Bs = reinterpret_cast<bf16*>(smem_u4);   // 2 x (kTU, LDN)
  bf16* Xs = Bs + 2 * kTU * LDN;                 // 2 x (kTU, LDP)
  float* Ds = reinterpret_cast<float*>(Xs + 2 * kTU * LDP);  // (Lt)
  float* Ss = Ds + Lt;                           // (Lt)
  float* Ws = Ss + Lt;                           // (Lt) u weights

  const bf16* x = static_cast<const bf16*>(a.x) + b * a.sx_b + hd * a.sx_h +
                  c0 * a.sx_t;
  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.sB_b + c0 * a.sB_t;

  if (a.v16) {
    zero_cols(Bs, LDN, 2 * kTU, N, Np);
    zero_cols(Xs, LDP, 2 * kTU, P, Pp);
  }
  const int nu = (Lc + kTU - 1) / kTU;     // u tiles with data
  stage_bf(Bs, LDN, Bg, a.sB_t, a.sB_n, kTU, Lc, N, Np, a.v16);
  stage_bf(Xs, LDP, x, a.sx_t, a.sx_p, kTU, Lc, P, Pp, a.v16);
  cp_async_commit();

  chunk_decay(Ds, Ss, a.dt + b * a.sdt_b + hd * a.sdt_h + c0 * a.sdt_t,
              a.sdt_t, a.A[hd], Lc, L, Lt);
  float* sc = a.sc + ((b * a.H + hd) * a.nc + c) * (long long)L;
  const float s_last = Ss[L - 1];
  for (int t = tid; t < Lt; t += kMmaThreads) {
    if (t < L) sc[t] = Ss[t];
    Ws[t] = t < Lc ? expf(s_last - Ss[t]) * Ds[t] : 0.f;
  }

  const int n0 = 16 * warp;
  const bool active = n0 < Np;
  const int npt = Pp / 8;                  // n-tiles of 8 columns of P
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k = 0; k < nu; ++k) {
    const int st = k & 1;
    if (k + 1 < nu) {
      const int r1 = (k + 1) * kTU;
      stage_bf(Bs + (st ^ 1) * kTU * LDN, LDN, Bg + r1 * a.sB_t, a.sB_t,
               a.sB_n, kTU, Lc - r1, N, Np, a.v16);
      stage_bf(Xs + (st ^ 1) * kTU * LDP, LDP, x + r1 * a.sx_t, a.sx_t,
               a.sx_p, kTU, Lc - r1, P, Pp, a.v16);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile k (and, at k = 0, Ws) visible to all
    if (active) {
      const bf16* Bt = Bs + st * kTU * LDN;
      const bf16* Xt = Xs + st * kTU * LDP;
#pragma unroll
      for (int j = 0; j < kTU / 16; ++j) {
        const int u0 = k * kTU + 16 * j;   // chunk row of the slice
        if (u0 >= Lc) break;
        // matrix m holds u = u0 + (m >> 1) * 8 .., n = n0 + (m & 1) * 8 ..
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, smem_addr(Bt + (16 * j + (lmat >> 1) * 8 +
                                              lrow) * LDN +
                                        n0 + (lmat & 1) * 8));
        uint32_t w1[4], w2[4], w3[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int u = u0 + (m >> 1) * 8 + 2 * t4;
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&bb[m]));
          split3(f.x * Ws[u], f.y * Ws[u + 1], w1[m], w2[m], w3[m]);
        }
        uint32_t xv[4][4];
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
          if (2 * dp < npt)
            ldmatrix_x4_trans(xv[dp], smem_addr(Xt + (16 * j + (lmat & 1) * 8 +
                                                      lrow) * LDP +
                                                dp * 16 + (lmat >> 1) * 8));
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
          if (2 * dp < npt) {
            mma_bf16(acc[2 * dp], w1, xv[dp][0], xv[dp][1]);
            mma_bf16(acc[2 * dp + 1], w1, xv[dp][2], xv[dp][3]);
          }
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
          if (2 * dp < npt) {
            mma_bf16(acc[2 * dp], w2, xv[dp][0], xv[dp][1]);
            mma_bf16(acc[2 * dp + 1], w2, xv[dp][2], xv[dp][3]);
          }
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
          if (2 * dp < npt) {
            mma_bf16(acc[2 * dp], w3, xv[dp][0], xv[dp][1]);
            mma_bf16(acc[2 * dp + 1], w3, xv[dp][2], xv[dp][3]);
          }
      }
    }
    __syncthreads();   // stage st is refilled at the next iteration
  }

  // element (j, e) is state row n0 + g + 8 (e >> 1), column 8 j + 2 t4 +
  // (e & 1)
  if (!active) return;
  float* hc = a.hc + ((b * a.nc + c) * a.H + hd) * (long long)N * P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + 8 * (e >> 1), p = 8 * j + 2 * t4 + (e & 1);
      if (n < N && p < P) hc[n * P + p] = acc[j][e];
    }
}

// (c) on the tensor cores: one block of 8 warps per (chunk, head, batch
// row), two blocks per SM.  Per tile of 128 rows of t, warp w owns rows
// T0 + 16 w .. + 15:
//   acc  = exp(s_t) * sum_q C_t . h_q                 (3 mma per step)
//   for each 64-row tile of u up to its last row, in two halves of 32:
//     G  = C_t . B_u^T                                (fp32 accumulators)
//     W  = G * exp(s_t - s_u) * dt_u for u <= t, in registers, split into
//          three bf16 A fragments
//     acc += sum_q W_q . x_u                          (3 mma per step)
// h_prev is split into its three bf16 planes at the start of each t tile,
// in the shared memory that the u tiles' ring takes over once the
// inter-chunk term has read them; the C fragments are read from the
// staged C tile where they are used.  That keeps a block to 92 KB of
// shared memory and its threads to 128 registers.
__global__ void __launch_bounds__(kMmaThreads, 2) ssd_chunk_out_mma(Args a) {
  const int c = blockIdx.x, hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lrow = lane & 7, lmat = lane >> 3;
  const int N = a.N, P = a.P, L = a.L;
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  const int LDN = ld_bf(Np), LDP = ld_bf(Pp), Lt = round_up(L, kTT);
  const int nk = Np / 16, npt = Pp / 8;
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);

  extern __shared__ uint4 smem_u4[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_u4);   // (kTT, LDN)
  bf16* Us = Cs + kTT * LDN;                     // h planes, then the ring
  bf16* Hs = Us;                                 // 3 x (Np, LDP)
  bf16* Bs = Us;                                 // 2 x (kTU, LDN)
  bf16* Xs = Us + 2 * kTU * LDN;                 // 2 x (kTU, LDP)
  float* Ds = reinterpret_cast<float*>(Us + out_union(Np, Pp));  // (Lt)
  float* Ss = Ds + Lt;                           // (Lt)

  const bf16* x = static_cast<const bf16*>(a.x) + b * a.sx_b + hd * a.sx_h +
                  c0 * a.sx_t;
  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.sB_b + c0 * a.sB_t;
  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.sC_b + c0 * a.sC_t;
  const float* dt = a.dt + b * a.sdt_b + hd * a.sdt_h + c0 * a.sdt_t;
  const float* hp = a.hc + ((b * a.nc + c) * a.H + hd) * (long long)N * P;
  const float* sc = a.sc + ((b * a.H + hd) * a.nc + c) * (long long)L;
  const long long y_t = (long long)a.H * P;
  bf16* y = static_cast<bf16*>(a.y) + ((b * a.S + c0) * a.H + hd) * P;

  if (a.v16) zero_cols(Cs, LDN, kTT, N, Np);
  for (int t = tid; t < Lt; t += kMmaThreads) {
    Ds[t] = t < Lc ? dt[t * a.sdt_t] : 0.f;
    Ss[t] = t < L ? sc[t] : 0.f;
  }

  const bool pairs = (P & 1) == 0;   // y rows hold whole bf16 pairs
  for (int T0 = 0; T0 < Lc; T0 += kTT) {
    const int nu = (min(T0 + kTT, Lc) + kTU - 1) / kTU;
    stage_bf(Cs, LDN, Cg + T0 * a.sC_t, a.sC_t, a.sC_n, kTT, Lc - T0, N, Np,
             a.v16);
    cp_async_commit();
    // h_prev (fp32) as three exact bf16 planes, zero in the padding
    for (int e = tid; e < Np * Pp / 2; e += kMmaThreads) {
      const int n = e / (Pp / 2), p = 2 * (e % (Pp / 2));
      const bool okn = n < N;
      const float v0 = okn && p < P ? hp[n * P + p] : 0.f;
      const float v1 = okn && p + 1 < P ? hp[n * P + p + 1] : 0.f;
      uint32_t q1, q2, q3;
      split3(v0, v1, q1, q2, q3);
      uint32_t* row = reinterpret_cast<uint32_t*>(Hs + n * LDP + p);
      row[0] = q1;
      row[Np * LDP / 2] = q2;
      row[Np * LDP] = q3;
    }
    cp_async_wait<0>();
    __syncthreads();

    const int r0 = T0 + 16 * warp;          // this warp's first row
    const bool active = r0 < Lc;
    const int rl = min(r0 + 15, Lc - 1);    // its last row with data
    const int t_lo = r0 + g, t_hi = r0 + g + 8;
    // the C fragment of N slice kk: matrices (rows 0-7 | 8-15) x (n 0-7 |
    // 8-15)
    const uint32_t c_addr = smem_addr(Cs + (16 * warp + lrow + (lmat & 1) * 8) *
                                               LDN + (lmat >> 1) * 8);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    if (active) {
      // inter-chunk term: C_t . h_prev, the three planes in turn
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nk) break;
        uint32_t cf[4];
        ldmatrix_x4(cf, c_addr + kk * 32);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const bf16* Hq = Hs + q * Np * LDP;
#pragma unroll
          for (int dp = 0; dp < 4; ++dp)
            if (2 * dp < npt) {
              uint32_t hv[4];
              ldmatrix_x4_trans(hv, smem_addr(Hq + (kk * 16 + (lmat & 1) * 8 +
                                                    lrow) * LDP +
                                              dp * 16 + (lmat >> 1) * 8));
              mma_bf16(acc[2 * dp], cf, hv[0], hv[1]);
              mma_bf16(acc[2 * dp + 1], cf, hv[2], hv[3]);
            }
        }
      }
      const float e0 = expf(Ss[t_lo]), e1 = expf(Ss[t_hi]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    __syncthreads();   // the planes are read: the ring takes their place
    if (a.v16) {
      zero_cols(Bs, LDN, 2 * kTU, N, Np);
      zero_cols(Xs, LDP, 2 * kTU, P, Pp);
    }
    stage_bf(Bs, LDN, Bg, a.sB_t, a.sB_n, kTU, Lc, N, Np, a.v16);
    stage_bf(Xs, LDP, x, a.sx_t, a.sx_p, kTU, Lc, P, Pp, a.v16);
    cp_async_commit();

    for (int k = 0; k < nu; ++k) {
      const int st = k & 1;
      if (k + 1 < nu) {
        const int r1 = (k + 1) * kTU;
        stage_bf(Bs + (st ^ 1) * kTU * LDN, LDN, Bg + r1 * a.sB_t, a.sB_t,
                 a.sB_n, kTU, Lc - r1, N, Np, a.v16);
        stage_bf(Xs + (st ^ 1) * kTU * LDP, LDP, x + r1 * a.sx_t, a.sx_t,
                 a.sx_p, kTU, Lc - r1, P, Pp, a.v16);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* Bt = Bs + st * kTU * LDN;
      const bf16* Xt = Xs + st * kTU * LDP;

#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int u0 = k * kTU + 32 * hf;
        if (!active || u0 > rl) break;
        // G = C_t . B_u^T for the 8-column slices of these 32 u that reach
        // row rl; element (j, e) is row t_lo / t_hi (e >> 1), u = u0 + 8 j
        // + 2 t4 + (e & 1)
        float gacc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk >= nk) break;
          uint32_t cf[4];
          ldmatrix_x4(cf, c_addr + kk * 32);
#pragma unroll
          for (int np = 0; np < 2; ++np)
            if (u0 + 16 * np <= rl) {
              // matrices: u (0-7 | 8-15 of the pair) x n (0-7 | 8-15)
              uint32_t bk[4];
              ldmatrix_x4(bk, smem_addr(Bt + (32 * hf + np * 16 +
                                              (lmat >> 1) * 8 + lrow) * LDN +
                                        kk * 16 + (lmat & 1) * 8));
              mma_bf16(gacc[2 * np], cf, bk[0], bk[1]);
              mma_bf16(gacc[2 * np + 1], cf, bk[2], bk[3]);
            }
        }
        // W . x per slice of 16 u: n-tiles 2 j and 2 j + 1 of G are the A
        // fragment, masked before the exp and split into three bf16 terms
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (u0 + 16 * j > rl) break;
          uint32_t w1[4], w2[4], w3[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int nt = 2 * j + (m >> 1);
            const int t = (m & 1) ? t_hi : t_lo;
            const int u = u0 + 8 * nt + 2 * t4;
            const bool live = t < Lc;
            const float st_ = Ss[t];
            const float v0 = live && u <= t
                                 ? gacc[nt][2 * (m & 1)] *
                                       expf(st_ - Ss[u]) * Ds[u]
                                 : 0.f;
            const float v1 = live && u + 1 <= t
                                 ? gacc[nt][2 * (m & 1) + 1] *
                                       expf(st_ - Ss[u + 1]) * Ds[u + 1]
                                 : 0.f;
            split3(v0, v1, w1[m], w2[m], w3[m]);
          }
          const int js = 2 * hf + j;        // the slice within the tile
          uint32_t xv[4][4];
#pragma unroll
          for (int dp = 0; dp < 4; ++dp)
            if (2 * dp < npt)
              ldmatrix_x4_trans(xv[dp],
                                smem_addr(Xt + (16 * js + (lmat & 1) * 8 +
                                                lrow) * LDP +
                                          dp * 16 + (lmat >> 1) * 8));
#pragma unroll
          for (int dp = 0; dp < 4; ++dp)
            if (2 * dp < npt) {
              mma_bf16(acc[2 * dp], w1, xv[dp][0], xv[dp][1]);
              mma_bf16(acc[2 * dp + 1], w1, xv[dp][2], xv[dp][3]);
            }
#pragma unroll
          for (int dp = 0; dp < 4; ++dp)
            if (2 * dp < npt) {
              mma_bf16(acc[2 * dp], w2, xv[dp][0], xv[dp][1]);
              mma_bf16(acc[2 * dp + 1], w2, xv[dp][2], xv[dp][3]);
            }
#pragma unroll
          for (int dp = 0; dp < 4; ++dp)
            if (2 * dp < npt) {
              mma_bf16(acc[2 * dp], w3, xv[dp][0], xv[dp][1]);
              mma_bf16(acc[2 * dp + 1], w3, xv[dp][2], xv[dp][3]);
            }
        }
      }
      __syncthreads();   // stage st (and at the end Cs and the ring) is
                         // refilled next
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? t_hi : t_lo;
        if (t >= Lc) continue;
        bf16* yr = y + t * y_t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * t4;
          if (p >= P) continue;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(yr + p) =
                __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
          } else {
            yr[p] = __float2bfloat16_rn(acc[j][2 * r]);
            if (p + 1 < P) yr[p + 1] = __float2bfloat16_rn(acc[j][2 * r + 1]);
          }
        }
      }
    }
  }
}

// --------------------------------------------------------------- launch

using Kern = void (*)(Args);

struct Plan {
  Kern fn[3];        // by Pass
  int threads[3];
  size_t smem[3];
};

// The three kernels for dtype at (N, P, L) with their shared memory opted
// into, or an error code (cudaErrorInvalidValue for what they cannot hold).
int plan(int dtype, int N, int P, int L, Plan* p) {
  if (dtype == kBF16) {
    *p = {{ssd_chunk_state_mma, ssd_state_pass, ssd_chunk_out_mma},
          {kMmaThreads, kPassThreads, kMmaThreads},
          {mma_state_bytes(N, P, L), 0, mma_out_bytes(N, P, L)}};
  } else if (dtype == kF32) {
    *p = {{ssd_chunk_state<float>, ssd_state_pass, ssd_chunk_out<float>},
          {kThreads, kPassThreads, kThreads},
          {state_floats(N, L) * sizeof(float), 0,
           out_floats(N, L) * sizeof(float)}};
  } else if (dtype == kF16) {
    *p = {{ssd_chunk_state<__half>, ssd_state_pass, ssd_chunk_out<__half>},
          {kThreads, kPassThreads, kThreads},
          {state_floats(N, L) * sizeof(float), 0,
           out_floats(N, L) * sizeof(float)}};
  } else {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 3; ++i) {
    if (p->smem[i] > kMaxSmem) return (int)cudaErrorInvalidValue;
    const cudaError_t rc = cudaFuncSetAttribute(
        p->fn[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p->smem[i]);
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

bool shape_ok(int P, int N, int L, int H) {
  return P >= 1 && P <= kMaxP && N >= 1 && N <= kMaxN && L >= 1 && H >= 1 &&
         H <= 65535;
}

}  // namespace

// Floats of scratch a call needs: Hc / h_prev (Bt, nc, H, N, P), then s
// (Bt, H, nc, L), nc = ceil(S / L).
extern "C" long long ssd_scan_scratch_floats(long long Bt, long long S, int H,
                                             int P, int N, int L) {
  const long long nc = (S + L - 1) / L;
  return Bt * nc * H * ((long long)N * P + L);
}

// strides: 13 element strides, in the order x (b, t, h, p), dt (b, t, h),
// B (b, t, n), C (b, t, n).  scratch: ssd_scan_scratch_floats floats.
// Launches (a), (b) and (c) on `stream`.  Returns cudaErrorInvalidValue,
// before launching anything, for shapes the kernels do not take (P > 64,
// N > 128, H or Bt > 65535, too much shared memory).
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* A, const void* B, const void* C,
                               int dtype, void* y, float* h, float* scratch,
                               long long Bt, long long S, int H, int P, int N,
                               int L, const long long* strides, void* stream) {
  if (!shape_ok(P, N, L, H) || Bt < 1 || Bt > 65535 || S < 1)
    return (int)cudaErrorInvalidValue;
  const long long nc = (S + L - 1) / L;
  if (nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Plan p;
  int rc = plan(dtype, N, P, L, &p);
  if (rc != 0) return rc;
  // bf16 tiles go by cp.async 16 when every staged row is 16-byte aligned:
  // the last axes contiguous, N and P multiples of 8, the other strides
  // multiples of 8 elements and the bases 16-byte aligned
  bool v16 = strides[3] == 1 && strides[9] == 1 && strides[12] == 1 &&
             N % 8 == 0 && P % 8 == 0;
  const int rows[] = {0, 1, 2, 7, 8, 10, 11};
  for (int i : rows) v16 = v16 && strides[i] % 8 == 0;
  v16 = v16 && ((reinterpret_cast<uintptr_t>(x) |
                 reinterpret_cast<uintptr_t>(B) |
                 reinterpret_cast<uintptr_t>(C)) & 15u) == 0;
  Args a{x, dt, A, B, C, y, h, scratch,
         scratch + Bt * nc * H * (long long)N * P, S, H, P, N, L, (int)nc,
         (int)v16,
         strides[0], strides[1], strides[2], strides[3],
         strides[4], strides[5], strides[6],
         strides[7], strides[8], strides[9],
         strides[10], strides[11], strides[12]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 chunks((unsigned)nc, (unsigned)H, (unsigned)Bt);
  const dim3 elems((unsigned)((N * P + kPassThreads - 1) / kPassThreads),
                   (unsigned)H, (unsigned)Bt);
  p.fn[kState]<<<chunks, p.threads[kState], p.smem[kState], st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  p.fn[kStatePass]<<<elems, p.threads[kStatePass], 0, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  p.fn[kOut]<<<chunks, p.threads[kOut], p.smem[kOut], st>>>(a);
  return (int)cudaGetLastError();
}

// The largest dynamic shared memory (bytes) of the three kernels for
// dtype at (N, P, L).
extern "C" size_t ssd_scan_smem_bytes(int dtype, int N, int P, int L) {
  size_t a, c;
  if (dtype == kBF16) {
    a = mma_state_bytes(N, P, L);
    c = mma_out_bytes(N, P, L);
  } else {
    a = state_floats(N, L) * sizeof(float);
    c = out_floats(N, L) * sizeof(float);
  }
  return a > c ? a : c;
}

// What the compiler made of pass `pass` (0: chunk states, 1: state pass,
// 2: chunk outputs) for dtype at (N, P, L): out[0..5] = registers per
// thread, local (spill) bytes per thread, static shared memory, dynamic
// shared memory (bytes), resident blocks per SM, threads per block.
// Returns a CUDA error code.
extern "C" int ssd_scan_kernel_info(int dtype, int pass, int N, int P, int L,
                                    long long* out) {
  if (!shape_ok(P, N, L, 1) || pass < 0 || pass > 2)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int rc = plan(dtype, N, P, L, &p);
  if (rc != 0) return rc;
  cudaFuncAttributes fa;
  rc = (int)cudaFuncGetAttributes(&fa, p.fn[pass]);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, p.fn[pass], p.threads[pass], p.smem[pass]);
  if (rc != 0) return rc;
  out[0] = fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  out[2] = (long long)fa.sharedSizeBytes;
  out[3] = (long long)p.smem[pass];
  out[4] = blocks;
  out[5] = p.threads[pass];
  return 0;
}
