// Backward of the Mamba2 SSD chunked scan (ssd_scan.cu), for sm_90a.
//
// Replaces no TPU kernel: the Pallas ssd_scan (src/repro/kernels/
// ssd_scan.py:83) defines no VJP, and the JAX package trains by
// differentiating its jnp oracle.  The port trains the ssm and hybrid
// families through ssd_scan's CUDA forward, and this is its gradient.
//
// Per batch row b, head h and chunk c of L rows, with A = A[h] < 0, s the
// within-chunk cumsum of dt A (s_L its last row), M[t,u] = exp(s_t - s_u)
// for u <= t and 0 otherwise, G[t,u] = C_t . B_u, Q[t,u] = dy_t . x_u,
// h_prev the state entering the chunk and dh the gradient of the state
// leaving it:
//
//   dH_c       = sum_t exp(s_t) C_t dy_t^T                           (a)
//   dh_{c-1}   = exp(s_L) dh_c + dH_c,  dh_{nc-1} = dh_final         (b)
//   dx_u       = sum_{t>=u} G M dt_u dy_t + exp(s_L - s_u) dt_u dh^T B_u
//   dB_u (h)   = sum_{t>=u} Q M dt_u C_t + exp(s_L - s_u) dt_u dh x_u
//   ddt_u      = sum_{t>=u} G M Q + exp(s_L - s_u) B_u . (dh x_u)   (direct)
//   dC_t (h)   = sum_{u<=t} Q M dt_u B_u + exp(s_t) h_prev dy_t      (c)
//   ds_t       = sum_{u<=t} G M dt_u Q + exp(s_t) C_t . (h_prev dy_t)
//                - dt_t ddt_t(direct)
//                + [t = last row] (sum_u dt_u ddt_u(state part)
//                                  + exp(s_L) <h_prev, dh>)
//   ddt_t     += A sum_{t'>=t} ds_t',  dA(h) = sum dt_t sum_{t'>=t} ds_t'
//   dB, dC     = sums of the per-head terms over the H heads           (d)
//
// Inputs x, B, C and dy in one dtype (fp32, bf16 or fp16) with any strides,
// dt fp32 strided, A (H,) fp32, dh_final (Bt, H, N, P) fp32 or null (zero),
// and the forward's scratch: the state entering every chunk (Bt, nc, H, N,
// P) and s (Bt, H, nc, L), which ssd_scan_launch leaves there.  Writes dx
// (Bt, S, H, P), dB and dC (Bt, S, N) contiguous in the input dtype, ddt
// (Bt, S, H) contiguous and dA (H,) fp32.  A ragged last chunk is masked:
// its missing rows are neither read nor written.  exp(s_t - s_u) is formed
// only for u <= t (finite at L = 256 and A = -16).
//
// Six launches on the caller's stream:
//   ssd_bwd_dstate     (a) per (chunk, head, row): dH_c into the scratch;
//   ssd_bwd_state_pass (b) one thread per state element, chunks in reverse
//                      order, dH_c replaced by the gradient of the state
//                      leaving chunk c;
//   ssd_bwd_rows_u     per (64-row tile of u, chunk, head, row): dx, the
//                      head's dB, ddt's direct part;
//   ssd_bwd_rows_t     per (64-row tile of t, chunk, head, row): the head's
//                      dC, ds's terms in t;
//   ssd_bwd_dlog       per (chunk, head, row): ds, its reverse cumsum, ddt,
//                      the chunk's part of dA;
//   ssd_bwd_head_sum   (d) dB and dC over the heads, dA over rows and chunks.
//
// What bounds it on an H100: operations.  At mamba2-1.3b's training shape
// (Bt 2, S 4096, H 64, P 64, N 128, L 256) the products are about 38 G
// multiply-adds (G and Q twice each, once for the u rows and once for the
// t rows), against 0.3 ms of bytes.  This first kernel runs them as fp32
// FMAs on the CUDA cores from 64-row tiles in shared memory (float4 reads,
// 4 x 8 register tiles per thread): a simple design, right first; tensor
// cores (the forward's split bf16 mma) are later work.
//
// Every sum runs in a fixed order and there are no atomics: the per-head
// dB and dC and the per-chunk dA go to the scratch and are summed in
// order by the last launch, so two launches give the same bits.  Built
// without --use_fast_math (expf).
//
// Plain C interface, bound with ctypes: pointers are raw device
// addresses, strides are in elements, the stream is the caller's current
// CUDA stream, and the launcher returns a CUDA error code (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // what one block may opt into
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kTile = 64;            // rows of t or u per tile
constexpr int kSide = 16;            // threads are a 16 x 16 grid
constexpr int kThreads = kSide * kSide;
constexpr int kLdT = kTile + 4;      // row stride of the (64, 64) W, V tiles

// dtype codes shared with repro_torch/kernels/ssd_scan.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
// the six launches, as ssd_scan_bwd_kernel_info numbers them
enum Pass { kDState = 0, kStatePass = 1, kRowsU = 2, kRowsT = 3, kDLog = 4,
            kHeadSum = 5, kPasses = 6 };

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
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  const float* dhf;    // (Bt, H, N, P) or null
  const float* hprev;  // forward scratch: (Bt, nc, H, N, P) entering states
  const float* sc;     // forward scratch: (Bt, H, nc, L) s of every chunk
  float* dhc;          // (Bt, nc, H, N, P): dH_c, then dh leaving chunk c
  float* dBp;          // (Bt, H, S, N) per-head dB
  float* dCp;          // (Bt, H, S, N) per-head dC
  float* dsp;          // (Bt, H, S) ds's terms in t
  float* ddts;         // (Bt, H, S) ddt's state part
  float* dAp;          // (Bt, H, nc) dA of each chunk
  void* dx;
  float* ddt;
  void* dB;
  void* dC;
  float* dA;
  long long Bt, S;
  int H, P, N, L, nc;
  long long sx_b, sx_t, sx_h, sx_p;
  long long sdt_b, sdt_t, sdt_h;
  long long sB_b, sB_t, sB_n;
  long long sC_b, sC_t, sC_n;
  long long sy_b, sy_t, sy_h, sy_p;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row stride of a staged tile of n columns: n rounded up to 4, plus 4 or
// 8 so that it is 4 x an odd number of floats (float4 reads of 8
// consecutive rows hit 8 distinct bank groups).
__host__ __device__ inline int row_stride(int n) {
  const int n4 = round_up(n, 4);
  return n4 + ((n4 / 4) % 2 == 0 ? 4 : 8);
}

// Floats of the region that holds W and V, or the scaled r of rows_u.
__host__ __device__ inline int wv_floats(int N) {
  const int wv = 2 * kTile * kLdT, r = kTile * row_stride(N);
  return wv > r ? wv : r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// acc[q] += s * v[q]
__device__ __forceinline__ void fma4(float (&acc)[4], float s, float4 v) {
  acc[0] += s * v.x;
  acc[1] += s * v.y;
  acc[2] += s * v.z;
  acc[3] += s * v.w;
}

// acc += u . v
__device__ __forceinline__ float dot4(float acc, float4 u, float4 v) {
  acc += u.x * v.x;
  acc += u.y * v.y;
  acc += u.z * v.z;
  acc += u.w * v.w;
  return acc;
}

// Rows [0, 64) of a strided (rows, cols) source into a (64, width) fp32
// tile with row stride ld, each row times scale[r] when scale is given;
// rows past `rows` and columns past `cols` are zero.
template <typename T>
__device__ void stage(float* dst, int ld, const T* src, long long s_row,
                      long long s_col, int rows, int cols, int width,
                      const float* scale) {
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width, c = i % width;
    float v = 0.f;
    if (r < rows && c < cols) {
      v = Cvt<T>::to(src[r * s_row + c * s_col]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ld + c] = v;
  }
}

// Sum of v over the block in a fixed tree order (red: kThreads floats);
// every thread gets it.  Called by every thread; ends synchronised.
__device__ float block_total(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// Sum of v over the 16 threads of one row of the 16 x 16 grid (a half
// warp), by a butterfly: every lane gets the same bits.
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The 64 x 64 tiles G[t][u] = Ct_t . Bu_u and Q[t][u] = Yt_t . Xu_u of the
// thread's rows t = ty + 16 i and columns u = tx + 16 j.
__device__ __forceinline__ void gq_tiles(const float* Ct, const float* Yt,
                                         const float* Bu, const float* Xu,
                                         int ldn, int ldp, int N4, int P4,
                                         int ty, int tx, float (&G)[4][4],
                                         float (&Q)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) G[i][j] = Q[i][j] = 0.f;
  for (int n = 0; n < N4; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = ld4(Ct + (ty + 16 * i) * ldn + n);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(Bu + (tx + 16 * j) * ldn + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) G[i][j] = dot4(G[i][j], cv[i], bv[j]);
  }
  for (int p = 0; p < P4; p += 4) {
    float4 yv[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[i] = ld4(Yt + (ty + 16 * i) * ldp + p);
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = ld4(Xu + (tx + 16 * j) * ldp + p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Q[i][j] = dot4(Q[i][j], yv[i], xv[j]);
  }
}

// s and dt of chunk c of (b, h) into Ss and Ds (dt 0 past the Lc rows
// with data).  Not synchronised.
__device__ void load_chunk(const Args& a, long long b, int hd, int c, int Lc,
                           float* Ss, float* Ds) {
  const float* sc = a.sc + ((b * a.H + hd) * a.nc + c) * (long long)a.L;
  const float* dt = a.dt + b * a.sdt_b + hd * a.sdt_h +
                    (long long)c * a.L * a.sdt_t;
  for (int t = threadIdx.x; t < a.L; t += kThreads) {
    Ss[t] = sc[t];
    Ds[t] = t < Lc ? dt[t * a.sdt_t] : 0.f;
  }
}

// ---------------------------------------------------------------- (a)

// dH_c[n][p] = sum_t exp(s_t) C_t[n] dy_t[p]; thread (ty, tx) owns state
// rows n = ty + 16 i and columns p = 4 tx .. 4 tx + 3.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dstate(Args a) {
  const int c = blockIdx.x, hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int N = a.N, P = a.P, L = a.L;
  const int N4 = round_up(N, 4), P4 = round_up(P, 4);
  const int ldn = row_stride(N), ldp = row_stride(P), p0 = 4 * tx;
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);

  extern __shared__ float4 sm4[];
  float* Cs = reinterpret_cast<float*>(sm4);  // (kTile, ldn) exp(s_t) C_t
  float* Ys = Cs + kTile * ldn;                // (kTile, ldp) dy_t
  float* Es = Ys + kTile * ldp;                // (L) exp(s_t)
  const float* sc = a.sc + ((b * a.H + hd) * a.nc + c) * (long long)L;
  for (int t = tid; t < L; t += kThreads) Es[t] = expf(sc[t]);
  __syncthreads();

  const T* C = static_cast<const T*>(a.C) + b * a.sC_b + c0 * a.sC_t;
  const T* dy = static_cast<const T*>(a.dy) + b * a.sy_b + hd * a.sy_h +
                c0 * a.sy_t;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int t0 = 0; t0 < Lc; t0 += kTile) {
    const int rows = min(kTile, Lc - t0);
    stage<T>(Cs, ldn, C + t0 * a.sC_t, a.sC_t, a.sC_n, rows, N, N4, Es + t0);
    stage<T>(Ys, ldp, dy + t0 * a.sy_t, a.sy_t, a.sy_p, rows, P, P4,
             nullptr);
    __syncthreads();
    if (p0 < P4) {
      for (int t = 0; t < rows; ++t) {
        const float4 y = ld4(Ys + t * ldp + p0);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (ty + 16 * i < N4) fma4(acc[i], Cs[t * ldn + ty + 16 * i], y);
      }
    }
    __syncthreads();
  }
  float* out = a.dhc + ((b * a.nc + c) * a.H + hd) * (long long)N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p0 + q < P) out[n * P + p0 + q] = acc[i][q];
  }
}

// ---------------------------------------------------------------- (b)

// One thread per element (n, p) of one (b, h) state, over the chunks in
// reverse order: dH_c is replaced by the gradient of the state leaving
// chunk c, g, and g = exp(s_L,c) g + dH_c is carried to chunk c - 1.
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_pass(Args a) {
  const int NP = a.N * a.P;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int hd = blockIdx.y;
  const long long b = blockIdx.z;
  const long long cs = (long long)a.H * NP;             // chunk stride
  float* dh = a.dhc + (b * a.nc * a.H + hd) * (long long)NP + e;
  const float* sl = a.sc + (b * a.H + hd) * (long long)a.nc * a.L + a.L - 1;
  float g = a.dhf != nullptr ? a.dhf[(b * a.H + hd) * NP + e] : 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const float v = dh[c * cs];
    dh[c * cs] = g;
    g = expf(sl[(long long)c * a.L]) * g + v;
  }
}

// ---------------------------------------------------------------- (c)

// Rows u of one 64-row tile: dx, the head's dB and ddt's direct part,
// over the t tiles at or after it.  Thread (ty, tx) owns u rows
// ty + 16 i for dx (columns p = 4 tx ..) and dB (columns n = 4 tx + 64 m
// ..), and u columns tx + 16 j of the G and Q tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_rows_u(Args a) {
  const int nt = (a.L + kTile - 1) / kTile;
  const int c = blockIdx.x / nt, ju = blockIdx.x % nt;
  const int hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int N = a.N, P = a.P, L = a.L;
  const int N4 = round_up(N, 4), P4 = round_up(P, 4);
  const int ldn = row_stride(N), ldp = row_stride(P), p0 = 4 * tx;
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);
  const int u0 = ju * kTile;
  if (u0 >= Lc) return;
  const int urows = min(kTile, Lc - u0);

  extern __shared__ float4 sm4[];
  float* Bu = reinterpret_cast<float*>(sm4);  // (kTile, ldn) B_u
  float* Xu = Bu + kTile * ldn;                // (kTile, ldp) x_u
  float* Rg = Xu + kTile * ldp;   // dh (N4, ldp), then C_t and dy_t tiles
  float* WV = Rg + kTile * (ldn + ldp);  // W, V (kTile, kLdT) or r
  float* Ss = WV + wv_floats(N);         // (L) s
  float* Ds = Ss + L;                    // (L) dt
  float* Red = Ds + L;                   // (16, kTile) partial sums
  float* Dst = Red + kSide * kTile;      // (kTile) ddt's state part

  load_chunk(a, b, hd, c, Lc, Ss, Ds);
  const T* xg = static_cast<const T*>(a.x) + b * a.sx_b + hd * a.sx_h +
                c0 * a.sx_t;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sB_b + c0 * a.sB_t;
  const T* Cg = static_cast<const T*>(a.C) + b * a.sC_b + c0 * a.sC_t;
  const T* yg = static_cast<const T*>(a.dy) + b * a.sy_b + hd * a.sy_h +
                c0 * a.sy_t;
  stage<T>(Bu, ldn, Bg + u0 * a.sB_t, a.sB_t, a.sB_n, urows, N, N4, nullptr);
  stage<T>(Xu, ldp, xg + u0 * a.sx_t, a.sx_t, a.sx_p, urows, P, P4, nullptr);
  const float* dhg = a.dhc + ((b * a.nc + c) * a.H + hd) * (long long)N * P;
  for (int i = tid; i < N4 * P4; i += kThreads) {
    const int n = i / P4, p = i % P4;
    Rg[n * ldp + p] = n < N && p < P ? dhg[n * P + p] : 0.f;
  }
  __syncthreads();
  const float sL = Ss[L - 1];

  // the state's terms: w_u = exp(s_L - s_u) dt_u
  float es[4], wu[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = ty + 16 * i;
    es[i] = u < urows ? expf(sL - Ss[u0 + u]) : 0.f;
    wu[i] = u < urows ? es[i] * Ds[u0 + u] : 0.f;
  }
  // dx[u][p] = w_u sum_n B_u[n] dh[n][p]
  float dx[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dx[i][q] = 0.f;
  if (p0 < P4) {
    for (int n = 0; n < N4; n += 4) {
      float4 d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = ld4(Rg + (n + k) * ldp + p0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 bv = ld4(Bu + (ty + 16 * i) * ldn + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) fma4(dx[i], comp(bv, k), d[k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dx[i][q] *= wu[i];
  // r[u][n] = sum_p dh[n][p] x_u[p], state rows n = tx + 16 m
  float r[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 8; ++m) r[i][m] = 0.f;
  for (int p = 0; p < P4; p += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = ld4(Xu + (ty + 16 * i) * ldp + p);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (tx + 16 * m >= N4) continue;
      const float4 dv = ld4(Rg + (tx + 16 * m) * ldp + p);
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i][m] = dot4(r[i][m], xv[i], dv);
    }
  }
  // ddt's state part exp(s_L - s_u) B_u . r_u, and dB's w_u r_u by way of
  // shared memory into the layout of the dB accumulators
  float* R = WV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = ty + 16 * i;
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int n = tx + 16 * m;
      if (n >= N4) continue;
      part += Bu[u * ldn + n] * r[i][m];
      R[u * ldn + n] = wu[i] * r[i][m];
    }
    part = row16_sum(part);
    if (tx == 0) Dst[u] = es[i] * part;
  }
  __syncthreads();
  float dB[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int n = p0 + 64 * m;
      const float4 v = n < N4 ? ld4(R + (ty + 16 * i) * ldn + n)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      dB[i][m][0] = v.x;
      dB[i][m][1] = v.y;
      dB[i][m][2] = v.z;
      dB[i][m][3] = v.w;
    }
  __syncthreads();   // Rg and WV are refilled next

  // the chunk's own terms, t tile by t tile
  float* Ct = Rg;
  float* Yt = Rg + kTile * ldn;
  float* Wt = WV;               // (u, t): G M dt_u
  float* Vt = WV + kTile * kLdT;  // (u, t): Q M dt_u
  float pd[4] = {0.f, 0.f, 0.f, 0.f};   // sum_t G M Q at u = tx + 16 j
  const int last = (Lc - 1) / kTile;
  for (int it = ju; it <= last; ++it) {
    const int t0 = it * kTile, trows = min(kTile, Lc - t0);
    stage<T>(Ct, ldn, Cg + t0 * a.sC_t, a.sC_t, a.sC_n, trows, N, N4,
             nullptr);
    stage<T>(Yt, ldp, yg + t0 * a.sy_t, a.sy_t, a.sy_p, trows, P, P4,
             nullptr);
    __syncthreads();
    float G[4][4], Q[4][4];
    gq_tiles(Ct, Yt, Bu, Xu, ldn, ldp, N4, P4, ty, tx, G, Q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = ty + 16 * i, t = t0 + tl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ul = tx + 16 * j, u = u0 + ul;
        const bool live = tl < trows && ul < urows && u <= t;
        const float m = live ? expf(Ss[t] - Ss[u]) : 0.f;
        const float d = live ? Ds[u] : 0.f;
        const float gm = G[i][j] * m;
        Wt[ul * kLdT + tl] = gm * d;
        Vt[ul * kLdT + tl] = Q[i][j] * m * d;
        pd[j] += gm * Q[i][j];
      }
    }
    __syncthreads();
    // dx[u][p] += sum_t W[u][t] dy_t[p];  dB[u][n] += sum_t V[u][t] C_t[n]
    const int t4 = round_up(trows, 4);
    for (int tt = 0; tt < t4; tt += 4) {
      float4 w[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = ld4(Wt + (ty + 16 * i) * kLdT + tt);
        v[i] = ld4(Vt + (ty + 16 * i) * kLdT + tt);
      }
      if (p0 < P4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 y = ld4(Yt + (tt + k) * ldp + p0);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(dx[i], comp(w[i], k), y);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int n = p0 + 64 * m;
        if (n >= N4) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 cv = ld4(Ct + (tt + k) * ldn + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(dB[i][m], comp(v[i], k), cv);
        }
      }
    }
    __syncthreads();   // Ct, Yt, Wt and Vt are refilled next
  }

  // ddt's direct part: the 16 rows' partial sums of each u in order
#pragma unroll
  for (int j = 0; j < 4; ++j) Red[ty * kTile + tx + 16 * j] = pd[j];
  __syncthreads();
  const int H = a.H;
  if (tid < urows) {
    float intra = 0.f;
    for (int k = 0; k < kSide; ++k) intra += Red[k * kTile + tid];
    const long long row = c0 + u0 + tid;
    a.ddt[(b * a.S + row) * H + hd] = intra + Dst[tid];
    a.ddts[(b * H + hd) * a.S + row] = Dst[tid];
  }
  T* dxo = static_cast<T*>(a.dx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = ty + 16 * i;
    if (u >= urows) continue;
    const long long row = c0 + u0 + u;
    T* dxr = dxo + ((b * a.S + row) * H + hd) * (long long)P;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p0 + q < P) dxr[p0 + q] = Cvt<T>::from(dx[i][q]);
    float* dbr = a.dBp + ((b * H + hd) * a.S + row) * (long long)N;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = p0 + 64 * m + q;
        if (n < N) dbr[n] = dB[i][m][q];
      }
  }
}

// Rows t of one 64-row tile: the head's dC and ds's terms in t, over the
// u tiles at or before it.  Thread (ty, tx) owns t rows ty + 16 i (dC
// columns n = 4 tx + 64 m ..) and u columns tx + 16 j of the G, Q tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_rows_t(Args a) {
  const int nt = (a.L + kTile - 1) / kTile;
  const int c = blockIdx.x / nt, it = blockIdx.x % nt;
  const int hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int N = a.N, P = a.P, L = a.L;
  const int N4 = round_up(N, 4), P4 = round_up(P, 4);
  const int ldn = row_stride(N), ldp = row_stride(P), p0 = 4 * tx;
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);
  const int t0 = it * kTile;
  if (t0 >= Lc) return;
  const int trows = min(kTile, Lc - t0);

  extern __shared__ float4 sm4[];
  float* Ct = reinterpret_cast<float*>(sm4);  // (kTile, ldn) C_t
  float* Yt = Ct + kTile * ldn;                // (kTile, ldp) dy_t
  float* Rg = Yt + kTile * ldp;   // h_prev^T (P4, ldn), then B_u and x_u
  float* Vs = Rg + kTile * (ldn + ldp);  // (kTile, kLdT) (t, u): Q M dt_u
  float* Ss = Vs + kTile * kLdT;         // (L) s
  float* Ds = Ss + L;                    // (L) dt
  float* Red = Ds + L;                   // (kThreads)

  load_chunk(a, b, hd, c, Lc, Ss, Ds);
  const T* xg = static_cast<const T*>(a.x) + b * a.sx_b + hd * a.sx_h +
                c0 * a.sx_t;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sB_b + c0 * a.sB_t;
  const T* Cg = static_cast<const T*>(a.C) + b * a.sC_b + c0 * a.sC_t;
  const T* yg = static_cast<const T*>(a.dy) + b * a.sy_b + hd * a.sy_h +
                c0 * a.sy_t;
  stage<T>(Ct, ldn, Cg + t0 * a.sC_t, a.sC_t, a.sC_n, trows, N, N4, nullptr);
  stage<T>(Yt, ldp, yg + t0 * a.sy_t, a.sy_t, a.sy_p, trows, P, P4, nullptr);
  const long long st = ((b * a.nc + c) * a.H + hd) * (long long)N * P;
  const float* hp = a.hprev + st;
  for (int i = tid; i < N4 * P4; i += kThreads) {
    const int n = i / P4, p = i % P4;
    Rg[p * ldn + n] = n < N && p < P ? hp[n * P + p] : 0.f;
  }
  __syncthreads();

  // the state's terms: dC[t][n] = exp(s_t) sum_p dy_t[p] h_prev[n][p], and
  // ds_t's exp(s_t) C_t . (h_prev dy_t)
  float dC[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) dC[i][m][q] = 0.f;
  for (int p = 0; p < P4; p += 4) {
    float4 yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) yv[i] = ld4(Yt + (ty + 16 * i) * ldp + p);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int n = p0 + 64 * m;
      if (n >= N4) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 hv = ld4(Rg + (p + k) * ldn + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) fma4(dC[i][m], comp(yv[i], k), hv);
      }
    }
  }
  float sp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tl = ty + 16 * i;
    const float et = tl < trows ? expf(Ss[t0 + tl]) : 0.f;
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = p0 + 64 * m + q;
        dC[i][m][q] *= et;
        if (n < N4) part += Ct[tl * ldn + n] * dC[i][m][q];
      }
    sp[i] = part;
  }
  // the last row's exp(s_L) <h_prev, dh>, in the tile that holds it
  float dec = 0.f;
  if (t0 + trows == Lc) {
    const float* dh = a.dhc + st;
    float v = 0.f;
    for (int e = tid; e < N * P; e += kThreads) v += hp[e] * dh[e];
    dec = expf(Ss[L - 1]) * block_total(v, Red);
  }
  __syncthreads();   // h_prev^T is no longer read

  float* Bu = Rg;
  float* Xu = Rg + kTile * ldn;
  for (int ju = 0; ju <= it; ++ju) {
    const int u0 = ju * kTile, urows = min(kTile, Lc - u0);
    stage<T>(Bu, ldn, Bg + u0 * a.sB_t, a.sB_t, a.sB_n, urows, N, N4,
             nullptr);
    stage<T>(Xu, ldp, xg + u0 * a.sx_t, a.sx_t, a.sx_p, urows, P, P4,
             nullptr);
    __syncthreads();
    float G[4][4], Q[4][4];
    gq_tiles(Ct, Yt, Bu, Xu, ldn, ldp, N4, P4, ty, tx, G, Q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = ty + 16 * i, t = t0 + tl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ul = tx + 16 * j, u = u0 + ul;
        const bool live = tl < trows && ul < urows && u <= t;
        const float v = live ? Q[i][j] * expf(Ss[t] - Ss[u]) * Ds[u] : 0.f;
        Vs[tl * kLdT + ul] = v;
        sp[i] += G[i][j] * v;
      }
    }
    __syncthreads();
    // dC[t][n] += sum_u V[t][u] B_u[n]
    const int u4 = round_up(urows, 4);
    for (int uu = 0; uu < u4; uu += 4) {
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = ld4(Vs + (ty + 16 * i) * kLdT + uu);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int n = p0 + 64 * m;
        if (n >= N4) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 bv = ld4(Bu + (uu + k) * ldn + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(dC[i][m], comp(v[i], k), bv);
        }
      }
    }
    __syncthreads();   // Bu, Xu and Vs are refilled next
  }

  const int H = a.H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = row16_sum(sp[i]);
    const int tl = ty + 16 * i;
    if (tl >= trows) continue;
    const long long row = c0 + t0 + tl;
    if (tx == 0)
      a.dsp[(b * H + hd) * a.S + row] = s + (t0 + tl == Lc - 1 ? dec : 0.f);
    float* dcr = a.dCp + ((b * H + hd) * a.S + row) * (long long)N;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = p0 + 64 * m + q;
        if (n < N) dcr[n] = dC[i][m][q];
      }
  }
}

// ds_t = dsp_t - dt_t ddt_t(direct) (+ sum_u dt_u ddt_u(state) at the last
// row), its reverse cumsum rc over the chunk, ddt_t += A rc_t, and the
// chunk's dA = sum_t dt_t rc_t.
__global__ void __launch_bounds__(kThreads) ssd_bwd_dlog(Args a) {
  const int c = blockIdx.x, hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, H = a.H;
  const long long c0 = (long long)c * a.L;
  const int Lc = (int)min((long long)a.L, a.S - c0);
  extern __shared__ float4 sm4[];
  float* Ds = reinterpret_cast<float*>(sm4);  // (L) ds, then rc
  float* Red = Ds + a.L;                       // (kThreads)
  const float* dt = a.dt + b * a.sdt_b + hd * a.sdt_h + c0 * a.sdt_t;
  const float* dsp = a.dsp + (b * H + hd) * a.S + c0;
  const float* ddts = a.ddts + (b * H + hd) * a.S + c0;
  float* ddt = a.ddt + (b * a.S + c0) * H + hd;

  float v = 0.f;
  for (int t = tid; t < Lc; t += kThreads) v += dt[t * a.sdt_t] * ddts[t];
  const float tail = block_total(v, Red);
  for (int t = tid; t < Lc; t += kThreads)
    Ds[t] = dsp[t] - dt[t * a.sdt_t] * ddt[t * H] +
            (t == Lc - 1 ? tail : 0.f);
  __syncthreads();
  if (tid < 32) {   // reverse inclusive cumsum by warp 0, in a fixed order
    const int lane = tid, per = (Lc + 31) / 32;
    const int lo = min(lane * per, Lc), hi = min(lo + per, Lc);
    float run = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      run += Ds[t];
      Ds[t] = run;
    }
    float incl = run;   // then the suffix sums of the lanes' totals
    for (int off = 1; off < 32; off <<= 1) {
      const float w = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += w;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    for (int t = lo; t < hi; ++t) Ds[t] += excl;
  }
  __syncthreads();
  const float A = a.A[hd];
  v = 0.f;
  for (int t = tid; t < Lc; t += kThreads) {
    const float rc = Ds[t];
    ddt[t * H] += A * rc;
    v += dt[t * a.sdt_t] * rc;
  }
  const float da = block_total(v, Red);
  if (tid == 0) a.dAp[(b * H + hd) * a.nc + c] = da;
}

// (d) dB and dC: one thread per element of (Bt, S, N), the heads summed in
// order; the block past them sums dA over (b, chunk) in order per head.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_head_sum(Args a) {
  const long long SN = a.S * a.N, total = a.Bt * SN;
  const int H = a.H;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (long long b = 0; b < a.Bt; ++b)
        for (int c = 0; c < a.nc; ++c) s += a.dAp[(b * H + h) * a.nc + c];
      a.dA[h] = s;
    }
    return;
  }
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long b = e / SN, r = e % SN;
  const float* pb = a.dBp + b * H * SN + r;
  const float* pc = a.dCp + b * H * SN + r;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[h * SN];
    sc += pc[h * SN];
  }
  static_cast<T*>(a.dB)[e] = Cvt<T>::from(sb);
  static_cast<T*>(a.dC)[e] = Cvt<T>::from(sc);
}

// ---------------------------------------------------------------- launch

using Kern = void (*)(Args);

struct Plan {
  Kern fn[kPasses];
  size_t smem[kPasses];
};

size_t dstate_floats(int N, int P, int L) {
  return (size_t)kTile * (row_stride(N) + row_stride(P)) + L;
}
size_t rows_u_floats(int N, int P, int L) {
  return (size_t)2 * kTile * (row_stride(N) + row_stride(P)) +
         wv_floats(N) + 2 * (size_t)L + kSide * kTile + kTile;
}
size_t rows_t_floats(int N, int P, int L) {
  return (size_t)2 * kTile * (row_stride(N) + row_stride(P)) +
         kTile * kLdT + 2 * (size_t)L + kThreads;
}

template <typename T>
void fill(Plan* p, int N, int P, int L) {
  *p = {{ssd_bwd_dstate<T>, ssd_bwd_state_pass, ssd_bwd_rows_u<T>,
         ssd_bwd_rows_t<T>, ssd_bwd_dlog, ssd_bwd_head_sum<T>},
        {dstate_floats(N, P, L) * sizeof(float), 0,
         rows_u_floats(N, P, L) * sizeof(float),
         rows_t_floats(N, P, L) * sizeof(float),
         ((size_t)L + kThreads) * sizeof(float), 0}};
}

// The six kernels for dtype at (N, P, L) with their shared memory opted
// into, or an error code (cudaErrorInvalidValue for what they cannot hold).
int plan(int dtype, int N, int P, int L, Plan* p) {
  if (dtype == kF32) {
    fill<float>(p, N, P, L);
  } else if (dtype == kBF16) {
    fill<__nv_bfloat16>(p, N, P, L);
  } else if (dtype == kF16) {
    fill<__half>(p, N, P, L);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < kPasses; ++i) {
    if (p->smem[i] > kMaxSmem) return (int)cudaErrorInvalidValue;
    if (p->smem[i] == 0) continue;
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

// Floats of scratch a call needs: dH / dh (Bt, nc, H, N, P), the per-head
// dB and dC (Bt, H, S, N) each, ds's terms in t and ddt's state part
// (Bt, H, S) each, and the per-chunk dA (Bt, H, nc); nc = ceil(S / L).
extern "C" long long ssd_scan_bwd_scratch_floats(long long Bt, long long S,
                                                 int H, int P, int N, int L) {
  const long long nc = (S + L - 1) / L;
  return Bt * H * (nc * N * P + 2 * S * N + 2 * S + nc);
}

// strides: 17 element strides, in the order x (b, t, h, p), dt (b, t, h),
// B (b, t, n), C (b, t, n), dy (b, t, h, p).  fwd_scratch: the scratch of
// the ssd_scan_launch call on the same inputs (ssd_scan_scratch_floats
// floats: the entering states, then s).  dhf: (Bt, H, N, P) contiguous or
// null.  scratch: ssd_scan_bwd_scratch_floats floats.  Launches the six
// passes on `stream`.  Returns cudaErrorInvalidValue, before launching
// anything, for shapes the kernels do not take.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* dy, const float* dhf, const float* fwd_scratch,
    int dtype, void* dx, float* ddt, float* dA, void* dB, void* dC,
    float* scratch, long long Bt, long long S, int H, int P, int N, int L,
    const long long* strides, void* stream) {
  if (!shape_ok(P, N, L, H) || Bt < 1 || Bt > 65535 || S < 1)
    return (int)cudaErrorInvalidValue;
  const long long nc = (S + L - 1) / L;
  const long long nt = (L + kTile - 1) / kTile;
  if (nc * nt > 0x7fffffffLL || Bt * S * N / kThreads + 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int rc = plan(dtype, N, P, L, &p);
  if (rc != 0) return rc;
  float* dhc = scratch;
  float* dBp = dhc + Bt * nc * H * (long long)N * P;
  float* dCp = dBp + Bt * H * S * N;
  float* dsp = dCp + Bt * H * S * N;
  float* ddts = dsp + Bt * H * S;
  float* dAp = ddts + Bt * H * S;
  Args a{x, dt, A, B, C, dy, dhf, fwd_scratch,
         fwd_scratch + Bt * nc * H * (long long)N * P, dhc, dBp, dCp, dsp,
         ddts, dAp, dx, ddt, dB, dC, dA, Bt, S, H, P, N, L, (int)nc,
         strides[0], strides[1], strides[2], strides[3],
         strides[4], strides[5], strides[6],
         strides[7], strides[8], strides[9],
         strides[10], strides[11], strides[12],
         strides[13], strides[14], strides[15], strides[16]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 chunks((unsigned)nc, (unsigned)H, (unsigned)Bt);
  const dim3 tiles((unsigned)(nc * nt), (unsigned)H, (unsigned)Bt);
  const dim3 elems((unsigned)((N * P + kThreads - 1) / kThreads),
                   (unsigned)H, (unsigned)Bt);
  const unsigned sums = (unsigned)((Bt * S * N + kThreads - 1) / kThreads + 1);
  const dim3 grid[kPasses] = {chunks, elems, tiles, tiles, chunks,
                              dim3(sums)};
  for (int i = 0; i < kPasses; ++i) {
    p.fn[i]<<<grid[i], kThreads, p.smem[i], st>>>(a);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

// What the compiler made of pass `pass` (0 dstate, 1 state pass, 2 rows u,
// 3 rows t, 4 dlog, 5 head sum) for dtype at (N, P, L): out[0..5] =
// registers per thread, local (spill) bytes per thread, static shared
// memory, dynamic shared memory (bytes), resident blocks per SM, threads
// per block.  Returns a CUDA error code.
extern "C" int ssd_scan_bwd_kernel_info(int dtype, int pass, int N, int P,
                                        int L, long long* out) {
  if (!shape_ok(P, N, L, 1) || pass < 0 || pass >= kPasses)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int rc = plan(dtype, N, P, L, &p);
  if (rc != 0) return rc;
  cudaFuncAttributes fa;
  rc = (int)cudaFuncGetAttributes(&fa, p.fn[pass]);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, p.fn[pass], kThreads, p.smem[pass]);
  if (rc != 0) return rc;
  out[0] = fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  out[2] = (long long)fa.sharedSizeBytes;
  out[3] = (long long)p.smem[pass];
  out[4] = blocks;
  out[5] = kThreads;
  return 0;
}
