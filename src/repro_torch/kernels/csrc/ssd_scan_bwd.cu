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
//   ssd_bwd_rows_u     per (64-row tile of u, chunk, group of heads, row):
//                      dx, ddt's direct part, the group's dB;
//   ssd_bwd_rows_t     per (64-row tile of t, chunk, group of heads, row):
//                      ds's terms in t, the group's dC;
//   ssd_bwd_dlog       per (chunk, head, row): ds, its reverse cumsum, ddt,
//                      the chunk's part of dA;
//   ssd_bwd_head_sum   (d) dB and dC over the groups, dA over rows and
//                      chunks.
//
// What bounds it on an H100: operations.  At mamba2-1.3b's training shape
// (Bt 2, S 4096, H 64, P 64, N 128, L 256) the products are 4.5 G
// multiply-adds with bf16 factors only (G once per (row, chunk), Q per
// head, over the lower triangle) and 38.7 G with an fp32 factor: 0.244 ms
// on the tensor cores with each fp32 factor split into three exact bf16
// terms, 1.29 ms as fp32 FMAs on the CUDA cores, against 0.105 ms of
// bytes.
//
// The first kernel ran every product as fp32 FMAs from shared memory, one
// block of 8 warps per SM (13.96 ms at that shape), and wrote each head's
// dB and dC to an (Bt, H, S, N) fp32 scratch that a last pass summed over
// the 64 heads (1.07 GB of traffic, 537 MB of scratch).  What this design
// does about each, for bf16 inputs:
//
//  * Every product on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    sums), as the forward's: G = C.B^T and Q = dy.x^T as exact bf16 x
//    bf16 products; every product with an fp32 factor as three mma of its
//    exact three-term bf16 split (split3, common.cuh) into one fp32
//    accumulator: dx = W^T.dy with W = G M dt_u, dB = V^T.C and dC = V.B
//    with V = Q M dt_u, the state terms B.dh, x.dh^T and dy.h_prev^T (dh
//    and h_prev split into three bf16 planes in shared memory), and dH =
//    (exp(s) C)^T.dy.  W and V are built in registers from the G and Q
//    accumulator fragments, masked before the exp, split and fed on as A
//    fragments (the FlashAttention-2 relayout); ddt's direct part and ds's
//    terms in t are taken from the same fragments as fixed-order row sums.
//  * dB and dC summed over heads inside the kernel.  A block of rows_u or
//    rows_t walks a group of 8 heads of one (row, chunk, tile) in order and
//    keeps the group's dB or dC in registers; only H / 8 partials reach the
//    scratch (2 x 33.6 MB at that shape), which ssd_bwd_head_sum sums in
//    order.  G is formed again per head, in rows_u and in rows_t: on the
//    tensor cores that is 0.035 ms a call, where holding it for the group
//    would take 64 KB of shared memory a block.  rows_u's warps 0-3 own
//    dx and ddt's direct part (G, Q, W.dy), warps 4-7 dB and ddt's state
//    part (Q, V.C), each warp 16 rows of u; rows_t's warps split N in two,
//    16 rows of t each (G over their half of N, Q, V.B into their half of
//    dC).
//  * Loads in flight while the tensor cores work.  The B, C, x and dy tiles
//    are staged bf16 with cp.async into a two-stage ring (rows padded to an
//    odd number of 16-byte units for ldmatrix); an operand whose rows are
//    not 16-byte aligned, or whose N or P is not a multiple of 8 (a strided
//    dy, say), is staged with plain loads, eight in flight per thread, at
//    the same place in the ring.  The dh / h_prev planes and the ring take
//    turns in one region of shared memory.
//
// fp32 and fp16 inputs keep the first kernel's fp32 FMAs on the CUDA cores
// (per head, per-head dB and dC partials): a bf16 mma would round fp32
// operands, and fp16's narrow range has no exact three-term split.
//
// As built (bf16, P 64, L 256, N 128 / 64; ssd_scan_bwd_kernel_info on
// NVIDIA H100 80GB HBM3): rows_u and rows_t 128 registers (rows_u with 64
// bytes of spill), 84.6 / 58.0 KB of shared memory, 2 blocks of 8 warps
// per SM; dH 80 registers, 54.3 / 37.9 KB, 3 blocks; the state pass 64
// registers, 4 blocks.  The fixed A fragments (B_u, x_u, C_t,
// dy_t) are read again from shared memory for each slice: holding them in
// registers would cost spills or the second block per SM.
//
// Every sum runs in a fixed order and there are no atomics: the group
// partials of dB and dC and the per-chunk dA go to the scratch and are
// summed in order by the last launch, so two launches give the same bits.
// Built without --use_fast_math (expf).
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

constexpr size_t kMaxSmem = 232448;  // what one block may opt into
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kTile = 64;            // rows of t or u per tile
constexpr int kSide = 16;            // threads are a 16 x 16 grid
constexpr int kThreads = kSide * kSide;
constexpr int kLdT = kTile + 4;      // row stride of the (64, 64) W, V tiles
constexpr int kGroup = 8;            // heads per block of the bf16 rows passes

// dtype codes shared with repro_torch/kernels/ssd_scan.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
// the six launches, as ssd_scan_bwd_kernel_info numbers them
enum Pass { kDState = 0, kStatePass = 1, kRowsU = 2, kRowsT = 3, kDLog = 4,
            kHeadSum = 5, kPasses = 6 };
// Args::v16 bits: the operand is staged by cp.async 16 (bf16 passes)
enum Stage16 { kVx = 1, kVB = 2, kVC = 4, kVy = 8 };

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
  float* dBp;          // (Bt, ng, S, N) dB of each head or group of heads
  float* dCp;          // (Bt, ng, S, N) dC of each head or group of heads
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
  int ng;              // partials of dB and dC: H (fp32, fp16), H / kGroup
  int v16;             // Stage16 bits (bf16)
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
// chunk c, g, and g = exp(s_L,c) g + dH_c is carried to chunk c - 1.  The
// loads of kAhead chunks are issued before the carried product uses the
// first of them (the stores in between would otherwise keep each load
// behind the last store).
constexpr int kAhead = 16;

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
  for (int c1 = a.nc - 1; c1 >= 0; c1 -= kAhead) {     // c1, c1 - 1, ..
    float v[kAhead], d[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c1 - q >= 0) {
        v[q] = dh[(c1 - q) * cs];
        d[q] = expf(sl[(long long)(c1 - q) * a.L]);
      }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (c1 - q >= 0) {
        dh[(c1 - q) * cs] = g;
        g = d[q] * g + v[q];
      }
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

// (d) dB and dC: one thread per element of (Bt, S, N), the ng partials
// (heads or groups of heads) summed in order; the block past them sums dA
// over (b, chunk) in order per head.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_head_sum(Args a) {
  const long long SN = a.S * a.N, total = a.Bt * SN;
  const int H = a.H, ng = a.ng;
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
  const float* pb = a.dBp + b * ng * SN + r;
  const float* pc = a.dCp + b * ng * SN + r;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < ng; ++k) {
    sb += pb[k * SN];
    sc += pc[k * SN];
  }
  static_cast<T*>(a.dB)[e] = Cvt<T>::from(sb);
  static_cast<T*>(a.dC)[e] = Cvt<T>::from(sc);
}

// ------------------------------------------------------------ bf16 body

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;    // 8 warps

// bf16 values of the region that holds the three planes of dh or h_prev,
// then the two stages of the ring (a (kTile, N) and a (kTile, P) tile each).
__host__ __device__ inline int plane_ring(int Np, int Pp) {
  const int planes = 3 * Np * ld_bf(Pp);
  const int ring = 2 * kTile * (ld_bf(Np) + ld_bf(Pp));
  return planes > ring ? planes : ring;
}

// (a): two stages of C and dy tiles, exp(s) of the chunk
size_t mma_dstate_bytes(int N, int P, int L) {
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  return 2 * sizeof(bf16) * kTile * ((size_t)ld_bf(Np) + ld_bf(Pp)) +
         sizeof(float) * (size_t)round_up(L, kTile);
}
// rows_u and rows_t: a (kTile, N) and a (kTile, P) tile held for the block,
// the planes / ring region, s and dt of the chunk, two rows of per-row
// exchange and 40 floats of block sums
size_t mma_rows_bytes(int N, int P, int L) {
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  return sizeof(bf16) * ((size_t)kTile * (ld_bf(Np) + ld_bf(Pp)) +
                         plane_ring(Np, Pp)) +
         sizeof(float) * (2 * (size_t)round_up(L, kTile) + 2 * kTile + 40);
}

// The (N, P) fp32 matrix m (row-major, contiguous) as three exact bf16
// planes of (Np, ld) at Dq, Dq + Np ld and Dq + 2 Np ld, zero past N and
// P.  With d (also (N, P)), returns this thread's part of sum m .* d, in a
// fixed order.  Not synchronised.
__device__ float fill_planes(bf16* Dq, int ld, int Np, int Pp,
                             const float* m, const float* d, int N, int P) {
  const bool v4 = (P & 3) == 0;      // rows of whole float4s
  const int w4 = Pp / 4;
  float dot = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < Np * w4; e += kMmaThreads) {
    const int n = e / w4, p = 4 * (e % w4);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < N && p < P) {
      if (v4) {
        const float4 f = *reinterpret_cast<const float4*>(m + n * P + p);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p + q < P) v[q] = m[n * P + p + q];
      }
      if (d != nullptr) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p + q < P) dot += v[q] * d[n * P + p + q];
      }
    }
    uint32_t a1, a2, a3, b1, b2, b3;
    split3(v[0], v[1], a1, a2, a3);
    split3(v[2], v[3], b1, b2, b3);
    uint2* row = reinterpret_cast<uint2*>(Dq + n * ld + p);
    const int plane = Np * ld / 4;   // in uint2
    row[0] = make_uint2(a1, b1);
    row[plane] = make_uint2(a2, b2);
    row[2 * plane] = make_uint2(a3, b3);
  }
  return dot;
}

// The A fragment of rows [r0, r0 + 16) and columns [k0, k0 + 16) of a
// staged row-major tile.
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* tile,
                                       int ld, int r0, int k0, int lane) {
  const int lrow = lane & 7, lmat = lane >> 3;
  ldmatrix_x4(f, smem_addr(tile + (r0 + (lmat & 1) * 8 + lrow) * ld + k0 +
                           (lmat >> 1) * 8));
}
// The B fragments of two n-tiles, [n0, n0 + 8) (f[0], f[1]) and [n0 + 8,
// n0 + 16) (f[2], f[3]), over k in [k0, k0 + 16), from a tile stored
// [n][k] (rows n, k along the row).
__device__ __forceinline__ void frag_b_nk(uint32_t (&f)[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  const int lrow = lane & 7, lmat = lane >> 3;
  ldmatrix_x4(f, smem_addr(tile + (n0 + (lmat >> 1) * 8 + lrow) * ld + k0 +
                           (lmat & 1) * 8));
}
// The same from a tile stored [k][n] (rows k, n along the row).
__device__ __forceinline__ void frag_b_kn(uint32_t (&f)[4], const bf16* tile,
                                          int ld, int k0, int n0, int lane) {
  const int lrow = lane & 7, lmat = lane >> 3;
  ldmatrix_x4_trans(f, smem_addr(tile + (k0 + (lmat & 1) * 8 + lrow) * ld +
                                 n0 + (lmat >> 1) * 8));
}
// c0 += a . (n-tile 0 of b), c1 += a . (n-tile 1 of b)
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}
// The three split terms of an A fragment against the same B fragments.
__device__ __forceinline__ void mma2x3(float (&c0)[4], float (&c1)[4],
                                       const uint32_t (&a1)[4],
                                       const uint32_t (&a2)[4],
                                       const uint32_t (&a3)[4],
                                       const uint32_t (&b)[4]) {
  mma2(c0, c1, a1, b);
  mma2(c0, c1, a2, b);
  mma2(c0, c1, a3, b);
}

// v summed over the four lanes of a quad (one accumulator row) by a
// butterfly: each lane gets the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// (a) on the tensor cores: one block of 8 warps per (chunk, head, batch
// row), as the forward's chunk-state pass.  Warp w owns state rows n in
// [16 w, 16 w + 16) and all of P:
//   dH[n, p] = sum_t (exp(s_t) C[t, n]) dy[t, p]
// as an (N x L) . (L x P) product.  The A fragment (e^s C)^T comes from an
// ldmatrix.trans of the staged C rows; each fp32 product exp(s_t) C[t, n]
// is split into three bf16 terms, each an mma against the dy fragments.
__global__ void __launch_bounds__(kMmaThreads) ssd_bwd_dstate_mma(Args a) {
  const int c = blockIdx.x, hd = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2, lrow = lane & 7, lmat = lane >> 3;
  const int N = a.N, P = a.P, L = a.L;
  const int Np = round_up(N, 16), Pp = round_up(P, 16), pk = Pp / 16;
  const int LDN = ld_bf(Np), LDP = ld_bf(Pp), Lt = round_up(L, kTile);
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);
  const bool vC = a.v16 & kVC, vy = a.v16 & kVy;

  extern __shared__ uint4 smem_u4[];   // uint4: 16-byte aligned
  bf16* Cs = reinterpret_cast<bf16*>(smem_u4);   // 2 x (kTile, LDN)
  bf16* Ys = Cs + 2 * kTile * LDN;               // 2 x (kTile, LDP)
  float* Es = reinterpret_cast<float*>(Ys + 2 * kTile * LDP);  // (Lt)

  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.sC_b + c0 * a.sC_t;
  const bf16* yg = static_cast<const bf16*>(a.dy) + b * a.sy_b +
                   hd * a.sy_h + c0 * a.sy_t;
  const float* sc = a.sc + ((b * a.H + hd) * a.nc + c) * (long long)L;

  if (vC) zero_cols(Cs, LDN, 2 * kTile, N, Np);
  if (vy) zero_cols(Ys, LDP, 2 * kTile, P, Pp);
  const int nu = (Lc + kTile - 1) / kTile;     // t tiles with data
  stage_bf(Cs, LDN, Cg, a.sC_t, a.sC_n, kTile, Lc, N, Np, vC);
  stage_bf(Ys, LDP, yg, a.sy_t, a.sy_p, kTile, Lc, P, Pp, vy);
  cp_async_commit();
  for (int t = tid; t < Lt; t += kMmaThreads)
    Es[t] = t < Lc ? expf(sc[t]) : 0.f;

  const int n0 = 16 * warp;
  const bool active = n0 < Np;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k = 0; k < nu; ++k) {
    const int st = k & 1;
    if (k + 1 < nu) {
      const int r1 = (k + 1) * kTile;
      stage_bf(Cs + (st ^ 1) * kTile * LDN, LDN, Cg + r1 * a.sC_t, a.sC_t,
               a.sC_n, kTile, Lc - r1, N, Np, vC);
      stage_bf(Ys + (st ^ 1) * kTile * LDP, LDP, yg + r1 * a.sy_t, a.sy_t,
               a.sy_p, kTile, Lc - r1, P, Pp, vy);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile k (and, at k = 0, Es) visible to all
    if (active) {
      const bf16* Ct = Cs + st * kTile * LDN;
      const bf16* Yt = Ys + st * kTile * LDP;
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        const int t0 = k * kTile + 16 * j;     // chunk row of the slice
        if (t0 >= Lc) break;
        // matrix m holds t = t0 + (m >> 1) * 8 .., n = n0 + (m & 1) * 8 ..
        uint32_t cc[4];
        ldmatrix_x4_trans(cc, smem_addr(Ct + (16 * j + (lmat >> 1) * 8 +
                                              lrow) * LDN +
                                        n0 + (lmat & 1) * 8));
        uint32_t w1[4], w2[4], w3[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int t = t0 + (m >> 1) * 8 + 2 * t4;
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&cc[m]));
          split3(f.x * Es[t], f.y * Es[t + 1], w1[m], w2[m], w3[m]);
        }
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
          if (dp < pk) {
            uint32_t yv[4];
            frag_b_kn(yv, Yt, LDP, 16 * j, 16 * dp, lane);
            mma2x3(acc[2 * dp], acc[2 * dp + 1], w1, w2, w3, yv);
          }
      }
    }
    __syncthreads();   // stage st is refilled at the next iteration
  }

  // element (j, e) is state row n0 + g + 8 (e >> 1), column 8 j + 2 t4 +
  // (e & 1)
  if (!active) return;
  float* out = a.dhc + ((b * a.nc + c) * a.H + hd) * (long long)N * P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + 8 * (e >> 1), p = 8 * j + 2 * t4 + (e & 1);
      if (n < N && p < P) out[n * P + p] = acc[j][e];
    }
}

// rows_u on the tensor cores: one block of 8 warps per (64-row tile of u,
// chunk, group of kGroup heads, batch row), two blocks per SM.  Warp w
// owns u rows u0 + 16 (w & 3) .. + 15; warps 0-3 (role 0) dx and ddt's
// direct part, warps 4-7 (role 1) dB and ddt's state part.  B_u is staged
// once for the block; per head, in order:
//   x_u, s, dt, and dh as three bf16 planes;
//   role 0: dx = w_u (B_u . dh),   role 1: r = x_u . dh^T in slices of 16
//           n, dB += w_u r and ddt's state part exp(s_L - s_u) B_u . r
//           (w_u = exp(s_L - s_u) dt_u);
//   over the t tiles at or after the u tile (a cp.async ring of C_t and
//   dy_t rows, in the planes' place), per 16-row slice of t:
//     Q^T = x_u . dy_t^T (both roles);
//     role 0: G^T = B_u . C_t^T, W^T = G^T M dt_u in registers, split,
//             dx += W^T . dy_t, ddt's direct part += sum_t G^T M Q^T;
//     role 1: V^T = Q^T M dt_u, split, dB += V^T . C_t;
//   dx and ddt written for the head.
// dB of the group is written at the end, one partial per group.  One
// accumulator array holds role 0's dx (8 tiles of P) or role 1's dB (16
// tiles of N).
__global__ void __launch_bounds__(kMmaThreads, 2) ssd_bwd_rows_u_mma(Args a) {
  const int nt = (a.L + kTile - 1) / kTile;
  const int c = blockIdx.x / nt, ju = blockIdx.x % nt;
  const int grp = blockIdx.y, h0 = grp * kGroup, h1 = min(a.H, h0 + kGroup);
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int N = a.N, P = a.P, L = a.L, H = a.H;
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  const int nk = Np / 16, pk = Pp / 16;       // 16-column slices of N, P
  const int LDN = ld_bf(Np), LDP = ld_bf(Pp), Lt = round_up(L, kTile);
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);
  const int u0 = ju * kTile;
  if (u0 >= Lc) return;
  const int last = (Lc - 1) / kTile;           // the chunk's last t tile
  const int role = warp >> 2;
  const int ul = 16 * (warp & 3);              // the warp's rows in the tile
  const bool active = u0 + ul < Lc;
  const int u_lo = u0 + ul + g, u_hi = u_lo + 8;   // the thread's two rows
  const bool vx = a.v16 & kVx, vB = a.v16 & kVB, vC = a.v16 & kVC,
             vy = a.v16 & kVy;

  extern __shared__ uint4 smem_u4[];
  bf16* Bu = reinterpret_cast<bf16*>(smem_u4);   // (kTile, LDN) B_u
  bf16* Xu = Bu + kTile * LDN;                   // (kTile, LDP) x_u
  bf16* Dq = Xu + kTile * LDP;                   // 3 x (Np, LDP) dh planes
  bf16* Cr = Dq;                                 // then 2 x (kTile, LDN) C_t
  bf16* Yr = Dq + 2 * kTile * LDN;               // and 2 x (kTile, LDP) dy_t
  float* Ss = reinterpret_cast<float*>(Dq + plane_ring(Np, Pp));  // (Lt)
  float* Ds = Ss + Lt;                           // (Lt) dt, 0 past the data
  float* Xch = Ds + Lt;                          // (2, kTile) ddt's two parts

  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.sB_b + c0 * a.sB_t;
  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.sC_b + c0 * a.sC_t;
  if (vB) zero_cols(Bu, LDN, kTile, N, Np);
  if (vx) zero_cols(Xu, LDP, kTile, P, Pp);
  stage_bf(Bu, LDN, Bg + u0 * a.sB_t, a.sB_t, a.sB_n, kTile, Lc - u0, N, Np,
           vB);

  // role 0: acc[j] is dx's p-tile j (j < 8); role 1: dB's n-tile j.
  // Element e of a tile is row u_lo (e < 2) or u_hi, column 8 j + 2 t4 +
  // (e & 1).
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int hd = h0; hd < h1; ++hd) {
    const bf16* xg = static_cast<const bf16*>(a.x) + b * a.sx_b +
                     hd * a.sx_h + c0 * a.sx_t;
    const bf16* yg = static_cast<const bf16*>(a.dy) + b * a.sy_b +
                     hd * a.sy_h + c0 * a.sy_t;
    const float* dt = a.dt + b * a.sdt_b + hd * a.sdt_h + c0 * a.sdt_t;
    const float* sc = a.sc + ((b * H + hd) * a.nc + c) * (long long)L;
    const float* dh = a.dhc + ((b * a.nc + c) * H + hd) * (long long)N * P;
    __syncthreads();   // the last head is done with Xu, the ring, Ss, Xch
    stage_bf(Xu, LDP, xg + u0 * a.sx_t, a.sx_t, a.sx_p, kTile, Lc - u0, P, Pp,
             vx);
    cp_async_commit();
    for (int t = tid; t < Lt; t += kMmaThreads) {
      Ss[t] = t < L ? sc[t] : 0.f;
      Ds[t] = t < Lc ? dt[t * a.sdt_t] : 0.f;
    }
    fill_planes(Dq, LDP, Np, Pp, dh, nullptr, N, P);
    cp_async_wait<0>();
    __syncthreads();

    // the state's terms
    const float sL = Ss[L - 1];
    const float e_lo = u_lo < Lc ? expf(sL - Ss[u_lo]) : 0.f;
    const float e_hi = u_hi < Lc ? expf(sL - Ss[u_hi]) : 0.f;
    const float w_lo = e_lo * Ds[u_lo], w_hi = e_hi * Ds[u_hi];
    if (active && role == 0) {
      // dx = w_u sum_n B_u[n] dh[n][p]
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4];
        frag_a(af, Bu, LDN, ul, 16 * kk, lane);
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int dp = 0; dp < 4; ++dp)
            if (dp < pk) {
              uint32_t bv[4];
              frag_b_kn(bv, Dq + q * Np * LDP, LDP, 16 * kk, 16 * dp, lane);
              mma2(acc[2 * dp], acc[2 * dp + 1], af, bv);
            }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= w_lo;
        acc[j][1] *= w_lo;
        acc[j][2] *= w_hi;
        acc[j][3] *= w_hi;
      }
    }
    if (active && role == 1) {
      // r = x_u . dh^T, 16 columns of n at a time
      uint32_t xa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < pk) frag_a(xa[kk], Xu, LDP, ul, 16 * kk, lane);
      float st_lo = 0.f, st_hi = 0.f;   // B_u . r
#pragma unroll
      for (int nq = 0; nq < 8; ++nq) {
        if (nq >= nk) break;
        float r[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[j][e] = 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < pk) {
              uint32_t bv[4];
              frag_b_nk(bv, Dq + q * Np * LDP, LDP, 16 * nq, 16 * kk, lane);
              mma2(r[0], r[1], xa[kk], bv);
            }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 16 * nq + 8 * j + 2 * t4;
          const float2 blo = bf2(Bu + (ul + g) * LDN + n);
          const float2 bhi = bf2(Bu + (ul + g + 8) * LDN + n);
          st_lo += blo.x * r[j][0] + blo.y * r[j][1];
          st_hi += bhi.x * r[j][2] + bhi.y * r[j][3];
          acc[2 * nq + j][0] += w_lo * r[j][0];
          acc[2 * nq + j][1] += w_lo * r[j][1];
          acc[2 * nq + j][2] += w_hi * r[j][2];
          acc[2 * nq + j][3] += w_hi * r[j][3];
        }
      }
      st_lo = quad_sum(st_lo);
      st_hi = quad_sum(st_hi);
      if (t4 == 0) {
        Xch[kTile + ul + g] = e_lo * st_lo;
        Xch[kTile + ul + g + 8] = e_hi * st_hi;
      }
    }
    __syncthreads();   // the planes are read: the ring takes their place

    if (vC) zero_cols(Cr, LDN, 2 * kTile, N, Np);
    if (vy) zero_cols(Yr, LDP, 2 * kTile, P, Pp);
    const int ntl = last - ju + 1;             // t tiles at or after u's
    stage_bf(Cr, LDN, Cg + u0 * a.sC_t, a.sC_t, a.sC_n, kTile, Lc - u0, N, Np,
             vC);
    stage_bf(Yr, LDP, yg + u0 * a.sy_t, a.sy_t, a.sy_p, kTile, Lc - u0, P, Pp,
             vy);
    cp_async_commit();
    float pd_lo = 0.f, pd_hi = 0.f;            // ddt's direct part
    for (int k = 0; k < ntl; ++k) {
      const int st = k & 1;
      if (k + 1 < ntl) {
        const int r1 = u0 + (k + 1) * kTile;
        stage_bf(Cr + (st ^ 1) * kTile * LDN, LDN, Cg + r1 * a.sC_t, a.sC_t,
                 a.sC_n, kTile, Lc - r1, N, Np, vC);
        stage_bf(Yr + (st ^ 1) * kTile * LDP, LDP, yg + r1 * a.sy_t, a.sy_t,
                 a.sy_p, kTile, Lc - r1, P, Pp, vy);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* Ct = Cr + st * kTile * LDN;
      const bf16* Yt = Yr + st * kTile * LDP;
      const int t0 = u0 + k * kTile;
#pragma unroll 1
      for (int ts = 0; ts < kTile / 16; ++ts) {
        const int tt = t0 + 16 * ts;           // the slice's first t
        if (!active || tt >= Lc) break;
        if (tt + 15 < u0 + ul) continue;       // every u of the warp > t
        // Q^T[u][t] = x_u . dy_t
        float qa[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < pk) {
            uint32_t bv[4];
            uint32_t af[4];
            frag_a(af, Xu, LDP, ul, 16 * kk, lane);
            frag_b_nk(bv, Yt, LDP, 16 * ts, 16 * kk, lane);
            mma2(qa[0], qa[1], af, bv);
          }
        uint32_t w1[4], w2[4], w3[4];
        if (role == 0) {
          // G^T[u][t] = B_u . C_t
          float ga[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ga[j][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk >= nk) break;
            uint32_t bv[4];
            uint32_t af[4];
            frag_a(af, Bu, LDN, ul, 16 * kk, lane);
            frag_b_nk(bv, Ct, LDN, 16 * ts, 16 * kk, lane);
            mma2(ga[0], ga[1], af, bv);
          }
          // W^T = G^T M dt_u as the A fragment: register m is row u_lo
          // (m even) or u_hi, columns t of n-tile m >> 1
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int jt = m >> 1, hi = m & 1;
            const int u = hi ? u_hi : u_lo;
            const int t = tt + 8 * jt + 2 * t4;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool live = u <= t + e && t + e < Lc;
              const float gm =
                  live ? ga[jt][2 * hi + e] * expf(Ss[t + e] - Ss[u]) : 0.f;
              v[e] = gm * Ds[u];
              if (hi)
                pd_hi += gm * qa[jt][2 * hi + e];
              else
                pd_lo += gm * qa[jt][2 * hi + e];
            }
            split3(v[0], v[1], w1[m], w2[m], w3[m]);
          }
          // dx += W^T . dy_t
#pragma unroll
          for (int dp = 0; dp < 4; ++dp)
            if (dp < pk) {
              uint32_t bv[4];
              frag_b_kn(bv, Yt, LDP, 16 * ts, 16 * dp, lane);
              mma2x3(acc[2 * dp], acc[2 * dp + 1], w1, w2, w3, bv);
            }
        } else {
          // V^T = Q^T M dt_u as the A fragment
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int jt = m >> 1, hi = m & 1;
            const int u = hi ? u_hi : u_lo;
            const int t = tt + 8 * jt + 2 * t4;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool live = u <= t + e && t + e < Lc;
              v[e] = live ? qa[jt][2 * hi + e] * expf(Ss[t + e] - Ss[u]) *
                                Ds[u]
                          : 0.f;
            }
            split3(v[0], v[1], w1[m], w2[m], w3[m]);
          }
          // dB += V^T . C_t
#pragma unroll
          for (int nq = 0; nq < 8; ++nq) {
            if (nq >= nk) break;
            uint32_t bv[4];
            frag_b_kn(bv, Ct, LDN, 16 * ts, 16 * nq, lane);
            mma2x3(acc[2 * nq], acc[2 * nq + 1], w1, w2, w3, bv);
          }
        }
      }
      __syncthreads();   // stage st is refilled next
    }

    // the head's dx and ddt
    if (role == 0) {
      pd_lo = quad_sum(pd_lo);
      pd_hi = quad_sum(pd_hi);
      if (active) {
        if (t4 == 0) {
          Xch[ul + g] = pd_lo;
          Xch[ul + g + 8] = pd_hi;
        }
        bf16* dxo = static_cast<bf16*>(a.dx);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int u = r ? u_hi : u_lo;
          if (u >= Lc) continue;
          bf16* row = dxo + ((b * a.S + c0 + u) * H + hd) * (long long)P;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = 8 * j + 2 * t4;
            if (p >= P) continue;
            if ((P & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(row + p) =
                  __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
            } else {
              row[p] = __float2bfloat16_rn(acc[j][2 * r]);
              if (p + 1 < P)
                row[p + 1] = __float2bfloat16_rn(acc[j][2 * r + 1]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    __syncthreads();
    if (tid < kTile && u0 + tid < Lc) {
      const long long row = c0 + u0 + tid;
      a.ddt[(b * a.S + row) * H + hd] = Xch[tid] + Xch[kTile + tid];
      a.ddts[(b * H + hd) * a.S + row] = Xch[kTile + tid];
    }
  }

  // the group's dB
  if (!active || role != 1) return;
  float* out = a.dBp + ((b * a.ng + grp) * a.S + c0) * (long long)N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + 2 * t4;
    if (n >= N) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = r ? u_hi : u_lo;
      if (u >= Lc) continue;
      float* o = out + (long long)u * N + n;
      o[0] = acc[j][2 * r];
      if (n + 1 < N) o[1] = acc[j][2 * r + 1];
    }
  }
}

// rows_t on the tensor cores: one block of 8 warps per (64-row tile of t,
// chunk, group of kGroup heads, batch row), two blocks per SM.  Warp w
// owns t rows t0 + 16 (w & 3) .. + 15 and the 16-column slices nq of N
// with nq % 2 = w >> 2 (its half).  C_t is staged once for the block; per
// head, in order:
//   dy_t, s, dt, and h_prev as three bf16 planes (in the tile that holds
//   the chunk's last row, also exp(s_L) <h_prev, dh>);
//   dC += exp(s_t) dy_t . h_prev^T and ds's exp(s_t) C_t . (h_prev dy_t)
//   over the warp's half of N;
//   over the u tiles at or before the t tile (a cp.async ring of B_u and
//   x_u rows, in the planes' place), per 16-row slice of u:
//     Q = dy_t . x_u^T,  G = C_t . B_u^T over the warp's half of N,
//     V = Q M dt_u in registers, split, dC += V . B_u (the half),
//     ds += sum_u G V (the half);
//   ds's terms in t written for the head, the two halves added in order.
// dC of the group is written at the end, one partial per group.
__global__ void __launch_bounds__(kMmaThreads, 2) ssd_bwd_rows_t_mma(Args a) {
  const int nt = (a.L + kTile - 1) / kTile;
  const int c = blockIdx.x / nt, it = blockIdx.x % nt;
  const int grp = blockIdx.y, h0 = grp * kGroup, h1 = min(a.H, h0 + kGroup);
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int N = a.N, P = a.P, L = a.L, H = a.H;
  const int Np = round_up(N, 16), Pp = round_up(P, 16);
  const int nk = Np / 16, pk = Pp / 16;
  const int LDN = ld_bf(Np), LDP = ld_bf(Pp), Lt = round_up(L, kTile);
  const long long c0 = (long long)c * L;
  const int Lc = (int)min((long long)L, a.S - c0);
  const int t0 = it * kTile;
  if (t0 >= Lc) return;
  const int half = warp >> 2;
  const int tl = 16 * (warp & 3);              // the warp's rows in the tile
  const bool active = t0 + tl < Lc;
  const int t_lo = t0 + tl + g, t_hi = t_lo + 8;   // the thread's two rows
  const bool tail = t0 + kTile >= Lc;          // holds the chunk's last row
  const bool vx = a.v16 & kVx, vB = a.v16 & kVB, vC = a.v16 & kVC,
             vy = a.v16 & kVy;

  extern __shared__ uint4 smem_u4[];
  bf16* Ct = reinterpret_cast<bf16*>(smem_u4);   // (kTile, LDN) C_t
  bf16* Yt = Ct + kTile * LDN;                   // (kTile, LDP) dy_t
  bf16* Hq = Yt + kTile * LDP;                   // 3 x (Np, LDP) h_prev
  bf16* Br = Hq;                                 // then 2 x (kTile, LDN) B_u
  bf16* Xr = Hq + 2 * kTile * LDN;               // and 2 x (kTile, LDP) x_u
  float* Ss = reinterpret_cast<float*>(Hq + plane_ring(Np, Pp));  // (Lt)
  float* Ds = Ss + Lt;                           // (Lt)
  float* Xch = Ds + Lt;                          // (2, kTile) ds by half
  float* Red = Xch + 2 * kTile;                  // (40) block sums

  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.sB_b + c0 * a.sB_t;
  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.sC_b + c0 * a.sC_t;
  if (vC) zero_cols(Ct, LDN, kTile, N, Np);
  if (vy) zero_cols(Yt, LDP, kTile, P, Pp);
  stage_bf(Ct, LDN, Cg + t0 * a.sC_t, a.sC_t, a.sC_n, kTile, Lc - t0, N, Np,
           vC);

  // acc[2 i + j]: dC's n-tile j of slice nq = half + 2 i; element e is
  // row t_lo (e < 2) or t_hi, column 16 nq + 8 j + 2 t4 + (e & 1)
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int hd = h0; hd < h1; ++hd) {
    const bf16* xg = static_cast<const bf16*>(a.x) + b * a.sx_b +
                     hd * a.sx_h + c0 * a.sx_t;
    const bf16* yg = static_cast<const bf16*>(a.dy) + b * a.sy_b +
                     hd * a.sy_h + c0 * a.sy_t;
    const float* dt = a.dt + b * a.sdt_b + hd * a.sdt_h + c0 * a.sdt_t;
    const float* sc = a.sc + ((b * H + hd) * a.nc + c) * (long long)L;
    const long long so = ((b * a.nc + c) * H + hd) * (long long)N * P;
    __syncthreads();   // the last head is done with Yt, the ring, Ss, Xch
    stage_bf(Yt, LDP, yg + t0 * a.sy_t, a.sy_t, a.sy_p, kTile, Lc - t0, P, Pp,
             vy);
    cp_async_commit();
    for (int t = tid; t < Lt; t += kMmaThreads) {
      Ss[t] = t < L ? sc[t] : 0.f;
      Ds[t] = t < Lc ? dt[t * a.sdt_t] : 0.f;
    }
    float dot = fill_planes(Hq, LDP, Np, Pp, a.hprev + so,
                            tail ? a.dhc + so : nullptr, N, P);
    cp_async_wait<0>();
    __syncthreads();
    if (tail) {   // exp(s_L) <h_prev, dh>, for the chunk's last row
      dot = block_sum(dot, Red);
      if (tid == 0) Red[32] = expf(Ss[L - 1]) * dot;
    }

    // the state's terms, over the warp's half of N
    float ds_lo = 0.f, ds_hi = 0.f;
    const float e_lo = t_lo < Lc ? expf(Ss[t_lo]) : 0.f;
    const float e_hi = t_hi < Lc ? expf(Ss[t_hi]) : 0.f;
    if (active) {
      uint32_t ya[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < pk) frag_a(ya[kk], Yt, LDP, tl, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nq = half + 2 * i;
        if (nq >= nk) break;
        float r[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[j][e] = 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < pk) {
              uint32_t bv[4];
              frag_b_nk(bv, Hq + q * Np * LDP, LDP, 16 * nq, 16 * kk, lane);
              mma2(r[0], r[1], ya[kk], bv);
            }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 16 * nq + 8 * j + 2 * t4;
          const float2 clo = bf2(Ct + (tl + g) * LDN + n);
          const float2 chi = bf2(Ct + (tl + g + 8) * LDN + n);
          const float s0 = e_lo * r[j][0], s1 = e_lo * r[j][1];
          const float s2 = e_hi * r[j][2], s3 = e_hi * r[j][3];
          acc[2 * i + j][0] += s0;
          acc[2 * i + j][1] += s1;
          acc[2 * i + j][2] += s2;
          acc[2 * i + j][3] += s3;
          ds_lo += clo.x * s0 + clo.y * s1;
          ds_hi += chi.x * s2 + chi.y * s3;
        }
      }
    }
    __syncthreads();   // the planes are read: the ring takes their place

    if (vB) zero_cols(Br, LDN, 2 * kTile, N, Np);
    if (vx) zero_cols(Xr, LDP, 2 * kTile, P, Pp);
    const int nu = it + 1;                     // u tiles at or before t's
    stage_bf(Br, LDN, Bg, a.sB_t, a.sB_n, kTile, Lc, N, Np, vB);
    stage_bf(Xr, LDP, xg, a.sx_t, a.sx_p, kTile, Lc, P, Pp, vx);
    cp_async_commit();
    for (int k = 0; k < nu; ++k) {
      const int st = k & 1;
      if (k + 1 < nu) {
        const int r1 = (k + 1) * kTile;
        stage_bf(Br + (st ^ 1) * kTile * LDN, LDN, Bg + r1 * a.sB_t, a.sB_t,
                 a.sB_n, kTile, Lc - r1, N, Np, vB);
        stage_bf(Xr + (st ^ 1) * kTile * LDP, LDP, xg + r1 * a.sx_t, a.sx_t,
                 a.sx_p, kTile, Lc - r1, P, Pp, vx);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* Bt = Br + st * kTile * LDN;
      const bf16* Xt = Xr + st * kTile * LDP;
      const int u0 = k * kTile;
#pragma unroll 1
      for (int us = 0; us < kTile / 16; ++us) {
        const int uu = u0 + 16 * us;           // the slice's first u
        if (!active || uu > t0 + tl + 15 || uu >= Lc) break;
        // Q[t][u] = dy_t . x_u
        float qa[2][4], ga[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[j][e] = ga[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < pk) {
            uint32_t bv[4];
            uint32_t af[4];
            frag_a(af, Yt, LDP, tl, 16 * kk, lane);
            frag_b_nk(bv, Xt, LDP, 16 * us, 16 * kk, lane);
            mma2(qa[0], qa[1], af, bv);
          }
        // G[t][u] = C_t . B_u over the half's columns
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nq = half + 2 * i;
          if (nq >= nk) break;
          uint32_t bv[4];
          uint32_t af[4];
          frag_a(af, Ct, LDN, tl, 16 * nq, lane);
          frag_b_nk(bv, Bt, LDN, 16 * us, 16 * nq, lane);
          mma2(ga[0], ga[1], af, bv);
        }
        // V = Q M dt_u as the A fragment: register m is row t_lo (m even)
        // or t_hi, columns u of n-tile m >> 1
        uint32_t v1[4], v2[4], v3[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int ju = m >> 1, hi = m & 1;
          const int t = hi ? t_hi : t_lo;
          const int u = uu + 8 * ju + 2 * t4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = u + e <= t && t < Lc;
            v[e] = live ? qa[ju][2 * hi + e] * expf(Ss[t] - Ss[u + e]) *
                              Ds[u + e]
                        : 0.f;
            if (hi)
              ds_hi += ga[ju][2 * hi + e] * v[e];
            else
              ds_lo += ga[ju][2 * hi + e] * v[e];
          }
          split3(v[0], v[1], v1[m], v2[m], v3[m]);
        }
        // dC += V . B_u over the half's columns
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nq = half + 2 * i;
          if (nq >= nk) break;
          uint32_t bv[4];
          frag_b_kn(bv, Bt, LDN, 16 * us, 16 * nq, lane);
          mma2x3(acc[2 * i], acc[2 * i + 1], v1, v2, v3, bv);
        }
      }
      __syncthreads();   // stage st is refilled next
    }

    // the head's ds terms in t: the two halves in order
    ds_lo = quad_sum(ds_lo);
    ds_hi = quad_sum(ds_hi);
    if (active && t4 == 0) {
      Xch[half * kTile + tl + g] = ds_lo;
      Xch[half * kTile + tl + g + 8] = ds_hi;
    }
    __syncthreads();
    if (tid < kTile && t0 + tid < Lc) {
      const int t = t0 + tid;
      a.dsp[(b * H + hd) * a.S + c0 + t] =
          Xch[tid] + Xch[kTile + tid] + (t == Lc - 1 ? Red[32] : 0.f);
    }
  }

  // the group's dC
  if (!active) return;
  float* out = a.dCp + ((b * a.ng + grp) * a.S + c0) * (long long)N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nq = half + 2 * i;
    if (nq >= nk) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 16 * nq + 8 * j + 2 * t4;
      if (n >= N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? t_hi : t_lo;
        if (t >= Lc) continue;
        float* o = out + (long long)t * N + n;
        o[0] = acc[2 * i + j][2 * r];
        if (n + 1 < N) o[1] = acc[2 * i + j][2 * r + 1];
      }
    }
  }
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

// the CUDA-core passes (fp32, fp16)
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
    *p = {{ssd_bwd_dstate_mma, ssd_bwd_state_pass, ssd_bwd_rows_u_mma,
           ssd_bwd_rows_t_mma, ssd_bwd_dlog, ssd_bwd_head_sum<bf16>},
          {mma_dstate_bytes(N, P, L), 0, mma_rows_bytes(N, P, L),
           mma_rows_bytes(N, P, L), ((size_t)L + kThreads) * sizeof(float),
           0}};
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

// dB and dC partials a call writes: one per head on the CUDA cores, one
// per group of kGroup heads on the tensor cores (bf16).
int partials(int dtype, int H) {
  return dtype == kBF16 ? (H + kGroup - 1) / kGroup : H;
}

// Whether a bf16 operand's rows go by cp.async 16: its last axis
// contiguous, `width` (its N or P) a multiple of 8, its other strides
// multiples of 8 elements and its base 16-byte aligned.
bool rows16(const void* base, const long long* s, int n, int width) {
  if (s[n - 1] != 1 || width % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(base) & 15u) != 0)
    return false;
  for (int i = 0; i + 1 < n; ++i)
    if (s[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// Floats of scratch a call in dtype needs: dH / dh (Bt, nc, H, N, P), the
// partials of dB and dC (Bt, ng, S, N) each (ng: H, or H / 8 rounded up
// for bf16), ds's terms in t and ddt's state part (Bt, H, S) each, and
// the per-chunk dA (Bt, H, nc); nc = ceil(S / L).
extern "C" long long ssd_scan_bwd_scratch_floats(long long Bt, long long S,
                                                 int H, int P, int N, int L,
                                                 int dtype) {
  const long long nc = (S + L - 1) / L, ng = partials(dtype, H);
  return Bt * (H * (nc * N * P + 2 * S + nc) + 2 * ng * S * N);
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
  const int ng = partials(dtype, H);
  float* dhc = scratch;
  float* dBp = dhc + Bt * nc * H * (long long)N * P;
  float* dCp = dBp + Bt * ng * S * N;
  float* dsp = dCp + Bt * ng * S * N;
  float* ddts = dsp + Bt * H * S;
  float* dAp = ddts + Bt * H * S;
  const int v16 = (rows16(x, strides, 4, P) ? kVx : 0) |
                  (rows16(B, strides + 7, 3, N) ? kVB : 0) |
                  (rows16(C, strides + 10, 3, N) ? kVC : 0) |
                  (rows16(dy, strides + 13, 4, P) ? kVy : 0);
  Args a{x, dt, A, B, C, dy, dhf, fwd_scratch,
         fwd_scratch + Bt * nc * H * (long long)N * P, dhc, dBp, dCp, dsp,
         ddts, dAp, dx, ddt, dB, dC, dA, Bt, S, H, P, N, L, (int)nc, ng, v16,
         strides[0], strides[1], strides[2], strides[3],
         strides[4], strides[5], strides[6],
         strides[7], strides[8], strides[9],
         strides[10], strides[11], strides[12],
         strides[13], strides[14], strides[15], strides[16]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 chunks((unsigned)nc, (unsigned)H, (unsigned)Bt);
  const dim3 tiles((unsigned)(nc * nt), (unsigned)ng, (unsigned)Bt);
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
