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
// kernel never forms it (the TPU kernel masks with jnp.where before the
// product, ssd_scan.py:58).
//
// What bounds it on an H100: the work is chunk-local matrix algebra, so
// operations, not bytes.  At the full mamba2-1.3b width (H = 64, P = 64,
// N = 128, L = 256) a chunk of one head needs about 10.5 M multiply-adds
// (G and W.X over the lower triangle 6.3 M, C.h 2.1 M, the state update
// 2.1 M) and reads 256 x (64 + 2 x 128) input values.  This first kernel
// is simple, and does 12.1 M (whole 64-row tiles on the diagonal):
//
//  * One block of 256 threads per (b, h).  It walks the chunks in order
//    and keeps the (N, P) state in shared memory (32 KB at full width).
//  * A chunk is processed in tiles of 64 rows: for each tile of t, the
//    C rows are staged once, then every tile of u <= t stages its B and
//    x rows (re-read from L2 for each tile of t) and a (64, 64) tile of
//    W, so the (L, L) matrix never exists whole.  Shared memory: about
//    133 KB at full width, set with cudaFuncSetAttribute.  A thread
//    issues all its loads of a tile before it stores any, so the load
//    latency is paid once per tile (the stages are not yet overlapped
//    with the products).
//  * fp32 throughout with fp32 FMAs, no tensor cores.  Each thread
//    computes a 4 x 4 (state update: 8 x 4) register tile and reads its
//    operands from shared memory 16 bytes at a time along the reduced
//    axis (n, or u), so a product issues 8 128-bit loads per 64 FMAs.
//    Rows of staged B and C (and of W) are padded to a stride of 4 x an
//    odd number of floats: no bank conflicts for those loads.  A thread's
//    4 columns of x, h and y are adjacent (p = 4 tx .. 4 tx + 3).
//  * Every reduction runs in a fixed order (the chunk cumsum as per-lane
//    runs plus a shuffle scan, the dot products as plain loops); there
//    are no atomics, so two launches give the same bits.
//  * What it leaves for a later redesign: at Bt = 1 there are only H =
//    64 blocks for 132 SMs, and G = C.B^T is formed once per head though
//    B and C are shared by all heads (one group).  A chunk-parallel
//    state pass plus a short scan over chunks, and G once per (b, chunk)
//    on the tensor cores, would attack both.
//
// Plain C interface, bound with ctypes: pointers are raw device
// addresses, strides are in elements, the stream is the caller's current
// CUDA stream, and the launcher returns a CUDA error code (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kTile = 64;           // rows of t or u per tile
constexpr int kSide = 16;           // threads are a 16 x 16 grid
constexpr int kThreads = kSide * kSide;
constexpr int kMaxP = 64;           // 4 columns per thread
constexpr int kMaxN = 128;          // 8 state rows per thread
constexpr int kTI = kTile / kSide;  // 4
constexpr int kNI = kMaxN / kSide;  // 8
constexpr int kLdw = kTile + 4;     // row stride of the W tile (17 x 4)
constexpr size_t kMaxSmem = 232448; // what one block may opt into

// dtype codes shared with repro_torch/kernels/ssd_scan.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float to(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half from(float v) {
    return __float2half_rn(v);
  }
};

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* h;
  long long S;
  int H, P, N, L;
  long long sx_b, sx_t, sx_h, sx_p;
  long long sdt_b, sdt_t, sdt_h;
  long long sB_b, sB_t, sB_n;
  long long sC_b, sC_t, sC_n;
};

// N rounded up to a multiple of 4, and the row stride of staged B and C:
// 4 x an odd number of floats, so 8 threads reading 16 bytes from 8
// consecutive rows hit 8 distinct bank groups.
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int row_stride(int N) {
  const int n4 = round4(N);
  return n4 + ((n4 / 4) % 2 == 0 ? 4 : 8);
}

size_t smem_floats(int N, int P, int L) {
  (void)P;  // x, h and the W tile are laid out for kMaxP columns
  return (size_t)round4(N) * kMaxP + 2 * (size_t)kTile * row_stride(N) +
         (size_t)kTile * kMaxP + (size_t)kTile * kLdw + 2 * (size_t)L +
         kTile;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_chunked(Args a) {
  const int b = blockIdx.x / a.H, hd = blockIdx.x % a.H;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int N = a.N, P = a.P, L = a.L;
  const int N4 = round4(N), ldb = row_stride(N), p0 = 4 * tx;

  extern __shared__ float4 sm4[];   // float4: 16-byte aligned
  float* Hs = reinterpret_cast<float*>(sm4);  // (N4, kMaxP) state
  float* Cs = Hs + N4 * kMaxP;      // (kTile, ldb) C rows of the t tile
  float* Bs = Cs + kTile * ldb;     // (kTile, ldb) B rows of the u tile
  float* Xs = Bs + kTile * ldb;     // (kTile, kMaxP) x rows of the u tile
  float* Ws = Xs + kTile * kMaxP;   // (kTile, kLdw) W tile
  float* Ss = Ws + kTile * kLdw;    // (L) cumsum of dt * A
  float* Ds = Ss + L;               // (L) dt, 0 past the data
  float* Us = Ds + L;               // (kTile) exp(s_L - s_u) * dt_u

  const T* x = static_cast<const T*>(a.x) + b * a.sx_b + hd * a.sx_h;
  const float* dt = a.dt + b * a.sdt_b + hd * a.sdt_h;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sB_b;
  const T* Cg = static_cast<const T*>(a.C) + b * a.sC_b;
  const long long y_t = (long long)a.H * P;
  T* y = static_cast<T*>(a.y) + ((long long)b * a.S * a.H + hd) * P;
  const float A = a.A[hd];

  for (int e = tid; e < N4 * kMaxP; e += kThreads) Hs[e] = 0.f;

  for (long long c0 = 0; c0 < a.S; c0 += L) {
    const int Lc = (int)min((long long)L, a.S - c0);  // rows with data
    __syncthreads();
    for (int t = tid; t < L; t += kThreads)
      Ds[t] = t < Lc ? dt[(c0 + t) * a.sdt_t] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(Ds, Ss, A, L, tid);
    __syncthreads();
    const float s_last = Ss[L - 1];

    // ---- outputs, one tile of t rows at a time
    for (int t0 = 0; t0 < Lc; t0 += kTile) {
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
        for (int u = 0; u < round4(nu); u += 4) {
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
          if (p0 + q < P) y[(c0 + t) * y_t + p0 + q] = Cvt<T>::from(acc[i][q]);
      }
      __syncthreads();
    }

    // ---- state update: h = exp(s_L) h + sum_u (exp(s_L - s_u) dt_u B_u)^T x_u
    // hacc[i][q] is state row n = ty + 16 i, column p0 + q
    float hacc[kNI][4];
#pragma unroll
    for (int i = 0; i < kNI; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) hacc[i][q] = 0.f;
    for (int u0 = 0; u0 < Lc; u0 += kTile) {
      const int nu = min(kTile, Lc - u0);
      __syncthreads();
      stage<T, kNI>(Bs, ldb, Bg, a.sB_t, a.sB_n, c0 + u0, nu, N, N4,
                      ty, tx);
      stage<T, kMaxP / kSide>(Xs, kMaxP, x, a.sx_t, a.sx_p, c0 + u0, nu,
                                P, kMaxP, ty, tx);
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
    const float decay = expf(s_last);
    // Hs was last read by the output tiles, which every thread has left.
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int n = ty + kSide * i;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p0 + q < P) {
          float* hp = Hs + n * kMaxP + p0 + q;
          *hp = decay * *hp + hacc[i][q];
        }
    }
  }
  __syncthreads();
  float* h = a.h + ((long long)b * a.H + hd) * N * P;
  for (int e = tid; e < N * P; e += kThreads)
    h[e] = Hs[(e / P) * kMaxP + e % P];
}

template <typename T>
int launch(const Args& a, long long Bt, cudaStream_t st) {
  const size_t smem = smem_floats(a.N, a.P, a.L) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      ssd_scan_chunked<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  ssd_scan_chunked<T><<<(unsigned)(Bt * a.H), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 13 element strides, in the order x (b, t, h, p), dt (b, t, h),
// B (b, t, n), C (b, t, n).  Returns cudaErrorInvalidValue for shapes the
// kernel does not take (P > 64, N > 128, too much shared memory).
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* A, const void* B, const void* C,
                               int dtype, void* y, float* h, long long Bt,
                               long long S, int H, int P, int N, int L,
                               const long long* strides, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || L < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x, dt, A, B, C, y, h, S, H, P, N, L,
         strides[0], strides[1], strides[2], strides[3],
         strides[4], strides[5], strides[6],
         strides[7], strides[8], strides[9],
         strides[10], strides[11], strides[12]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(a, Bt, st);
    case kBF16: return launch<__nv_bfloat16>(a, Bt, st);
    case kF16: return launch<__half>(a, Bt, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t ssd_scan_smem_bytes(int N, int P, int L) {
  return smem_floats(N, P, L) * sizeof(float);
}
