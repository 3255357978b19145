// Row gather and inverse-permutation scatter for capacity-bucketed
// active-set compaction (repro_torch.solvers.compaction), for sm_90a.
//
// gather_rows  replaces src/repro/kernels/flexa_prox.py:278 (gather_rows,
//              pallas_call at :294):  out[k] = src[idx[k]] as fp32, and a
//              zero row where idx[k] < 0.
// scatter_rows replaces src/repro/kernels/flexa_prox.py:308 (scatter_rows,
//              pallas_call at :329):  out[i] = vals[inv[i]] where
//              inv[i] >= 0, else base[i], in base's dtype.  The scatter is a
//              gather of the inverse permutation: one writer per output
//              row, no atomics.
// compact_best_response replaces src/repro/kernels/flexa_prox.py:351
//              (compact_best_response, pallas_call at :385): the gather of
//              the K rows idx picks from x, g (and a dense d), fused with
//              the FLEXA best response on them,
//                  w = x - g / d,  t = c / d,  z = sign(w) * max(|w| - t, 0)
//              z (K, C) fp32 with pad rows (idx = -1) exactly 0, and
//              e2 = sum over the gathered rows of (z - x)^2.  Both
//              quotients are true fp32 divisions (__fdiv_rn), as the
//              reference's oracle and the port's plain version divide.
//
// What bounds them on an H100: both move bytes and compute nothing, so the
// floor is (rows read + rows written) over the 3.35 TB/s of HBM3.  On the
// path the gather reads the K active columns of the transposed design
// matrix (rows of C = m floats, 20 KB each at m = 5000) and writes them
// densely; the scatter moves one float per block of an (n, 1) vector.
//
// compact_best_response reads the K gathered rows of x and g (and d) and
// writes z: 12 bytes per fp32 element (16 with dense d), 1.17 ms at
// (K, C) = (65536, 5000).
//
// What the design does about it:
//  * Wide rows (C >= 32): one block per output row.  Each thread moves 16
//    bytes of the source row per step (float4 for fp32, 8 halves for
//    bf16/fp16) when the row length and both base pointers allow it, so a
//    warp reads 512 contiguous bytes; consecutive blocks write
//    consecutive rows.  Rows with a negative index are only written.
//  * Narrow rows (C < 32, e.g. the (n, 1) Lasso vectors): one thread per
//    output row, so a 65536-row gather is 256 blocks, not 65536
//    one-element blocks.
//  * The scatter has the narrow layout only, for every C: the path
//    scatters (n, 1) vectors and nothing wider.
//  * Each block loads its own index; there is no scalar prefetch and no
//    padding of C to a lane multiple (the TPU kernel pads to 128 columns).
//  * compact_best_response has both layouts, with a grid the wrapper sizes
//    from K and the SM count alone: wide rows (C >= 32) one row per block
//    at a time, grid-stride over the rows, 4 elements per thread per step
//    (16 bytes of fp32, 8 of bf16) when C % 4 == 0 and the pointers allow
//    it; narrow rows (the (n, 1) layout of l1 block size 1) one row per
//    thread.  e2: each block sums its threads' (z - x)^2 in a fixed tree
//    into one partial; the last block to finish (a ticket counter, zeroed
//    by a memset before the launch) sums the partials in index order.  No
//    float atomics, so the same inputs give the same bits on every launch.
//
// Plain C interface, bound with ctypes: pointers are raw device addresses,
// the stream is the caller's current CUDA stream, and each launcher
// returns cudaGetLastError() after its launch (0 = success).  Indices
// must lie in [-1, N); the Python dispatch validates them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr long long kNarrowCols = 32;
constexpr int kNarrowThreads = 256;
constexpr int kMaxWideThreads = 256;

// dtype codes shared with repro_torch/kernels/flexa_prox.py
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

// ---------------------------------------------------------------- gather
template <typename T>
__global__ void gather_wide(const T* __restrict__ src,
                            const int* __restrict__ idx,
                            float* __restrict__ out, long long C, int vec) {
  const long long k = blockIdx.x;
  const int r = idx[k];
  float* o = out + k * C;
  if (vec) {
    // 16 bytes of source per step: V elements in, V floats (V/4 float4) out.
    constexpr int V = 16 / sizeof(T);
    const long long nv = C / V;
    float4* o4 = reinterpret_cast<float4*>(o);
    if (r < 0) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (long long j = threadIdx.x; j < nv * (V / 4); j += blockDim.x)
        o4[j] = z;
      return;
    }
    const uint4* s4 = reinterpret_cast<const uint4*>(src + (long long)r * C);
    for (long long j = threadIdx.x; j < nv; j += blockDim.x) {
      const uint4 raw = s4[j];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        o4[j * (V / 4) + q] =
            make_float4(Cvt<T>::to(e[4 * q]), Cvt<T>::to(e[4 * q + 1]),
                        Cvt<T>::to(e[4 * q + 2]), Cvt<T>::to(e[4 * q + 3]));
    }
    return;
  }
  if (r < 0) {
    for (long long j = threadIdx.x; j < C; j += blockDim.x) o[j] = 0.f;
    return;
  }
  const T* s = src + (long long)r * C;
  for (long long j = threadIdx.x; j < C; j += blockDim.x)
    o[j] = Cvt<T>::to(s[j]);
}

template <typename T>
__global__ void gather_narrow(const T* __restrict__ src,
                              const int* __restrict__ idx,
                              float* __restrict__ out, long long K,
                              long long C) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int r = idx[k];
  float* o = out + k * C;
  if (r < 0) {
    for (long long j = 0; j < C; ++j) o[j] = 0.f;
    return;
  }
  const T* s = src + (long long)r * C;
  for (long long j = 0; j < C; ++j) o[j] = Cvt<T>::to(s[j]);
}

int wide_threads(long long units) {
  long long t = ((units + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > kMaxWideThreads) t = kMaxWideThreads;
  return (int)t;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
void launch_gather(const void* src, const int* idx, float* out, long long K,
                   long long C, cudaStream_t st) {
  const T* s = static_cast<const T*>(src);
  if (C < kNarrowCols) {
    const long long blocks = (K + kNarrowThreads - 1) / kNarrowThreads;
    gather_narrow<T><<<(unsigned)blocks, kNarrowThreads, 0, st>>>(
        s, idx, out, K, C);
    return;
  }
  constexpr int V = 16 / sizeof(T);
  const int vec = (C % V == 0) && aligned16(src) && aligned16(out);
  gather_wide<T><<<(unsigned)K, wide_threads(vec ? C / V : C), 0, st>>>(
      s, idx, out, C, vec);
}

// --------------------------------------------------------------- scatter
template <typename TV, typename TO>
__global__ void scatter_narrow(const TV* __restrict__ vals,
                               const int* __restrict__ inv,
                               const TO* __restrict__ base,
                               TO* __restrict__ out, long long N,
                               long long C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int r = inv[i];
  TO* o = out + i * C;
  if (r < 0) {
    const TO* b = base + i * C;
    for (long long j = 0; j < C; ++j) o[j] = b[j];
    return;
  }
  const TV* v = vals + (long long)r * C;
  for (long long j = 0; j < C; ++j) o[j] = Cvt<TO>::from(Cvt<TV>::to(v[j]));
}

template <typename TV, typename TO>
void launch_scatter(const void* vals, const int* inv, const void* base,
                    void* out, long long N, long long C, cudaStream_t st) {
  const TV* v = static_cast<const TV*>(vals);
  const TO* b = static_cast<const TO*>(base);
  TO* o = static_cast<TO*>(out);
  const long long blocks = (N + kNarrowThreads - 1) / kNarrowThreads;
  scatter_narrow<TV, TO><<<(unsigned)blocks, kNarrowThreads, 0, st>>>(
      v, inv, b, o, N, C);
}

template <typename TV>
bool scatter_by_out(int out_dtype, const void* vals, const int* inv,
                    const void* base, void* out, long long N, long long C,
                    cudaStream_t st) {
  switch (out_dtype) {
    case kF32: launch_scatter<TV, float>(vals, inv, base, out, N, C, st); return true;
    case kBF16: launch_scatter<TV, __nv_bfloat16>(vals, inv, base, out, N, C, st); return true;
    case kF16: launch_scatter<TV, __half>(vals, inv, base, out, N, C, st); return true;
  }
  return false;
}

// ----------------------------------------------------- compact best response
constexpr int kCbrNarrowThreads = 256;

// Four consecutive elements as fp32 (16 bytes of fp32, 8 of bf16).
template <typename T> struct Load4;
template <> struct Load4<float> {
  static __device__ __forceinline__ void get(const float* p, float v[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};
template <> struct Load4<__nv_bfloat16> {
  static __device__ __forceinline__ void get(const __nv_bfloat16* p,
                                             float v[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __bfloat162float(e[q]);
  }
};

template <typename T, bool kDenseD, bool kVec>
__global__ void compact_br_wide(const T* __restrict__ x,
                                const T* __restrict__ g,
                                const float* __restrict__ d,
                                const int* __restrict__ idx, float c,
                                float* __restrict__ z,
                                float* __restrict__ partials,
                                unsigned* __restrict__ ticket,
                                float* __restrict__ e2, long long K,
                                long long C) {
  float d0 = 0.f, t0 = 0.f;
  if (!kDenseD) {
    d0 = d[0];
    t0 = __fdiv_rn(c, d0);
  }
  float acc = 0.f;
  for (long long k = blockIdx.x; k < K; k += gridDim.x) {
    const int r = idx[k];
    float* zo = z + k * C;
    if (r < 0) {                          // pad row: z = 0, nothing to e2
      for (long long j = threadIdx.x; j < C; j += blockDim.x) zo[j] = 0.f;
      continue;
    }
    const T* xr = x + (long long)r * C;
    const T* gr = g + (long long)r * C;
    const float* dr = d + (kDenseD ? (long long)r * C : 0);
    if (kVec) {
      for (long long j = 4 * threadIdx.x; j < C; j += 4 * blockDim.x) {
        float xv[4], gv[4], dv[4], zv[4];
        Load4<T>::get(xr + j, xv);
        Load4<T>::get(gr + j, gv);
        if (kDenseD) Load4<float>::get(dr + j, dv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float dq = kDenseD ? dv[q] : d0;
          zv[q] = response(xv[q], gv[q], dq,
                           kDenseD ? __fdiv_rn(c, dq) : t0);
          const float diff = zv[q] - xv[q];
          acc += diff * diff;
        }
        *reinterpret_cast<float4*>(zo + j) =
            make_float4(zv[0], zv[1], zv[2], zv[3]);
      }
    } else {
      for (long long j = threadIdx.x; j < C; j += blockDim.x) {
        const float xf = Cvt<T>::to(xr[j]);
        const float dq = kDenseD ? dr[j] : d0;
        const float zj = response(xf, Cvt<T>::to(gr[j]), dq,
                                  kDenseD ? __fdiv_rn(c, dq) : t0);
        zo[j] = zj;
        const float diff = zj - xf;
        acc += diff * diff;
      }
    }
  }
  grid_sum(acc, partials, ticket, e2);
}

template <typename T, bool kDenseD>
__global__ void compact_br_narrow(const T* __restrict__ x,
                                  const T* __restrict__ g,
                                  const float* __restrict__ d,
                                  const int* __restrict__ idx, float c,
                                  float* __restrict__ z,
                                  float* __restrict__ partials,
                                  unsigned* __restrict__ ticket,
                                  float* __restrict__ e2, long long K,
                                  long long C) {
  float d0 = 0.f, t0 = 0.f;
  if (!kDenseD) {
    d0 = d[0];
    t0 = __fdiv_rn(c, d0);
  }
  float acc = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < K; k += stride) {
    const int r = idx[k];
    float* zo = z + k * C;
    if (r < 0) {
      for (long long j = 0; j < C; ++j) zo[j] = 0.f;
      continue;
    }
    const long long o = (long long)r * C;
    for (long long j = 0; j < C; ++j) {
      const float xf = Cvt<T>::to(x[o + j]);
      const float dq = kDenseD ? d[o + j] : d0;
      const float zj = response(xf, Cvt<T>::to(g[o + j]), dq,
                                kDenseD ? __fdiv_rn(c, dq) : t0);
      zo[j] = zj;
      const float diff = zj - xf;
      acc += diff * diff;
    }
  }
  grid_sum(acc, partials, ticket, e2);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, bool kDenseD>
void launch_cbr(const void* x, const void* g, const float* d, const int* idx,
                float c, float* z, float* work, long long K, long long C,
                int blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  float* partials = work;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + blocks);
  float* e2 = work + blocks + 1;
  if (C < kNarrowCols) {
    compact_br_narrow<T, kDenseD><<<blocks, kCbrNarrowThreads, 0, st>>>(
        xt, gt, d, idx, c, z, partials, ticket, e2, K, C);
    return;
  }
  // 4 elements per step: 16 bytes of fp32 or 8 of bf16 from every row
  const uintptr_t a = 4 * sizeof(T);
  const bool vec = C % 4 == 0 && aligned(x, a) && aligned(g, a) &&
                   aligned(z, 16) && (!kDenseD || aligned(d, 16));
  const int threads = wide_threads(vec ? C / 4 : C);
  if (vec)
    compact_br_wide<T, kDenseD, true><<<blocks, threads, 0, st>>>(
        xt, gt, d, idx, c, z, partials, ticket, e2, K, C);
  else
    compact_br_wide<T, kDenseD, false><<<blocks, threads, 0, st>>>(
        xt, gt, d, idx, c, z, partials, ticket, e2, K, C);
}

template <typename T>
void launch_cbr_d(int dense_d, const void* x, const void* g, const float* d,
                  const int* idx, float c, float* z, float* work,
                  long long K, long long C, int blocks, cudaStream_t st) {
  if (dense_d)
    launch_cbr<T, true>(x, g, d, idx, c, z, work, K, C, blocks, st);
  else
    launch_cbr<T, false>(x, g, d, idx, c, z, work, K, C, blocks, st);
}

}  // namespace

extern "C" int gather_rows_launch(const void* src, int src_dtype,
                                  const int* idx, float* out, long long K,
                                  long long C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case kF32: launch_gather<float>(src, idx, out, K, C, st); break;
    case kBF16: launch_gather<__nv_bfloat16>(src, idx, out, K, C, st); break;
    case kF16: launch_gather<__half>(src, idx, out, K, C, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int scatter_rows_launch(const void* vals, int vals_dtype,
                                   const int* inv, const void* base,
                                   void* out, int out_dtype, long long N,
                                   long long C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (vals_dtype) {
    case kF32: ok = scatter_by_out<float>(out_dtype, vals, inv, base, out, N, C, st); break;
    case kBF16: ok = scatter_by_out<__nv_bfloat16>(out_dtype, vals, inv, base, out, N, C, st); break;
    case kF16: ok = scatter_by_out<__half>(out_dtype, vals, inv, base, out, N, C, st); break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// z (K, C) fp32 and e2 of the rows idx picks from x and g (N, C), fp32
// (dtype 0) or bf16 (1).  d: a 0-d fp32 array (dense_d = 0) or dense fp32
// (N, C); c a host float.  work: blocks + 2 fp32 slots — the per-block
// partials, the ticket counter (as unsigned, zeroed here before the
// launch) and e2.  blocks: the grid, which the caller sizes from K and
// the SM count (rows per block-step for C >= 32, 256-row groups below).
extern "C" int compact_best_response_launch(const void* x, const void* g,
                                            int dtype, const float* d,
                                            int dense_d, float c,
                                            const int* idx, float* z,
                                            float* work, long long K,
                                            long long C, int blocks,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || C <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(work + blocks, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  switch (dtype) {
    case kF32: launch_cbr_d<float>(dense_d, x, g, d, idx, c, z, work, K, C, blocks, st); break;
    case kBF16: launch_cbr_d<__nv_bfloat16>(dense_d, x, g, d, idx, c, z, work, K, C, blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
