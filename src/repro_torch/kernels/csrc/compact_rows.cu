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
// (K, C) = (65536, 5000).  On the fig1d path's state, (n, 1) vectors and
// a K = 16384 bucket, and in scatter_rows' (100000, 1) vectors, the bytes
// take less than one launch (1.01 us for an empty kernel replayed from a
// CUDA graph on an H100): there the fixed cost of a call bounds them, its
// device operations and its chain of loads that wait on each other.
//
// What the design does about it:
//  * gather_rows, wide rows (C >= 32): one block per output row.  Each
//    thread moves 16 bytes of the source row per step (float4 for fp32, 8
//    halves for bf16/fp16) when the row length and both base pointers
//    allow it, so a warp reads 512 contiguous bytes; consecutive blocks
//    write consecutive rows.  Rows with a negative index are only
//    written.  Narrow rows (C < 32, e.g. the (n, 1) Lasso vectors): one
//    thread per output row, so a 65536-row gather is 256 blocks, not
//    65536 one-element blocks.  Each block loads its own index; there is
//    no scalar prefetch and no padding of C to a lane multiple (the TPU
//    kernel pads to 128 columns).
//  * scatter_rows, the path's (n, 1) fp32 form (C = 1, fp32 vals and
//    base, inv, base and out 16-byte aligned): scatter_rows4, each thread
//    4 consecutive rows.  It issues one int4 load of inv and one float4
//    load of base back to back (neither waits on the other), then the
//    vals loads of the rows that have a slot, all in flight together,
//    then one float4 store: two dependent round trips per 4 rows, where
//    a thread per row waited on inv before it read base.  A ragged tail
//    of n mod 4 rows goes one row at a time in the last thread.  The grid
//    is ceil(n / 1024) blocks of 256, a function of n only: 98 at n =
//    100000, one wave on 132 SMs.  Every other dtype pair or C, and an
//    unaligned view, takes scatter_narrow, one thread per row.  The
//    launcher picks the form and sizes the grid.  One writer per row, no
//    atomics.
//  * compact_best_response, one cluster (K * C <= 16 x 8192, 8 x 8192 on a
//    card that cannot place 16; every bucket of the (n, 1) path up to
//    K = 131072): compact_br_cluster, one launch of one thread-block
//    cluster of up to 16 CTAs of 512 threads, each CTA a contiguous share
//    of the flattened (K, C) output (per_cta elements, a multiple of 8,
//    at most 8192; ceil(K * C / 256) CTAs, so the path's K = 16384 takes
//    16 of 1024).  A gather of scattered rows is bounded by the loads
//    each SM can have in flight, not by the bytes, so the cluster spreads
//    over its 16 SMs as soon as each CTA has 256 elements.  A thread
//    issues all of its idx loads, then all of its gathered x, g (and
//    dense d) loads, before any arithmetic, in one of two forms: (n, 1)
//    rows 4 at a time where idx and z are 16-byte aligned (an int4 of
//    idx, a float4 of z), else one element at a time (the launcher picks
//    it).  e2: each thread sums (z - x)^2 per lane in order,
//    block_sum gives the CTA's partial and cluster_sum (common.cuh) sends
//    it by st.async into rank 0's shared memory and sums the slots in a
//    fixed order.  No memset, ticket, memory fence or atomic, and only z
//    and e2 are allocated.  The order depends only on K, C and the card,
//    so the same inputs give the same bits on every launch.
//  * compact_best_response above one cluster (the wide (65536, 5000)
//    shape): the grid form, with a grid the wrapper sizes from K and the
//    SM count alone.  Wide rows (C >= 32) one row per block at a time,
//    grid-stride over the rows, 4 elements per thread per step (16 bytes
//    of fp32, 8 of bf16) when C % 4 == 0 and the pointers allow it;
//    narrow rows one row per thread.  e2: each block sums its threads'
//    (z - x)^2 in a fixed tree into one partial; the last block to
//    finish (a ticket counter, zeroed by a memset before the launch) sums
//    the partials in index order.  No float atomics, so the same inputs
//    give the same bits on every launch.  At 1.4 ms the memset and the
//    ticket's round trips are lost in the bytes.
//  * Both quotients of the response are true fp32 divisions (no
//    --use_fast_math), so z equals the plain version bit for bit.

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

// The path's (n, 1) fp32 scatter, 4 consecutive rows per thread: inv,
// base and out 16-byte aligned.  Both 16-byte loads go out before the
// vals loads that wait on inv, and those go out together.
__global__ void __launch_bounds__(kNarrowThreads)
    scatter_rows4(const float* __restrict__ vals, const int* __restrict__ inv,
                  const float* __restrict__ base, float* __restrict__ out,
                  long long N) {
  const long long i =
      4 * ((long long)blockIdx.x * kNarrowThreads + threadIdx.x);
  if (i + 4 <= N) {
    const int4 r = *reinterpret_cast<const int4*>(inv + i);
    const float4 b = *reinterpret_cast<const float4*>(base + i);
    float4 o = b;
    if (r.x >= 0) o.x = vals[r.x];
    if (r.y >= 0) o.y = vals[r.y];
    if (r.z >= 0) o.z = vals[r.z];
    if (r.w >= 0) o.w = vals[r.w];
    *reinterpret_cast<float4*>(out + i) = o;
    return;
  }
  for (long long j = i; j < N; ++j) {    // the last n mod 4 rows
    const int r = inv[j];
    out[j] = r >= 0 ? vals[r] : base[j];
  }
}

template <typename TV, typename TO>
void launch_scatter(const void* vals, const int* inv, const void* base,
                    void* out, long long N, long long C, cudaStream_t st) {
  const long long blocks = (N + kNarrowThreads - 1) / kNarrowThreads;
  scatter_narrow<TV, TO><<<(unsigned)blocks, kNarrowThreads, 0, st>>>(
      static_cast<const TV*>(vals), inv, static_cast<const TO*>(base),
      static_cast<TO*>(out), N, C);
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

// The one-cluster form: threads per CTA, elements one CTA takes at most
// (its share of the flattened (K, C) output) and one thread, CTAs per
// cluster at most.  One cluster per call, so one CTA per SM: a thread may
// hold all 16 of its elements' loads in flight.
constexpr int kCbrThreads = 512;
constexpr int kCbrCtaElems = 8192;
constexpr int kCbrThreadElems = kCbrCtaElems / kCbrThreads;
constexpr int kCbrMaxCluster = 16;

// How a thread of the one-cluster form takes its elements, kCbrStep of
// them per step: kRows4, 4 consecutive rows of the (K, 1) layout (one
// int4 of idx, gathered scalars, one float4 of z); kScalar, one element.
enum CbrForm { kRows4 = 0, kScalar = 1 };
constexpr int kCbrForms = 2;

template <int kForm>
constexpr int kCbrStep = kForm == kRows4 ? 4 : 1;

// The one-cluster form: one launch of one cluster of gridDim.x CTAs; CTA
// r takes elements [r * per_cta, (r + 1) * per_cta) of the n = K * C
// outputs, step j of thread t the j * kCbrThreads + t-th step of them.
template <typename T, bool kDenseD, int kForm>
__global__ void __launch_bounds__(kCbrThreads, 1)
    compact_br_cluster(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ d,
                       const int* __restrict__ idx, float c,
                       float* __restrict__ z, float* __restrict__ e2, int n,
                       int C, int per_cta) {
  cluster_sum_begin();
  constexpr int V = kCbrStep<kForm>;     // elements (and rows) per step
  constexpr int S = kCbrThreadElems / V; // steps per thread
  const int t = threadIdx.x;
  const int lo = blockIdx.x * per_cta;
  const int cnt = max(0, min(per_cta, n - lo));
  const int steps = cnt / V;
  const int tail = steps * V + t;        // kRows4: the last cnt mod 4 rows
  const float d0 = kDenseD ? 0.f : d[0];
  // every index of the thread: r[j][q] the row of lane q of step j
  int r[S][V], col[S];
  int rt = -1;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int u = j * kCbrThreads + t;
    if (u >= steps) continue;
    if constexpr (kForm == kRows4) {
      const int4 q = reinterpret_cast<const int4*>(idx + lo)[u];
      r[j][0] = q.x; r[j][1] = q.y; r[j][2] = q.z; r[j][3] = q.w;
    } else {
      const int e = lo + u * V;
      const int k = e / C;
      col[j] = e - k * C;
      r[j][0] = idx[k];
    }
  }
  if constexpr (kForm == kRows4)
    if (tail < cnt) rt = idx[lo + tail];
  // every gathered load of the thread
  float xv[S][V], gv[S][V], dv[S][V];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int u = j * kCbrThreads + t;
    if (u >= steps) continue;
    if constexpr (kForm == kRows4) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (r[j][q] < 0) continue;
        xv[j][q] = Cvt<T>::to(x[r[j][q]]);
        gv[j][q] = Cvt<T>::to(g[r[j][q]]);
        if (kDenseD) dv[j][q] = d[r[j][q]];
      }
    } else {
      if (r[j][0] < 0) continue;
      const long long o = (long long)r[j][0] * C + col[j];
      xv[j][0] = Cvt<T>::to(x[o]);
      gv[j][0] = Cvt<T>::to(g[o]);
      if (kDenseD) dv[j][0] = d[o];
    }
  }
  float xt = 0.f, gt = 0.f, dt = 1.f;
  if (rt >= 0) {
    xt = Cvt<T>::to(x[rt]);
    gt = Cvt<T>::to(g[rt]);
    if (kDenseD) dt = d[rt];
  }
  // the responses, z, and the thread's sum of (z - x)^2 per lane
  const float t0 = kDenseD ? 0.f : __fdiv_rn(c, d0);
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int u = j * kCbrThreads + t;
    if (u >= steps) continue;
    float zv[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      zv[q] = 0.f;                                  // a pad row
      if (r[j][q] < 0) continue;
      const float dq = kDenseD ? dv[j][q] : d0;
      zv[q] = response(xv[j][q], gv[j][q], dq,
                       kDenseD ? __fdiv_rn(c, dq) : t0);
      const float diff = zv[q] - xv[j][q];
      acc[q] += diff * diff;
    }
    if constexpr (kForm == kRows4)
      *reinterpret_cast<float4*>(z + lo + u * V) =
          make_float4(zv[0], zv[1], zv[2], zv[3]);
    else
      z[lo + u] = zv[0];
  }
  if constexpr (kForm == kRows4) {
    if (tail < cnt) {
      float zt = 0.f;
      if (rt >= 0) {
        const float dq = kDenseD ? dt : d0;
        zt = response(xt, gt, dq, kDenseD ? __fdiv_rn(c, dq) : t0);
        const float diff = zt - xt;
        acc[0] += diff * diff;
      }
      z[lo + tail] = zt;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) s += acc[q];
  cluster_sum(s, e2);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The one-cluster kernels by [dtype][dense d][form].
#define CBR_FORMS(T, D)                                                    \
  {reinterpret_cast<const void*>(compact_br_cluster<T, D, kRows4>),        \
   reinterpret_cast<const void*>(compact_br_cluster<T, D, kScalar>)}
const void* const kCbrCluster[2][2][kCbrForms] = {
    {CBR_FORMS(float, false), CBR_FORMS(float, true)},
    {CBR_FORMS(__nv_bfloat16, false), CBR_FORMS(__nv_bfloat16, true)}};
#undef CBR_FORMS
constexpr int kCbrClusterKernels = 2 * 2 * kCbrForms;

// allow_wide_clusters' flags of one-cluster kernel k (flat index into
// kCbrCluster), by device.
bool cbr_ready[kCbrClusterKernels][kMaxClusterDevices];

// The form a one-cluster launch takes for these pointers and C.
int cbr_form(const int* idx, const float* z, long long C) {
  return C == 1 && aligned(idx, 16) && aligned(z, 16) ? kRows4 : kScalar;
}

template <typename T, bool kDenseD>
void launch_cbr(const void* x, const void* g, const float* d, const int* idx,
                float c, float* z, float* work, float* e2, long long K,
                long long C, int blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  float* partials = work;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + blocks);
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
                  const int* idx, float c, float* z, float* work, float* e2,
                  long long K, long long C, int blocks, cudaStream_t st) {
  if (dense_d)
    launch_cbr<T, true>(x, g, d, idx, c, z, work, e2, K, C, blocks, st);
  else
    launch_cbr<T, false>(x, g, d, idx, c, z, work, e2, K, C, blocks, st);
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

// out (N, C) in base's dtype.  C = 1, fp32 vals and base and 16-byte
// aligned inv, base and out: scatter_rows4 on ceil(N / 1024) blocks;
// anything else scatter_narrow on ceil(N / 256).
extern "C" int scatter_rows_launch(const void* vals, int vals_dtype,
                                   const int* inv, const void* base,
                                   void* out, int out_dtype, long long N,
                                   long long C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (C == 1 && vals_dtype == kF32 && out_dtype == kF32 &&
      aligned(inv, 16) && aligned(base, 16) && aligned(out, 16)) {
    const long long rows = 4 * kNarrowThreads;
    scatter_rows4<<<(unsigned)((N + rows - 1) / rows), kNarrowThreads, 0,
                    st>>>(static_cast<const float*>(vals), inv,
                          static_cast<const float*>(base),
                          static_cast<float*>(out), N);
    return (int)cudaGetLastError();
  }
  bool ok = false;
  switch (vals_dtype) {
    case kF32: ok = scatter_by_out<float>(out_dtype, vals, inv, base, out, N, C, st); break;
    case kBF16: ok = scatter_by_out<__nv_bfloat16>(out_dtype, vals, inv, base, out, N, C, st); break;
    case kF16: ok = scatter_by_out<__half>(out_dtype, vals, inv, base, out, N, C, st); break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// z (K, C) fp32 and e2 (a 0-d fp32) of the rows idx picks from x and g
// (N, C), fp32 (dtype 0) or bf16 (1).  d: a 0-d fp32 array (dense_d = 0)
// or dense fp32 (N, C); c a host float.  With work null, the one-cluster
// form: one launch of one cluster of ctas <= 16 CTAs, per_cta elements of
// the flattened (K, C) each (a multiple of 8, at most 8192, ctas *
// per_cta >= K * C).  Otherwise the grid form: ctas blocks (rows per
// block-step for C >= 32, 256-row groups below), work ctas + 1 fp32 slots
// (the per-block partials and the ticket counter, as unsigned, zeroed
// here before the launch); per_cta unused.  The caller sizes both from
// K, C and the card.
extern "C" int compact_best_response_launch(
    const void* x, const void* g, int dtype, const float* d, int dense_d,
    float c, const int* idx, float* z, float* e2, float* work, long long K,
    long long C, int ctas, int per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || C <= 0 || ctas <= 0 || dtype < 0 || dtype > kBF16)
    return (int)cudaErrorInvalidValue;
  if (work) {
    cudaError_t err = cudaMemsetAsync(work + ctas, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
    if (dtype == kF32)
      launch_cbr_d<float>(dense_d, x, g, d, idx, c, z, work, e2, K, C, ctas, st);
    else
      launch_cbr_d<__nv_bfloat16>(dense_d, x, g, d, idx, c, z, work, e2, K, C, ctas, st);
    return (int)cudaGetLastError();
  }
  if (ctas > kCbrMaxCluster || per_cta <= 0 || per_cta > kCbrCtaElems ||
      per_cta % 8 != 0 || (long long)ctas * per_cta < K * C)
    return (int)cudaErrorInvalidValue;
  const int form = cbr_form(idx, z, C);
  const int k = (dtype * 2 + (dense_d != 0)) * kCbrForms + form;
  int rc = allow_wide_clusters((&kCbrCluster[0][0][0])[k], cbr_ready[k]);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(ctas), ctas, kCbrThreads, 0, &attr, st);
  int n = (int)(K * C), Ci = (int)C;
  void* args[] = {&x, &g, &d, &idx, &c, &z, &e2, &n, &Ci, &per_cta};
  rc = (int)cudaLaunchKernelExC(&cfg, (&kCbrCluster[0][0][0])[k], args);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The largest cluster of compact_best_response's one-cluster form on the
// current device: 16 where the card can place a cluster of 16 CTAs of
// every one-cluster kernel, else 8 (into *out).  Returns a CUDA error
// code.
extern "C" int compact_max_cluster(int* out) {
  return largest_cluster(&kCbrCluster[0][0][0], cbr_ready,
                         kCbrClusterKernels, kCbrThreads, out);
}

// What the compiler and the card made of the one-cluster kernel for fp32
// x and g, dense d and aligned pointers in form `form` (0 the (K, 1)
// rows, 1 one element), with clusters of C
// CTAs: out[0..4] = registers per thread, local (spill) bytes per thread,
// threads per CTA, elements per CTA at most, clusters of C the card can
// hold at once.  Returns a CUDA error code.
extern "C" int compact_kernel_info(int C, int form, long long* out) {
  if (C < 1 || C > kCbrMaxCluster || form < 0 || form >= kCbrForms)
    return (int)cudaErrorInvalidValue;
  const int k = (kF32 * 2 + 1) * kCbrForms + form;
  const void* fn = (&kCbrCluster[0][0][0])[k];
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, fn);
  if (rc != 0) return rc;
  rc = allow_wide_clusters(fn, cbr_ready[k]);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(C), C, kCbrThreads, 0, &attr, nullptr);
  int clusters = 0;
  rc = (int)cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (rc != 0) return rc;
  out[0] = fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  out[2] = kCbrThreads;
  out[3] = kCbrCtaElems;
  out[4] = clusters;
  return 0;
}
