// FLEXA best response and fused updates, for sm_90a.
//
// best_response replaces src/repro/kernels/flexa_prox.py:55 (best_response,
// pallas_call at :69):
//
//     w  = x - g / d,   t = c / d,   z = sign(w) * max(|w| - t, 0)   (fp32)
//     e2 = sum (z - x)^2                                             (fp32)
//
// with d a scalar read through a device pointer (tau_i, so the optimizer
// never syncs the host) or a dense fp32 tensor of x's shape (tau_i * q_i),
// and c a host float.  x and g are fp32 or bf16; z is fp32.
//
// apply_update replaces flexa_prox.py:104 (apply_update, pallas_call at
// :117): out = x + gm * (z - x), z as best_response computes it but kept
// in registers, never written; gm (gamma * mask_i) a 0-d device tensor;
// out in x's dtype, and may be x itself (the FLEXA optimizer updates its
// parameters in place).  The roundings are the optimizer's: (z - x), then
// * gm, then x +, each an fp32 op of its own (__fsub_rn, __fmul_rn,
// __fadd_rn: nvcc would otherwise contract x + gm * (z - x) into an FMA,
// which rounds once where the torch expression rounds twice), then one
// rounding to x's dtype.
//
// batched_best_response and batched_apply_update replace flexa_prox.py:174
// and :223 (pallas_call at :188 and :239): the same two functions over a
// (B, n) bucket of B instances, with d a scalar, one per instance (B,) or
// dense (B, n), c a host float, a 0-d or a (B,) device tensor, and gm a
// 0-d or (B,) device tensor.  The function is the TPU kernel's; the rounding of the
// threshold is the FLEXA solver's, t = (1 / d) * c (a reciprocal, then a
// product), not the TPU kernel's c / d: these two kernels are steps S.2
// and S.4 of the solver's iteration (src/repro_torch/core/flexa.py), whose
// torch expression rounds so, and the lambda-path stops at the fp32 noise
// floor, where a one-ulp change of the threshold changes which points
// converge.  e2 is (B,), one fixed-order sum per instance.
//
// What bounds best_response, apply_update and batched_apply_update on an
// H100: one pass over the data and nothing to reuse.  best_response reads
// x and g (and a dense d) once and writes z once: 12 bytes per fp32
// element (16 with dense d), against 3 flops; apply_update reads x and g
// and writes x: 12 bytes per element as well.  The floor is those bytes
// over 3.35 TB/s of HBM3: 0.063 ms for stablelm-3b's largest layer tensor
// (2560 x 6912), 0.46 ms for its (50304 x 2560) lm_head.
//
// What their design does about it:
//  * The TPU kernels' (256, 512) VMEM tiles and the 512-column padding of
//    their dispatch have no reason to exist here: each kernel walks an
//    instance's n elements once, grid-stride, 16 bytes of x and of g per
//    thread per step (4 fp32 or 8 bf16 elements) when every pointer is
//    16-byte aligned (and, with B > 1, n keeps each row aligned), with a
//    scalar tail; otherwise the scalar loop throughout.  A bucket is a
//    grid of (blocks per instance, B); a ragged n is masked by the loop
//    bounds.
//  * best_response's e2: each thread accumulates (z - x)^2 in fp32, one
//    accumulator per vector lane (short dependent chains), then a fixed
//    warp-shuffle tree and a fixed tree over the block's warps give one
//    partial per block.  The last block to finish (a ticket counter,
//    reset with a memset before the launch) sums the partials in index
//    order.  The number of blocks depends only on n and the SM count, so
//    the same inputs give the same bits on every launch: no float
//    atomics.
//  * Built without --use_fast_math, so every quotient is an IEEE division
//    and z equals the plain torch version bit for bit; only e2's
//    summation order differs from it.
//
// batched_best_response is step S.2 of every solver iteration, at the
// solver's sizes: (1, 100000) dense d on the fig1d path and in a solo
// solve, (8, 100000) in a batch, (4, 10000) in a 4-fold CV.
//  * What bounds it.  Bytes first: 16 per element with dense d (x, g, d
//    read, z written), 0.48 us at (1, 100000) and 3.8 us at (8, 100000)
//    over HBM3; on the path the inputs are in L2, where the products that
//    made g left them.  At those sizes the bytes take less time than the
//    fixed cost of a call: the device operations it makes, the serial
//    tail of its sum and the latency of loads that wait on each other.
//  * One launch per call, one cluster per instance: grid (C, B), cluster
//    (C, 1, 1), C = ceil(n / 2048) capped at 16 (at 8 on a card that
//    cannot place 16); each CTA takes a contiguous share of its row,
//    per_cta elements (a multiple of 8, at most kCtaElems = 8192).  C is 1
//    for n <= 2048, and then there is no barrier at all.  A lone
//    instance has only its cluster's 16 SMs, and there the arithmetic
//    (two IEEE divisions per element) is as long as the loads: 512
//    threads per CTA keep 16 warps per SM to hide its latency, and at
//    two CTAs per SM (at most 64 registers) the card holds 14 clusters of
//    16 at once, a batch of 8 in one wave.
//  * The whole instance in flight at once: each thread issues all of its
//    16-byte loads of x, g and a dense d (at most 4 of each in fp32, 2 in
//    bf16) before it computes any, a fixed unrolled count instead of a
//    grid-stride loop whose next loads wait for the loop.  The last
//    n mod V elements of a ragged row go one per thread; a row that is
//    not 16-byte aligned takes the scalar form, 16 elements per thread
//    the same way.
//  * e2 with no global scratch: each thread sums (z - x)^2 per vector lane
//    over its vectors in order, then its lanes; block_sum (a fixed
//    warp-shuffle tree, then over the warps) gives the CTA's partial;
//    cluster_sum (common.cuh) sends it by st.async into slot [rank] of
//    the cluster's rank 0, whose mbarrier counts the bytes as they land,
//    and rank 0's first warp sums the C slots by the fixed shuffle tree.
//    The one cluster barrier only guards that mbarrier's set-up: its
//    relaxed arrival is at the kernel's start, so its wait is complete
//    by the time the sum needs it.  No memset, ticket, memory fence or
//    atomic.  The order depends only on n and the card, so the same
//    inputs give the same bits on every launch; it is not the order of
//    the earlier grid-stride design, which summed per-block partials in
//    index order, so e2 may differ from that design's in the last bits.
//  * Above C x kCtaElems elements per instance (131072 with clusters of
//    16, 65536 with 8) a row takes the two-level form: the grid-stride
//    kernel flexa_batched_best_response_two_level_kernel with per-block
//    partials and ticket counters reset by a memset, two device
//    operations.  The wrapper (kernels/flexa_prox.py, batched_blocks)
//    chooses the form by size alone; every size of the solver path takes
//    the one launch.
//
// Plain C interface, bound with ctypes: pointers are raw device addresses,
// the stream is the caller's current CUDA stream, and each launcher
// returns cudaGetLastError() after its launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// dtype codes shared with repro_torch/kernels/flexa_prox.py
enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// fp32 -> T, rounded to nearest even (torch's .to() and copy_).
template <typename T> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T, bool kDenseD, bool kVec>
__global__ void __launch_bounds__(kThreads) flexa_best_response_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ d, float c, float* __restrict__ z,
    float* __restrict__ partials, unsigned* __restrict__ ticket,
    float* __restrict__ e2, long long n) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte load of x
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float d0 = 0.f, t0 = 0.f;
  if (!kDenseD) {
    d0 = d[0];
    t0 = c / d0;
  }
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;

  long long done = 0;
  if (kVec) {
    const long long nv = n / V;
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* z4 = reinterpret_cast<float4*>(z);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 xr = x4[i];
      const uint4 gr = g4[i];
      const T* xe = reinterpret_cast<const T*>(&xr);
      const T* ge = reinterpret_cast<const T*>(&gr);
      float dv[V];
      if (kDenseD) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 dd = d4[i * (V / 4) + q];
          dv[4 * q] = dd.x; dv[4 * q + 1] = dd.y;
          dv[4 * q + 2] = dd.z; dv[4 * q + 3] = dd.w;
        }
      }
      float zv[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float xf = Cvt<T>::to(xe[q]);
        const float gf = Cvt<T>::to(ge[q]);
        const float dq = kDenseD ? dv[q] : d0;
        const float tq = kDenseD ? c / dq : t0;
        zv[q] = response(xf, gf, dq, tq);
        const float diff = zv[q] - xf;
        acc[q] += diff * diff;
      }
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        z4[i * (V / 4) + q] = make_float4(zv[4 * q], zv[4 * q + 1],
                                          zv[4 * q + 2], zv[4 * q + 3]);
    }
    done = nv * V;
  }
  // scalar loop: the tail of the vector path, or everything when a
  // pointer is not 16-byte aligned
  for (long long i = done + tid; i < n; i += stride) {
    const float xf = Cvt<T>::to(x[i]);
    const float gf = Cvt<T>::to(g[i]);
    const float dq = kDenseD ? d[i] : d0;
    const float tq = kDenseD ? c / dq : t0;
    const float zi = response(xf, gf, dq, tq);
    z[i] = zi;
    const float diff = zi - xf;
    acc[0] += diff * diff;
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) s += acc[q];

  grid_sum(s, partials, ticket, e2);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, bool kDenseD>
void launch_typed(const void* x, const void* g, const float* d, float c,
                  float* z, float* work, long long n, int blocks,
                  cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  float* partials = work;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + blocks);
  float* e2 = work + blocks + 1;
  const bool vec = aligned16(x) && aligned16(g) && aligned16(z) &&
                   (!kDenseD || aligned16(d));
  if (vec)
    flexa_best_response_kernel<T, kDenseD, true><<<blocks, kThreads, 0, st>>>(
        xt, gt, d, c, z, partials, ticket, e2, n);
  else
    flexa_best_response_kernel<T, kDenseD, false><<<blocks, kThreads, 0, st>>>(
        xt, gt, d, c, z, partials, ticket, e2, n);
}

template <typename T>
void launch_d(int dense_d, const void* x, const void* g, const float* d,
              float c, float* z, float* work, long long n, int blocks,
              cudaStream_t st) {
  if (dense_d)
    launch_typed<T, true>(x, g, d, c, z, work, n, blocks, st);
  else
    launch_typed<T, false>(x, g, d, c, z, work, n, blocks, st);
}


// ---------------------------------------------------------------------
// apply_update, batched_best_response, batched_apply_update
// ---------------------------------------------------------------------

// How a kernel reads d: one value for the launch, one per instance, or
// dense (one per element).
enum DMode { kDScalar = 0, kDInstance = 1, kDDense = 2 };

// The threshold: c / d (best_response's and apply_update's rounding) or
// (1 / d) * c (the solver chain's, kRecip).  Intrinsics keep each op
// rounded on its own: |w| - t below must not absorb the product into an
// FMA.
template <bool kRecip>
__device__ __forceinline__ float threshold(float c, float d) {
  return kRecip ? __fmul_rn(__fdiv_rn(1.f, d), c) : __fdiv_rn(c, d);
}

// x + gm * (z - x), rounded as torch rounds x + gm * (z - x): three ops.
__device__ __forceinline__ float update(float xf, float z, float gm) {
  return __fadd_rn(xf, __fmul_rn(__fsub_rn(z, xf), gm));
}

// One instance's n elements, grid-stride over blockIdx.x: z (kApply =
// false; returns this thread's sum of (z - x)^2) or the update into out
// (kApply).  x and out may be one array: each element is read, then
// written, by one thread.
template <typename T, int kD, bool kVec, bool kRecip, bool kApply>
__device__ __forceinline__ float stream(
    const T* x, const T* __restrict__ g, const float* __restrict__ d,
    float d0, float c, float gm, float* __restrict__ z, T* out,
    long long n) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte load of x
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const float t0 = kD == kDDense ? 0.f : threshold<kRecip>(c, d0);
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;

  long long done = 0;
  if (kVec) {
    const long long nv = n / V;
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 xr = x4[i];
      const uint4 gr = g4[i];
      const T* xe = reinterpret_cast<const T*>(&xr);
      const T* ge = reinterpret_cast<const T*>(&gr);
      float dv[V];
      if (kD == kDDense) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 dd = d4[i * (V / 4) + q];
          dv[4 * q] = dd.x; dv[4 * q + 1] = dd.y;
          dv[4 * q + 2] = dd.z; dv[4 * q + 3] = dd.w;
        }
      }
      float zv[V];
      uint4 orow;
      T* oe = reinterpret_cast<T*>(&orow);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float xf = Cvt<T>::to(xe[q]);
        const float dq = kD == kDDense ? dv[q] : d0;
        const float tq = kD == kDDense ? threshold<kRecip>(c, dq) : t0;
        zv[q] = response(xf, Cvt<T>::to(ge[q]), dq, tq);
        if (kApply) {
          oe[q] = Out<T>::from(update(xf, zv[q], gm));
        } else {
          const float diff = zv[q] - xf;
          acc[q] += diff * diff;
        }
      }
      if (kApply) {
        reinterpret_cast<uint4*>(out)[i] = orow;
      } else {
        float4* z4 = reinterpret_cast<float4*>(z);
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          z4[i * (V / 4) + q] = make_float4(zv[4 * q], zv[4 * q + 1],
                                            zv[4 * q + 2], zv[4 * q + 3]);
      }
    }
    done = nv * V;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float xf = Cvt<T>::to(x[i]);
    const float dq = kD == kDDense ? d[i] : d0;
    const float tq = kD == kDDense ? threshold<kRecip>(c, dq) : t0;
    const float zi = response(xf, Cvt<T>::to(g[i]), dq, tq);
    if (kApply) {
      out[i] = Out<T>::from(update(xf, zi, gm));
    } else {
      z[i] = zi;
      const float diff = zi - xf;
      acc[0] += diff * diff;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) s += acc[q];
  return s;
}

template <typename T, bool kDenseD, bool kVec>
__global__ void __launch_bounds__(kThreads) flexa_apply_update_kernel(
    const T* x, const T* __restrict__ g, const float* __restrict__ d,
    float c, const float* __restrict__ gm, T* out, long long n) {
  stream<T, kDenseD ? kDDense : kDScalar, kVec, false, true>(
      x, g, d, kDenseD ? 0.f : d[0], c, gm[0], nullptr, out, n);
}

// d0 of instance b (kDScalar: d[0]; kDInstance: d[b]).
template <int kD>
__device__ __forceinline__ float instance_d(const float* d, int b) {
  return kD == kDScalar ? d[0] : (kD == kDInstance ? d[b] : 0.f);
}

// A per-instance scalar: v[b * stride] from the device, or the host value
// when v is null.
__device__ __forceinline__ float instance_v(const float* v, int stride,
                                            float host, int b) {
  return v ? v[(long long)b * stride] : host;
}

// The one-launch batched best response: threads per CTA; elements one
// CTA takes at most (its share of an instance), and one thread (4 fp32 or
// 2 bf16 vectors of 16 bytes); CTAs per cluster at most.  512 threads at
// two CTAs per SM (at most 64 registers) keep 16 warps on each SM of a
// lone instance's cluster and let the card hold 14 clusters of 16 at once.
constexpr int kOneThreads = 512;
constexpr int kCtaElems = 8192;
constexpr int kThreadElems = kCtaElems / kOneThreads;
constexpr int kMaxClusterCtas = 16;

// One CTA's cnt elements of an instance: z written, the thread's sum of
// (z - x)^2 returned.  Every load of the thread is issued before the
// first response is computed.
template <typename T, int kD, bool kVec>
__device__ __forceinline__ float share(const T* __restrict__ x,
                                       const T* __restrict__ g,
                                       const float* __restrict__ d,
                                       float d0, float c,
                                       float* __restrict__ z, int cnt) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte load of x
  constexpr int S = kThreadElems / V;   // vectors per thread, at most
  const int t = threadIdx.x;
  const float t0 = kD == kDDense ? 0.f : threshold<true>(c, d0);
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.f;
  if (kVec) {
    const int nv = cnt / V;
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* z4 = reinterpret_cast<float4*>(z);
    uint4 xr[S], gr[S];
    float4 dr[S][V / 4];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int v = j * kOneThreads + t;
      if (v < nv) {
        xr[j] = x4[v];
        gr[j] = g4[v];
        if (kD == kDDense) {
#pragma unroll
          for (int q = 0; q < V / 4; ++q) dr[j][q] = d4[v * (V / 4) + q];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int v = j * kOneThreads + t;
      if (v < nv) {
        const T* xe = reinterpret_cast<const T*>(&xr[j]);
        const T* ge = reinterpret_cast<const T*>(&gr[j]);
        const float* de = reinterpret_cast<const float*>(dr[j]);
        float zv[V];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float xf = Cvt<T>::to(xe[q]);
          const float dq = kD == kDDense ? de[q] : d0;
          const float tq = kD == kDDense ? threshold<true>(c, dq) : t0;
          zv[q] = response(xf, Cvt<T>::to(ge[q]), dq, tq);
          const float diff = zv[q] - xf;
          acc[q] += diff * diff;
        }
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          z4[v * (V / 4) + q] = make_float4(zv[4 * q], zv[4 * q + 1],
                                            zv[4 * q + 2], zv[4 * q + 3]);
      }
    }
    const int i = nv * V + t;           // a ragged row's last cnt mod V
    if (i < cnt) {
      const float xf = Cvt<T>::to(x[i]);
      const float dq = kD == kDDense ? d[i] : d0;
      const float tq = kD == kDDense ? threshold<true>(c, dq) : t0;
      const float zi = response(xf, Cvt<T>::to(g[i]), dq, tq);
      z[i] = zi;
      const float diff = zi - xf;
      acc[0] += diff * diff;
    }
  } else {
    float xs[kThreadElems], gs[kThreadElems], ds[kThreadElems];
#pragma unroll
    for (int j = 0; j < kThreadElems; ++j) {
      const int i = j * kOneThreads + t;
      if (i < cnt) {
        xs[j] = Cvt<T>::to(x[i]);
        gs[j] = Cvt<T>::to(g[i]);
        if (kD == kDDense) ds[j] = d[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kThreadElems; ++j) {
      const int i = j * kOneThreads + t;
      if (i < cnt) {
        const float dq = kD == kDDense ? ds[j] : d0;
        const float tq = kD == kDDense ? threshold<true>(c, dq) : t0;
        const float zi = response(xs[j], gs[j], dq, tq);
        z[i] = zi;
        const float diff = zi - xs[j];
        acc[0] += diff * diff;
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) s += acc[q];
  return s;
}

// The one-launch form: grid (C, B), one cluster of C = gridDim.x CTAs per
// instance b = blockIdx.y; CTA r takes elements [r * per_cta, (r + 1) *
// per_cta) of the row.
template <typename T, int kD, bool kVec>
__global__ void __launch_bounds__(kOneThreads, 2)
    flexa_batched_best_response_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ d, const float* __restrict__ c, int c_stride,
    float c_host, float* __restrict__ z, float* __restrict__ e2, long long n,
    int per_cta) {
  cluster_sum_begin();
  const int b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * per_cta;
  const long long off = (long long)b * n + lo;
  const int cnt = (int)(n - lo < per_cta ? n - lo : per_cta);
  const float s = share<T, kD, kVec>(
      x + off, g + off, kD == kDDense ? d + off : d, instance_d<kD>(d, b),
      instance_v(c, c_stride, c_host, b), z + off, cnt);
  cluster_sum(s, e2 + b);
}

// The two-level form, for rows longer than a cluster takes: grid (blocks
// per instance, B), grid-stride, per-block partials summed by the last
// block of the instance (grid_sum: a ticket per instance, zeroed by the
// launcher's memset).
template <typename T, int kD, bool kVec>
__global__ void __launch_bounds__(kThreads)
    flexa_batched_best_response_two_level_kernel(
        const T* __restrict__ x, const T* __restrict__ g,
        const float* __restrict__ d, const float* __restrict__ c,
        int c_stride, float c_host, float* __restrict__ z,
        float* __restrict__ partials, unsigned* __restrict__ tickets,
        float* __restrict__ e2, long long n) {
  const int b = blockIdx.y;
  const long long off = (long long)b * n;
  float s = stream<T, kD, kVec, true, false>(
      x + off, g + off, kD == kDDense ? d + off : d, instance_d<kD>(d, b),
      instance_v(c, c_stride, c_host, b), 0.f, z + off, nullptr, n);

  grid_sum(s, partials + (long long)b * gridDim.x, tickets + b, e2 + b);
}

template <typename T, int kD, bool kVec>
__global__ void __launch_bounds__(kThreads) flexa_batched_apply_update_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ d, const float* __restrict__ c, int c_stride,
    float c_host, const float* __restrict__ gm, int gm_stride,
    T* __restrict__ out, long long n) {
  const int b = blockIdx.y;
  const long long off = (long long)b * n;
  stream<T, kD, kVec, true, true>(
      x + off, g + off, kD == kDDense ? d + off : d, instance_d<kD>(d, b),
      instance_v(c, c_stride, c_host, b), gm[(long long)b * gm_stride],
      nullptr, out + off, n);
}

// The 16-byte path: every array aligned, and (B > 1) rows of n elements
// that keep the alignment.
template <typename T>
bool vector_ok(const void* x, const void* g, const void* o, const float* d,
               bool dense, long long n, int B) {
  constexpr int V = 16 / sizeof(T);
  return aligned16(x) && aligned16(g) && aligned16(o) &&
         (!dense || aligned16(d)) && (B == 1 || n % V == 0);
}

template <typename T>
void launch_apply(const void* x, const void* g, const float* d, bool dense,
                  float c, const float* gm, void* out, long long n,
                  int blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  const bool vec = vector_ok<T>(x, g, out, d, dense, n, 1);
#define APPLY(DENSE, VEC)                                                  \
  flexa_apply_update_kernel<T, DENSE, VEC><<<blocks, kThreads, 0, st>>>(   \
      xt, gt, d, c, gm, ot, n)
  if (dense) { if (vec) APPLY(true, true); else APPLY(true, false); }
  else { if (vec) APPLY(false, true); else APPLY(false, false); }
#undef APPLY
}

// The two-level batched best response (e2 (B,); work: B * blocks
// partials, then B ticket counters) or, with apply, the batched update
// into o.
template <typename T, int kD>
void launch_batched(bool apply, const void* x, const void* g, const float* d,
                    const float* c, int c_stride, float c_host,
                    const float* gm, int gm_stride, void* o, float* e2,
                    float* work, long long n, int B, int blocks,
                    cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const dim3 grid(blocks, B);
  const bool vec = vector_ok<T>(x, g, o, d, kD == kDDense, n, B);
  if (apply) {
    T* ot = static_cast<T*>(o);
    if (vec)
      flexa_batched_apply_update_kernel<T, kD, true><<<grid, kThreads, 0, st>>>(
          xt, gt, d, c, c_stride, c_host, gm, gm_stride, ot, n);
    else
      flexa_batched_apply_update_kernel<T, kD, false><<<grid, kThreads, 0, st>>>(
          xt, gt, d, c, c_stride, c_host, gm, gm_stride, ot, n);
    return;
  }
  float* z = static_cast<float*>(o);
  float* partials = work;
  unsigned* tickets = reinterpret_cast<unsigned*>(work + (long long)B * blocks);
#define TWO_LEVEL(VEC)                                                    \
  flexa_batched_best_response_two_level_kernel<T, kD, VEC>                \
      <<<grid, kThreads, 0, st>>>(xt, gt, d, c, c_stride, c_host, z,      \
                                  partials, tickets, e2, n)
  if (vec) TWO_LEVEL(true); else TWO_LEVEL(false);
#undef TWO_LEVEL
}

template <typename T>
int launch_batched_d(int d_mode, bool apply, const void* x, const void* g,
                     const float* d, const float* c, int c_stride,
                     float c_host, const float* gm, int gm_stride,
                     void* o, float* e2, float* work, long long n, int B,
                     int blocks, cudaStream_t st) {
  switch (d_mode) {
    case kDScalar:
      launch_batched<T, kDScalar>(apply, x, g, d, c, c_stride, c_host, gm,
                                  gm_stride, o, e2, work, n, B, blocks, st);
      break;
    case kDInstance:
      launch_batched<T, kDInstance>(apply, x, g, d, c, c_stride, c_host, gm,
                                    gm_stride, o, e2, work, n, B, blocks,
                                    st);
      break;
    case kDDense:
      launch_batched<T, kDDense>(apply, x, g, d, c, c_stride, c_host, gm,
                                 gm_stride, o, e2, work, n, B, blocks, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch_batched_any(int dtype, int d_mode, bool apply, const void* x,
                       const void* g, const float* d, const float* c,
                       int c_stride, float c_host, const float* gm,
                       int gm_stride, void* o, float* e2, float* work,
                       long long n, int B, int blocks, cudaStream_t st) {
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_batched_d<float>(d_mode, apply, x, g, d, c, c_stride, c_host,
                                   gm, gm_stride, o, e2, work, n, B,
                                   blocks, st);
      break;
    case kBF16:
      rc = launch_batched_d<__nv_bfloat16>(d_mode, apply, x, g, d, c, c_stride,
                                           c_host, gm, gm_stride, o, e2,
                                           work, n, B, blocks, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}

// The batched best response's kernels by [dtype][d mode][16-byte path]:
// the one-launch form and the two-level form.
#define BY_VEC(K, T, D) \
  {reinterpret_cast<const void*>(K<T, D, false>), \
   reinterpret_cast<const void*>(K<T, D, true>)}
#define BY_D(K, T) \
  {BY_VEC(K, T, kDScalar), BY_VEC(K, T, kDInstance), BY_VEC(K, T, kDDense)}
const void* const kOneLaunch[2][3][2] = {
    BY_D(flexa_batched_best_response_kernel, float),
    BY_D(flexa_batched_best_response_kernel, __nv_bfloat16)};
const void* const kTwoLevel[2][3][2] = {
    BY_D(flexa_batched_best_response_two_level_kernel, float),
    BY_D(flexa_batched_best_response_two_level_kernel, __nv_bfloat16)};
#undef BY_D
#undef BY_VEC
constexpr int kOneLaunchKernels = 2 * 3 * 2;

// allow_wide_clusters' flags of one-launch kernel k (flat index into
// kOneLaunch), by device.
bool one_launch_ready[kOneLaunchKernels][kMaxClusterDevices];

int allow_one_launch(int k) {
  return allow_wide_clusters((&kOneLaunch[0][0][0])[k], one_launch_ready[k]);
}

bool batched_vec(int dtype, const void* x, const void* g, const void* z,
                 const float* d, int d_mode, long long n, int B) {
  return dtype == kF32
             ? vector_ok<float>(x, g, z, d, d_mode == kDDense, n, B)
             : vector_ok<__nv_bfloat16>(x, g, z, d, d_mode == kDDense, n, B);
}

}  // namespace

// work: blocks + 2 fp32 slots — the per-block partials, the ticket counter
// (as unsigned, zeroed here before the launch) and e2.
extern "C" int best_response_launch(const void* x, const void* g, int dtype,
                                    const float* d, int dense_d, float c,
                                    float* z, float* work, long long n,
                                    int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(work + blocks, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  switch (dtype) {
    case kF32: launch_d<float>(dense_d, x, g, d, c, z, work, n, blocks, st); break;
    case kBF16: launch_d<__nv_bfloat16>(dense_d, x, g, d, c, z, work, n, blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out = x + gm * (z - x) over n elements (out may be x); d a 0-d (dense_d
// = 0) or dense fp32 array, gm a 0-d fp32 array, c a host float.
extern "C" int apply_update_launch(const void* x, const void* g, int dtype,
                                   const float* d, int dense_d, float c,
                                   const float* gm, void* out, long long n,
                                   int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: launch_apply<float>(x, g, d, dense_d, c, gm, out, n, blocks, st); break;
    case kBF16: launch_apply<__nv_bfloat16>(x, g, d, dense_d, c, gm, out, n, blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// z (B, n) fp32 and e2 (B,) of B instances.  d_mode: 0 d[0], 1 d[b], 2
// dense (B, n).  c: c[b * c_stride] from the device, or c_host when c is
// null.  With work null, the one-launch form: one launch of grid (ctas,
// B), a cluster of ctas <= 16 CTAs per instance, per_cta elements each (a
// multiple of 8, at most 8192, ctas * per_cta >= n).  Otherwise the
// two-level form: ctas blocks per instance, work B * ctas + B fp32 slots
// (the per-block partials and the per-instance ticket counters, as
// unsigned, zeroed here before the launch); per_cta unused.
extern "C" int batched_best_response_launch(
    const void* x, const void* g, int dtype, const float* d, int d_mode,
    const float* c, int c_stride, float c_host, float* z, float* e2,
    float* work, long long n, int B, int ctas, int per_cta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || B <= 0 || B > 65535 || ctas <= 0)
    return (int)cudaErrorInvalidValue;
  if (work) {
    cudaError_t err = cudaMemsetAsync(work + (long long)B * ctas, 0,
                                      sizeof(unsigned) * B, st);
    if (err != cudaSuccess) return (int)err;
    return launch_batched_any(dtype, d_mode, false, x, g, d, c, c_stride,
                              c_host, nullptr, 0, z, e2, work, n, B, ctas,
                              st);
  }
  if (dtype < 0 || dtype > kBF16 || d_mode < 0 || d_mode > kDDense ||
      ctas > kMaxClusterCtas || per_cta <= 0 || per_cta > kCtaElems ||
      per_cta % 8 != 0 || (long long)ctas * per_cta < n)
    return (int)cudaErrorInvalidValue;
  const int vec = batched_vec(dtype, x, g, z, d, d_mode, n, B);
  const int k = (dtype * 3 + d_mode) * 2 + vec;
  int rc = allow_one_launch(k);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(ctas, B), ctas, kOneThreads, 0, &attr, st);
  void* args[] = {&x, &g, &d, &c, &c_stride, &c_host, &z, &e2, &n, &per_cta};
  rc = (int)cudaLaunchKernelExC(&cfg, kOneLaunch[dtype][d_mode][vec], args);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The largest cluster of the one-launch form on the current device: 16
// where the card can place a cluster of 16 CTAs of every one-launch
// kernel, else 8 (into *out).  Returns a CUDA error code.
extern "C" int batched_max_cluster(int* out) {
  return largest_cluster(&kOneLaunch[0][0][0], one_launch_ready,
                         kOneLaunchKernels, kOneThreads, out);
}

// What the compiler and the card made of the batched best response's
// kernel for the solver's inputs (fp32 x and g, dense d, 16-byte aligned
// rows), in the one-launch form with clusters of C CTAs (two_level 0) or
// in the two-level form: out[0..4] = registers per thread, local (spill)
// bytes per thread, threads per CTA, elements per CTA at most (one-launch;
// 0 otherwise), clusters of C the card can hold at once (one-launch; 0
// otherwise).  Returns a CUDA error code.
extern "C" int batched_kernel_info(int two_level, int C, long long* out) {
  if (C < 1 || C > kMaxClusterCtas) return (int)cudaErrorInvalidValue;
  const int k = (kF32 * 3 + kDDense) * 2 + 1;
  const void* fn = (two_level ? kTwoLevel : kOneLaunch)[kF32][kDDense][1];
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, fn);
  if (rc != 0) return rc;
  int clusters = 0;
  if (!two_level) {
    rc = allow_one_launch(k);
    if (rc != 0) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(C), C, kOneThreads, 0, &attr, nullptr);
    rc = (int)cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (rc != 0) return rc;
  }
  out[0] = fa.numRegs;
  out[1] = (long long)fa.localSizeBytes;
  out[2] = two_level ? kThreads : kOneThreads;
  out[3] = two_level ? 0 : kCtaElems;
  out[4] = clusters;
  return 0;
}

// out (B, n) in x's dtype = x + gm_b * (z - x), z as
// batched_best_response computes it, gm_b = gm[b * gm_stride] from the
// device.
extern "C" int batched_apply_update_launch(
    const void* x, const void* g, int dtype, const float* d, int d_mode,
    const float* c, int c_stride, float c_host, const float* gm,
    int gm_stride, void* out, long long n, int B, int blocks,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || B <= 0 || B > 65535 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_batched_any(dtype, d_mode, true, x, g, d, c, c_stride, c_host,
                            gm, gm_stride, out, nullptr, nullptr, n, B,
                            blocks, st);
}
