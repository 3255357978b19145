// FLEXA best response of one parameter tensor, for sm_90a.
//
// best_response replaces src/repro/kernels/flexa_prox.py:55 (best_response,
// pallas_call at :69):
//
//     w  = x - g / d,   t = c / d,   z = sign(w) * max(|w| - t, 0)   (fp32)
//     e2 = sum (z - x)^2                                             (fp32)
//
// with d a scalar read through a device pointer (tau_i, so the optimizer
// never syncs the host) or a dense fp32 tensor of x's shape (tau_i * q_i),
// and c a host float.  x and g are fp32, bf16 or fp16; z is fp32.
//
// What bounds it on an H100: one pass over the data and nothing to reuse.
// It reads x and g (and a dense d) once and writes z once: 12 bytes per
// fp32 element (16 with dense d), against 3 flops.  The floor is those
// bytes over 3.35 TB/s of HBM3: 0.063 ms for stablelm-3b's largest layer
// tensor (2560 x 6912), 0.46 ms for its (50304 x 2560) lm_head.
//
// What the design does about it:
//  * The TPU kernel's (256, 512) VMEM tiles and the 512-column padding of
//    its dispatch have no reason to exist here: the kernel walks the flat
//    numel elements once, grid-stride, 16 bytes of x and of g per thread
//    per step (4 fp32 or 8 bf16/fp16 elements) when every pointer is
//    16-byte aligned, with a scalar tail; a misaligned view takes the
//    scalar loop throughout.
//  * e2: each thread accumulates (z - x)^2 in fp32, one accumulator per
//    vector lane (short dependent chains), then a fixed warp-shuffle tree
//    and a fixed tree over the block's warps give one partial per block.
//    The last block to finish (a ticket counter, reset with a memset
//    before the launch) sums the partials in index order.  The number of
//    blocks depends only on numel and the SM count, so the same inputs
//    give the same bits on every launch: no float atomics.
//  * Built without --use_fast_math, so g / d and c / d are IEEE divisions
//    and z equals the plain torch version bit for bit; only e2's
//    summation order differs from it.
//
// Plain C interface, bound with ctypes: pointers are raw device addresses,
// the stream is the caller's current CUDA stream, and the launcher returns
// cudaGetLastError() after its launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// soft(w, t) = sign(w) * max(|w| - t, 0), as torch.sign * clamp_min.
__device__ __forceinline__ float soft(float w, float t) {
  const float a = fabsf(w) - t;
  const float m = a > 0.f ? a : 0.f;
  const float s = w > 0.f ? 1.f : (w < 0.f ? -1.f : 0.f);
  return s * m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? sh[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

template <typename T, bool kDenseD, bool kVec>
__global__ void __launch_bounds__(kThreads) flexa_best_response_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ d, float c, float* __restrict__ z,
    float* __restrict__ partials, unsigned* __restrict__ ticket,
    float* __restrict__ e2, long long n) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte load of x
  __shared__ float sh[kWarps];
  __shared__ bool last;

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
        zv[q] = soft(xf - gf / dq, tq);
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
    const float zi = soft(xf - gf / dq, tq);
    z[i] = zi;
    const float diff = zi - xf;
    acc[0] += diff * diff;
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) s += acc[q];

  s = block_sum(s, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();                      // partial visible before ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial is written; sum them in index order
  // (thread j takes j, j + 256, ... in turn, then the fixed tree).
  __threadfence();
  float p = 0.f;
  for (unsigned j = threadIdx.x; j < gridDim.x; j += kThreads)
    p += __ldcg(partials + j);
  __syncthreads();                        // sh is reused
  p = block_sum(p, sh);
  if (threadIdx.x == 0) *e2 = p;
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
