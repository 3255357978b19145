// One cyclic Gauss-Seidel sweep of the Lasso  min ||Ax - b||^2 + c||x||_1,
// for sm_90a.
//
// Replaces no TPU kernel: the reference runs each sweep as one device
// program, a lax.fori_loop over the n coordinates
// (src/repro/baselines/gauss_seidel.py:37-50), and this kernel is the
// port's form of that program.  Eager torch would make about six launches
// per coordinate, 600k per sweep at n = 100000.  For i = 0 .. n-1, against
// the residual r = Ax - b as the earlier coordinates left it:
//
//     g_i = 2 a_i^T r,   d_i = 2 colsq_i,   z_i = soft(x_i - g_i/d_i, c/d_i)
//     delta = z_i - x_i,   r += a_i * delta,   x_i = z_i
//
// and max |delta| over the sweep into one device scalar.  x and r are
// updated in place.  The quotients are true fp32 divisions (__fdiv_rn)
// and r's update rounds the product and the sum on their own (__fmul_rn,
// __fadd_rn), as the plain torch version (kernels/ref.py) does; the dot
// products sum in another order, so the two agree to rounding, not bits.
//
// What bounds it on an H100: the sweep reads A once (n * m * 4 bytes,
// 2 GB at fig1d: 0.6 ms at 3.35 TB/s), but it is sequential by
// construction: coordinate i's dot product needs r after coordinate i-1's
// update.  So latency bounds it: per coordinate, a 20 KB row read, a block
// reduction and a broadcast, about a microsecond.
//
// What the design does about it:
//  * One block of kThreads walks the coordinates in order.
//  * r lives in shared memory for the whole sweep (m floats, dynamic;
//    m = 5000 is 20 KB, at most kMaxRows = 57344, 224 KB; the wrapper
//    refuses more), read from and written back to device memory once.
//  * Column a_i is row i of a contiguous A^T (n, m), which the solver
//    makes once: 16 bytes per thread per step when m % 4 == 0 and A^T is
//    16-byte aligned.  While row i is reduced, each thread asks L2 for a
//    128-byte line of row i + 1 (prefetch.global.L2), so the next row's
//    read waits on L2, not on HBM.  The second read of row i, for r's
//    update, hits L1.
//  * The dot product: per-thread partials, a fixed warp-shuffle tree and
//    a fixed tree over the warps; thread 0 forms z_i and delta (x_i and
//    colsq_i were loaded at the top of the step, under the row's read)
//    and broadcasts delta through shared memory.  r += a_i * delta runs
//    only when delta != 0 (a coordinate that stays at 0 changes nothing),
//    and the same inputs give the same bits on every launch.
//
// Plain C interface, bound with ctypes: pointers are raw device addresses,
// the stream is the caller's current CUDA stream, and the launcher returns
// cudaGetLastError() after its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 57344;        // r in 224 KB of shared memory
constexpr int kLine = 128;             // bytes per L2 prefetch

template <bool kVec>
__global__ void __launch_bounds__(kThreads) gauss_seidel_sweep_kernel(
    const float* __restrict__ At, const float* __restrict__ colsq,
    float* __restrict__ x, float* __restrict__ r, float c,
    float* __restrict__ max_delta, long long n, int m) {
  extern __shared__ float4 smem[];
  float* rs = reinterpret_cast<float*>(smem);
  float4* rs4 = smem;
  __shared__ float red[kWarps];
  __shared__ float bcast;
  const int tid = threadIdx.x;
  for (int j = tid; j < m; j += kThreads) rs[j] = r[j];
  __syncthreads();

  const long long row_bytes = (long long)m * sizeof(float);
  float maxd = 0.f;
  for (long long i = 0; i < n; ++i) {
    const float* a = At + i * m;
    if (i + 1 < n) {
      const char* next = reinterpret_cast<const char*>(a + m);
      for (long long o = (long long)tid * kLine; o < row_bytes;
           o += (long long)kThreads * kLine)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(next + o));
    }
    float xi = 0.f, cs = 0.f;
    if (tid == 0) {
      xi = x[i];
      cs = colsq[i];
    }
    float p = 0.f;
    if (kVec) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      for (int j = tid; j < m / 4; j += kThreads) {
        const float4 av = __ldg(a4 + j);
        const float4 rv = rs4[j];
        p += av.x * rv.x + av.y * rv.y + av.z * rv.z + av.w * rv.w;
      }
    } else {
      for (int j = tid; j < m; j += kThreads) p += __ldg(a + j) * rs[j];
    }
    p = block_sum(p, red);
    if (tid == 0) {
      const float d = 2.f * cs;
      const float z = response(xi, 2.f * p, d, __fdiv_rn(c, d));
      const float delta = __fsub_rn(z, xi);
      x[i] = z;
      const float ad = fabsf(delta);
      if (ad > maxd || ad != ad) maxd = ad;   // NaN sticks, as jnp.maximum
      bcast = delta;
    }
    __syncthreads();
    const float delta = bcast;
    if (delta != 0.f) {
      if (kVec) {
        const float4* a4 = reinterpret_cast<const float4*>(a);
        for (int j = tid; j < m / 4; j += kThreads) {
          const float4 av = __ldg(a4 + j);
          float4 rv = rs4[j];
          rv.x = __fadd_rn(rv.x, __fmul_rn(av.x, delta));
          rv.y = __fadd_rn(rv.y, __fmul_rn(av.y, delta));
          rv.z = __fadd_rn(rv.z, __fmul_rn(av.z, delta));
          rv.w = __fadd_rn(rv.w, __fmul_rn(av.w, delta));
          rs4[j] = rv;
        }
      } else {
        for (int j = tid; j < m; j += kThreads)
          rs[j] = __fadd_rn(rs[j], __fmul_rn(__ldg(a + j), delta));
      }
    }
    __syncthreads();                      // r complete; red and bcast free
  }
  for (int j = tid; j < m; j += kThreads) r[j] = rs[j];
  if (tid == 0) *max_delta = maxd;
}

}  // namespace

// One sweep over the n coordinates: At (n, m) fp32 contiguous (row i is
// column a_i of A), colsq (n,), x (n,) and r (m,) fp32, x and r updated in
// place; max |delta| into max_delta (one fp32).  m <= 57344.
extern "C" int gauss_seidel_sweep_launch(const float* At, const float* colsq,
                                         float* x, float* r, float c,
                                         float* max_delta, long long n,
                                         int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || m < 0 || m > kMaxRows) return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 && (reinterpret_cast<uintptr_t>(At) & 15u) == 0;
  void (*kern)(const float*, const float*, float*, float*, float, float*,
               long long, int) =
      vec ? gauss_seidel_sweep_kernel<true> : gauss_seidel_sweep_kernel<false>;
  const size_t smem = ((size_t)m + 3) / 4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<1, kThreads, smem, st>>>(At, colsq, x, r, c, max_delta, n, m);
  return (int)cudaGetLastError();
}
