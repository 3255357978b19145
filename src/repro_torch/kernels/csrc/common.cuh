// Device helpers shared by flexa_prox.cu, compact_rows.cu and
// gauss_seidel.cu: the soft threshold of the FLEXA best response, and the
// fixed-order block and grid sums that keep z equal to the plain torch
// version bit for bit and give e2 the same bits on every launch.  Included
// by those sources, not built on its own (kernels/build.py builds *.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// soft(w, t) = sign(w) * max(|w| - t, 0), as torch.sign * clamp_min.  The
// subtraction rounds on its own: a product in t must not fuse into an FMA.
__device__ __forceinline__ float soft(float w, float t) {
  const float a = __fsub_rn(fabsf(w), t);
  const float m = a > 0.f ? a : 0.f;
  const float s = w > 0.f ? 1.f : (w < 0.f ? -1.f : 0.f);
  return s * m;
}

// w = x - g / d, then soft(w, t): the quotient a true fp32 division.
__device__ __forceinline__ float response(float xf, float gf, float d,
                                          float t) {
  return soft(__fsub_rn(xf, __fdiv_rn(gf, d)), t);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block (blockDim.x a multiple of 32), a fixed
// warp-shuffle tree, then one over the warps; valid in thread 0.  sh holds
// one float per warp.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? sh[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

// A grid's sum without float atomics: each block writes its block_sum of
// acc to partials[blockIdx.x]; the last block to arrive (a ticket counter,
// zeroed before the launch) sums the gridDim.x partials in index order
// (thread j takes j, j + blockDim.x, ... in turn, then block_sum) into
// *out.  The order depends only on the grid, so the same inputs give the
// same bits on every launch.  Every thread calls it, as the kernel's last
// statement.
__device__ __forceinline__ void grid_sum(float acc, float* partials,
                                         unsigned* ticket, float* out) {
  __shared__ float sh[32];
  __shared__ bool last;
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();                      // partial visible before ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float p = 0.f;
  for (unsigned j = threadIdx.x; j < gridDim.x; j += blockDim.x)
    p += __ldcg(partials + j);
  __syncthreads();                        // sh is reused
  p = block_sum(p, sh);
  if (threadIdx.x == 0) *out = p;
}

}  // namespace
