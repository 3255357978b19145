// Causal or non-causal GQA flash attention, for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py:86 (flash_attention,
// pallas_call at :103).  For q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D),
// query head h reads kv head h / (Hq / Hkv), and query row i sits at key
// position qpos = (Skv - Sq) + i (queries aligned to the end of the keys):
//
//   s[i, j] = (q_i . k_j) * scale                     masked to -1e30 where
//                                                     j >= Skv, or j > qpos
//                                                     when causal
//   o_i     = sum_j softmax_j(s[i, :]) v_j            fp32, stored in q's
//                                                     dtype
//
// computed as the TPU kernel computes it: q, k and v read as fp32, an
// online softmax over tiles of keys with the (m, l, acc) carry in fp32, p
// kept in fp32 for the P.V product, and o = acc / max(l, 1e-30).  Unlike
// the TPU kernel it also masks key positions past Skv in a ragged last
// tile (as chunked_attention does), and Sq need not be a tile multiple.
//
// What bounds it on an H100: operations.  Per (b, h) each of the two
// products takes Sq * Skv * D multiply-adds (about half of that when
// causal), against (Sq + 2 Skv) * D values read and Sq * D written.  At
// stablelm-3b's prefill (4 x 32 heads, 4096 x 4096, D = 80, causal, bf16)
// each is 1.7e11 flops.  q.k^T multiplies bf16 operands into fp32 sums,
// which the tensor cores do exactly at 989 TFLOP/s: 0.17 ms.  P.V takes
// the fp32 p, so it runs at the CUDA cores' 66.9 TFLOP/s: 2.57 ms.  The
// bound is their sum, 2.74 ms, against 0.1 ms for the bytes.
//
// What this first kernel does about it (fp32 FMAs on the CUDA cores; the
// tensor cores, wgmma and TMA are later work):
//
//  * One block of 256 threads, a 16 x 16 grid, per (b, h, tile of 64
//    query rows).  The q tile is staged once into shared memory; tiles of
//    64 keys and values are staged in turn.  Thread (ty, tx) owns query
//    rows ty + 16 i (i < 4): their scores against keys tx + 16 j (j < 4),
//    their (m, l) carry and their output columns tx + 16 c (c < NC, NC =
//    ceil(D / 16), a template parameter), all in registers.
//  * Scores: a 4 x 4 register tile, reduced over D with 16-byte loads of
//    q and k rows.  Each row's max and sum over the tile's 64 keys is a
//    4-step shuffle among the 16 lanes that hold it.  p goes to shared
//    memory (over the k tile, which the scores no longer need), then
//    P.V reads p and V^T 16 bytes at a time along the keys.
//  * Shared-memory rows are padded to 4 x an odd number of floats (k, q,
//    V^T) or by 16 floats (p): no bank conflicts on the loads of the two
//    products.  About 65 KB at D = 80 and 100 KB at D = 128, so two
//    blocks share an SM.
//  * Tiles of keys that lie wholly above the causal diagonal are never
//    staged or computed: a causal call does about half the work of a
//    non-causal one.  Blocks take the query tiles from the last (the most
//    key tiles) to the first, so the longest blocks start first.
//  * Any strides of q, k, v and the output with the D axis contiguous, so
//    the model passes its (B, S, H, D) projections as they are and gets
//    the output in the layout the output projection reads.
//  * Every sum runs in a fixed order and there are no atomics: a second
//    launch gives the same bits.  Built without --use_fast_math (expf,
//    IEEE division).
//
// Plain C interface, bound with ctypes: pointers are raw device addresses,
// strides are in elements, the stream is the caller's current CUDA stream,
// and the launcher returns a CUDA error code (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kSide = 16;            // threads are a 16 x 16 grid
constexpr int kThreads = kSide * kSide;
constexpr int kRows = kBQ / kSide;   // 4 query rows per thread
constexpr int kCols = kBK / kSide;   // 4 keys per thread
constexpr int kMaxD = 128;
constexpr int kLdp = kBK + 16;       // row stride of p: 16-bank offset
constexpr int kLdvt = kBK + 4;       // row stride of V^T: 4 x 17 floats
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // what one block may opt into

// dtype codes shared with repro_torch/kernels/flash_attention.py
enum DType { kF32 = 0, kBF16 = 1 };

// Row stride of staged q and k: D + 4 floats, which with D a multiple of
// 8 is 4 x an odd number, so 8 lanes reading 16 bytes from 8 consecutive
// rows hit 8 distinct bank groups.
__host__ __device__ inline int ld_qk(int D) { return D + 4; }

size_t smem_floats(int D) {
  const size_t kp = (size_t)kBK * ld_qk(D) > (size_t)kBQ * kLdp
                        ? (size_t)kBK * ld_qk(D)
                        : (size_t)kBQ * kLdp;
  return (size_t)kBQ * ld_qk(D) + kp + (size_t)D * kLdvt;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, rep, Sq, Skv, D, causal, n_qtiles;
  float scale;
  long long sq_b, sq_h, sq_s;
  long long sk_b, sk_h, sk_s;
  long long sv_b, sv_h, sv_s;
  long long so_b, so_h, so_s;
};

// 4 consecutive values at p (16-byte aligned for fp32, 8-byte for bf16)
// as fp32; also the 16-byte loads from shared memory.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [row0, row0 + 64) of a (rows, D) strided source into shared memory,
// zero past `rows`: as 64 x D row-major with stride ld (transposed = false)
// or as D x 64 with stride kLdvt (transposed = true, V^T).  Lane order runs
// over rows first, so both layouts are stored without bank conflicts.
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long s_row, int row0, int rows,
                                      int D, int tid) {
  const int n4 = D / 4;
  for (int e = tid; e < kBK * n4; e += kThreads) {
    const int r = e % kBK, d = 4 * (e / kBK);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) v = load4(src + (long long)(row0 + r) * s_row + d);
    if (kTransposed) {
      dst[(d + 0) * kLdvt + r] = v.x;
      dst[(d + 1) * kLdvt + r] = v.y;
      dst[(d + 2) * kLdvt + r] = v.z;
      dst[(d + 3) * kLdvt + r] = v.w;
    } else {
      *reinterpret_cast<float4*>(dst + r * ld + d) = v;
    }
  }
}

// max or sum over the 16 lanes that share ty (lanes 0-15 or 16-31 of the
// warp), in a fixed order
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_fwd(Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.rep;
  const int qt = a.n_qtiles - 1 - (int)blockIdx.y;  // longest tiles first
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const int D = a.D, ldq = ld_qk(D);
  const int offset = a.Skv - a.Sq;

  extern __shared__ float4 sm4[];   // float4: 16-byte aligned
  float* Qs = reinterpret_cast<float*>(sm4);   // (64, ldq) q tile
  float* Ks = Qs + kBQ * ldq;                  // (64, ldq) k tile, then p
  float* Ps = Ks;                              // (64, kLdp) p over k
  const int kp = kBK * ldq > kBQ * kLdp ? kBK * ldq : kBQ * kLdp;
  float* Vt = Ks + kp;                         // (D, kLdvt) V^T tile

  const T* q = static_cast<const T*>(a.q) + b * a.sq_b + h * a.sq_h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk_b + hk * a.sk_h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv_b + hk * a.sv_h;
  T* o = static_cast<T*>(a.o) + b * a.so_b + h * a.so_h;

  // key tiles this query tile needs: all, or those reaching no further
  // than the last valid query row's position
  int kv_end = a.Skv;
  if (a.causal) {
    const int q_last = min(q0 + kBQ, a.Sq) - 1;
    kv_end = min(kv_end, offset + q_last + 1);
  }
  const int n_kt = (kv_end + kBK - 1) / kBK;

  stage<T, false>(Qs, ldq, q, a.sq_s, q0, a.Sq, D, tid);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's p and V^T are read
    stage<T, false>(Ks, ldq, k, a.sk_s, k0, a.Skv, D, tid);
    stage<T, true>(Vt, 0, v, a.sv_s, k0, a.Skv, D, tid);
    __syncthreads();

    // s[i][j]: query row ty + 16 i against key tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = load4(Qs + (ty + kSide * i) * ldq + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = load4(Ks + (tx + kSide * j) * ldq + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

    // scale, mask and the online softmax; p stays in s
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = offset + q0 + ty + kSide * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kSide * j;
        const bool valid = kpos < a.Skv && (!a.causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done with the k tile
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        Ps[(ty + kSide * i) * kLdp + tx + kSide * j] = s[i][j];
    __syncthreads();

    // acc[i][c] += sum_u p[row i][u] * v[u][column tx + 16 c]
    for (int u = 0; u < kBK; u += 4) {
      float4 pv[kRows], vv[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = load4(Ps + (ty + kSide * i) * kLdp + u);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + kSide * c;
        vv[c] = col < D ? load4(Vt + col * kLdvt + u)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c] += pv[i].x * vv[c].x;
          acc[i][c] += pv[i].y * vv[c].y;
          acc[i][c] += pv[i].z * vv[c].z;
          acc[i][c] += pv[i].w * vv[c].w;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + kSide * i;
    if (r >= a.Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + kSide * c;
      if (col < D) store1(o + (long long)r * a.so_s + col, acc[i][c] * inv_l);
    }
  }
}

template <typename T, int NC>
int launch_nc(const Args& a, long long BH, cudaStream_t st) {
  const size_t smem = smem_floats(a.D) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      flash_attention_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)BH, (unsigned)a.n_qtiles);
  flash_attention_fwd<T, NC><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, long long BH, cudaStream_t st) {
  switch ((a.D + kSide - 1) / kSide) {
    case 1: return launch_nc<T, 1>(a, BH, st);
    case 2: return launch_nc<T, 2>(a, BH, st);
    case 3: return launch_nc<T, 3>(a, BH, st);
    case 4: return launch_nc<T, 4>(a, BH, st);
    case 5: return launch_nc<T, 5>(a, BH, st);
    case 6: return launch_nc<T, 6>(a, BH, st);
    case 7: return launch_nc<T, 7>(a, BH, st);
    case 8: return launch_nc<T, 8>(a, BH, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and o in that order;
// the D axis of each is contiguous.  Every base address is 16-byte
// aligned and every stride a multiple of 4 (the wrapper makes a copy
// otherwise).  Returns cudaErrorInvalidValue for what the kernel does not
// take: D not a multiple of 8 in [8, 128], Hq not a multiple of Hkv, an
// empty key axis, or a causal call with Sq > Skv.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Hq, int Hkv, int Sq, int Skv,
                                      int D, int causal, float scale,
                                      const long long* strides, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      D < 8 || D > kMaxD || D % 8 != 0 || (causal && Sq > Skv))
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  if (n_qtiles > 65535) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, Hq, Hq / Hkv, Sq, Skv, D, causal, n_qtiles, scale,
         strides[0], strides[1], strides[2],
         strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8],
         strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long BH = (long long)B * Hq;
  switch (dtype) {
    case kF32: return launch<float>(a, BH, st);
    case kBF16: return launch<__nv_bfloat16>(a, BH, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t flash_attention_smem_bytes(int D) {
  return smem_floats(D) * sizeof(float);
}
