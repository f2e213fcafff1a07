// Flash attention for Hopper (sm_90a): block-wise online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel) and computes what
// repro_torch/kernels/ref.py::flash_attention_ref computes:
//   out[b, h, i, :] = softmax_j(q_i . k_j * scale, masked) @ v_j
// with query head h reading KV head h / (Hq / Hkv) (GQA), key j masked for
// query i unless i >= j (causal; indices from 0, so the mask is aligned
// top-left when Sq != Sk) and i - j < window (window > 0), float32 running
// max, sum and accumulator, and 0 for a row whose every key is masked.  Any
// Sq, Sk, D <= 256; float32 or bf16 in and out.
//
// Bound.  At the dense prefill's shape (qwen3-0.6b: B = 8, Hq = Hkv = 16,
// S = 1,024, D = 128, bf16, causal) one launch moves 134 MB (q, k, v read
// once, out written once): 0.04 ms at 3.35 TB/s.  Its 34 GFLOP of causal
// QK^T and PV take 0.035 ms on the bf16 tensor cores but 0.51 ms on the
// float32 CUDA cores this kernel uses, so this formulation is bound by its
// operations, and the tensor-core form (wgmma, TMA) is the next step.
//
// Design.  One CTA of 256 threads per (b, h, 64-query block).  The query
// tile and one 64-key tile of K, then of V, are staged in shared memory as
// float32 rows padded to D + 1 words, so that the 16 threads of a row group
// read 16 different banks.  Thread (ty, tx) owns query rows ty + 16a
// (a < 4): scores for keys tx + 16j (j < 4) and output columns tx + 16c
// (c < D/16) in registers; the row max and row sum are reduced over the 16
// lanes that share a row with warp shuffles.  The Pallas kernel carried m,
// l and acc in scratch across a sequential grid axis; here one CTA walks
// its key blocks in a loop, skipping blocks that the causal mask or the
// window mask wholly.  Masked scores take no part in the softmax (p = 0),
// so a wholly masked row ends with l = 0 and is written as 0.  Shared
// memory: (2 x 64 x (D + 1) + 64 x 65) x 4 B, 83 KB at D = 128, so the
// launch opts in above 48 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per step
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPStride = kBK + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + 64) of a [rows, d] matrix with row stride `rs` into
// shared float rows of kD + 1 words; zero outside the matrix and past d
template <typename T, int kD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int r0, int rows, int d) {
  constexpr int kStride = kD + 1;
  for (int e = threadIdx.x; e < kBQ * kD; e += kThreads) {
    const int r = e / kD, c = e - r * kD;
    float x = 0.f;
    if (r0 + r < rows && c < d) x = to_f(src[(r0 + r) * rs + c]);
    dst[r * kStride + c] = x;
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int group, int sq,
             int sk, int d, long long q_sb, long long q_sh, long long q_ss,
             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
             long long v_sh, long long v_ss, long long o_sb, long long o_sh,
             long long o_ss, int causal, int window, float scale) {
  constexpr int kStride = kD + 1;
  constexpr int kCols = kD / 16;
  extern __shared__ float smem[];
  float* s_q = smem;                    // [kBQ][kStride]
  float* s_kv = s_q + kBQ * kStride;    // [kBK][kStride], K then V
  float* s_p = s_kv + kBK * kStride;    // [kBQ][kPStride]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  stage<T, kD>(s_q, qb, q_ss, q0, sq, d);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  }

  // the key blocks that hold an unmasked key for some query of the block
  const int q_last = min(q0 + kBQ, sq) - 1;
  int kb_lo = 0, kb_hi = (sk + kBK - 1) / kBK;
  if (causal) kb_hi = min(kb_hi, q_last / kBK + 1);
  if (window > 0 && q0 - window + 1 > 0) kb_lo = (q0 - window + 1) / kBK;

  for (int kbi = kb_lo; kbi < kb_hi; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();                    // Q staged; last V tile read
    stage<T, kD>(s_kv, kb, k_ss, k0, sk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kD; ++c) {
      float qa[4], kj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = s_q[(ty + 16 * a) * kStride + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kj[j] = s_kv[(tx + 16 * j) * kStride + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qa[a], kj[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < sk;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && qi - kj < window;
        s[a][j] = ok ? s[a][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = m_new == -INFINITY ? 0.f : expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[a][j] == -INFINITY ? 0.f : expf(s[a][j] - m_new);
        s_p[(ty + 16 * a) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();                    // every K read done, P written
    stage<T, kD>(s_kv, vb, v_ss, k0, sk, d);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = s_p[(ty + 16 * a) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = s_kv[j * kStride + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sq) continue;
    const float inv = l[a] == 0.f ? 1.f : l[a];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[row * o_ss + col] = from_f<T>(acc[a][c] / inv);
    }
  }
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int sq, int sk, int d,
                   const long long* st, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t bytes =
      (2 * kBQ * (kD + 1) + kBQ * kPStride) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq / hkv, sq, sk, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int hq, int hkv, int sq, int sk, int d,
                     const long long* st, int causal, int window,
                     float scale, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, d, st, causal,
                         window, scale, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, d, st, causal,
                         window, scale, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, d, st, causal,
                          window, scale, s);
  return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, sk, d, st, causal,
                        window, scale, s);
}

}  // namespace

extern "C" {

// One launch on `stream`; returns the cudaError_t of the launch (0 on
// success).  dtype 0 = float32, 1 = bf16.  q [b, hq, sq, d], k and v
// [b, hkv, sk, d] and o [b, hq, sq, d] are device pointers with element
// strides (batch, head, row) given in that order for q, k, v, o; the last
// axis is contiguous.  Requires 1 <= d <= 256 and hq % hkv == 0.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* o, int b, int hq, int hkv,
                           int sq, int sk, int d, long long q_sb,
                           long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb,
                           long long o_sh, long long o_ss, int causal,
                           int window, float scale, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv) return cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? dispatch<float>(q, k, v, o, b, hq, hkv, sq, sk, d, st,
                                   causal, window, scale, s)
                 : dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d,
                                           st, causal, window, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
