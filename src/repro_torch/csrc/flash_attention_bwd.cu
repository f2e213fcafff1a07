// Flash attention's backward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel.
// Its training differentiates the plain attention (repro/models/
// attention.py, _sdpa) with XLA's autodiff.  The port's forward is the
// hand-written flash kernel (csrc/flash_attention.cu), which autograd
// cannot differentiate, so its backward is a kernel of its own, behind the
// torch.autograd.Function of repro_torch/kernels/ops.py.  It computes what
// repro_torch/kernels/ref.py::flash_attention_bwd_ref computes, in the
// FlashAttention-2 formulation, from the forward's inputs, its output O and
// its float32 row logsumexp lse (natural log of the scaled scores):
//   delta_i = rowsum(dO_i * O_i)                      (delta_kernel)
//   P_ij    = exp(q_i . k_j * scale - lse_i), 0 where masked
//   dV_j    = sum_i P_ij dO_i                         (dkdv_kernel)
//   dS_ij   = P_ij (dO_i . v_j - delta_i)
//   dK_j    = scale * sum_i dS_ij q_i                 (dkdv_kernel)
//   dQ_i    = scale * sum_j dS_ij k_j                 (dq_kernel)
// with the forward's masks (causal aligned top-left: i >= j; window:
// i - j < window), GQA (query head h reads KV head h / g, so dK and dV of a
// KV head sum over its g query heads), and 0 for a wholly masked row.
//
// Design.  No atomics, so two runs give the same bits: one CTA of dkdv_kernel
// owns a tile of keys of one KV head and walks every query tile of its g
// query heads that sees one of its keys, keeping dK and dV in registers; one
// CTA of dq_kernel owns a tile of queries of one head and walks the key
// tiles its rows see (the forward's loop), keeping dQ in registers.  Each
// recomputes P and dS for its tile pairs (the two kernels together do 14
// tile products where a single pass with atomics on dQ would do 10).  Every
// tile is staged in shared memory as float32 rows padded to D + 1 words, so
// that the 16 threads of a row group read 16 different banks; thread (ty,
// tx) of 256 owns rows ty + 16a and columns tx + 16c.  Accumulation is
// float32 in both dtypes; inputs and outputs are float32 or bf16, read and
// written through their strides (the model's [B, S, H, D] layout), only the
// last axis contiguous.  Tiles are 64 rows for D <= 128 and 32 for D = 256.
// Shared memory: four tiles of D + 1 words a row, plus the P and dS tiles in
// dkdv_kernel (165 KB at D = 128, 140 KB at D = 256) and the dS tile in
// dq_kernel (149 KB, 136 KB).
//
// Bound.  At qwen3-0.6b's training call (B = 8, Hq = Hkv = 16 after its KV
// heads are repeated, S = 1,024, D = 128, causal) the backward needs five
// products over the 524,800 unmasked (query, key) pairs of each head
// (recompute QK^T, dV, dP, dK, dQ): 10 * B * Hq * pairs * D = 86 GFLOP,
// 1.28 ms on the float32 CUDA cores (67 TFLOP/s), against 269 MB of bf16
// q, k, v, O, dO, lse read and dq, dk, dv written (0.08 ms at 3.35 TB/s):
// bound by operations.  Tensor cores (wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int kD>
struct Tile {
  static constexpr int kB = kD <= 128 ? 64 : 32;   // rows of a tile
  static constexpr int kR = kB / 16;               // rows a thread owns
  static constexpr int kStride = kD + 1;
  static constexpr int kCols = kD / 16;            // columns a thread owns
  static constexpr int kPStride = kB + 1;
  static constexpr int kTile = kB * kStride;
  static constexpr int kPTile = kB * kPStride;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;             // [b, hq, sq], contiguous
  float* delta;                 // [b, hq, sq], contiguous
  T* dq;
  T* dk;
  T* dv;
  // (batch, head, row) element strides of q, k, v, o, dout, dq, dk, dv
  long long st[24];
  int hq, group, sq, sk, d, causal, window;
  float scale;
};

// rows [r0, r0 + kB) of a [rows, d] matrix with row stride rs into shared
// float rows of kD + 1 words; zero outside the matrix and past d
template <int kD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int r0, int rows, int d) {
  constexpr int kB = Tile<kD>::kB, kStride = Tile<kD>::kStride;
  for (int e = threadIdx.x; e < kB * kD; e += kThreads) {
    const int r = e / kD, c = e - r * kD;
    float x = 0.f;
    if (r0 + r < rows && c < d) x = to_f(src[(r0 + r) * rs + c]);
    dst[r * kStride + c] = x;
  }
}

__device__ __forceinline__ bool kept(int i, int j, int sq, int sk,
                                     int causal, int window) {
  bool ok = i < sq && j < sk;
  if (causal) ok = ok && i >= j;
  if (window > 0) ok = ok && i - j < window;
  return ok;
}

// delta[b, h, i] = sum_c dout[b, h, i, c] * o[b, h, i, c]: one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Params<T> p,
                                                          long long rows) {
  const long long row = blockIdx.x * (long long)(kThreads / 32) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(row % p.sq);
  const long long bh = row / p.sq;
  const int h = static_cast<int>(bh % p.hq), b = static_cast<int>(bh / p.hq);
  const T* o = p.o + b * p.st[9] + h * p.st[10] + i * p.st[11];
  const T* g = p.dout + b * p.st[12] + h * p.st[13] + i * p.st[14];
  float sum = 0.f;
  for (int c = lane; c < p.d; c += 32) sum = fmaf(to_f(g[c]), to_f(o[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[row] = sum;
}

// dK and dV of keys [k0, k0 + kB) of KV head blockIdx.y, batch blockIdx.z
template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params<T> p) {
  using C = Tile<kD>;
  constexpr int kB = C::kB, kR = C::kR, kStride = C::kStride;
  constexpr int kCols = C::kCols, kPStride = C::kPStride;
  extern __shared__ float smem[];
  float* s_k = smem;                    // [kB keys][kStride]
  float* s_v = s_k + C::kTile;
  float* s_q = s_v + C::kTile;          // [kB queries][kStride]
  float* s_do = s_q + C::kTile;
  float* s_p = s_do + C::kTile;         // [kB keys][kPStride]
  float* s_ds = s_p + C::kPTile;
  __shared__ float s_lse[64], s_dl[64];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  stage<kD>(s_k, p.k + b * p.st[3] + hk * p.st[4], p.st[5], k0, p.sk, p.d);
  stage<kD>(s_v, p.v + b * p.st[6] + hk * p.st[7], p.st[8], k0, p.sk, p.d);

  float dk[kR][kCols], dv[kR][kCols];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[a][c] = dv[a][c] = 0.f;

  // the query tiles that hold a query seeing a key of this tile
  const int k_last = min(k0 + kB, p.sk) - 1;
  int qb_lo = 0, qb_hi = (p.sq + kB - 1) / kB;
  if (p.causal) qb_lo = k0 / kB;
  if (p.window > 0) qb_hi = min(qb_hi, (k_last + p.window - 1) / kB + 1);

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const T* qb = p.q + b * p.st[0] + h * p.st[1];
    const T* gb = p.dout + b * p.st[12] + h * p.st[13];
    const float* lse = p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq;
    const float* dl = p.delta + (static_cast<long long>(b) * p.hq + h) * p.sq;
    for (int qbi = qb_lo; qbi < qb_hi; ++qbi) {
      const int q0 = qbi * kB;
      __syncthreads();                  // the last tile's reads are done
      stage<kD>(s_q, qb, p.st[2], q0, p.sq, p.d);
      stage<kD>(s_do, gb, p.st[14], q0, p.sq, p.d);
      if (threadIdx.x < kB) {
        const int i = q0 + threadIdx.x;
        s_lse[threadIdx.x] = i < p.sq ? lse[i] : 0.f;
        s_dl[threadIdx.x] = i < p.sq ? dl[i] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: keys ty + 16a against queries tx + 16j
      float st[kR][kR], dp[kR][kR];
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int j = 0; j < kR; ++j) st[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kD; ++c) {
        float ka[kR], va[kR], qj[kR], gj[kR];
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          ka[a] = s_k[(ty + 16 * a) * kStride + c];
          va[a] = s_v[(ty + 16 * a) * kStride + c];
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          qj[j] = s_q[(tx + 16 * j) * kStride + c];
          gj[j] = s_do[(tx + 16 * j) * kStride + c];
        }
#pragma unroll
        for (int a = 0; a < kR; ++a)
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            st[a][j] = fmaf(ka[a], qj[j], st[a][j]);
            dp[a][j] = fmaf(va[a], gj[j], dp[a][j]);
          }
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int kj = k0 + ty + 16 * a, qi = q0 + tx + 16 * j;
          const float pr =
              kept(qi, kj, p.sq, p.sk, p.causal, p.window)
                  ? expf(st[a][j] * p.scale - s_lse[tx + 16 * j])
                  : 0.f;
          s_p[(ty + 16 * a) * kPStride + tx + 16 * j] = pr;
          s_ds[(ty + 16 * a) * kPStride + tx + 16 * j] =
              pr * (dp[a][j] - s_dl[tx + 16 * j]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over this tile's queries
#pragma unroll 4
      for (int i = 0; i < kB; ++i) {
        float pa[kR], da[kR];
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          pa[a] = s_p[(ty + 16 * a) * kPStride + i];
          da[a] = s_ds[(ty + 16 * a) * kPStride + i];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float g = s_do[i * kStride + tx + 16 * c];
          const float x = s_q[i * kStride + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < kR; ++a) {
            dv[a][c] = fmaf(pa[a], g, dv[a][c]);
            dk[a][c] = fmaf(da[a], x, dk[a][c]);
          }
        }
      }
    }
  }

  T* dkb = p.dk + b * p.st[18] + hk * p.st[19];
  T* dvb = p.dv + b * p.st[21] + hk * p.st[22];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= p.sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) {
        put(dkb + row * p.st[20] + col, dk[a][c] * p.scale);
        put(dvb + row * p.st[23] + col, dv[a][c]);
      }
    }
  }
}

// dQ of queries [q0, q0 + kB) of head blockIdx.y, batch blockIdx.z
template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params<T> p) {
  using C = Tile<kD>;
  constexpr int kB = C::kB, kR = C::kR, kStride = C::kStride;
  constexpr int kCols = C::kCols, kPStride = C::kPStride;
  extern __shared__ float smem[];
  float* s_q = smem;                    // [kB queries][kStride]
  float* s_do = s_q + C::kTile;
  float* s_k = s_do + C::kTile;         // [kB keys][kStride]
  float* s_v = s_k + C::kTile;
  float* s_ds = s_v + C::kTile;         // [kB queries][kPStride]
  __shared__ float s_lse[64], s_dl[64];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  stage<kD>(s_q, p.q + b * p.st[0] + h * p.st[1], p.st[2], q0, p.sq, p.d);
  stage<kD>(s_do, p.dout + b * p.st[12] + h * p.st[13], p.st[14], q0, p.sq,
            p.d);
  if (threadIdx.x < kB) {
    const int i = q0 + threadIdx.x;
    const long long at = (static_cast<long long>(b) * p.hq + h) * p.sq + i;
    s_lse[threadIdx.x] = i < p.sq ? p.lse[at] : 0.f;
    s_dl[threadIdx.x] = i < p.sq ? p.delta[at] : 0.f;
  }
  const T* kb = p.k + b * p.st[3] + hk * p.st[4];
  const T* vb = p.v + b * p.st[6] + hk * p.st[7];

  float dq[kR][kCols];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[a][c] = 0.f;

  // the key tiles that hold a key seen by some query of this tile
  const int q_last = min(q0 + kB, p.sq) - 1;
  int kb_lo = 0, kb_hi = (p.sk + kB - 1) / kB;
  if (p.causal) kb_hi = min(kb_hi, q_last / kB + 1);
  if (p.window > 0 && q0 - p.window + 1 > 0)
    kb_lo = (q0 - p.window + 1) / kB;

  for (int kbi = kb_lo; kbi < kb_hi; ++kbi) {
    const int k0 = kbi * kB;
    __syncthreads();                    // the last tile's reads are done
    stage<kD>(s_k, kb, p.st[5], k0, p.sk, p.d);
    stage<kD>(s_v, vb, p.st[8], k0, p.sk, p.d);
    __syncthreads();
    // S and dP: queries ty + 16a against keys tx + 16j
    float s[kR][kR], dp[kR][kR];
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kD; ++c) {
      float qa[kR], ga[kR], kj[kR], vj[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        qa[a] = s_q[(ty + 16 * a) * kStride + c];
        ga[a] = s_do[(ty + 16 * a) * kStride + c];
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        kj[j] = s_k[(tx + 16 * j) * kStride + c];
        vj[j] = s_v[(tx + 16 * j) * kStride + c];
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          s[a][j] = fmaf(qa[a], kj[j], s[a][j]);
          dp[a][j] = fmaf(ga[a], vj[j], dp[a][j]);
        }
    }
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int qi = q0 + ty + 16 * a, kj = k0 + tx + 16 * j;
        const float pr = kept(qi, kj, p.sq, p.sk, p.causal, p.window)
                             ? expf(s[a][j] * p.scale - s_lse[ty + 16 * a])
                             : 0.f;
        s_ds[(ty + 16 * a) * kPStride + tx + 16 * j] =
            pr * (dp[a][j] - s_dl[ty + 16 * a]);
      }
    __syncthreads();
    // dQ += dS K over this tile's keys
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float da[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) da[a] = s_ds[(ty + 16 * a) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = s_k[j * kStride + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < kR; ++a) dq[a][c] = fmaf(da[a], x, dq[a][c]);
      }
    }
  }

  T* dqb = p.dq + b * p.st[15] + h * p.st[16];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) put(dqb + row * p.st[17] + col, dq[a][c] * p.scale);
    }
  }
}

template <int kD, typename T>
cudaError_t launch(const Params<T>& p, int b, int hkv, cudaStream_t stream) {
  using C = Tile<kD>;
  const size_t dkdv_bytes = (4 * C::kTile + 2 * C::kPTile) * sizeof(float);
  const size_t dq_bytes = (4 * C::kTile + C::kPTile) * sizeof(float);
  static bool opted = false;
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<kD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_bytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_kernel<kD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_bytes));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const long long rows = static_cast<long long>(b) * p.hq * p.sq;
  const int rows_per_cta = kThreads / 32;
  delta_kernel<T><<<static_cast<unsigned>((rows + rows_per_cta - 1) /
                                          rows_per_cta),
                    kThreads, 0, stream>>>(p, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<kD, T><<<dim3((p.sk + C::kB - 1) / C::kB, hkv, b), kThreads,
                       dkdv_bytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<kD, T><<<dim3((p.sq + C::kB - 1) / C::kB, p.hq, b), kThreads,
                     dq_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int b, int hq, int hkv, int sq, int sk, int d,
        const long long* strides, int causal, int window, float scale,
        cudaStream_t stream) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  p.hq = hq;
  p.group = hq / hkv;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaError_t e;
  if (d <= 32)
    e = launch<32, T>(p, b, hkv, stream);
  else if (d <= 64)
    e = launch<64, T>(p, b, hkv, stream);
  else if (d <= 128)
    e = launch<128, T>(p, b, hkv, stream);
  else
    e = launch<256, T>(p, b, hkv, stream);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// q [b, hq, sq, d], k and v [b, hkv, sk, d], o and dout [b, hq, sq, d] in
// float32 (bf16 = 0) or bf16 (bf16 = 1), lse and delta (scratch) float32
// [b, hq, sq] contiguous; dq, dk, dv in the layouts of q, k, v.  Element
// strides (batch, head, row) of q, k, v, o, dout, dq, dk, dv, in that
// order; the last axis of each is contiguous.  Launches three kernels on
// `stream` and returns the cudaError_t of the launches (0 on success).
// Requires 1 <= d <= 256, sq, sk >= 1 and hq % hkv == 0.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int b, int hq, int hkv,
                               int sq, int sk, int d,
                               const long long* strides, int causal,
                               int window, float scale, int bf16,
                               void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 || b < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b,
                              hq, hkv, sq, sk, d, strides, causal, window,
                              scale, s);
  return run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq,
                    sk, d, strides, causal, window, scale, s);
}

}  // extern "C"
