// Flash attention's backward for Hopper (sm_90a): the bf16 route at D <= 128
// on the tensor cores (wgmma, TMA), float32 and bf16 at D > 128 on the CUDA
// cores.
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
//   delta_i = rowsum(dO_i * O_i)
//   P_ij    = exp(q_i . k_j * scale - lse_i), 0 where masked
//   dV_j    = sum_i P_ij dO_i
//   dS_ij   = P_ij (dO_i . v_j - delta_i)
//   dK_j    = scale * sum_i dS_ij q_i
//   dQ_i    = scale * sum_j dS_ij k_j
// with the forward's masks (causal aligned top-left: i >= j; window:
// i - j < window), GQA (query head h reads KV head h / g, so dK and dV of a
// KV head sum over its g query heads), and 0 for a wholly masked row.  dq,
// dk and dv are written in the layouts of q, k and v.  The wrapper
// (kernels/flash_attention.py, bwd_route) picks the route by dtype and D,
// and no route stands in for another.
//
// Bound.  At qwen3-0.6b's training call (B = 8, Hq = Hkv = 16 after its KV
// heads are repeated, S = 1,024, D = 128, causal) the backward needs five
// products over the 524,800 unmasked (query, key) pairs of each head
// (recompute QK^T, dV, dP, dK, dQ): 10 * B * Hq * pairs * D = 86 GFLOP,
// 0.087 ms on the bf16 tensor cores (989 TFLOP/s) and 1.28 ms on the
// float32 CUDA cores (67 TFLOP/s), against 269 MB of bf16 q, k, v, O, dO
// and float32 lse read and dq, dk, dv written (0.080 ms at 3.35 TB/s):
// bound by operations on either route.  Measured on an H100 SXM (80 GB
// HBM3, 700 W) at that call: the tensor-core route 0.42 ms (4.8x its bound;
// SDPA's backward 0.325 ms), where the CUDA-core kernels took 7.26 ms in
// bf16.
//
// Both routes: no atomics, so two runs give the same bits.  One kernel owns
// a tile of keys of one KV head and walks every query tile of its g query
// heads that sees one of its keys, keeping dK and dV in registers; a second
// owns a tile of queries of one head and walks the key tiles its rows see
// (the forward's loop), keeping dQ in registers.  Each recomputes P and dS
// for its tile pairs: seven tile products where a single pass with atomics
// on dQ would do five.  Accumulation is float32.
//
// bf16, D <= 128: the tensor-core kernels (namespace tc), three launches.
// prep_kernel writes delta and lse2 = lse * log2(e) (+inf for a wholly
// masked row, so that its P is exp2(-inf) = 0 and never NaN) into a float32
// scratch whose rows are padded to 64 (padding: lse2 +inf, delta 0).
// dkdv_tc_kernel and dq_tc_kernel have the forward's shape: persistent, one
// CTA of three warpgroups per SM walking work items heaviest first (key tile
// 0 first for dK/dV: under the causal mask it sees every query tile; the
// last query tile first for dQ).  Warpgroup 0 is the producer (setmaxnreg 24
// / 240): one thread loads the item's owned 128-row tiles (K and V, or Q and
// dO) by TMA into the second of two buffers while the consumers finish the
// first, and keeps the 64-row streamed tiles (Q, dO and the queries' lse2
// and delta by a bulk copy; or K and V) in flight into a ring of three
// stages, each a full/empty mbarrier pair.  Warpgroups 1 and 2 each own 64
// rows of the item.  Every product is one of the forward's two wgmma forms:
//   dK/dV (keys on M): S^T = K Q^T and dP^T = V dO^T are m64n64k16 chains
//     over D with both operands K-major from shared memory; dV += P^T dO and
//     dK += dS^T Q are m64n64k16 with P^T or dS^T rounded to bf16 in
//     registers as the A fragment (the accumulator's layout) and dO or Q read
//     through the descriptor's transpose bit; a query's lse2 and delta sit
//     on the accumulator's N axis and come from the stage's statistics.
//     dK and dV of a warpgroup's 64 keys: 2 x D / 2 float32 registers a
//     thread, 128 at D = 128.
//   dQ (queries on M): S = Q K^T and dP = dO V^T as above, dQ += dS K with
//     K through the transpose bit.
// The two score products are committed as two groups, so that P is computed
// while dP runs, and in dK/dV the dV product runs while dS is computed.
// The mask is evaluated only on tiles that cut it (ragged Sq or Sk, the
// causal diagonal, the window edge); tiles it wholly masks for a
// warpgroup's rows are skipped (still released to the producer).  D is
// padded with zeros to the next 64 by TMA's out-of-bounds fill; only columns
// below D are written.  TMA descriptors are encoded per call over the
// strided [B, S, H, D] views; where q, k, v or dO breaks TMA's 16-byte rule
// (autograd may hand dO over with any strides), the producer warpgroup
// stages every tile itself with plain loads into the same swizzled layout.
// Shared memory: 4 x 128 + 3 x 2 x 64 rows of 128 ceil(D / 64) bytes and
// the stages' statistics, 227 KB at D = 128.  The device helpers are in
// csrc/hopper.cuh, shared with the forward.
//
// float32 (the train golden holds the port to 1e-4, which TF32 would not),
// and bf16 at 128 < D <= 256, where a warpgroup's two 64 x D float32
// accumulators would not fit its registers: the CUDA-core kernels
// (namespace cc; the wrapper counts the bf16 launches under a name of their
// own).  delta_kernel writes delta; every tile is staged in shared memory as
// float32 rows padded to D + 1 words, so that the 16 threads of a row group
// read 16 different banks; thread (ty, tx) of 256 owns rows ty + 16a and
// columns tx + 16c; inputs and outputs are read and written through their
// strides, only the last axis contiguous.  Tiles are 64 rows for D <= 128
// and 32 for D = 256.  Shared memory: four tiles of D + 1 words a row, plus
// the P and dS tiles in dkdv_kernel (165 KB at D = 128, 140 KB at D = 256)
// and the dS tile in dq_kernel (149 KB, 136 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cc {

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

}  // namespace cc

namespace tc {

using namespace hopper;

constexpr int kThreads = 384;   // warpgroup 0 loads, 1 and 2 compute
constexpr int kStages = 3;      // ring depth of the streamed tiles
constexpr int kBM = 128;        // rows a work item owns: 64 a consumer
constexpr int kBN = 64;         // rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;

template <int kDB>              // 64-column blocks of D (1 or 2)
struct Cfg {
  static constexpr int kOwn = kDB * kBM * kRow;    // one owned tile
  static constexpr int kTile = kDB * kBN * kRow;   // one streamed tile
  static constexpr int kRowStats = 2 * kBN * 4;    // lse2 and delta
  // two buffers of two owned tiles, a ring of stages of two streamed tiles
  // and their row statistics, the mbarriers, and room to align to 1 KB
  // (232,064 bytes at D = 128; a block may take 232,448)
  static constexpr int kSmem =
      4 * kOwn + kStages * (2 * kTile + kRowStats) + 128 + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* o;
  const uint16_t* dout;
  const float* lse;             // [b, hq, sq], natural log
  float* lse2;                  // [b * hq, sp]: lse * log2(e); +inf for a
                                // wholly masked row and the padding
  float* delta;                 // [b * hq, sp]: rowsum(dO * O); 0 padding
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  // (batch, head, row) element strides of q, k, v, o, dout, dq, dk, dv
  long long st[24];
  int hq, hkv, nb, group, sq, sk, sp, d, causal, window, tma;
  float scale, scale_log2;      // sm_scale, sm_scale * log2(e)
};

__device__ __forceinline__ float bf(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// lse2 and delta of every row of [b * hq, sp], one warp a row
__global__ void __launch_bounds__(256) prep_kernel(const Params p,
                                                   long long rows) {
  const long long row = blockIdx.x * 8ll + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(row % p.sp);
  const long long bh = row / p.sp;
  float sum = 0.f, l2 = INFINITY;
  if (i < p.sq) {
    const int h = static_cast<int>(bh % p.hq);
    const int b = static_cast<int>(bh / p.hq);
    const uint16_t* o = p.o + b * p.st[9] + h * p.st[10] + i * p.st[11];
    const uint16_t* g = p.dout + b * p.st[12] + h * p.st[13] + i * p.st[14];
    for (int c = lane; c < p.d; c += 32) sum = fmaf(bf(g[c]), bf(o[c]), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float l = p.lse[bh * p.sq + i];
    l2 = l == -INFINITY ? INFINITY : l * kLog2e;
  }
  if (lane == 0) {
    p.lse2[row] = l2;
    p.delta[row] = sum;
  }
}

// rows [r0, r0 + n) of head h, batch b of one [B, S, H, D] operand (its
// three strides at st) into the n-row tile of kDB blocks at dst: TMA boxes
// of 64 rows completing on the stage's barrier, or the producer
// warpgroup's plain loads into the same swizzled layout
template <int kDB>
__device__ __forceinline__ void load_tile(uint32_t dst, uint8_t* gdst,
                                          const CUtensorMap* map,
                                          const uint16_t* src,
                                          const long long* st, int b, int h,
                                          int r0, int rows, int n, int d,
                                          int tma, int tid, uint32_t bar) {
  if (tma) {
    for (int blk = 0; blk < kDB; ++blk)
      for (int r = 0; r < n; r += kBN)
        tma_load(dst + (blk * n + r) * kRow, map, blk * 64, r0 + r, h, b,
                 bar);
  } else {
    stage<kDB>(gdst, src + b * st[0] + h * st[1], st[2], r0, rows, n, d,
               tid);
  }
}

// the end of a non-TMA stage: every producer thread's stores made visible
// to wgmma, then its arrival
__device__ __forceinline__ void staged(uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(bar);
}

__device__ __forceinline__ void init_bars(uint32_t bars, int tma) {
  if (threadIdx.x == 0) {
    const int arrivals = tma ? 1 : 128;
    // [2] owned full, [2] owned empty, [kStages] full, [kStages] empty
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * s, arrivals);
      mbar_init(bars + 16 + 8 * s, 256);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 32 + 8 * s, arrivals);
      mbar_init(bars + 32 + 8 * kStages + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// x = A B^T: A 64 rows of an owned tile (block stride a_blk bytes), B a
// 64-row streamed tile, a chain of m64n64k16 over D's k16 steps, both
// operands K-major; issued, not committed
template <int kDB>
__device__ __forceinline__ void ss_chain(float (&x)[32], uint32_t a,
                                         uint32_t a_blk, uint32_t bt) {
#pragma unroll
  for (int ks = 0; ks < 4 * kDB; ++ks) {
    const uint32_t off = (ks & 3) * 32;
    wgmma_ss(x, desc(a + (ks >> 2) * a_blk + off, 16, 1024),
             desc(bt + (ks >> 2) * kBN * kRow + off, 16, 1024), ks > 0);
  }
}

// an m64n64 accumulator's 64 columns as four bf16 A fragments of k16
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4],
                                         const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc[blk] += A (64 x 64, fragments) times the 64-row streamed tile at t
// (MN-major: the transpose bit; 16 rows = 2,048 bytes), per 64 columns of D
template <int kDB>
__device__ __forceinline__ void rs_into(float (&acc)[kDB][32],
                                        const uint32_t (&a)[4][4],
                                        uint32_t t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int blk = 0; blk < kDB; ++blk)
      wgmma_rs(acc[blk], a[kk],
               desc(t + blk * kBN * kRow + kk * 2048, 1024, 1024));
}

// rows ra and rb (this thread's two) of a [rows, d] bf16 output at base
// with row stride rs: acc * mul, columns past d and rows past `rows` dropped
template <int kDB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs,
                                           const float (&acc)[kDB][32],
                                           float mul, int ra, int rb,
                                           int rows, int d, int t) {
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= rows) continue;
    __nv_bfloat16* out = base + row * rs;
#pragma unroll
    for (int blk = 0; blk < kDB; ++blk)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = blk * 64 + 8 * j + 2 * t;
        const float x0 = acc[blk][4 * j + 2 * half] * mul;
        const float x1 = acc[blk][4 * j + 2 * half + 1] * mul;
        if (pairs && col + 1 < d) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < d) out[col] = __float2bfloat16_rn(x0);
          if (col + 1 < d) out[col + 1] = __float2bfloat16_rn(x1);
        }
      }
  }
}

// dK and dV.  Work item: 128 keys of one KV head (64 a consumer), key tile
// 0 first (under the causal mask it sees every query tile); the producer
// streams the 64-query Q and dO tiles, with their lse2 and delta, of every
// query head of the group that sees one of the keys.
template <int kDB>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ Params p) {
  using C = Cfg<kDB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;       // swizzle atoms
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t s_k = base;                          // [2] owned
  const uint32_t s_v = s_k + 2 * C::kOwn;             // [2] owned
  const uint32_t s_q = s_v + 2 * C::kOwn;             // [kStages]
  const uint32_t s_do = s_q + kStages * C::kTile;     // [kStages]
  const uint32_t s_l = s_do + kStages * C::kTile;     // [kStages] stats
  const uint32_t bars = s_l + kStages * C::kRowStats;
  const uint32_t bar_kv = bars, bar_kve = bars + 16;
  const uint32_t bar_full = bars + 32, bar_empty = bar_full + 8 * kStages;
  float* f_l = reinterpret_cast<float*>(gbase + (s_l - base));

  const int nk = (p.sk + kBM - 1) / kBM;
  const int hb = p.hkv * p.nb;
  const int total = nk * hb;
  struct Work {
    int k0, hk, b, qb_lo, nqb;
  };
  auto work = [&](int w) {
    Work x;
    x.k0 = (w / hb) * kBM;
    x.hk = (w % hb) % p.hkv;
    x.b = (w % hb) / p.hkv;
    const int k_last = min(x.k0 + kBM, p.sk) - 1;
    int hi = (p.sq + kBN - 1) / kBN;
    if (p.window > 0) hi = min(hi, (k_last + p.window - 1) / kBN + 1);
    x.qb_lo = p.causal ? x.k0 / kBN : 0;
    x.nqb = max(0, hi - x.qb_lo);
    return x;
  };

  init_bars(bars, p.tma);
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (p.tma && tid != 0) return;
    int it = 0;                   // streamed tiles loaded so far
    for (int w = blockIdx.x, j = 0; w < total; w += gridDim.x, ++j) {
      const Work x = work(w);
      const int kv = j & 1;
      if (j >= 2) mbar_wait(bar_kve + 8 * kv, ((j >> 1) - 1) & 1);
      const uint32_t bar = bar_kv + 8 * kv;
      if (p.tma) mbar_expect_tx(bar, 2 * C::kOwn);
      const uint32_t dk_ = s_k + kv * C::kOwn, dv_ = s_v + kv * C::kOwn;
      load_tile<kDB>(dk_, gbase + (dk_ - base), &tm_k, p.k, p.st + 3, x.b,
                     x.hk, x.k0, p.sk, kBM, p.d, p.tma, tid, bar);
      load_tile<kDB>(dv_, gbase + (dv_ - base), &tm_v, p.v, p.st + 6, x.b,
                     x.hk, x.k0, p.sk, kBM, p.d, p.tma, tid, bar);
      if (!p.tma) staged(bar);
      for (int i = 0; i < p.group * x.nqb; ++i, ++it) {
        const int h = x.hk * p.group + i / x.nqb;
        const int q0 = (x.qb_lo + i % x.nqb) * kBN;
        const int st = it % kStages;
        if (it >= kStages)
          mbar_wait(bar_empty + 8 * st, (it / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const long long at = (static_cast<long long>(x.b) * p.hq + h) *
                                 p.sp + q0;
        const uint32_t sl = s_l + st * C::kRowStats;
        if (p.tma) mbar_expect_tx(full, 2 * C::kTile + C::kRowStats);
        const uint32_t tq = s_q + st * C::kTile, tdo = s_do + st * C::kTile;
        load_tile<kDB>(tq, gbase + (tq - base), &tm_q, p.q, p.st, x.b, h, q0,
                       p.sq, kBN, p.d, p.tma, tid, full);
        load_tile<kDB>(tdo, gbase + (tdo - base), &tm_do, p.dout, p.st + 12,
                       x.b, h, q0, p.sq, kBN, p.d, p.tma, tid, full);
        if (p.tma) {
          bulk_load(sl, p.lse2 + at, kBN * 4, full);
          bulk_load(sl + kBN * 4, p.delta + at, kBN * 4, full);
        } else {
          if (tid < kBN) {
            f_l[st * 2 * kBN + tid] = p.lse2[at + tid];
            f_l[st * 2 * kBN + kBN + tid] = p.delta[at + tid];
          }
          staged(full);
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale_log2;
  int it = 0;                     // streamed tiles consumed so far
  for (int w = blockIdx.x, j = 0; w < total; w += gridDim.x, ++j) {
    const Work x = work(w);
    const int kv = j & 1;
    const int kr0 = x.k0 + 64 * c;              // this warpgroup's keys
    const int kr1 = min(kr0 + 63, p.sk - 1);    // last real one (may be < kr0)
    const int ka = kr0 + 16 * warp + g, kb = ka + 8;  // this thread's keys
    const uint32_t a_k = s_k + kv * C::kOwn + c * 64 * kRow;
    const uint32_t a_v = s_v + kv * C::kOwn + c * 64 * kRow;

    float dk[kDB][32], dv[kDB][32];
#pragma unroll
    for (int blk = 0; blk < kDB; ++blk)
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[blk][e] = dv[blk][e] = 0.f;

    mbar_wait(bar_kv + 8 * kv, (j >> 1) & 1);
    for (int i = 0; i < p.group * x.nqb; ++i, ++it) {
      const int q0 = (x.qb_lo + i % x.nqb) * kBN;
      const int q1 = min(q0 + kBN, p.sq) - 1;   // last real query
      const int st = it % kStages;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      const bool skip = kr0 > kr1 || (p.causal && kr0 > q1) ||
                        (p.window > 0 && q0 - kr1 >= p.window);
      if (!skip) {
        const uint32_t tq = s_q + st * C::kTile, tdo = s_do + st * C::kTile;
        // S^T = K Q^T and dP^T = V dO^T (keys on M, queries on N), two
        // commit groups: P^T is computed while dP^T runs
        float s[32], dp[32];
        wgmma_fence();
        ss_chain<kDB>(s, a_k, kBM * kRow, tq);
        wgmma_commit();
        ss_chain<kDB>(dp, a_v, kBM * kRow, tdo);
        wgmma_commit();
        wgmma_wait_n<1>();
        fence_regs(s);
        // P^T = exp2(S^T scale log2(e) - lse2): the query's lse2 on the N
        // axis; the mask only on tiles that cut it (ragged Sk or Sq, the
        // causal diagonal, the window)
        const bool cut = kr0 + 64 > p.sk || q0 + kBN > p.sq ||
                         (p.causal && kr0 + 63 > q0) ||
                         (p.window > 0 && q0 + kBN - 1 - kr0 >= p.window);
        const float* ls = f_l + st * 2 * kBN;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * t);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 4 * jj + r;
            float pr = exp2f(s[e] * sl2 - ((r & 1) ? l2.y : l2.x));
            if (cut) {
              const int kj = (r & 2) ? kb : ka;
              const int qi = q0 + 8 * jj + 2 * t + (r & 1);
              bool ok = kj < p.sk && qi < p.sq;
              if (p.causal) ok = ok && qi >= kj;
              if (p.window > 0) ok = ok && qi - kj < p.window;
              if (!ok) pr = 0.f;
            }
            s[e] = pr;
          }
        }
        // dV += P^T dO (P^T in bf16 registers, dO through the transpose
        // bit), running while dS^T = P^T (dP^T - delta) is computed
        uint32_t pa[4][4];
        to_frags(pa, s);
        wgmma_fence();
        rs_into<kDB>(dv, pa, tdo);
        wgmma_commit();
        wgmma_wait_n<1>();
        fence_regs(dp);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 dl =
              *reinterpret_cast<const float2*>(ls + kBN + 8 * jj + 2 * t);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 4 * jj + r;
            dp[e] = s[e] * (dp[e] - ((r & 1) ? dl.y : dl.x));
          }
        }
        // dK += dS^T Q
        uint32_t da[4][4];
        to_frags(da, dp);
        wgmma_fence();
        rs_into<kDB>(dk, da, tq);
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int blk = 0; blk < kDB; ++blk) {
          fence_regs(dv[blk]);
          fence_regs(dk[blk]);
        }
      }
      mbar_arrive(bar_empty + 8 * st);
    }
    mbar_arrive(bar_kve + 8 * kv);            // the K/V buffer is free

    store_rows<kDB>(p.dk + x.b * p.st[18] + x.hk * p.st[19], p.st[20], dk,
                    p.scale, ka, kb, p.sk, p.d, t);
    store_rows<kDB>(p.dv + x.b * p.st[21] + x.hk * p.st[22], p.st[23], dv,
                    1.f, ka, kb, p.sk, p.d, t);
  }
}

// dQ.  Work item: 128 queries of one head (64 a consumer), the causal
// diagonal's heaviest tiles first; the producer streams the 64-key K and V
// tiles its rows see (the forward's loop).
template <int kDB>
__global__ void __launch_bounds__(kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ Params p) {
  using C = Cfg<kDB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t s_q = base;                          // [2] owned
  const uint32_t s_do = s_q + 2 * C::kOwn;            // [2] owned
  const uint32_t s_k = s_do + 2 * C::kOwn;            // [kStages]
  const uint32_t s_v = s_k + kStages * C::kTile;      // [kStages]
  const uint32_t bars = s_v + kStages * C::kTile;
  const uint32_t bar_q = bars, bar_qe = bars + 16;
  const uint32_t bar_full = bars + 32, bar_empty = bar_full + 8 * kStages;

  const int nq = (p.sq + kBM - 1) / kBM;
  const int hb = p.hq * p.nb;
  const int total = nq * hb;
  struct Work {
    int q0, h, b, kb_lo, nblk;
  };
  auto work = [&](int w) {
    Work x;
    x.q0 = (nq - 1 - w / hb) * kBM;
    x.h = (w % hb) % p.hq;
    x.b = (w % hb) / p.hq;
    const int q_last = min(x.q0 + kBM, p.sq) - 1;
    int kb_hi = (p.sk + kBN - 1) / kBN;
    if (p.causal) kb_hi = min(kb_hi, q_last / kBN + 1);
    x.kb_lo = 0;
    if (p.window > 0 && x.q0 - p.window + 1 > 0)
      x.kb_lo = (x.q0 - p.window + 1) / kBN;
    x.nblk = max(0, kb_hi - x.kb_lo);
    return x;
  };

  init_bars(bars, p.tma);
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (p.tma && tid != 0) return;
    int it = 0;
    for (int w = blockIdx.x, j = 0; w < total; w += gridDim.x, ++j) {
      const Work x = work(w);
      const int hk = x.h / p.group, qs = j & 1;
      if (j >= 2) mbar_wait(bar_qe + 8 * qs, ((j >> 1) - 1) & 1);
      const uint32_t bar = bar_q + 8 * qs;
      if (p.tma) mbar_expect_tx(bar, 2 * C::kOwn);
      const uint32_t tq = s_q + qs * C::kOwn, tdo = s_do + qs * C::kOwn;
      load_tile<kDB>(tq, gbase + (tq - base), &tm_q, p.q, p.st, x.b, x.h,
                     x.q0, p.sq, kBM, p.d, p.tma, tid, bar);
      load_tile<kDB>(tdo, gbase + (tdo - base), &tm_do, p.dout, p.st + 12,
                     x.b, x.h, x.q0, p.sq, kBM, p.d, p.tma, tid, bar);
      if (!p.tma) staged(bar);
      for (int i = 0; i < x.nblk; ++i, ++it) {
        const int st = it % kStages, k0 = (x.kb_lo + i) * kBN;
        if (it >= kStages)
          mbar_wait(bar_empty + 8 * st, (it / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        if (p.tma) mbar_expect_tx(full, 2 * C::kTile);
        const uint32_t tk = s_k + st * C::kTile, tv = s_v + st * C::kTile;
        load_tile<kDB>(tk, gbase + (tk - base), &tm_k, p.k, p.st + 3, x.b,
                       hk, k0, p.sk, kBN, p.d, p.tma, tid, full);
        load_tile<kDB>(tv, gbase + (tv - base), &tm_v, p.v, p.st + 6, x.b,
                       hk, k0, p.sk, kBN, p.d, p.tma, tid, full);
        if (!p.tma) staged(full);
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale_log2;
  int it = 0;
  for (int w = blockIdx.x, j = 0; w < total; w += gridDim.x, ++j) {
    const Work x = work(w);
    const int qs = j & 1;
    const int r0 = x.q0 + 64 * c;               // this warpgroup's rows
    const int r1 = min(r0 + 63, p.sq - 1);      // last real one (may be < r0)
    const int ra = r0 + 16 * warp + g, rb = ra + 8;   // this thread's rows
    const long long row0 = (static_cast<long long>(x.b) * p.hq + x.h) * p.sp;
    const float la = ra < p.sq ? p.lse2[row0 + ra] : INFINITY;
    const float lb = rb < p.sq ? p.lse2[row0 + rb] : INFINITY;
    const float da_ = ra < p.sq ? p.delta[row0 + ra] : 0.f;
    const float db_ = rb < p.sq ? p.delta[row0 + rb] : 0.f;
    const uint32_t a_q = s_q + qs * C::kOwn + c * 64 * kRow;
    const uint32_t a_do = s_do + qs * C::kOwn + c * 64 * kRow;

    float dq[kDB][32];
#pragma unroll
    for (int blk = 0; blk < kDB; ++blk)
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[blk][e] = 0.f;

    mbar_wait(bar_q + 8 * qs, (j >> 1) & 1);
    for (int i = 0; i < x.nblk; ++i, ++it) {
      const int st = it % kStages, k0 = (x.kb_lo + i) * kBN;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      const bool skip = r0 > r1 || (p.causal && k0 > r1) ||
                        (p.window > 0 && r0 - (k0 + kBN - 1) >= p.window);
      if (!skip) {
        const uint32_t tk = s_k + st * C::kTile, tv = s_v + st * C::kTile;
        // S = Q K^T and dP = dO V^T, two commit groups: P is computed
        // while dP runs
        float s[32], dp[32];
        wgmma_fence();
        ss_chain<kDB>(s, a_q, kBM * kRow, tk);
        wgmma_commit();
        ss_chain<kDB>(dp, a_do, kBM * kRow, tv);
        wgmma_commit();
        wgmma_wait_n<1>();
        fence_regs(s);
        const bool cut = k0 + kBN > p.sk || (p.causal && k0 + kBN - 1 > r0) ||
                         (p.window > 0 && r1 - k0 >= p.window);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float pr = exp2f(s[e] * sl2 - ((e & 2) ? lb : la));
          if (cut) {
            const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            const int qi = (e & 2) ? rb : ra;
            bool ok = kj < p.sk;
            if (p.causal) ok = ok && qi >= kj;
            if (p.window > 0) ok = ok && qi - kj < p.window;
            if (!ok) pr = 0.f;
          }
          s[e] = pr;
        }
        wgmma_wait();
        fence_regs(dp);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          dp[e] = s[e] * (dp[e] - ((e & 2) ? db_ : da_));
        // dQ += dS K (dS in bf16 registers, K through the transpose bit)
        uint32_t ds[4][4];
        to_frags(ds, dp);
        wgmma_fence();
        rs_into<kDB>(dq, ds, tk);
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int blk = 0; blk < kDB; ++blk) fence_regs(dq[blk]);
      }
      mbar_arrive(bar_empty + 8 * st);
    }
    mbar_arrive(bar_qe + 8 * qs);             // the Q/dO buffer is free

    store_rows<kDB>(p.dq + x.b * p.st[15] + x.h * p.st[16], p.st[17], dq,
                    p.scale, ra, rb, p.sq, p.d, t);
  }
}

template <int kDB>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<kDB>;
  static bool opted = false;
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_tc_kernel<kDB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_tc_kernel<kDB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  CUtensorMap mq, mk, mv, mdo;
  memset(&mq, 0, sizeof(mq));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  memset(&mdo, 0, sizeof(mdo));
  if (p.tma) {
    const long long* s = p.st;
    if (!encode(&mq, p.q, p.nb, p.hq, p.sq, p.d, s[0], s[1], s[2], kBN) ||
        !encode(&mk, p.k, p.nb, p.hkv, p.sk, p.d, s[3], s[4], s[5], kBN) ||
        !encode(&mv, p.v, p.nb, p.hkv, p.sk, p.d, s[6], s[7], s[8], kBN) ||
        !encode(&mdo, p.dout, p.nb, p.hq, p.sq, p.d, s[12], s[13], s[14],
                kBN))
      return -1;
  }
  const int sms = sm_count();
  if (!sms) return static_cast<int>(cudaErrorInvalidDevice);
  const long long rows = static_cast<long long>(p.nb) * p.hq * p.sp;
  prep_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      p, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_kv = (p.sk + kBM - 1) / kBM * p.hkv * p.nb;
  dkdv_tc_kernel<kDB><<<min(n_kv, sms), kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_q = (p.sq + kBM - 1) / kBM * p.hq * p.nb;
  dq_tc_kernel<kDB><<<min(n_q, sms), kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" {

// q [b, hq, sq, d], k and v [b, hkv, sk, d], o and dout [b, hq, sq, d] in
// float32 (bf16 = 0) or bf16 (bf16 = 1), lse float32 [b, hq, sq] contiguous;
// dq, dk, dv in the layouts of q, k, v.  Element strides (batch, head, row)
// of q, k, v, o, dout, dq, dk, dv, in that order; the last axis of each is
// contiguous.  tc = 1: the tensor-core route (bf16 and d <= 128 only), with
// delta float32 scratch of 2 * b * hq * ceil(sq / 64) * 64 elements; tma = 1
// there: every base of q, k, v, dout is 16-byte aligned and every stride a
// multiple of 8 elements (the wrapper checks), so they come in through TMA;
// tma = 0: the producer stages them.  tc = 0: the CUDA-core route, delta
// float32 scratch of b * hq * sq elements.  Launches three kernels on
// `stream` and returns the cudaError_t of the launches (0 on success), -1
// if a TMA descriptor could not be encoded.  Requires 1 <= d <= 256,
// sq, sk >= 1 and hq % hkv == 0.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int b, int hq, int hkv,
                               int sq, int sk, int d,
                               const long long* strides, int causal,
                               int window, float scale, int bf16, int tc,
                               int tma, void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 || b < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (!bf16 || d > 128) return cudaErrorInvalidValue;
    tc::Params p;
    p.q = static_cast<const uint16_t*>(q);
    p.k = static_cast<const uint16_t*>(k);
    p.v = static_cast<const uint16_t*>(v);
    p.o = static_cast<const uint16_t*>(o);
    p.dout = static_cast<const uint16_t*>(dout);
    p.lse = lse;
    p.sp = (sq + tc::kBN - 1) / tc::kBN * tc::kBN;
    p.lse2 = delta;
    p.delta = delta + static_cast<long long>(b) * hq * p.sp;
    p.dq = static_cast<__nv_bfloat16*>(dq);
    p.dk = static_cast<__nv_bfloat16*>(dk);
    p.dv = static_cast<__nv_bfloat16*>(dv);
    for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
    p.hq = hq;
    p.hkv = hkv;
    p.nb = b;
    p.group = hq / hkv;
    p.sq = sq;
    p.sk = sk;
    p.d = d;
    p.causal = causal;
    p.window = window;
    p.tma = tma;
    p.scale = scale;
    p.scale_log2 = scale * tc::kLog2e;
    return d <= 64 ? tc::launch<1>(p, s) : tc::launch<2>(p, s);
  }
  if (bf16)
    return cc::run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  b, hq, hkv, sq, sk, d, strides, causal,
                                  window, scale, s);
  return cc::run<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, hq, hkv,
                        sq, sk, d, strides, causal, window, scale, s);
}

}  // extern "C"
