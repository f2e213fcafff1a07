// Flash attention for Hopper (sm_90a): block-wise online softmax, with the
// bf16 route on the tensor cores (wgmma, TMA) and the float32 route on the
// CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel) and computes what
// repro_torch/kernels/ref.py::flash_attention_ref computes:
//   out[b, h, i, :] = softmax_j(q_i . k_j * scale, masked) @ v_j
// with query head h reading KV head h / (Hq / Hkv) (GQA), key j masked for
// query i unless i >= j (causal; indices from 0, so the mask is aligned
// top-left when Sq != Sk) and i - j < window (window > 0), float32 running
// max, sum and accumulator, and 0 for a row whose every key is masked.  Any
// Sq, Sk, D <= 256.  The wrapper picks the route by dtype, and neither
// route stands in for the other.  Training asks each route for the float32
// row logsumexp lse[b, h, i] of the scaled scores as well (natural log; -inf
// for a wholly masked row), which the backward (csrc/flash_attention_bwd.cu)
// reads; it is written only where its pointer is non-null, so a call without
// it (the prefill) computes and writes exactly what it did before.
//
// Bound.  At the dense prefill's shape (qwen3-0.6b: B = 8, Hq = Hkv = 16,
// S = 1,024, D = 128, bf16, causal) one launch moves 134 MB (q, k, v read
// once, out written once): 0.040 ms at 3.35 TB/s.  Its 34.4 GFLOP of
// causal QK^T and PV take 0.035 ms on the bf16 tensor cores (989 TFLOP/s)
// and 0.51 ms on the float32 CUDA cores (67 TFLOP/s), so only the tensor
// cores bring a launch near its byte bound.
//
// bf16: the tensor-core kernel (namespace tc).  Persistent: one CTA of three
// warpgroups per SM walks the (b, h, 128-query tile) items, the causal
// diagonal's heaviest tiles first, so that the next item's query and first K/V
// tiles load while the current one finishes and writes its output (one CTA per
// item left each SM idle through every item's prologue).  Warpgroup 0 is the
// producer: one thread keeps TMA loads of the next K and V tiles in flight
// into a ring of two stages, each a full/empty mbarrier pair, and of the next
// query tile into the second of two query buffers (one at D > 192); it gives
// its registers to the consumers (setmaxnreg 24 / 240).  Warpgroups 1 and 2
// each own 64 query rows: S = Q K^T is a chain of wgmma m64nBKk16 over the k16
// steps of D padded to 64, with Q and K read from shared memory, and O += P V
// is wgmma m64n64k16 per 64 columns of D with P in registers (the S
// accumulator's layout is the A operand's, rounded to bf16) and V read through
// the descriptor's transpose bit.  The running max, sum and O stay in float32
// registers; softmax is exp2 of scores pre-scaled by scale * log2(e), masked
// entries are -inf and take no part (p = 0), the first finite max stands in
// for -inf, so a wholly masked row ends with l = 0 and is written as 0.  Key
// tiles wholly masked for a warpgroup's rows are skipped (still released to
// the producer); the mask is evaluated only on tiles that cut it (ragged Sk,
// the causal diagonal, the window edge).  Tiles in shared memory are 64-column
// blocks of 128-byte rows in the 128-byte swizzle that TMA writes and wgmma
// reads; D is padded with zeros to the next 64 (TMA's out-of-bounds fill), and
// both products run over whole 64-column blocks: the QK^T chain has a
// compile-time length, which keeps ptxas from serializing it (a chain cut at
// the next 16 of D did, warning C7515).  Key tile BK = 128 for D <= 128, 64
// above, where O's D / 2 registers a thread press on the budget.  TMA
// descriptors are encoded per call over the strided [B, S, H, D] views
// (cuTensorMapEncodeTiled from cudaGetDriverEntryPoint, so the library needs
// no -lcuda).  Where a tensor breaks TMA's 16-byte rule (an unaligned base, a
// row or head stride not a multiple of 16 bytes), the producer warpgroup
// stages all three tensors itself, with plain loads into the same swizzled
// layout, and the consumers run unchanged.  Shared memory: (128 q + 4 BK) x 64
// ceil(D / 64) x 2 B + 1 KB for q query buffers, 193 KB at D = 128.  Tried and
// no faster at the qwen3 shape: three stages, separate K and V barriers, one P
// V wgmma across D, ex2.approx, tile i-1's P V in flight behind tile i's Q
// K^T, and ping-pong turns between the consumer warpgroups.  The device
// helpers (mbarriers, TMA, wgmma, the producer's staging) and the tensor map
// encoder live in csrc/hopper.cuh, shared with the backward.
//
// float32: the CUDA-core kernel (namespace cc), for the float32 golden
// checks that hold the port to 1e-4, which TF32 would not.  One CTA of 256
// threads per (b, h, 64-query block).  The query tile and one 64-key tile
// of K, then of V, are staged in shared memory as float32 rows padded to
// D + 1 words, so that the 16 threads of a row group read 16 different
// banks.  Thread (ty, tx) owns query rows ty + 16a (a < 4): scores for
// keys tx + 16j (j < 4) and output columns tx + 16c (c < D/16) in
// registers; the row max and row sum are reduced over the 16 lanes that
// share a row with warp shuffles.  The Pallas kernel carried m, l and acc
// in scratch across a sequential grid axis; here one CTA walks its key
// blocks in a loop, skipping blocks that the causal mask or the window
// mask wholly.  Shared memory: (2 x 64 x (D + 1) + 64 x 65) x 4 B, 83 KB
// at D = 128, so the launch opts in above 48 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cc {


constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per step
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPStride = kBK + 1;

// rows [r0, r0 + 64) of a [rows, d] matrix with row stride `rs` into
// shared float rows of kD + 1 words; zero outside the matrix and past d
template <int kD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long rs, int r0, int rows, int d) {
  constexpr int kStride = kD + 1;
  for (int e = threadIdx.x; e < kBQ * kD; e += kThreads) {
    const int r = e / kD, c = e - r * kD;
    float x = 0.f;
    if (r0 + r < rows && c < d) x = src[(r0 + r) * rs + c];
    dst[r * kStride + c] = x;
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int group,
             int sq, int sk, int d, long long q_sb, long long q_sh,
             long long q_ss, long long k_sb, long long k_sh, long long k_ss,
             long long v_sb, long long v_sh, long long v_ss, long long o_sb,
             long long o_sh, long long o_ss, int causal, int window,
             float scale, float* __restrict__ lse) {
  constexpr int kStride = kD + 1;
  constexpr int kCols = kD / 16;
  extern __shared__ float smem[];
  float* s_q = smem;                    // [kBQ][kStride]
  float* s_kv = s_q + kBQ * kStride;    // [kBK][kStride], K then V
  float* s_p = s_kv + kBK * kStride;    // [kBQ][kPStride]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  stage<kD>(s_q, qb, q_ss, q0, sq, d);

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
    stage<kD>(s_kv, kb, k_ss, k0, sk, d);
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
    stage<kD>(s_kv, vb, v_ss, k0, sk, d);
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

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sq) continue;
    const float inv = l[a] == 0.f ? 1.f : l[a];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[row * o_ss + col] = acc[a][c] / inv;
    }
    if (lse && tx == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * sq + row] =
          l[a] == 0.f ? -INFINITY : m[a] + logf(l[a]);
  }
}

template <int kD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int b, int hq, int hkv, int sq, int sk, int d,
                   const long long* st, int causal, int window, float scale,
                   float* lse, cudaStream_t stream) {
  const size_t bytes =
      (2 * kBQ * (kD + 1) + kBQ * kPStride) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<kD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, hq / hkv, sq, sk, d, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, window,
      scale, lse);
  return cudaGetLastError();
}

}  // namespace cc

namespace tc {

using namespace hopper;

constexpr int kBQ = 128;        // queries per CTA: two consumer warpgroups
constexpr int kThreads = 384;   // warpgroup 0 loads, 1 and 2 compute
constexpr int kStages = 2;      // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int kDB>              // 64-column blocks of D
struct Cfg {
  static constexpr int kBK = kDB <= 2 ? 128 : 64;
  static constexpr int kQBytes = kDB * kBQ * kRow;
  static constexpr int kTile = kDB * kBK * kRow;      // one K or V tile
  static constexpr int kQBuf = kDB <= 3 ? 2 : 1;       // query tiles
  static constexpr int kSmem =
      kQBuf * kQBytes + 2 * kStages * kTile + 1024 + 128;
};

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  __nv_bfloat16* o;
  float* lse;                   // [B, Hq, Sq] or null
  long long st[12];             // (batch, head, row) strides of q, k, v, o
  int group, sq, sk, d, causal, window, tma, hq, nb;
  float scale_log2;             // sm_scale * log2(e)
};

template <int kDB>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<kDB>;
  constexpr int kBK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;       // swizzle atoms
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t s_q = base;                          // [kQBuf] tiles
  const uint32_t s_k = s_q + C::kQBuf * C::kQBytes;   // [kStages] tiles
  const uint32_t s_v = s_k + kStages * C::kTile;
  const uint32_t bar_q = s_v + kStages * C::kTile;    // [kQBuf] full
  const uint32_t bar_qe = bar_q + 8 * C::kQBuf;       // [kQBuf] empty
  const uint32_t bar_full = bar_qe + 8 * C::kQBuf;    // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;  // [kStages]

  // Persistent: CTA x walks work items x, x + gridDim.x, ...; item w is
  // query tile nq - 1 - w / (hq * nb) (the causal diagonal's heaviest
  // tiles first) of head w % hq, batch (w / hq) % nb.
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int total = nq * p.hq * p.nb;
  struct Work {
    int q0, h, b, kb_lo, nblk;
  };
  auto work = [&](int w) {
    Work x;
    const int hb = p.hq * p.nb;
    x.q0 = (nq - 1 - w / hb) * kBQ;
    x.h = (w % hb) % p.hq;
    x.b = (w % hb) / p.hq;
    const int q_last = min(x.q0 + kBQ, p.sq) - 1;
    int kb_hi = (p.sk + kBK - 1) / kBK;
    if (p.causal) kb_hi = min(kb_hi, q_last / kBK + 1);
    x.kb_lo = 0;
    if (p.window > 0 && x.q0 - p.window + 1 > 0)
      x.kb_lo = (x.q0 - p.window + 1) / kBK;
    x.nblk = max(0, kb_hi - x.kb_lo);
    return x;
  };

  if (threadIdx.x == 0) {
    const int arrivals = p.tma ? 1 : 128;
    for (int s = 0; s < C::kQBuf; ++s) {
      mbar_init(bar_q + 8 * s, arrivals);
      mbar_init(bar_qe + 8 * s, 256);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, arrivals);
      mbar_init(bar_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (p.tma && tid != 0) return;
    int it = 0;                   // K/V tiles loaded so far
    for (int w = blockIdx.x, j = 0; w < total; w += gridDim.x, ++j) {
      const Work x = work(w);
      const int hk = x.h / p.group, qs = j % C::kQBuf;
      if (j >= C::kQBuf)
        mbar_wait(bar_qe + 8 * qs, (j / C::kQBuf - 1) & 1);
      const uint32_t sq_ = s_q + qs * C::kQBytes;
      if (p.tma) {
        mbar_expect_tx(bar_q + 8 * qs, C::kQBytes);
        for (int blk = 0; blk < kDB; ++blk)
          tma_load(sq_ + blk * kBQ * kRow, &tm_q, blk * 64, x.q0, x.h, x.b,
                   bar_q + 8 * qs);
      } else {
        stage<kDB>(gbase + (sq_ - base), p.q + x.b * p.st[0] + x.h * p.st[1],
                   p.st[2], x.q0, p.sq, kBQ, p.d, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(bar_q + 8 * qs);
      }
      for (int i = 0; i < x.nblk; ++i, ++it) {
        const int st = it % kStages, k0 = (x.kb_lo + i) * kBK;
        if (it >= kStages)
          mbar_wait(bar_empty + 8 * st, (it / kStages - 1) & 1);
        if (p.tma) {
          mbar_expect_tx(bar_full + 8 * st, 2 * C::kTile);
          for (int blk = 0; blk < kDB; ++blk) {
            tma_load(s_k + st * C::kTile + blk * kBK * kRow, &tm_k, blk * 64,
                     k0, hk, x.b, bar_full + 8 * st);
            tma_load(s_v + st * C::kTile + blk * kBK * kRow, &tm_v, blk * 64,
                     k0, hk, x.b, bar_full + 8 * st);
          }
        } else {
          stage<kDB>(gbase + (s_k - base) + st * C::kTile,
                     p.k + x.b * p.st[3] + hk * p.st[4], p.st[5], k0, p.sk,
                     kBK, p.d, tid);
          stage<kDB>(gbase + (s_v - base) + st * C::kTile,
                     p.v + x.b * p.st[6] + hk * p.st[7], p.st[8], k0, p.sk,
                     kBK, p.d, tid);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(bar_full + 8 * st);
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
  int it = 0;                     // K/V tiles consumed so far
  for (int w = blockIdx.x, j = 0; w < total; w += gridDim.x, ++j) {
    const Work x = work(w);
    const int q0 = x.q0, h = x.h, b = x.b, qs = j % C::kQBuf;
    const uint32_t s_qt = s_q + qs * C::kQBytes;
    const int r0 = q0 + 64 * c;               // this warpgroup's rows
    const int r1 = min(r0 + 63, p.sq - 1);    // last real one (may be < r0)
    const int ra = r0 + 16 * warp + g, rb = ra + 8;   // this thread's rows

    float o[kDB][32];
#pragma unroll
    for (int blk = 0; blk < kDB; ++blk)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[blk][e] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    mbar_wait(bar_q + 8 * qs, (j / C::kQBuf) & 1);
    for (int i = 0; i < x.nblk; ++i, ++it) {
      const int st = it % kStages, k0 = (x.kb_lo + i) * kBK;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      const bool skip = r0 > r1 || (p.causal && k0 > r1) ||
                        (p.window > 0 && r0 - (k0 + kBK - 1) >= p.window);
      if (!skip) {
        // S = Q K^T (K-major operands, 32-byte steps inside a swizzled row)
        float s[kBK / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4 * kDB; ++ks) {
          const uint32_t in_row = (ks & 3) * 32;
          const uint64_t da = desc(
              s_qt + (ks >> 2) * kBQ * kRow + c * 64 * kRow + in_row, 16,
              1024);
          const uint64_t dk = desc(
              s_k + st * C::kTile + (ks >> 2) * kBK * kRow + in_row, 16,
              1024);
          wgmma_ss(s, da, dk, ks > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(s);

        // scale to log2 units, mask, online softmax over this tile
        const bool cut = k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > r0) ||
                         (p.window > 0 && r1 - k0 >= p.window);
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          float x = s[e] * sl2;
          if (cut) {
            const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            const int qi = (e & 2) ? rb : ra;
            bool ok = kj < p.sk;
            if (p.causal) ok = ok && qi >= kj;
            if (p.window > 0) ok = ok && qi - kj < p.window;
            if (!ok) x = -INFINITY;
          }
          s[e] = x;
        }
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
        const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
        const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          s[4 * j] = exp2f(s[4 * j] - mu_a);
          s[4 * j + 1] = exp2f(s[4 * j + 1] - mu_a);
          s[4 * j + 2] = exp2f(s[4 * j + 2] - mu_b);
          s[4 * j + 3] = exp2f(s[4 * j + 3] - mu_b);
          sum_a += s[4 * j] + s[4 * j + 1];
          sum_b += s[4 * j + 2] + s[4 * j + 3];
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int blk = 0; blk < kDB; ++blk)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[blk][4 * j] *= al_a;
            o[blk][4 * j + 1] *= al_a;
            o[blk][4 * j + 2] *= al_b;
            o[blk][4 * j + 3] *= al_b;
          }
        // P (bf16, the S accumulator's layout read as wgmma's A fragment)
        uint32_t pa[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        // O += P V (V MN-major: the transpose bit; 16 keys = 2,048 bytes)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int blk = 0; blk < kDB; ++blk)
            wgmma_rs(o[blk], pa[kk],
                     desc(s_v + st * C::kTile + blk * kBK * kRow + kk * 2048,
                          1024, 1024));
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int blk = 0; blk < kDB; ++blk) fence_regs(o[blk]);
      }
      mbar_arrive(bar_empty + 8 * st);
    }
    mbar_arrive(bar_qe + 8 * qs);             // the query tile is free

    // epilogue: O / l, rows past Sq and columns past D dropped
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    if (p.lse && t == 0) {        // m in log2 units: lse = (m + log2 l) ln 2
      float* lrow = p.lse + (static_cast<long long>(b) * p.hq + h) * p.sq;
      if (ra < p.sq)
        lrow[ra] = l_a > 0.f ? (m_a + log2f(l_a)) * kLn2 : -INFINITY;
      if (rb < p.sq)
        lrow[rb] = l_b > 0.f ? (m_b + log2f(l_b)) * kLn2 : -INFINITY;
    }
    __nv_bfloat16* ob = p.o + b * p.st[9] + h * p.st[10];
    const bool pairs = (p.d & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? rb : ra;
      if (row >= p.sq) continue;
      const float inv = half ? inv_b : inv_a;
      __nv_bfloat16* orow = ob + row * p.st[11];
#pragma unroll
      for (int blk = 0; blk < kDB; ++blk)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = blk * 64 + 8 * j + 2 * t;
          const float x0 = o[blk][4 * j + 2 * half] * inv;
          const float x1 = o[blk][4 * j + 2 * half + 1] * inv;
          if (pairs && col + 1 < p.d) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < p.d) orow[col] = __float2bfloat16_rn(x0);
            if (col + 1 < p.d) orow[col + 1] = __float2bfloat16_rn(x1);
          }
        }
    }
  }
}

template <int kDB>
int launch(const Params& p, int b, int hq, int hkv, cudaStream_t stream) {
  using C = Cfg<kDB>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<kDB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  CUtensorMap mq, mk, mv;
  memset(&mq, 0, sizeof(mq));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  if (p.tma) {
    const long long* s = p.st;
    if (!encode(&mq, p.q, b, hq, p.sq, p.d, s[0], s[1], s[2], kBQ) ||
        !encode(&mk, p.k, b, hkv, p.sk, p.d, s[3], s[4], s[5], C::kBK) ||
        !encode(&mv, p.v, b, hkv, p.sk, p.d, s[6], s[7], s[8], C::kBK))
      return -1;
  }
  const int sms = sm_count();
  if (!sms) return static_cast<int>(cudaErrorInvalidDevice);
  const int total = (p.sq + kBQ - 1) / kBQ * hq * b;
  flash_tc_kernel<kDB><<<min(total, sms), kThreads, C::kSmem, stream>>>(
      mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" {

// Element strides (batch, head, row) of q, k, v, o, in that order; the last
// axis of each is contiguous.  q [b, hq, sq, d], k and v [b, hkv, sk, d] and
// o [b, hq, sq, d] are device pointers; lse, where not null, a contiguous
// float32 [b, hq, sq] that receives each row's logsumexp.  Each launches on
// `stream` and returns the cudaError_t of the launch (0 on success).

// float32 on the CUDA cores.  Requires 1 <= d <= 256 and hq % hkv == 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int hq, int hkv, int sq, int sk,
                           int d, const long long* strides, int causal,
                           int window, float scale, float* lse,
                           void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv) return cudaErrorInvalidValue;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (d <= 32)
    return cc::launch<32>(fq, fk, fv, fo, b, hq, hkv, sq, sk, d, st, causal,
                          window, scale, lse, s);
  if (d <= 64)
    return cc::launch<64>(fq, fk, fv, fo, b, hq, hkv, sq, sk, d, st, causal,
                          window, scale, lse, s);
  if (d <= 128)
    return cc::launch<128>(fq, fk, fv, fo, b, hq, hkv, sq, sk, d, st, causal,
                           window, scale, lse, s);
  return cc::launch<256>(fq, fk, fv, fo, b, hq, hkv, sq, sk, d, st, causal,
                         window, scale, lse, s);
}

// bf16 on the tensor cores.  tma = 1: every base is 16-byte aligned and
// every stride a multiple of 8 elements (the wrapper checks), so K and V
// come in through TMA; tma = 0: the producer stages them.  Returns -1 if a
// TMA descriptor could not be encoded.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int b, int hq, int hkv, int sq, int sk,
                              int d, const long long* strides, int causal,
                              int window, float scale, int tma, float* lse,
                              void* stream) {
  if (d < 1 || d > 256 || hkv < 1 || hq % hkv) return cudaErrorInvalidValue;
  tc::Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
  p.group = hq / hkv;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.tma = tma;
  p.scale_log2 = scale * tc::kLog2e;
  p.hq = hq;
  p.nb = b;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1: return tc::launch<1>(p, b, hq, hkv, s);
    case 2: return tc::launch<2>(p, b, hq, hkv, s);
    case 3: return tc::launch<3>(p, b, hq, hkv, s);
    default: return tc::launch<4>(p, b, hq, hkv, s);
  }
}

}  // extern "C"
