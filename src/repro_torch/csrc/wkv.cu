// Chunked RWKV6 WKV for Hopper (sm_90a), its chunk products on the tensor
// cores.
//
// Replaces the Pallas TPU kernel repro/kernels/wkv.py (wkv_chunked,
// _wkv_kernel) and computes what repro_torch/kernels/ref.py::
// wkv_chunked_ref computes: per (b, h) and chunk of C steps, with the
// float32 state S [D, D] carried across chunks,
//   cum   = inclusive cumsum of log w over the chunk,  ce = cum - log w,
//   c     = cum_last / 2 (the centring offset),
//   out_t = (r_t e^{ce_t}) S                                   (inter-chunk)
//         + sum_{s<t} (r_t e^{ce_t - c} . k_s e^{c - cum_s}) v_s  (intra)
//         + (r_t . u k_t) v_t                                  (bonus)
//   S'    = diag(e^{cum_last}) S + sum_s (k_s e^{cum_last - cum_s})^T v_s.
// It also starts from a given state and writes the final one, and, when
// asked (training: csrc/wkv_bwd.cu reads them), the state entering each
// chunk.  D in {16, 32, 64}, C from 1 to 128; r, k, v float32 or bf16, log
// w and u float32, out and the states float32.
//
// Bound.  At the RWKV prefill's shape (rwkv6-3b: B = 8, H = 48, S = 1,024,
// D = 64, chunk 128, bf16 r/k/v) one launch moves 358.6 MB (r, k, v, log w
// read once, out and the state written once): 0.107 ms at 3.35 TB/s.  Its
// 12.83 GFLOP of chunk products take 0.19 ms at the card's 67 TFLOP/s of
// float32 on the CUDA cores, but three TF32 passes of them 0.078 ms at 495
// TFLOP/s on the tensor cores: there the bytes bound it.
//
// Design.  A CTA of four warps per (b, h, DV value columns), DV = min(D,
// 32): out[:, j] and S[:, j] depend on v[:, j] only, so at D = 64 the value
// columns split over the two CTAs of a cluster, 768 CTAs at the main-path
// shape, two resident per SM in 111 KB of shared memory each.  Each CTA
// walks the chunks in order; per chunk:
//   1. the prefix, shared by the pair: each CTA takes half of the channels
//      for all rows.  Its warps load their 32 rows of log w coalesced (a
//      chunk ahead, into registers), thread t scans row t's channels over
//      the warp's rows by shuffles (an inclusive warp scan, 5 steps), and
//      the warps' totals are added in order: cum, c = cum_last / 2, e^c,
//      e^{cum_last}.  Then, coalesced again, r' = r e^{ce - c} and k' = k
//      e^{c - cum} (0 past the chunk) and this half's r.(u k); all of it is
//      stored into both CTAs' shared memory (distributed shared memory).
//      Since e^{ce} = e^{ce - c} e^{c} and e^{cum_last - cum} = e^{c - cum}
//      e^{c}, the same r' and k' serve the inter-chunk term and the state
//      update.  Two split cluster barriers a chunk order the exchange: a
//      CTA waits, before it writes into the other, until that one has read
//      its last chunk, and both wait for the other's writes before step 2;
//      the next chunk's r, k and v rows are prefetched into L2 meanwhile.
//   2. the products on the tensor cores, mma.sync m16n8k8 TF32, at float32
//      accuracy by the 3xTF32 split: x = hi + lo with hi = x rounded to
//      TF32 to nearest (as cvt.rna.tf32.f32, in integer operations) and lo
//      = x - hi truncated to TF32; a b = al bh + ah bl (a correction
//      accumulator) + ah bh (the main one), each float32, al bl dropped
//      (~2^-21 relative); a bf16 v is exact in TF32, so its lo pass is
//      skipped (the helpers: csrc/tf32.cuh).  Warp w owns the row tiles w
//      and 7 - w of 16 rows, so that the triangle's work is even: r' of
//      the tile is split once into registers;
//      out = r' (e^c S), with e^c S split once a chunk into
//      shared memory; then two blocks of 8 keys at a time up to the
//      diagonal, A = r' k'^T masked to s < t and at once A v: A's
//      accumulator fragment is the next product's operand fragment with
//      the keys taken in the order 2q, 2q + 1 (a key order is free in a
//      sum), so A never leaves the registers.  Then the bonus, the two
//      CTAs' parts of r.(u k) added, and 8-byte stores of out.
//   3. S' = e^{cum_last} S + (k' e^c)^T v, S held in the registers of
//      warps 0-3 (rows 16 w .. 16 w + 15, the accumulator layout), keys in
//      the same permuted order.
// Shared-memory rows are padded (r', k' to D + 4 floats, v to DV + 4, e^c S
// to DV + 8) so that the fragment reads hit 32 banks.  Sums run in another
// order than the plain version's: the prefix as a warp scan, each product
// in tensor-core k-steps of 8 into the main and correction accumulators,
// the inter and intra terms into one pair of them, then the bonus, whose
// sum runs over 4 channels a lane and a butterfly over the lanes;
// tests/test_torch_wkv.py holds a twin of this formulation to the
// reference within atol 1e-4, rtol 1e-3.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tf32;

constexpr int kMaxC = 128;
constexpr int kThreads = 128;    // four warps; thread t is chunk row t
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int kD>
struct Tile {
  static constexpr int DV = kD < 32 ? kD : 32;   // value columns a CTA
  static constexpr int LD = kD + 4;              // r', k' row stride
  static constexpr int LV = DV + 4;              // v row stride
  static constexpr int LS = DV + 8;              // e^c S row stride
  static constexpr size_t R = 0;
  static constexpr size_t K = R + size_t(kMaxC) * LD;
  static constexpr size_t V = K + size_t(kMaxC) * LD;
  static constexpr size_t SH = V + size_t(kMaxC) * LV;   // e^c S, split
  static constexpr size_t SL = SH + size_t(kD) * LS;
  static constexpr size_t RU = SL + size_t(kD) * LS;  // [CTA][row] r.(u k)
  static constexpr size_t TOT = RU + 2 * kMaxC;       // [warp][D] totals
  static constexpr size_t EC = TOT + kWarps * kD;     // e^c
  static constexpr size_t EL = EC + kD;               // e^{cum_last}
  static constexpr size_t U = EL + kD;
  static constexpr size_t FLOATS = U + kD;
};

// The two halves of a cluster barrier (kSplit = 2 CTAs), with release /
// acquire of shared memory at cluster scope; nothing for one CTA.
template <int kSplit>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (kSplit == 2)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
template <int kSplit>
__device__ __forceinline__ void cluster_wait() {
  if constexpr (kSplit == 2)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ state0,
           float* __restrict__ out, float* __restrict__ state_out,
           float* __restrict__ states, int h_n,
           int s_n, int c_n, bool vec, long long r_sb, long long r_sh,
           long long r_st, long long k_sb, long long k_sh, long long k_st,
           long long v_sb, long long v_sh, long long v_st, long long w_sb,
           long long w_sh, long long w_st, long long o_sb, long long o_sh,
           long long o_st) {
  using L = Tile<kD>;
  constexpr int DV = L::DV, LD = L::LD, LV = L::LV, LS = L::LS;
  constexpr int NJ = DV / 8;                 // n-tiles of the value columns
  constexpr int KD = kD / 8;                 // k-steps over the channels
  constexpr bool kExact = sizeof(T) == 2;    // bf16 v: exact in TF32
  constexpr int kSplit = kD / DV;            // CTAs of a (b, h): a cluster
  constexpr int kDC = kD / kSplit;           // channels of a CTA's prefix
  constexpr int kLanes = kDC / 4, kRows = 32 / kLanes;     // a row's lanes
  constexpr int kLanesV = DV / 4, kRowsV = 32 / kLanesV;   // of v
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem + L::R;
  float* s_k = smem + L::K;
  float* s_v = smem + L::V;
  uint32_t* s_sh = reinterpret_cast<uint32_t*>(smem + L::SH);
  uint32_t* s_sl = reinterpret_cast<uint32_t*>(smem + L::SL);
  float* s_ru = smem + L::RU;
  float* s_tot = smem + L::TOT;
  float* s_ec = smem + L::EC;
  float* s_el = smem + L::EL;
  float* s_u = smem + L::U;

  const int rank = blockIdx.x % kSplit;      // the cluster rank
  const int h = blockIdx.x / kSplit, j0 = rank * DV, ch0 = rank * kDC;
  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;    // mma groupID, thread in group
  const T* rb = r + b * r_sb + h * r_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh + j0;
  const float* wb = w + b * w_sb + h * w_sh;
  float* ob = out + b * o_sb + h * o_sh + j0;
  const size_t sbase = (size_t(b) * h_n + h) * kD * kD + j0;
  // the other CTA's shared memory: what this CTA's prefix makes is
  // written to both
  float* peer = smem;
  if constexpr (kSplit == 2)
    peer = cg::this_cluster().map_shared_rank(smem, rank ^ 1);
  auto put = [&](size_t off, float x) {
    smem[off] = x;
    if constexpr (kSplit == 2) peer[off] = x;
  };
  auto put4 = [&](size_t off, float4 x) {
    at4(smem + off) = x;
    if constexpr (kSplit == 2) at4(peer + off) = x;
  };

  // S[:, DV] in the registers of warps 0 .. kD / 16 - 1, warp w rows 16 w
  // .. 16 w + 15 in the mma accumulator layout
  const bool s_owner = warp < kD / 16;
  const int i0 = warp * 16;
  float sreg[NJ][4];
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = nj * 8 + 2 * q4 + (e & 1);
      sreg[nj][e] = s_owner && state0 ? state0[sbase + size_t(i) * kD + j]
                                      : 0.f;
    }
  for (int e = t; e < kD; e += kThreads) s_u[e] = u[h * kD + e];
  const int nrt = (c_n + 15) / 16;           // row tiles of 16

  // log w of the warp's 32 rows at this CTA's channels, coalesced (kDC / 4
  // lanes a row), loaded a chunk ahead
  float4 lwp[32 / kRows];
  auto load_lw = [&](long long c0) {
#pragma unroll
    for (int it = 0; it < 32 / kRows; ++it) {
      const int tr = 32 * warp + it * kRows + lane / kLanes;
      lwp[it] = tr < c_n && c0 < s_n
          ? load4(wb + (c0 + tr) * w_st + ch0 + lane % kLanes * 4, vec)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_lw(0);
  // barrier A: a CTA arrives once done reading its chunk, and waits before
  // it writes into the other CTA's shared memory (here: both are running)
  cluster_arrive<kSplit>();

  for (long long c0 = 0; c0 < s_n; c0 += c_n) {
    __syncthreads();             // this CTA is done with the last chunk
    if (states && s_owner) {     // the state entering the chunk
      float* sc = states + ((size_t(b) * h_n + h) * (s_n / c_n) + c0 / c_n)
                  * kD * kD + j0;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = i0 + g + 8 * (e >> 1), j = nj * 8 + 2 * q4;
          *reinterpret_cast<float2*>(sc + size_t(i) * kD + j) =
              make_float2(sreg[nj][e], sreg[nj][e + 1]);
        }
    }
    // 1. log w into r', then thread t's row from there and its inclusive
    // scan over the warp's rows; k' holds the warp's partial cum until the
    // next step
#pragma unroll
    for (int it = 0; it < 32 / kRows; ++it)
      at4(s_r + (32 * warp + it * kRows + lane / kLanes) * LD + ch0 +
          lane % kLanes * 4) = lwp[it];
    __syncwarp();
#pragma unroll
    for (int q = ch0; q < ch0 + kDC; q += 4) {
      float4 x = at4(s_r + t * LD + q);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float4 y = make_float4(__shfl_up_sync(kFull, x.x, off),
                                     __shfl_up_sync(kFull, x.y, off),
                                     __shfl_up_sync(kFull, x.z, off),
                                     __shfl_up_sync(kFull, x.w, off));
        if (lane >= off) x = x + y;
      }
      at4(s_k + t * LD + q) = x;
      if (lane == 31) at4(s_tot + warp * kD + q) = x;
    }
    __syncthreads();
    cluster_wait<kSplit>();      // barrier A: the other CTA read its chunk
    // r', k' and this CTA's part of r . (u k) of the warp's rows, coalesced
    // as log w was: 4 channels a lane; cum is the warp's partial cum plus
    // the earlier warps' totals, added in order (their sum over all warps
    // is cum_last, c = cum_last / 2); the bonus terms summed in order, then
    // over the row's lanes by a butterfly.  r', k', e^c, e^{cum_last} and
    // the bonus part go to both CTAs.  v's DV columns, DV / 4 lanes a row.
#pragma unroll
    for (int it = 0; it < 32 / kRows; ++it) {
      const int tr = 32 * warp + it * kRows + lane / kLanes;
      const int q = ch0 + lane % kLanes * 4;
      float4 off = make_float4(0.f, 0.f, 0.f, 0.f), last = off;
#pragma unroll
      for (int wq = 0; wq < kWarps; ++wq) {
        if (wq == warp) off = last;
        last = last + at4(s_tot + wq * kD + q);
      }
      const float4 c = make_float4(last.x * 0.5f, last.y * 0.5f,
                                   last.z * 0.5f, last.w * 0.5f);
      if (warp == 0 && it == 0) {
        put4(L::EC + q, make_float4(expf(c.x), expf(c.y), expf(c.z),
                                    expf(c.w)));
        put4(L::EL + q, make_float4(expf(last.x), expf(last.y),
                                    expf(last.z), expf(last.w)));
      }
      float4 rp = make_float4(0.f, 0.f, 0.f, 0.f), kp = rp;
      float ru = 0.f;
      if (tr < c_n) {
        const float4 lw = at4(s_r + tr * LD + q);
        const float4 cum = at4(s_k + tr * LD + q) + off;
        const float4 ce = cum - lw, uu = at4(s_u + q);
        const float4 rr = load4(rb + (c0 + tr) * r_st + q, vec);
        const float4 kk = load4(kb + (c0 + tr) * k_st + q, vec);
        rp = make_float4(rr.x * expf(ce.x - c.x), rr.y * expf(ce.y - c.y),
                         rr.z * expf(ce.z - c.z), rr.w * expf(ce.w - c.w));
        kp = make_float4(kk.x * expf(c.x - cum.x), kk.y * expf(c.y - cum.y),
                         kk.z * expf(c.z - cum.z), kk.w * expf(c.w - cum.w));
        ru = rr.x * uu.x * kk.x;
        ru += rr.y * uu.y * kk.y;
        ru += rr.z * uu.z * kk.z;
        ru += rr.w * uu.w * kk.w;
      }
#pragma unroll
      for (int o2 = 1; o2 < kLanes; o2 <<= 1)
        ru += __shfl_xor_sync(kFull, ru, o2);
      if (lane % kLanes == 0) put(L::RU + rank * kMaxC + tr, ru);
      put4(L::R + tr * LD + q, rp);
      put4(L::K + tr * LD + q, kp);
    }
#pragma unroll
    for (int it = 0; it < 32 / kRowsV; ++it) {
      const int tr = 32 * warp + it * kRowsV + lane / kLanesV;
      const int q = lane % kLanesV * 4;
      at4(s_v + tr * LV + q) = tr < c_n
          ? load4(vb + (c0 + tr) * v_st + q, vec)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cluster_arrive<kSplit>();    // barrier B: this CTA's writes are done
    load_lw(c0 + c_n);
    if (c0 + c_n < s_n && t < c_n) {   // the next chunk's r, k, v rows,
      const long long nx = c0 + c_n + t;  // into L2
      prefetch_l2(rb + nx * r_st + ch0);
      prefetch_l2(kb + nx * k_st + ch0);
      prefetch_l2(vb + nx * v_st);
    }
    cluster_wait<kSplit>();      // barrier B: both CTAs' r', k', ... are in
    if constexpr (kSplit == 1) __syncthreads();
    // e^c S, split, for the inter-chunk term's operand
    if (s_owner) {
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1), j = nj * 8 + 2 * q4 + (e & 1);
          split(s_ec[i] * sreg[nj][e], s_sh[i * LS + j], s_sl[i * LS + j]);
        }
    }
    __syncthreads();
    // 2. out of the warp's row tiles
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int mt = pass ? 7 - warp : warp;
      if (mt >= nrt) continue;
      const int t0 = mt * 16;
      float o[NJ][4], oc[NJ][4];           // main and correction terms
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        zero(o[nj]);
        zero(oc[nj]);
      }
      // r' of the tile, split once for the inter-chunk term and every key
      // block
      uint32_t rh[KD][4], rl[KD][4];
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        const int i = ks * 8 + q4;
        split(s_r[(t0 + g) * LD + i], rh[ks][0], rl[ks][0]);
        split(s_r[(t0 + g + 8) * LD + i], rh[ks][1], rl[ks][1]);
        split(s_r[(t0 + g) * LD + i + 4], rh[ks][2], rl[ks][2]);
        split(s_r[(t0 + g + 8) * LD + i + 4], rh[ks][3], rl[ks][3]);
      }
      // inter: r' (e^c S) over the channels
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        const int b0 = (ks * 8 + q4) * LS + g, b1 = b0 + 4 * LS;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
          mma3s(o[nj], oc[nj], rh[ks], rl[ks], s_sh[b0 + nj * 8],
                s_sh[b1 + nj * 8], s_sl[b0 + nj * 8], s_sl[b1 + nj * 8]);
      }
      // intra: two blocks of 8 keys at a time up to the diagonal, A = r'
      // k'^T masked to s < t, then A v with A's fragment as the operand
      // (keys 2q, 2q + 1)
#pragma unroll 2
      for (int s0 = 0; s0 <= t0; s0 += 16) {
        float a[2][4], ac[2][4];
        zero(a[0]);
        zero(a[1]);
        zero(ac[0]);
        zero(ac[1]);
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
          const int i = ks * 8 + q4;
#pragma unroll
          for (int blk = 0; blk < 2; ++blk) {
            const float* kr = s_k + (s0 + 8 * blk + g) * LD + i;
            mma3<false, false>(a[blk], ac[blk], rh[ks], rl[ks], kr[0],
                               kr[4]);
          }
        }
#pragma unroll
        for (int blk = 0; blk < 2; ++blk) {
          const int s = s0 + 8 * blk + 2 * q4;   // the keys of a[0], a[1]
          const int ta = t0 + g, tb = t0 + g + 8;
          const float x0 = s < ta ? a[blk][0] + ac[blk][0] : 0.f;
          const float x1 = s + 1 < ta ? a[blk][1] + ac[blk][1] : 0.f;
          const float x2 = s < tb ? a[blk][2] + ac[blk][2] : 0.f;
          const float x3 = s + 1 < tb ? a[blk][3] + ac[blk][3] : 0.f;
          uint32_t ah[4], al[4];
          split(x0, ah[0], al[0]);
          split(x2, ah[1], al[1]);
          split(x1, ah[2], al[2]);
          split(x3, ah[3], al[3]);
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj)
            mma3<false, kExact>(o[nj], oc[nj], ah, al,
                                s_v[s * LV + nj * 8 + g],
                                s_v[(s + 1) * LV + nj * 8 + g]);
        }
      }
      // the bonus, then rows t0 + g and t0 + g + 8 of out
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tr = t0 + g + 8 * half;
        if (tr >= c_n) continue;
        const float ru =
            kSplit == 2 ? s_ru[tr] + s_ru[kMaxC + tr] : s_ru[tr];
        float* orow = ob + (c0 + tr) * o_st;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const int j = nj * 8 + 2 * q4, e = 2 * half;
          const float y0 = (o[nj][e] + oc[nj][e]) + ru * s_v[tr * LV + j];
          const float y1 =
              (o[nj][e + 1] + oc[nj][e + 1]) + ru * s_v[tr * LV + j + 1];
          *reinterpret_cast<float2*>(orow + j) = make_float2(y0, y1);
        }
      }
    }
    // 3. S' = e^{cum_last} S + (k' e^c)^T v, in the owners' registers
    if (s_owner) {
      const float ea = s_ec[i0 + g], eb = s_ec[i0 + g + 8];
      float d[NJ][4], dc[NJ][4];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        zero(d[nj]);
        zero(dc[nj]);
      }
#pragma unroll 2
      for (int s0 = 0; s0 < nrt * 16; s0 += 8) {
        const int s = s0 + 2 * q4;
        uint32_t ah[4], al[4];
        split(s_k[s * LD + i0 + g] * ea, ah[0], al[0]);
        split(s_k[s * LD + i0 + g + 8] * eb, ah[1], al[1]);
        split(s_k[(s + 1) * LD + i0 + g] * ea, ah[2], al[2]);
        split(s_k[(s + 1) * LD + i0 + g + 8] * eb, ah[3], al[3]);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
          mma3<false, kExact>(d[nj], dc[nj], ah, al,
                              s_v[s * LV + nj * 8 + g],
                              s_v[(s + 1) * LV + nj * 8 + g]);
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sreg[nj][e] = s_el[i0 + g + 8 * (e >> 1)] * sreg[nj][e] +
                        (d[nj][e] + dc[nj][e]);
    }
    cluster_arrive<kSplit>();    // barrier A: this CTA read its chunk
  }
  cluster_wait<kSplit>();
  if (s_owner) {
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = nj * 8 + 2 * q4 + (e & 1);
        state_out[sbase + size_t(i) * kD + j] = sreg[nj][e];
      }
  }
}

template <typename T, int kD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* state0,
                   void* out, void* state, void* states, int b, int h,
                   int s, int c, bool vec, const long long* st,
                   cudaStream_t stream) {
  const size_t bytes = Tile<kD>::FLOATS * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  // CTA (h * kSplit + rank, b); the kSplit CTAs of a (b, h) are a cluster
  constexpr int kSplit = kD / Tile<kD>::DV;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(h * kSplit, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, wkv_kernel<T, kD>, static_cast<const T*>(r),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(state0), static_cast<float*>(out),
      static_cast<float*>(state), static_cast<float*>(states), h, s, c, vec,
      st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14]);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* state0,
                     void* out, void* state, void* states, int b, int h,
                     int s, int d, int c, bool vec, const long long* st,
                     cudaStream_t stream) {
  if (d == 16)
    return launch<T, 16>(r, k, v, w, u, state0, out, state, states, b, h, s,
                         c, vec, st, stream);
  if (d == 32)
    return launch<T, 32>(r, k, v, w, u, state0, out, state, states, b, h, s,
                         c, vec, st, stream);
  return launch<T, 64>(r, k, v, w, u, state0, out, state, states, b, h, s, c,
                       vec, st, stream);
}

}  // namespace

extern "C" {

// One launch on `stream`; returns the cudaError_t of the launch (0 on
// success).  dtype 0 = float32, 1 = bf16 (r, k, v).  r, k, v, log w and out
// are [b, h, s, d] with element strides (batch, head, step) given in that
// order for r, k, v, w, out and a contiguous last axis; u is [h, d];
// state0 (null for zeros) and state are contiguous [b, h, d, d]; states
// (null: not written) a contiguous [b, h, s / c, d, d], the state entering
// each chunk.  vec: every
// pointer of r, k, v and log w 16-byte aligned and each of their strides a
// multiple of 8 elements (vector loads).  Requires d in {16, 32, 64},
// 1 <= c <= 128 and s % c == 0.
int wkv_launch(int dtype, const void* r, const void* k, const void* v,
               const void* w, const void* u, const void* state0, void* out,
               void* state, void* states, int b, int h, int s, int d, int c,
               int vec,
               long long r_sb, long long r_sh, long long r_st,
               long long k_sb, long long k_sh, long long k_st,
               long long v_sb, long long v_sh, long long v_st,
               long long w_sb, long long w_sh, long long w_st,
               long long o_sb, long long o_sh, long long o_st,
               void* stream) {
  if ((d != 16 && d != 32 && d != 64) || c < 1 || c > kMaxC || s % c)
    return cudaErrorInvalidValue;
  const long long st[15] = {r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh,
                            v_st, w_sb, w_sh, w_st, o_sb, o_sh, o_st};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? dispatch<float>(r, k, v, w, u, state0, out, state, states,
                                   b, h, s, d, c, vec != 0, st, cs)
                 : dispatch<__nv_bfloat16>(r, k, v, w, u, state0, out, state,
                                           states, b, h, s, d, c, vec != 0,
                                           st, cs);
  return static_cast<int>(e);
}

}  // extern "C"
