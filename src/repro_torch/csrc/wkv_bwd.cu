// The backward of the chunked RWKV6 WKV (csrc/wkv.cu) for Hopper (sm_90a),
// its chunk products on the tensor cores.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the chunk scan repro/models/rwkv.py:131 (wkv_chunked).  It computes what
// repro_torch/kernels/ref.py::wkv_chunked_bwd_ref computes.  Per chunk,
// with S the float32 [D, D] state entering it (the forward's saved
// states), G the gradient of the state it writes (the final state's
// gradient, or 0, for the last chunk), cum the inclusive cumsum of log w,
// ce = cum - log w, L = cum_last, the forward's centring c = L / 2, r' = r
// e^{ce - c}, k' = k e^{c - cum}, A = r' k'^T strictly below the diagonal
// and the bonus ru = r . (u k):
//   dA  = dO v^T strictly below,  dru = rowsum(dO * v),
//   dv  = A^T dO + ru dO + k' (e^c G),
//   dr  = e^{ce - c} (dA k' + dO (e^c S)^T) + dru u k,
//   dk  = e^{c - cum} (dA^T r' + v (e^c G)^T) + dru u r,
//   du += sum_t dru r k,
//   dlog w[t] = sum_{t' > t} gce[t'] + sum_{t' >= t} gcum[t'] + gL, with
//         gce = r' (dA k' + dO (e^c S)^T), gcum = -k' (dA^T r' + v (e^c
//         G)^T) and gL = sum_j e^L S G + sum_s k' (v (e^c G)^T), the same
//         for every step of the chunk,
//   G  <- e^L G + e^c (r'^T dO), the gradient of the state entering it.
// The exponentials are the forward's, centred, so nothing overflows where
// the forward does not.  D in {16, 32, 64}, C from 1 to 128; r, k, v (and
// dr, dk, dv) float32 or bf16, log w, dO, u, the states and dlog w, du,
// dstate0 float32.
//
// Two facts split the work.  Only G crosses chunks, and G's update is
// elementwise given each chunk's own term: G <- e^L G + P with P = e^c
// (r'^T dO), which needs only the chunk's inputs.  And gL = sum_j G[i, j]
// S'[i, j], where S' = e^L S + (k' e^c)^T v is the state the chunk writes:
// the forward's saved state of the next chunk, or for the last chunk the
// forward's final state (read only when it has a gradient).  So each
// chunk's gradients need only its own inputs, S and G.  Four device
// kernels a call, no atomics, every sum in a fixed order:
//   1. wkv_bwd_pstate: every chunk's P at once, a CTA of eight warps per
//      (b, h, chunk), two an SM: warp w copies rows 16 w .. 16 w + 15 of
//      log w, r and dO in (cp.async for float32 rows), scans its tile by
//      channel (16 rows in order, then the earlier tiles' totals in order:
//      the prefix pass 3 takes too), and one 16-row block of P; P goes to a
//      float32 scratch [B, H, S/C, D, D] that the scan then fills with G.
//   2. wkv_bwd_dstate: the scan, a warp per row of G (lanes over the
//      columns), the chunks in reverse, four chunks' loads issued before
//      their updates: gL (a butterfly over the lanes), G over P, G <- e^L
//      G + P.  The last G is dstate0.
//   3. wkv_bwd_chunk: every chunk's gradients at once, a persistent CTA of
//      16 warps an SM walking (b, h, chunk) items.  Phase 0: warps 8-15
//      copy the v, dO, r and k rows of tile w - 8 and e^c G, e^c S in, and
//      sum dru and r.(u k) by row; warps 0-7 scan tile w's log w, then
//      write r', k', e^{ce - c}, e^{c - cum} and du's part of the tile.
//      Then three passes with no barrier between them, warps w and w + 8
//      on the same 16-row tile, each half of the output columns: dv over
//      the keys t > s (A^T = k' r'^T, then A^T dO, after k' (e^c G)), dk
//      the same way (dA^T = v dO^T, then dA^T r', after v (e^c G)^T), dr
//      over the keys s < t (dA = dO v^T, then dA k', after dO (e^c S)^T).
//      Warp w takes tiles w % 8, (w + 4) % 8 and (0, 2, 4, 6, 1, 3, 5,
//      7)[w % 8] for the three, so that every warp does 13 or 14 of the
//      108 blocks of 16 x 16 keys (46 at most with one tile for all
//      three).  A, dA^T and dA go from the accumulator to the next
//      product's operand fragment in registers, with the keys taken in the
//      order 2q, 2q + 1 (a key order is free in a sum), as csrc/wkv.cu
//      does with A.  The dk and dr passes write gcum and gce over e^{c -
//      cum} and e^{ce - c}, which only the tile's own warps read.  Then
//      dlog w: the reverse scan of gcum[t] + gce[t + 1] in 512 / D
//      segments a channel, the later segments' totals added from the last
//      one down, plus gL; du's part of the chunk, the tiles' parts in
//      order, to a [B, H, S/C, D] scratch.
//   4. wkv_du_sum: du [H, D], over the batch and then the chunks in order.
// Every product runs on mma.sync m16n8k8 TF32 at float32 accuracy by the
// 3xTF32 split of csrc/tf32.cuh; a bf16 v is exact in TF32, so its
// correction pass is skipped.
//
// Shared memory of kernel 3 at D = 64: six [128, 64] float32 arrays (r',
// k', v, dO, r then e^{ce - c} then gce, k then e^{c - cum} then gcum), e^c
// G and e^c S [64, 64] and three small ones, 232,448 bytes, all a CTA may
// have: one CTA an SM.  Two would need 113 KB each: the six arrays alone
// are 192 KB, and each is read by every warp (the operands) or holds a
// tile's values until the end.  So the CTA has 16 warps (128 registers a
// thread) to hide its latency; each pass's block of keys is computed by
// both warps of a tile (a third more tensor-core products than one warp a
// tile, measured faster on the card).  The arrays are not padded but
// swizzled (a row's 16-byte groups permuted by its low bits) so that the
// fragment reads of both orientations hit 32 banks at D >= 32.
//
// Bound.  At rwkv6-3b's training call (B = 8, H = 48, S = 1,024, D = 64, C =
// 128, bf16 r/k/v) the chunk products are about 2.25 times the forward's
// 12.83 GFLOP (chip_smoke.py counts them); three TF32 passes of them at 495
// TFLOP/s take about 0.175 ms.  The function's bytes bound it: about 661 MB
// (r, k, v, log w, dO, u and the saved states read once; dr, dk, dv, dlog
// w, du and dstate0 written once), 0.197 ms at 3.35 TB/s.  This design
// moves about 1.17 GB: P and G through the scratch, the saved states read
// by kernels 2 and 3, and r, log w and dO read by kernels 1 and 3.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using namespace tf32;

constexpr int kMaxC = 128;
constexpr int kTiles = kMaxC / 16;     // row tiles of 16 (prefix segments)
constexpr unsigned kFull = 0xffffffffu;

struct Strides {       // element strides (batch, head, step) of a tensor
  long long b, h, t;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Asynchronous 16- and 4-byte copies from global to shared memory, and
// the wait for this thread's copies.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Four consecutive bf16 elements as they are (8 bytes), and widened.
__device__ __forceinline__ uint2 load4raw(const __nv_bfloat16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint2*>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  return make_uint2(h[0] | unsigned(h[1]) << 16, h[2] | unsigned(h[3]) << 16);
}
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Rows t0 .. t0 + 15 of a [.., kD] tensor (row stride st) into shared
// memory at offset idx(t, col), 4 columns a lane, zeros past c_n: float32
// rows by cp.async (16 bytes at a time when vec, else 4), bf16 rows by
// loads that are all issued before the first store.  Float32 rows are in
// once this thread has waited for its copies (cp_async_wait_all).
template <int kD, typename T, typename F>
__device__ __forceinline__ void tile_rows(float* s, F idx, const T* src,
                                          long long st, int t0, int c_n,
                                          int lane, bool vec) {
  constexpr int kQ = kD / 4, kRowsI = 32 / kQ, kIt = 16 / kRowsI;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int t = t0 + it * kRowsI + lane / kQ, col = 4 * (lane % kQ);
      float* d = s + idx(t, col);
      const float* p = reinterpret_cast<const float*>(src) + t * st + col;
      if (t >= c_n) {
        at4(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (vec) {
        cp_async16(d, p);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(d + e, p + e);
      }
    }
  } else {
    uint2 raw[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int t = t0 + it * kRowsI + lane / kQ, col = 4 * (lane % kQ);
      raw[it] = t < c_n ? load4raw(src + t * st + col, vec)
                        : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int t = t0 + it * kRowsI + lane / kQ, col = 4 * (lane % kQ);
      at4(s + idx(t, col)) = widen(raw[it]);
    }
  }
}

constexpr int kThreads = 256;      // kernels 1 and 2 (a block of 2)
constexpr int kWarps = kThreads / 32;
constexpr int kCThreads = 512;     // the chunk kernel's CTA

// ------------------------------------------------------------- 1, 2. G
// 1. Every chunk's own term of G's update, all chunks at once: P = e^c
// (r'^T dO) [D, D], into the scratch that the scan then fills with G, and
// e^L.  Warp w copies in and scans the rows of tile w, then takes a 16-row
// block of P (rows 16 (w % (D / 16)) ..) and its share of the columns.
template <int kD>
struct PsSmem {
  static constexpr int LA = kD + 8;  // r' and dO rows: reads of (row q,
  static constexpr size_t A = 0;     // column g) hit 32 banks; log w first
  static constexpr size_t A0 = A + size_t(kMaxC) * LA;     // r
  static constexpr size_t B = A0 + size_t(kMaxC) * LA;
  static constexpr size_t PART = B + size_t(kMaxC) * LA;   // [8][kD]
  static constexpr size_t EC = PART + kWarps * kD;         // e^c
  static constexpr size_t EL = EC + kD;                    // e^L
  static constexpr size_t FLOATS = EL + kD;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 2)
wkv_bwd_pstate(const T* __restrict__ r, const float* __restrict__ w,
               const float* __restrict__ dout, float* __restrict__ ps,
               float* __restrict__ el, int h_n, int s_n, int c_n, bool vec,
               Strides sr, Strides sw, Strides so) {
  using L = PsSmem<kD>;
  constexpr int LA = L::LA;
  constexpr int NCH = kD >= 32 ? kD / 32 : 1;   // channels a lane
  constexpr int MT = kD / 16;                   // 16-row blocks of P
  constexpr int NTW = kD / 8 * MT / kWarps > 0 ? kD / 8 * MT / kWarps : 1;
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem + L::A;
  float* s_a0 = smem + L::A0;
  float* s_b = smem + L::B;
  float* s_part = smem + L::PART;
  float* s_ec = smem + L::EC;
  float* s_el = smem + L::EL;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;       // mma groupID, thread in group
  const int nc = s_n / c_n, item = blockIdx.x;
  const int ci = item % nc, h = (item / nc) % h_n, b = item / nc / h_n;
  const long long c0 = (long long)ci * c_n;
  const int t0w = 16 * warp;                   // the tile this warp loads
  const int m0 = 16 * (warp % MT), n0 = warp / MT * NTW * 8;  // its P block

  // the tile's rows, 4 columns a lane: log w, r, dO
  auto idx = [](int t, int col) { return t * LA + col; };
  tile_rows<kD>(s_a, idx, w + b * sw.b + h * sw.h + c0 * sw.t, sw.t, t0w,
                c_n, lane, vec);
  tile_rows<kD>(s_a0, idx, r + b * sr.b + h * sr.h + c0 * sr.t, sr.t, t0w,
                c_n, lane, vec);
  tile_rows<kD>(s_b, idx, dout + b * so.b + h * so.h + c0 * so.t, so.t, t0w,
                c_n, lane, vec);
  cp_async_wait_all();
  __syncwarp();
  // its prefix by channel (lane, lane + 32) in order; the total
#pragma unroll
  for (int hh = 0; hh < NCH; ++hh) {
    const int i = lane + 32 * hh;
    if (i >= kD) continue;
    float x = 0.f;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) x += s_a[(t0w + rr) * LA + i];
    s_part[warp * kD + i] = x;
  }
  __syncthreads();                 // every tile's total is in
#pragma unroll
  for (int hh = 0; hh < NCH; ++hh) {
    const int i = lane + 32 * hh;
    if (i >= kD) continue;
    float off = 0.f, last = 0.f;
#pragma unroll
    for (int wq = 0; wq < kTiles; ++wq) {
      if (wq == warp) off = last;
      last += s_part[wq * kD + i];
    }
    const float c = last * 0.5f;
    if (warp == 0) {
      s_ec[i] = expf(c);
      s_el[i] = expf(last);
    }
    float x = 0.f;                 // the prefix again; r' over log w
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int e = (t0w + rr) * LA + i;
      const float lw = s_a[e];
      x += lw;
      s_a[e] = s_a0[e] * expf((x + off - lw) - c);
    }
  }
  __syncthreads();
  if (n0 < kD) {
    float p[NTW][4], pc[NTW][4];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      zero(p[nt]);
      zero(pc[nt]);
    }
    const int ksn = (c_n + 7) / 8;
#pragma unroll 2
    for (int ks = 0; ks < ksn; ++ks) {
      const float* a0 = s_a + (ks * 8 + q) * LA + m0 + g;
      uint32_t ah[4], al[4];
      split(a0[0], ah[0], al[0]);
      split(a0[8], ah[1], al[1]);
      split(a0[4 * LA], ah[2], al[2]);
      split(a0[4 * LA + 8], ah[3], al[3]);
      const float* b0 = s_b + (ks * 8 + q) * LA + n0 + g;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        mma3<false, false>(p[nt], pc[nt], ah, al, b0[nt * 8],
                           b0[4 * LA + nt * 8]);
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = m0 + g + 4 * e, j = n0 + nt * 8 + 2 * q;
        const float ec = s_ec[i];
        *reinterpret_cast<float2*>(ps + size_t(item) * kD * kD + i * kD +
                                   j) =
            make_float2(ec * (p[nt][e] + pc[nt][e]),
                        ec * (p[nt][e + 1] + pc[nt][e + 1]));
      }
  }
  if (tid < kD) el[size_t(item) * kD + tid] = s_el[tid];
}

// 2. The scan over the chunks in reverse, a row of G a warp (lanes over
// the columns, from the final state's gradient or 0): gL = sum_j G S', S'
// the state the chunk writes (the next chunk's saved state, or for the
// last chunk the forward's final state), a butterfly over the lanes; G
// over P in the scratch; G <- e^L G + P.  The last G is dstate0.
template <int kD>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_dstate(const float* __restrict__ states,
               const float* __restrict__ dstate,
               const float* __restrict__ fin, const float* __restrict__ el,
               float* __restrict__ gs, float* __restrict__ gl,
               float* __restrict__ dstate0, int rows, int nc) {
  constexpr int NCH = kD >= 32 ? kD / 32 : 1;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (b, h, i)
  if (row >= rows) return;
  const size_t bh = row / kD;
  const int i = row % kD;
  float g[NCH];
#pragma unroll
  for (int hh = 0; hh < NCH; ++hh) {
    const int j = lane + 32 * hh;
    g[hh] = dstate && j < kD ? dstate[size_t(row) * kD + j] : 0.f;
  }
  constexpr int kAhead = 4;            // chunks whose loads go first
  for (int c1 = nc - 1; c1 >= 0; c1 -= kAhead) {
    float p[kAhead][NCH], sn[kAhead][NCH], e[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int ci = c1 - a;
      const size_t base = ((bh * nc + ci) * kD + i) * kD;
      const float* sp = ci + 1 < nc ? states + base + kD * kD
                        : fin       ? fin + size_t(row) * kD
                                    : nullptr;
      e[a] = ci >= 0 ? el[(bh * nc + ci) * kD + i] : 0.f;
#pragma unroll
      for (int hh = 0; hh < NCH; ++hh) {
        const int j = lane + 32 * hh;
        const bool in = ci >= 0 && j < kD;
        p[a][hh] = in ? gs[base + j] : 0.f;
        sn[a][hh] = in && sp ? sp[j] : 0.f;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int ci = c1 - a;
      if (ci < 0) break;
      const size_t base = ((bh * nc + ci) * kD + i) * kD;
      float x = 0.f;
#pragma unroll
      for (int hh = 0; hh < NCH; ++hh) {
        const int j = lane + 32 * hh;
        if (j >= kD) continue;
        x += g[hh] * sn[a][hh];
        gs[base + j] = g[hh];
        g[hh] = e[a] * g[hh] + p[a][hh];
      }
#pragma unroll
      for (int o2 = 16; o2 >= 1; o2 >>= 1)
        x += __shfl_xor_sync(kFull, x, o2);
      if (lane == 0) gl[(bh * nc + ci) * kD + i] = x;
    }
  }
#pragma unroll
  for (int hh = 0; hh < NCH; ++hh) {
    const int j = lane + 32 * hh;
    if (j < kD) dstate0[size_t(row) * kD + j] = g[hh];
  }
}

// ------------------------------------------------------------- 3. chunks
// Element (row, col) of a [rows, kD] array: the row's 16-byte groups
// permuted by its low bits.  At D >= 32, A-operand reads (row g, column q)
// and key-permuted B reads (row 2q + 1, column g) hit 32 banks; at D = 16
// some are 2-way.
template <int kD>
__device__ __forceinline__ int at(int row, int col) {
  const int s = kD >= 32 ? (row & 7) << 2 : ((row >> 1) & 3) << 2;
  return row * kD + (col ^ s);
}
// The same for the [kD, kD] arrays, read as (row q, column g) and as (row g,
// column q).
template <int kD>
__device__ __forceinline__ int atm(int row, int col) {
  const int s = kD >= 32 ? ((row & 3) << 3) ^ (((row >> 2) & 1) << 2)
                         : ((row >> 1) & 3) << 2;
  return row * kD + (col ^ s);
}

template <int kD>
struct Smem {
  static constexpr size_t N = size_t(kMaxC) * kD;
  static constexpr size_t R = 0;            // r'
  static constexpr size_t K = R + N;        // k'
  static constexpr size_t V = K + N;        // v
  static constexpr size_t O = V + N;        // dO
  static constexpr size_t ER = O + N;       // r, then e^{ce - c}, then gce
  static constexpr size_t EK = ER + N;      // k, then e^{c - cum}, then gcum
  static constexpr size_t MG = EK + N;      // e^c G
  static constexpr size_t MS = MG + size_t(kD) * kD;    // e^c S
  static constexpr size_t PART = MS + size_t(kD) * kD;  // [8][kD]
  static constexpr size_t DRU = PART + kTiles * kD;     // rowsum(dO v)
  static constexpr size_t RU = DRU + kMaxC;             // r . (u k)
  static constexpr size_t FLOATS = RU + kMaxC;
};

// An accumulator block (rows m and m + 8, keys key and key + 1 in its
// columns; main and correction sums) as the next product's A operand with
// the keys in the order 2q, 2q + 1, masked to key > row (kAbove) or key <
// row, split.
template <bool kAbove>
__device__ __forceinline__ void as_operand(const float (&a)[4],
                                           const float (&ac)[4], int key,
                                           int m, uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
  auto keep = [](int kk, int rr) { return kAbove ? kk > rr : kk < rr; };
  auto x = [&](int e) { return a[e] + ac[e]; };
  split(keep(key, m) ? x(0) : 0.f, ah[0], al[0]);
  split(keep(key, m + 8) ? x(2) : 0.f, ah[1], al[1]);
  split(keep(key + 1, m) ? x(1) : 0.f, ah[2], al[2]);
  split(keep(key + 1, m + 8) ? x(3) : 0.f, ah[3], al[3]);
}

// The A-operand fragment of rows m .. m + 15 of a [128, kD] array at
// k-step ks: split, or as it is when exact in TF32.
template <int kD, bool kExact>
__device__ __forceinline__ void operand(const float* s, int m, int ks, int g,
                                        int q, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float x[4] = {s[at<kD>(m + g, ks * 8 + q)],
                      s[at<kD>(m + g + 8, ks * 8 + q)],
                      s[at<kD>(m + g, ks * 8 + q + 4)],
                      s[at<kD>(m + g + 8, ks * 8 + q + 4)]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kExact) {
      hi[e] = __float_as_uint(x[e]);
      lo[e] = 0u;
    } else {
      split(x[e], hi[e], lo[e]);
    }
  }
}

// One pass of the chunk kernel for rows m .. m + 15 of `a` and the NTH
// n-tiles from nt0 of the output, into d (main) + dc (correction): first
// the square term, a times the [kD, kD] array `sq` (read at (k, n) when
// kSqRowK, else at (n, k)), then the keys from k_lo to k_hi in blocks of
// 16: the block a `blk`^T over the kD channels, masked to the keys after
// the row (kAbove) or before it, as the operand of the product with the
// key rows of `out`.
template <int kD, int NTH, bool kExactA, bool kExactBlk, bool kSqRowK,
          bool kAbove>
__device__ __forceinline__ void tile_pass(const float* a, const float* sq,
                                          const float* blk, const float* out,
                                          int m, int nt0, int k_lo, int k_hi,
                                          int g, int q, float (&d)[NTH][4],
                                          float (&dc)[NTH][4]) {
  constexpr int KD = kD / 8;
#pragma unroll
  for (int nt = 0; nt < NTH; ++nt) {
    zero(d[nt]);
    zero(dc[nt]);
  }
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
    uint32_t ah[4], al[4];
    operand<kD, kExactA>(a, m, ks, g, q, ah, al);
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      const int n = (nt0 + nt) * 8 + g, k0 = ks * 8 + q;
      mma3<kExactA, false>(
          d[nt], dc[nt], ah, al,
          kSqRowK ? sq[atm<kD>(k0, n)] : sq[atm<kD>(n, k0)],
          kSqRowK ? sq[atm<kD>(k0 + 4, n)] : sq[atm<kD>(n, k0 + 4)]);
    }
  }
#pragma unroll 1
  for (int kb = k_lo; kb < k_hi; kb += 16) {
    float x[2][4], xc[2][4];
#pragma unroll
    for (int b2 = 0; b2 < 2; ++b2) {
      zero(x[b2]);
      zero(xc[b2]);
    }
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t ah[4], al[4];
      operand<kD, kExactA>(a, m, ks, g, q, ah, al);
#pragma unroll
      for (int b2 = 0; b2 < 2; ++b2) {
        const int kr = kb + 8 * b2 + g;
        mma3<kExactA, kExactBlk>(x[b2], xc[b2], ah, al,
                                 blk[at<kD>(kr, ks * 8 + q)],
                                 blk[at<kD>(kr, ks * 8 + q + 4)]);
      }
    }
#pragma unroll
    for (int b2 = 0; b2 < 2; ++b2) {
      const int key = kb + 8 * b2 + 2 * q;
      uint32_t ah[4], al[4];
      as_operand<kAbove>(x[b2], xc[b2], key, m + g, ah, al);
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
        const int n = (nt0 + nt) * 8 + g;
        mma3<false, false>(d[nt], dc[nt], ah, al, out[at<kD>(key, n)],
                           out[at<kD>(key + 1, n)]);
      }
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kCThreads, 1)
wkv_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ states,
              const float* __restrict__ dout, const float* __restrict__ gs,
              const float* __restrict__ gl, T* __restrict__ dr,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ dw, float* __restrict__ du_part,
              int b_n, int h_n, int s_n, int c_n, bool vec, Strides sr,
              Strides sk, Strides sv, Strides sw, Strides so, Strides sdr,
              Strides sdk, Strides sdv, Strides sdw) {
  using L = Smem<kD>;
  constexpr int NTH = kD / 8 * kTiles * 32 / kCThreads;  // n-tiles a warp
  constexpr bool kExact = sizeof(T) == 2;   // bf16 v: exact in TF32
  constexpr int NCH = kD >= 32 ? kD / 32 : 1;   // channels a lane
  constexpr int kQ = kD / 4;                // float4 lanes of a row
  constexpr int kRowsI = 32 / kQ;           // rows a warp's float4 pass
  constexpr int kIt = 16 / kRowsI;
  constexpr int kMRows = kD / kTiles;       // rows of e^c G a warp copies
  constexpr int kMIt = (kMRows * kQ + 31) / 32;
  constexpr int kSeg = kCThreads / kD;      // dlog w's scan segments
  constexpr int kSegRows = kMaxC / kSeg;
  static_assert(kSeg <= 2 * kD, "segment totals fit e^c G and e^c S");
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem + L::R;
  float* s_k = smem + L::K;
  float* s_v = smem + L::V;
  float* s_o = smem + L::O;
  float* s_er = smem + L::ER;
  float* s_ek = smem + L::EK;
  float* s_mg = smem + L::MG;
  float* s_ms = smem + L::MS;
  float* s_part = smem + L::PART;
  float* s_dru = smem + L::DRU;
  float* s_ru = smem + L::RU;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;     // mma groupID, thread in group
  const int nc = s_n / c_n, n_items = b_n * h_n * nc;
  const int nrt = (c_n + 15) / 16;           // row tiles of the chunk
  // warps 0-7 scan tile `tl`'s log w; warps 8-15 load its other rows; in
  // the passes both take tile tl's rows, each half of the columns
  const bool scan_warp = warp < kTiles || kCThreads == 32 * kTiles;
  const bool row_warp = warp >= kTiles || kCThreads == 32 * kTiles;
  const int tl = warp % kTiles, t0 = 16 * tl, nt0 = warp / kTiles * NTH;
  // the three passes' tiles: dv, dk, dr
  const int x1 = tl, x2 = (tl + 4) % kTiles;
  const int x3 = tl < 4 ? 2 * tl : 2 * tl - 7;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int ci = item % nc, h = (item / nc) % h_n, b = item / nc / h_n;
    const long long c0 = (long long)ci * c_n;
    const T* rb = r + b * sr.b + h * sr.h + c0 * sr.t;
    const T* kb = k + b * sk.b + h * sk.h + c0 * sk.t;
    const T* vb = v + b * sv.b + h * sv.h + c0 * sv.t;
    const float* wb = w + b * sw.b + h * sw.h + c0 * sw.t;
    const float* ob = dout + b * so.b + h * so.h + c0 * so.t;
    const float* uh = u + h * kD;
    __syncthreads();                // the last item is done with smem

    // ---- phase 0.  Warps 8-15: e^c G and e^c S rows copied in (scaled
    // once e^c is known), the tile's v, dO, r and k rows 4 columns a lane
    // (r and k in e^{...}'s places until they are read), dru and r.(u k).
    // Warps 0-7: the tile's log w by channel (lane, lane + 32), its prefix
    // in order, the total for the other tiles.
    float lwv[NCH][16];
    if (row_warp) {
#pragma unroll
      for (int it = 0; it < kMIt; ++it) {
        const int e = it * 32 + lane;
        if (e >= kMRows * kQ) continue;
        const int row = tl * kMRows + e / kQ, col = 4 * (e % kQ);
        cp_async16(s_mg + atm<kD>(row, col),
                   gs + (size_t(item) * kD + row) * kD + col);
        cp_async16(s_ms + atm<kD>(row, col),
                   states + (size_t(item) * kD + row) * kD + col);
      }
      auto idx = [](int t, int col) { return at<kD>(t, col); };
      tile_rows<kD>(s_o, idx, ob, so.t, t0, c_n, lane, vec);
      tile_rows<kD>(s_v, idx, vb, sv.t, t0, c_n, lane, vec);
      tile_rows<kD>(s_er, idx, rb, sr.t, t0, c_n, lane, vec);
      tile_rows<kD>(s_ek, idx, kb, sk.t, t0, c_n, lane, vec);
      cp_async_wait_all();
      __syncwarp();
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int t = t0 + it * kRowsI + lane / kQ, col = 4 * (lane % kQ);
        const int a = at<kD>(t, col);
        const float4 y = at4(s_v + a), o = at4(s_o + a);
        const float4 rr = at4(s_er + a), kk = at4(s_ek + a);
        float x = o.x * y.x;      // dru and r.(u k) of the row: 4 columns,
        x += o.y * y.y;           // then a butterfly over the row's lanes
        x += o.z * y.z;
        x += o.w * y.w;
        float x2 = (rr.x * uh[col]) * kk.x;
        x2 += (rr.y * uh[col + 1]) * kk.y;
        x2 += (rr.z * uh[col + 2]) * kk.z;
        x2 += (rr.w * uh[col + 3]) * kk.w;
#pragma unroll
        for (int o2 = 1; o2 < kQ; o2 <<= 1) {
          x += __shfl_xor_sync(kFull, x, o2);
          x2 += __shfl_xor_sync(kFull, x2, o2);
        }
        if (lane % kQ == 0) {
          s_dru[t] = x;
          s_ru[t] = x2;
        }
      }
    }
    if (scan_warp) {
#pragma unroll
      for (int hh = 0; hh < NCH; ++hh) {
        const int i = lane + 32 * hh;
        float x = 0.f;
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const int t = t0 + rr;
          lwv[hh][rr] = i < kD && t < c_n ? wb[t * sw.t + i] : 0.f;
          x += lwv[hh][rr];
        }
        if (i < kD) s_part[tl * kD + i] = x;
      }
    }
    __syncthreads();                // totals, rows, dru, r.(u k) in
    float dup[NCH];
    if (scan_warp) {
      // cum = the tile's prefix + the earlier tiles' totals in order; c =
      // L / 2; r', k', the two exponentials; du's part of the tile
#pragma unroll
      for (int hh = 0; hh < NCH; ++hh) {
        const int i = lane + 32 * hh;
        dup[hh] = 0.f;
        if (i >= kD) continue;
        float off = 0.f, last = 0.f;
#pragma unroll
        for (int wq = 0; wq < kTiles; ++wq) {
          if (wq == tl) off = last;
          last += s_part[wq * kD + i];
        }
        const float c = last * 0.5f;
        float x = 0.f;
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const int t = t0 + rr, a = at<kD>(t, i);
          x += lwv[hh][rr];
          const float cm = x + off;
          const float er = expf((cm - lwv[hh][rr]) - c);
          const float ek = expf(c - cm);
          const float r1 = s_er[a], k1 = s_ek[a];
          dup[hh] += (s_dru[t] * r1) * k1;
          s_r[a] = r1 * er;
          s_k[a] = k1 * ek;
          s_er[a] = er;
          s_ek[a] = ek;
        }
      }
    }
    if (row_warp) {
#pragma unroll
      for (int it = 0; it < kMIt; ++it) {     // this thread's copies
        const int e = it * 32 + lane;
        if (e >= kMRows * kQ) continue;
        const int row = tl * kMRows + e / kQ, col = 4 * (e % kQ);
        float last = 0.f;                     // as the scan warps sum it
#pragma unroll
        for (int wq = 0; wq < kTiles; ++wq) last += s_part[wq * kD + row];
        const float ec = expf(last * 0.5f);
        float4& x = at4(s_mg + atm<kD>(row, col));
        float4& y = at4(s_ms + atm<kD>(row, col));
        x = make_float4(ec * x.x, ec * x.y, ec * x.z, ec * x.w);
        y = make_float4(ec * y.x, ec * y.y, ec * y.z, ec * y.w);
      }
    }
    __syncthreads();                // phase 0 done
    if (scan_warp) {
#pragma unroll
      for (int hh = 0; hh < NCH; ++hh)
        if (lane + 32 * hh < kD) s_part[tl * kD + lane + 32 * hh] = dup[hh];
    }

    // ---- dv of tile x1: k' (e^c G), then A^T = k' r'^T over the keys t >
    // s, times dO
    if (x1 < nrt) {
      const int m = 16 * x1;
      float d[NTH][4], dc[NTH][4];
      tile_pass<kD, NTH, false, false, true, true>(s_k, s_mg, s_r, s_o, m,
                                                    nt0, m, nrt * 16, g, q,
                                                    d, dc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = m + g + 8 * hh;
        if (s >= c_n) continue;
        const float ru = s_ru[s];
        T* row = dv + b * sdv.b + h * sdv.h + (c0 + s) * sdv.t;
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = (nt0 + nt) * 8 + 2 * q + e;
            st(row + j, (d[nt][2 * hh + e] + dc[nt][2 * hh + e]) +
                            ru * s_o[at<kD>(s, j)]);
          }
      }
    }

    // ---- dk of tile x2: v (e^c G)^T, then dA^T = v dO^T over the keys t
    // > s, times r'; gcum over e^{c - cum}
    if (x2 < nrt) {
      const int m = 16 * x2;
      float d[NTH][4], dc[NTH][4];
      tile_pass<kD, NTH, kExact, false, false, true>(s_v, s_mg, s_o, s_r, m,
                                                      nt0, m, nrt * 16, g, q,
                                                      d, dc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = m + g + 8 * hh;
        if (s >= c_n) continue;
        const float dru = s_dru[s];
        float raw[NTH][2];         // r of the row, all loads issued first
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            raw[nt][e] = ld(rb + s * sr.t + (nt0 + nt) * 8 + 2 * q + e);
        T* row = dk + b * sdk.b + h * sdk.h + (c0 + s) * sdk.t;
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = (nt0 + nt) * 8 + 2 * q + e, a = at<kD>(s, i);
            const float pre = d[nt][2 * hh + e] + dc[nt][2 * hh + e];
            st(row + i, s_ek[a] * pre + (dru * uh[i]) * raw[nt][e]);
            s_ek[a] = -(s_k[a] * pre);
          }
      }
    }

    // ---- dr of tile x3: dO (e^c S)^T, then dA = dO v^T over the keys s <
    // t, times k'; gce over e^{ce - c}
    if (x3 < nrt) {
      const int m = 16 * x3;
      float d[NTH][4], dc[NTH][4];
      tile_pass<kD, NTH, false, kExact, false, false>(s_o, s_ms, s_v, s_k, m,
                                                       nt0, 0, m + 16, g, q,
                                                       d, dc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = m + g + 8 * hh;
        if (t >= c_n) continue;
        const float dru = s_dru[t];
        float raw[NTH][2];         // k of the row, all loads issued first
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            raw[nt][e] = ld(kb + t * sk.t + (nt0 + nt) * 8 + 2 * q + e);
        T* row = dr + b * sdr.b + h * sdr.h + (c0 + t) * sdr.t;
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = (nt0 + nt) * 8 + 2 * q + e, a = at<kD>(t, i);
            const float pre = d[nt][2 * hh + e] + dc[nt][2 * hh + e];
            st(row + i, s_er[a] * pre + (dru * uh[i]) * raw[nt][e]);
            s_er[a] = s_r[a] * pre;
          }
      }
    }
    __syncthreads();                // gce and gcum of every tile are in

    // ---- du's part of the chunk, the tiles' parts in order
    if (tid < kD) {
      float x = 0.f;
      for (int w2 = 0; w2 < kTiles; ++w2) x += s_part[w2 * kD + tid];
      du_part[size_t(item) * kD + tid] = x;
    }
    // ---- dlog w: the reverse scan of gcum[t] + gce[t + 1] by segment
    // (the partial sums over gcum), the segments' totals into e^c G's place
    const int i = tid % kD, sgm = tid / kD;
    const int lo = sgm * kSegRows, hi = min(lo + kSegRows, c_n);
    float x = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      const int a = at<kD>(t, i);
      x += s_ek[a] + (t + 1 < c_n ? s_er[at<kD>(t + 1, i)] : 0.f);
      s_ek[a] = x;
    }
    s_mg[sgm * kD + i] = x;
    __syncthreads();
    float later = 0.f;
    for (int s2 = kSeg - 1; s2 > sgm; --s2) later += s_mg[s2 * kD + i];
    const float gli = gl[size_t(item) * kD + i];
    float* dwb = dw + b * sdw.b + h * sdw.h + c0 * sdw.t + i;
    for (int t = lo; t < hi; ++t)
      dwb[t * sdw.t] = (s_ek[at<kD>(t, i)] + later) + gli;
  }
}

// ------------------------------------------------------------- 4. du
// du [h, D] = du_part [b, h, chunks, D] summed over the batch, then the
// chunks, in order
__global__ void wkv_du_sum(const float* __restrict__ du_part,
                           float* __restrict__ du, int b_n, int h_n, int nc,
                           int d) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= h_n * d) return;
  const int h = e / d, i = e % d;
  float x = 0.f;
  for (int b = 0; b < b_n; ++b)
    for (int ci = 0; ci < nc; ++ci)
      x += du_part[((size_t(b) * h_n + h) * nc + ci) * d + i];
  du[e] = x;
}

template <typename T, int kD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* states,
                   const void* dout, const void* dstate, void* dr, void* dk,
                   void* dv, void* dw, void* gs, void* el, void* gl,
                   void* du_part, const void* fin, void* du, void* dstate0,
                   int b, int h, int s, int c, bool vec, const long long* st,
                   cudaStream_t stream) {
  Strides s9[9];
  for (int i = 0; i < 9; ++i)
    s9[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const T* tr = static_cast<const T*>(r);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const float* fw = static_cast<const float*>(w);
  const float* fs = static_cast<const float*>(states);
  const float* fo = static_cast<const float*>(dout);
  float* fgs = static_cast<float*>(gs);
  float* fel = static_cast<float*>(el);
  float* fgl = static_cast<float*>(gl);
  const int nc = s / c, items = b * h * nc;
  // 1. every chunk's P, a CTA a chunk
  const size_t ps_bytes = PsSmem<kD>::FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_bwd_pstate<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ps_bytes));
  if (e != cudaSuccess) return e;
  wkv_bwd_pstate<T, kD><<<items, kThreads, ps_bytes, stream>>>(
      tr, fw, fo, fgs, fel, h, s, c, vec, s9[0], s9[3], s9[4]);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // 2. the scan, a row of G a warp
  const int rows = b * h * kD;
  wkv_bwd_dstate<kD><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      fs, static_cast<const float*>(dstate),
      dstate ? static_cast<const float*>(fin) : nullptr, fel,
      fgs, fgl, static_cast<float*>(dstate0), rows, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // 3. the chunks, a persistent grid of as many CTAs as fit at once
  const size_t bytes = Smem<kD>::FLOATS * sizeof(float);
  e = cudaFuncSetAttribute(wkv_bwd_chunk<T, kD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, wkv_bwd_chunk<T, kD>, kCThreads, bytes)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  wkv_bwd_chunk<T, kD><<<grid, kCThreads, bytes, stream>>>(
      tr, tk, tv, fw, static_cast<const float*>(u), fs, fo, fgs, fgl,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part), b, h, s, c,
      vec, s9[0], s9[1], s9[2], s9[3], s9[4], s9[5], s9[6], s9[7], s9[8]);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // 4. du
  const int hd = h * kD;
  wkv_du_sum<<<(hd + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), b, h, nc,
      kD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* states,
                     const void* dout, const void* dstate, void* dr,
                     void* dk, void* dv, void* dw, void* gs, void* el,
                     void* gl, void* du_part, const void* fin, void* du,
                     void* dstate0, int b, int h, int s, int c, bool vec,
                     const long long* st, cudaStream_t stream) {
  if (d == 16)
    return launch<T, 16>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw,
                         gs, el, gl, du_part, fin, du, dstate0, b, h, s, c,
                         vec, st, stream);
  if (d == 32)
    return launch<T, 32>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw,
                         gs, el, gl, du_part, fin, du, dstate0, b, h, s, c,
                         vec, st, stream);
  return launch<T, 64>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw,
                       gs, el, gl, du_part, fin, du, dstate0, b, h, s, c,
                       vec, st, stream);
}

template <typename T, int kD>
cudaError_t occupancy(int* ctas) {
  cudaError_t e = cudaFuncSetAttribute(
      wkv_bwd_pstate<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(PsSmem<kD>::FLOATS * sizeof(float)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        wkv_bwd_chunk<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<kD>::FLOATS * sizeof(float)));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, wkv_bwd_pstate<T, kD>, kThreads,
        PsSmem<kD>::FLOATS * sizeof(float));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas + 1, wkv_bwd_dstate<kD>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas + 2, wkv_bwd_chunk<T, kD>, kCThreads,
        Smem<kD>::FLOATS * sizeof(float));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas + 3, wkv_du_sum,
                                                      256, 0);
  return e;
}

}  // namespace

extern "C" {

// CTAs an SM of the four device kernels at (dtype, d), in launch order,
// into ctas[0..3]; returns the cudaError_t.
int wkv_bwd_occupancy(int dtype, int d, int* ctas) {
  if (d != 16 && d != 32 && d != 64) return cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == 0)
    e = d == 16 ? occupancy<float, 16>(ctas)
        : d == 32 ? occupancy<float, 32>(ctas) : occupancy<float, 64>(ctas);
  else
    e = d == 16 ? occupancy<__nv_bfloat16, 16>(ctas)
        : d == 32 ? occupancy<__nv_bfloat16, 32>(ctas)
                  : occupancy<__nv_bfloat16, 64>(ctas);
  return static_cast<int>(e);
}

// One host call on `stream` (four device kernels: wkv_bwd_pstate,
// wkv_bwd_dstate, wkv_bwd_chunk, wkv_du_sum); returns the cudaError_t (0
// on success).  dtype 0 = float32, 1 = bf16 (r, k, v, dr, dk, dv).  r, k,
// v, log w, dout, dr, dk, dv, dw are [b, h, s, d] with a contiguous last
// axis and element strides (batch, head, step) in `strides`, in that order
// (27 values); u is [h, d]; states [b, h, s / c, d, d] (16-byte aligned),
// dstate (null for zeros) and dstate0 [b, h, d, d] contiguous float32;
// float32 scratch: gs [b, h, s / c, d, d], el, gl and du_part [b, h, s /
// c, d]; fin, the forward's final state [b, h, d, d] contiguous float32
// (read only with a dstate); du [h, d].  vec:
// every pointer of r, k, v, log w and dout 16-byte aligned and each of
// their strides a multiple of 8 elements (vector loads).  Requires d in
// {16, 32, 64}, 1 <= c <= 128 and s % c == 0.
int wkv_bwd_launch(int dtype, const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* states,
                   const void* dout, const void* dstate, void* dr, void* dk,
                   void* dv, void* dw, void* gs, void* el, void* gl,
                   void* du_part, const void* fin, void* du, void* dstate0,
                   int b, int h, int s, int d, int c, int vec,
                   const long long* strides, void* stream) {
  if ((d != 16 && d != 32 && d != 64) || c < 1 || c > kMaxC || s % c)
    return cudaErrorInvalidValue;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0
          ? dispatch<float>(d, r, k, v, w, u, states, dout, dstate, dr, dk,
                            dv, dw, gs, el, gl, du_part, fin, du, dstate0,
                            b, h, s, c, vec != 0, strides, cs)
          : dispatch<__nv_bfloat16>(d, r, k, v, w, u, states, dout, dstate,
                                    dr, dk, dv, dw, gs, el, gl, du_part,
                                    fin, du, dstate0, b, h, s, c, vec != 0,
                                    strides, cs);
  return static_cast<int>(e);
}

}  // extern "C"
