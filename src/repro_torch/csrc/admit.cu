// The batch scheduler's three admission scans, one call per tick each,
// for Hopper (sm_90a).  They are not TPU kernels: they replace the XLA
// scans (lax.scan) of repro/sched/scheduler.py, which a loop of torch
// operations would turn into some ten launches per transaction, about
// 50,000 per tick at n = 4,096.
//
//   ppcc_admit   ppcc_tick's step (scheduler.py:173-191): transaction i,
//                in the order seq, is admitted unless it would both
//                precede and be preceded, or meets an admitted preceding
//                transaction through a RAW arc out of it or a preceded
//                one through an arc into it; the class bits and the
//                precedence rows and columns follow.
//   twopl_admit  twopl_tick's step (:223-228): i in index order is
//                admitted unless (raw | raw^T | ww) meets an admitted j.
//   occ_admit    occ_tick's step (:247-254): i survives unless raw | ww
//                meets an earlier survivor.
//
// Each computes exactly its plain version in repro_torch/kernels/ref.py.
//
// Bound.  A step reads one or two rows of n bools: at n = 4,096 raw is 16
// MB; ppcc reads it and writes 16 MB of prec, twopl reads raw and ww:
// about 10 us of bytes at 3.35 TB/s; occ needs only the half j < i of raw
// and ww, 5 us.
// What bounds the scans is their chain of dependent steps: a step whose
// transaction is not admitted changes nothing, so the chain runs through
// the admitted ones; chip_smoke.py models it beside the byte bound.
//
// Design of ppcc_admit: three device kernels a call.
//   1. ppcc_pack: raw's rows and columns as packed words, no transposed
//      copy of raw: a warp reads 32 rows of 128 columns, a word of 4
//      columns a lane (a 128-byte line a row); row words come from the
//      lanes' nibbles by butterfly shuffles, column words from each lane's
//      own bits, and both leave in 16- or 32-byte pieces.  Rows are padded
//      with 0 to the scan's row width.  The same pass writes the order as
//      steps[t] = seq[t] | valid[seq[t]] << 31.
//   2. ppcc_scan: the chain.  Up to n = 16,384 a CTA of four warps, one a
//      scheduler, holds the three sets (admitted, preceding, preceded) in
//      registers, K = 1, 2 or 4 words of each a thread (thread t owns words
//      t K .. t K + K - 1).  A step that is not admitted changes no set,
//      and under contention most are not: so the CTA tests B = 16 steps at
//      once (8 at K = 4) against the same sets and applies the first
//      admitted one among them, if any, then tests the steps after it
//      again from the new sets.  A test ANDs the packed row and column of
//      the transaction with admitted and takes three any-tests (arcs out,
//      arcs in, an arc to a preceding or from a preceded one), kept as bit
//      b of three masks; two __reduce_or_sync and one __syncthreads OR
//      them over the CTA.  The rows and columns of the steps ahead sit in
//      a ring of 4 B shared-memory stages, refilled at the start of each
//      batch by cp.async copies spread over the CTA, since seq is known in
//      advance: a refill has two batches to land, off the chain.  Above
//      16,384 (to 262,144) a CTA of 512 threads keeps the sets in shared
//      memory, each thread its own K = 2..16 words, with the next step's
//      words loaded one step ahead and one __syncthreads per step.
//   3. ppcc_prec: prec, which the reference builds row by row and column
//      by column, is exactly raw & admitted[:, None] & admitted[None, :]
//      off the diagonal (a pair is written last at the later of its two
//      steps, when the earlier one's verdict is final); one coalesced pass
//      after the scan writes it from the packed rows, so prec needs no
//      zero fill.
//
// Design of twopl_admit and occ_admit: two device kernels a call, the same
// walk on other rows.
//   1. greedy_pack: one packed row a transaction, padded with 0 to the
//      scan's row width.  A CTA owns 256 rows x 4 words of the output, so no
//      two CTAs write one word, and takes raw | ww at that tile as ppcc_pack
//      takes raw's rows (row words by butterfly shuffles).  For twopl the
//      row is raw[i, :] | raw[:, i] | ww[i, :] with the diagonal cleared,
//      and no transposed copy of raw: the CTA also reads raw at the
//      transposed tile (column words, as ppcc_pack) and ORs both in shared
//      memory; 3 n^2 bytes, 50 MB at n = 4,096.  For occ the row is
//      raw[i, :] | ww[i, :] at and below i's own word: a lane reads a word
//      only if it is not right of the row's diagonal word, and the words
//      right of it stay 0, so the pack reads the triangle j < i the step
//      needs, about n^2 bytes (17 MB at n = 4,096).
//   2. greedy_scan: ppcc_scan's walk with one set.  Up to n = 16,384 four
//      warps hold admitted in registers, K = 1, 2 or 4 words a thread, and
//      test B = 32 steps at once (16 at K = 4) against it, one bit of a mask
//      each; one __reduce_or_sync and one __syncthreads OR the masks, and
//      the first valid step among them that meets no admitted transaction
//      is admitted; the walk resumes after it.  Steps go in index order, so
//      the rows ahead are refilled into a ring of 4 B stages by cp.async,
//      as in ppcc_scan.  Above 16,384 (to 262,144) a CTA of 512 threads,
//      K = 2..16 words a thread in registers, one __syncthreads_or a step.
//   At step i only j < i can be admitted, never i: so a row's bits j >= i
//   change nothing, the diagonal (which occ keeps) and the columns right of
//   i's word (which occ's pack leaves 0) alike.  That makes occ_tick's step,
//   i survives unless raw | ww meets an earlier survivor, exactly
//   twopl_tick's on the row raw | ww: "earlier" removes no bit.
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int admit_row_words(int n);

namespace {

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kValid = 0x80000000u;  // steps[t]: the valid bit
constexpr int kScanThreads = 128;  // ppcc_scan: four warps, one a scheduler
constexpr int kScanMaxK = 4;       // n <= 128 x 32 x 4 = 16,384
constexpr int kCtaThreads = 512;   // CTA route
constexpr int kCtaMaxK = 16;       // CTA route: n <= 512 x 32 x 16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte cp.async into shared memory.
__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K consecutive words, 16-byte aligned when K >= 4, in vector loads.
template <int K>
__device__ __forceinline__ void load_words(uint32_t (&dst)[K],
                                           const uint32_t* src) {
  if constexpr (K == 1) {
    dst[0] = src[0];
  } else if constexpr (K == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
#pragma unroll
    for (int m = 0; m < K; m += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + m);
      dst[m] = v.x;
      dst[m + 1] = v.y;
      dst[m + 2] = v.z;
      dst[m + 3] = v.w;
    }
  }
}

// Four bits as four 0/1 bytes of a little-endian word.
__device__ __forceinline__ uint32_t expand4(uint32_t nib) {
  return ((nib & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Word q of a packed set as bytes 32 q .. 32 q + 31 of a bool[n].
__device__ __forceinline__ void store_bytes(uint8_t* out, int q,
                                            uint32_t word, int n) {
  const int b0 = q * 32;
  if (b0 >= n) return;
  if (b0 + 32 <= n) {
    uint4* o = reinterpret_cast<uint4*>(out + b0);
    o[0] = make_uint4(expand4(word), expand4(word >> 4), expand4(word >> 8),
                      expand4(word >> 12));
    o[1] = make_uint4(expand4(word >> 16), expand4(word >> 20),
                      expand4(word >> 24), expand4(word >> 28));
  } else {
    for (int b = 0; b < n - b0; ++b) out[b0 + b] = (word >> b) & 1u;
  }
}

// ---- 1. pack: a CTA of 8 warps packs 256 rows x 128 columns of raw, warp
// w the 32 rows I*32 .. I*32 + 31 (I = I0 + w) of the 128 columns G*128 ..
// G*128 + 127.  Lane l loads 4 columns of a row as one word (a 128-byte
// line a row for the warp) and keeps them as the 4 bits of a nibble.  Row
// words: the 8 lanes of a 32-column group OR their nibbles together by
// three butterfly shuffles, and lane m of the group keeps rows m, m + 8,
// m + 16, m + 24, so that a row's 4 words leave as 16 contiguous bytes.
// Column words: lane l gathers bit r of its 4 columns over the 32 rows (8
// rows a word by shifts, then byte permutes), and the CTA's 8 words of a
// column go out together through shared memory as 32 bytes.
__global__ void __launch_bounds__(256)
ppcc_pack_kernel(const uint8_t* __restrict__ raw,
                 const uint8_t* __restrict__ valid,
                 const int32_t* __restrict__ seq, int n, int nw, int ws,
                 uint32_t* __restrict__ rows, uint32_t* __restrict__ cols,
                 uint32_t* __restrict__ steps) {
  __shared__ uint32_t s_col[8][128];         // [I - I0][column - G*128]
  const size_t gid =
      (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
      threadIdx.x;
  if (gid < size_t(n)) {
    const int i = seq[gid];
    steps[gid] = uint32_t(i) | (valid[i] ? kValid : 0u);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int I0 = blockIdx.y * 8, G = blockIdx.x;
  if (I0 >= nw && G * 4 >= nw) return;       // padding only, CTA-uniform
  const int I = I0 + w;
  const int c0 = G * 128 + lane * 4;         // this lane's first column
  const bool vec = n % 4 == 0;
  uint32_t x[32];                            // 0/1 bytes: columns c0 .. c0+3
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int i = I * 32 + r;
    uint32_t v = 0u;
    if (i < n) {
      const uint8_t* p = raw + size_t(i) * n + c0;
      if (vec) {
        if (c0 < n) v = *reinterpret_cast<const uint32_t*>(p);
      } else {
        for (int b = 0; b < 4; ++b)
          if (c0 + b < n) v |= uint32_t(p[b]) << (8 * b);
      }
    }
    x[r] = __vcmpne4(v, 0u) & 0x01010101u;
  }
  // row words: after the butterfly every lane of group c = lane / 8 holds
  // word G*4 + c of the row; lane m + 8 c keeps rows m + 8 q
  uint32_t keep[4];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    uint32_t v = ((x[r] * 0x01020408u) >> 24) << (4 * (lane & 7));
    v |= __shfl_xor_sync(kFull, v, 1);
    v |= __shfl_xor_sync(kFull, v, 2);
    v |= __shfl_xor_sync(kFull, v, 4);
    if ((r & 7) == 0) keep[r >> 3] = 0u;
    keep[r >> 3] = (lane & 7) == (r & 7) ? v : keep[r >> 3];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = I * 32 + (lane & 7) + 8 * q;
    if (i < n) rows[size_t(i) * ws + G * 4 + (lane >> 3)] = keep[q];
  }
  // column words: y[q] byte b holds rows 8q .. 8q + 7 of column c0 + b
  uint32_t y[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    y[q] = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) y[q] |= x[8 * q + k] << k;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t sel = b | (4 + b) << 4;
    s_col[w][lane * 4 + b] = __byte_perm(__byte_perm(y[0], y[1], sel),
                                         __byte_perm(y[2], y[3], sel), 0x5410);
  }
  __syncthreads();
  const int col = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int j = G * 128 + col;
  if (j < n) {
    uint4* o = reinterpret_cast<uint4*>(cols + size_t(j) * ws + I0 + 4 * h);
    *o = make_uint4(s_col[4 * h][col], s_col[4 * h + 1][col],
                    s_col[4 * h + 2][col], s_col[4 * h + 3][col]);
  }
}

// Steps ppcc_scan tests at once (at most 16), and the stages of its ring:
// four batches, so that a refill has two batches to land.
__host__ __device__ constexpr int batch_steps(int k) { return k <= 2 ? 16 : 8; }
__host__ __device__ constexpr int ring_stages(int k) {
  return k <= 2 ? 64 : 32;
}

// ---- 2. scan: the sets in the registers of four warps, K words of each
// a thread.  A step that is not admitted changes no set, so B steps are
// tested at once against the same sets and the first admitted one among
// them, if any, is applied; the steps after it are tested again from the
// new sets.  The rows and columns of the steps ahead sit in a ring of
// shared-memory stages; at the start of a batch, cp.async copies spread
// over the CTA refill the stages the last batch used.
template <int K>
__global__ void __launch_bounds__(kScanThreads)
ppcc_scan_kernel(const uint32_t* __restrict__ rows,
                 const uint32_t* __restrict__ cols,
                 const uint32_t* __restrict__ steps, int n,
                 uint32_t* __restrict__ bits, uint8_t* __restrict__ admitted,
                 uint8_t* __restrict__ preceding,
                 uint8_t* __restrict__ preceded) {
  constexpr int WS = kScanThreads * K;
  constexpr int B = batch_steps(K);
  constexpr int R = ring_stages(K);
  static_assert(B <= 16 && R == 4 * B, "two batches for a refill to land");
  constexpr int kUnits = WS / 2;             // 16-byte copies a step
  constexpr int kIters = B * kUnits / kScanThreads;
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ uint32_t s_part[kScanThreads / 32][2];
  const int n4 = (n + 3) / 4 * 4;
  const int nv = n4 / 32 + 2;                // valid words, one of padding
  uint32_t* ring = sm;                       // [R][row, column][WS]
  uint32_t* s_steps = sm + R * 2 * WS;       // [n4]
  uint32_t* s_valid = s_steps + n4;          // valid bits in step order
  const int g = threadIdx.x, lane = g & 31;
  for (int u = g; u < n4 / 4; u += kScanThreads)
    cp_async16(s_steps + 4 * u, steps + 4 * u);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int q = g >> 5; q < nv; q += kScanThreads / 32) {
    const int x = q * 32 + lane;
    const unsigned v =
        __ballot_sync(kFull, x < n && (s_steps[x] & kValid) != 0u);
    if (lane == 0) s_valid[q] = v;
  }

  // the rows and columns of steps x0 .. x1 - 1 (at most B) into their
  // stages x % R: 16-byte cp.async copies spread over the CTA, the steps'
  // indices read first so that their loads overlap
  auto refill = [&](int x0, int x1) {
    const int x_end = x1 < n ? x1 : n;
    uint32_t idx[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int x = x0 + int(unsigned(g + it * kScanThreads) / kUnits);
      idx[it] = x < x_end ? s_steps[x] & ~kValid : 0u;
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const unsigned u = g + it * kScanThreads;
      const int x = x0 + int(u / kUnits);
      if (x < x_end) {
        const int o = u % kUnits;
        const bool col = o >= WS / 4;
        const int w0 = (col ? o - WS / 4 : o) * 4;
        cp_async16(ring + (x & (R - 1)) * 2 * WS + (col ? WS : 0) + w0,
                   (col ? cols : rows) + size_t(idx[it]) * WS + w0);
      }
    }
  };
#pragma unroll 1
  for (int x = 0; x < R; x += B) refill(x, x + B);
  cp_async_commit();             // the first R steps, then two empty groups:
  cp_async_commit();             // a batch waits for all but the last two
  cp_async_commit();

  uint32_t adm[K], pg[K], pd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) adm[k] = pg[k] = pd[k] = 0u;
  int done = 0;                  // the stages of steps before it are refilled
  for (int s = 0; s < n;) {
    // steps s .. s + B - 1 lie in the refills before the last two (R = 4
    // B), so each refill has two batches to land
    cp_async_wait<2>();
    __syncthreads();               // every thread is done with the last
    refill(done + R, s + R);       // batch: refill the stages it used
    cp_async_commit();
    done = s;
    // this thread's words of the three tests of each step, as bit b of a
    // mask: any arc out, any arc in, an arc to a preceding or from a
    // preceded transaction (those hold admitted ones only, so the AND with
    // admitted is already in them)
    unsigned m_r = 0u, m_w = 0u, m_p = 0u;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const uint32_t* st = ring + ((s + b) & (R - 1)) * 2 * WS + g * K;
      uint32_t rw[K], cw[K];
      load_words<K>(rw, st);
      load_words<K>(cw, st + WS);
      uint32_t xr = 0u, xw = 0u, xp = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xr |= rw[k] & adm[k];
        xw |= cw[k] & adm[k];
        xp |= (rw[k] & pg[k]) | (cw[k] & pd[k]);
      }
      m_r |= xr ? 1u << b : 0u;
      m_w |= xw ? 1u << b : 0u;
      m_p |= xp ? 1u << b : 0u;
    }
    // OR over the warp, then over the four warps
    const unsigned rw_or = __reduce_or_sync(kFull, m_r | m_w << 16);
    const unsigned p_or = __reduce_or_sync(kFull, m_p);
    if (lane == 0) {
      s_part[g >> 5][0] = rw_or;
      s_part[g >> 5][1] = p_or;
    }
    __syncthreads();
    unsigned all_rw = 0u;
    m_p = 0u;
#pragma unroll
    for (int w = 0; w < kScanThreads / 32; ++w) {
      all_rw |= s_part[w][0];
      m_p |= s_part[w][1];
    }
    m_r = all_rw & 0xffffu;
    m_w = all_rw >> 16;
    const int left = n - s;
    const unsigned live = (1u << (left < B ? left : B)) - 1u;
    const unsigned valid_m = __funnelshift_r(s_valid[s >> 5],
                                             s_valid[(s >> 5) + 1], s & 31);
    const unsigned ok_m = valid_m & live & ~(m_r & m_w) & ~m_p;
    int adv = left < B ? left : B;
    if (ok_m) {                              // apply the first admitted step
      const int b = __ffs(ok_m) - 1;
      adv = b + 1;
      const int x = s + b;
      const int i = s_steps[x] & ~kValid;
      const uint32_t* st = ring + (x & (R - 1)) * 2 * WS + g * K;
      uint32_t rw[K], cw[K];
      load_words<K>(rw, st);
      load_words<K>(cw, st + WS);
      const bool any_r = (m_r >> b) & 1u, any_w = (m_w >> b) & 1u;
      const int wi = i >> 5;
      const uint32_t bit = wi / K == g ? 1u << (i & 31) : 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t me = k == (wi & (K - 1)) ? bit : 0u;
        pg[k] |= (cw[k] & adm[k]) | (any_r ? me : 0u);
        pd[k] |= (rw[k] & adm[k]) | (any_w ? me : 0u);
        adm[k] |= me;
      }
    }
    s += adv;
  }
  cp_async_wait<0>();              // no copy may outlive the CTA
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = g * K + k;
    bits[q] = adm[k];
    bits[WS + q] = pg[k];
    bits[2 * WS + q] = pd[k];
    store_bytes(admitted, q, adm[k], n);
    store_bytes(preceding, q, pg[k], n);
    store_bytes(preceded, q, pd[k], n);
  }
}

// ---- 2'. scan, CTA route: the sets in shared memory, each thread its own
// K words; one block-wide OR of the three tests per step
template <int K>
__global__ void __launch_bounds__(kCtaThreads)
ppcc_scan_cta_kernel(const uint32_t* __restrict__ rows,
                     const uint32_t* __restrict__ cols,
                     const uint32_t* __restrict__ steps, int n,
                     uint32_t* __restrict__ bits,
                     uint8_t* __restrict__ admitted,
                     uint8_t* __restrict__ preceding,
                     uint8_t* __restrict__ preceded) {
  constexpr int WS = kCtaThreads * K;
  extern __shared__ __align__(16) uint32_t sm[];   // [admitted, pg, pd][WS]
  __shared__ unsigned s_any[3];
  const int g = threadIdx.x;
  uint32_t* my_adm = sm + g * K;
  uint32_t* my_pg = sm + WS + g * K;
  uint32_t* my_pd = sm + 2 * WS + g * K;
#pragma unroll
  for (int k = 0; k < K; ++k) my_adm[k] = my_pg[k] = my_pd[k] = 0u;
  if (g < 3) s_any[g] = 0u;
  __syncthreads();

  uint32_t e = steps[0];
  uint32_t rw[K], cw[K];
  load_words<K>(rw, rows + size_t(e & ~kValid) * WS + g * K);
  load_words<K>(cw, cols + size_t(e & ~kValid) * WS + g * K);
  uint32_t e_nx = n > 1 ? steps[1] : 0u;
  for (int s = 0; s < n; ++s) {
    uint32_t rn[K], cn[K];
    const size_t i_nx = e_nx & ~kValid;
    load_words<K>(rn, rows + i_nx * WS + g * K);
    load_words<K>(cn, cols + i_nx * WS + g * K);
    const uint32_t e_nn = s + 2 < n ? steps[s + 2] : 0u;

    const int i = e & ~kValid;
    uint32_t xr = 0u, xw = 0u, xp = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t a = my_adm[k];
      const uint32_t r = rw[k] & a, w = cw[k] & a;
      xr |= r;
      xw |= w;
      xp |= (r & my_pg[k]) | (w & my_pd[k]);
    }
    unsigned f = unsigned(xr != 0u) | unsigned(xw != 0u) << 1 |
                 unsigned(xp != 0u) << 2;
    f = __reduce_or_sync(kFull, f);
    const int slot = s % 3;
    if ((g & 31) == 0 && f) atomicOr(&s_any[slot], f);
    __syncthreads();
    f = s_any[slot];
    if (g == 0) s_any[(s + 2) % 3] = 0u;     // last read in step s - 1
    const bool any_r = f & 1u, any_w = f & 2u;
    const bool ok = (e & kValid) && !(any_r && any_w) && !(f & 4u);
    if (ok) {
      const int wi = i >> 5;
      const uint32_t bit = wi / K == g ? 1u << (i & 31) : 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t me = k == (wi & (K - 1)) ? bit : 0u;
        const uint32_t a = my_adm[k];
        my_pg[k] |= (cw[k] & a) | (any_r ? me : 0u);
        my_pd[k] |= (rw[k] & a) | (any_w ? me : 0u);
        my_adm[k] = a | me;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rw[k] = rn[k];
      cw[k] = cn[k];
    }
    e = e_nx;
    e_nx = e_nn;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = g * K + k;
    bits[q] = my_adm[k];
    bits[WS + q] = my_pg[k];
    bits[2 * WS + q] = my_pd[k];
    store_bytes(admitted, q, my_adm[k], n);
    store_bytes(preceding, q, my_pg[k], n);
    store_bytes(preceded, q, my_pd[k], n);
  }
}

// ---- 3. prec = raw & admitted[:, None] & admitted[None, :], diagonal 0:
// one CTA per row, 16 bytes a thread
__global__ void __launch_bounds__(256)
ppcc_prec_kernel(const uint32_t* __restrict__ rows,
                 const uint32_t* __restrict__ adm, int n, int ws,
                 uint8_t* __restrict__ prec) {
  const int i = blockIdx.x;
  const bool ai = (adm[i >> 5] >> (i & 31)) & 1u;
  const uint32_t* row = rows + size_t(i) * ws;
  uint8_t* out = prec + size_t(i) * n;
  for (int j0 = threadIdx.x * 16; j0 < n; j0 += blockDim.x * 16) {
    uint32_t b = ai ? ((row[j0 >> 5] & adm[j0 >> 5]) >> (j0 & 16)) & 0xffffu
                    : 0u;
    if (i >= j0 && i < j0 + 16) b &= ~(1u << (i - j0));
    if (n % 16 == 0) {
      *reinterpret_cast<uint4*>(out + j0) = make_uint4(
          expand4(b), expand4(b >> 4), expand4(b >> 8), expand4(b >> 12));
    } else {
      for (int k = 0; k < 16 && j0 + k < n; ++k) out[j0 + k] = (b >> k) & 1u;
    }
  }
}

template <int K>
int launch_scan(const void* const* a, int n, int ws, cudaStream_t s) {
  const int n4 = (n + 3) / 4 * 4;
  const size_t bytes =
      (size_t(ring_stages(K)) * 2 * ws + n4 + n4 / 32 + 2) *
      sizeof(uint32_t);
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(ppcc_scan_kernel<K>), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ppcc_scan_kernel<K><<<1, kScanThreads, bytes, s>>>(
      static_cast<const uint32_t*>(a[0]), static_cast<const uint32_t*>(a[1]),
      static_cast<const uint32_t*>(a[2]), n, (uint32_t*)a[3],
      (uint8_t*)a[4], (uint8_t*)a[5], (uint8_t*)a[6]);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_scan_cta(const void* const* a, int n, int ws, cudaStream_t s) {
  const size_t bytes = size_t(3) * ws * sizeof(uint32_t);
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(ppcc_scan_cta_kernel<K>), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ppcc_scan_cta_kernel<K><<<1, kCtaThreads, bytes, s>>>(
      static_cast<const uint32_t*>(a[0]), static_cast<const uint32_t*>(a[1]),
      static_cast<const uint32_t*>(a[2]), n, (uint32_t*)a[3],
      (uint8_t*)a[4], (uint8_t*)a[5], (uint8_t*)a[6]);
  return static_cast<int>(cudaGetLastError());
}

// ---- twopl_admit and occ_admit, 1. pack: the rows the scan tests, as
// packed words padded with 0 to the scan's row width ws; for twopl (kOcc
// false) the conflict rows raw[i, :] | raw[:, i] | ww[i, :] with the
// diagonal cleared, for occ raw[i, :] | ww[i, :] at and below i's word.  A
// CTA of 8 warps owns the rows R0 .. R0 + 255 (R0 = 256 blockIdx.y) and the
// 4 words of columns G*128 .. G*128 + 127 (G = blockIdx.x), so no two CTAs
// write one word.  Its warps first take raw | ww at those rows and columns
// as ppcc_pack takes raw's rows (row words from nibbles by butterfly
// shuffles); for occ a lane whose word lies right of its warp's row word
// (the rows of warp w share word R0 / 32 + w) reads nothing.  For twopl
// they then take raw at the transposed tile (rows G*128 .., columns R0 ..)
// as ppcc_pack takes raw's columns: warp w the 32 rows of word G*4 + w % 4
// and the 128 columns R0 + 128 (w / 4) ...  Both halves OR into a [256][4]
// tile in shared memory, which leaves as one 16-byte store a row.
template <bool kOcc>
__global__ void __launch_bounds__(256)
greedy_pack_kernel(const uint8_t* __restrict__ raw,
                   const uint8_t* __restrict__ ww, int n, int ws,
                   uint32_t* __restrict__ rows) {
  __shared__ __align__(16) uint32_t s_out[256][4];   // [row - R0][word - 4G]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int R0 = blockIdx.y * 256, G = blockIdx.x;
  const bool vec = n % 4 == 0;
  // four 0/1 bytes of row i at columns c .. c + 3 (0 past n), as one word
  auto bytes4 = [&](const uint8_t* m, int i, int c) {
    uint32_t v = 0u;
    if (i < n && c < n) {
      const uint8_t* p = m + size_t(i) * n + c;
      if (vec) {
        v = *reinterpret_cast<const uint32_t*>(p);
      } else {
        for (int b = 0; b < 4; ++b)
          if (c + b < n) v |= uint32_t(p[b]) << (8 * b);
      }
    }
    return v;
  };
  uint32_t x[32];
  // (a) raw | ww at rows R0 + 32 w + r, columns G*128 + 4 lane .. + 3;
  // for occ only where the column's word is not right of the row's
  {
    const int c0 = G * 128 + lane * 4;
    const bool need = !kOcc || G * 4 + (lane >> 3) <= (R0 >> 5) + w;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = R0 + 32 * w + r;
      x[r] = need ? __vcmpne4(bytes4(raw, i, c0) | bytes4(ww, i, c0), 0u) &
                        0x01010101u
                  : 0u;
    }
    uint32_t keep[4];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      uint32_t v = ((x[r] * 0x01020408u) >> 24) << (4 * (lane & 7));
      v |= __shfl_xor_sync(kFull, v, 1);
      v |= __shfl_xor_sync(kFull, v, 2);
      v |= __shfl_xor_sync(kFull, v, 4);
      if ((r & 7) == 0) keep[r >> 3] = 0u;
      keep[r >> 3] = (lane & 7) == (r & 7) ? v : keep[r >> 3];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s_out[32 * w + (lane & 7) + 8 * q][lane >> 3] = keep[q];
  }
  __syncthreads();
  // (b) twopl only: raw[j, i] for j in word G*4 + c (c = w % 4) and i = R0 +
  // 128 h + 4 lane .. + 3 (h = w / 4): the column words of that tile
  if constexpr (!kOcc) {
    const int c = w & 3, h = w >> 2;
    const int i0 = R0 + 128 * h + lane * 4;
#pragma unroll
    for (int r = 0; r < 32; ++r)
      x[r] = __vcmpne4(bytes4(raw, (G * 4 + c) * 32 + r, i0), 0u) &
             0x01010101u;
    uint32_t y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      y[q] = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) y[q] |= x[8 * q + k] << k;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t sel = b | (4 + b) << 4;
      s_out[128 * h + lane * 4 + b][c] |= __byte_perm(
          __byte_perm(y[0], y[1], sel), __byte_perm(y[2], y[3], sel), 0x5410);
    }
    __syncthreads();
  }
  const int i = R0 + threadIdx.x;
  if (i < n) {
    uint4 o = *reinterpret_cast<const uint4*>(s_out[threadIdx.x]);
    if constexpr (!kOcc) {
      const int d = (i >> 5) - G * 4;          // the diagonal's word, if here
      const uint32_t off = ~(1u << (i & 31));
      if (d == 0) o.x &= off;
      if (d == 1) o.y &= off;
      if (d == 2) o.z &= off;
      if (d == 3) o.w &= off;
    }
    *reinterpret_cast<uint4*>(rows + size_t(i) * ws + G * 4) = o;
  }
}

// Steps greedy_scan tests at once: 32 (one bit each of a word), 16 at K = 4,
// where a ring of 4 B rows of 128 K words must fit a CTA's shared memory.
__host__ __device__ constexpr int greedy_batch(int k) {
  return k <= 2 ? 32 : 16;
}

// ---- twopl_admit and occ_admit, 2. scan: ppcc_scan's walk with one set.
// admitted sits in the registers of four warps, K words a thread (thread t
// owns words t K .. t K + K - 1).  A step that is not admitted changes
// nothing, so the CTA tests B steps at once against the same set, bit b of
// a mask per thread (its words of row s + b meet admitted), ORs the masks
// over the CTA (__reduce_or_sync, then one __syncthreads over four
// partials) and admits the first valid step among them that meets nothing;
// the steps after it are tested again from the new set.  The rows of the steps ahead
// (index order, known in advance) sit in a ring of 4 B shared-memory
// stages, refilled at the start of each batch by cp.async copies spread
// over the CTA, so that a refill has two batches to land.
template <int K>
__global__ void __launch_bounds__(kScanThreads)
greedy_scan_kernel(const uint32_t* __restrict__ rows,
                   const uint8_t* __restrict__ valid, int n,
                   uint8_t* __restrict__ admitted) {
  constexpr int WS = kScanThreads * K;
  constexpr int B = greedy_batch(K);
  constexpr int R = 4 * B;
  constexpr int kUnits = WS / 4;             // 16-byte copies a row
  constexpr int kIters = B * kUnits / kScanThreads;
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ unsigned s_part[kScanThreads / 32];
  const int nv = n / 32 + 2;                 // valid words, one of padding
  uint32_t* ring = sm;                       // [R][WS]
  uint32_t* s_valid = sm + R * WS;           // [nv]
  const int g = threadIdx.x, lane = g & 31;
  for (int q = g >> 5; q < nv; q += kScanThreads / 32) {
    const int x = q * 32 + lane;
    const unsigned v = __ballot_sync(kFull, x < n && valid[x]);
    if (lane == 0) s_valid[q] = v;
  }
  // the rows of steps x0 .. x1 - 1 (at most B) into their stages x % R
  auto refill = [&](int x0, int x1) {
    const int x_end = x1 < n ? x1 : n;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const unsigned u = g + it * kScanThreads;
      const int x = x0 + int(u / kUnits);
      if (x < x_end) {
        const int w0 = int(u % kUnits) * 4;
        cp_async16(ring + (x & (R - 1)) * WS + w0, rows + size_t(x) * WS + w0);
      }
    }
  };
#pragma unroll 1
  for (int x = 0; x < R; x += B) refill(x, x + B);
  cp_async_commit();             // the first R steps, then two empty groups:
  cp_async_commit();             // a batch waits for all but the last two
  cp_async_commit();

  uint32_t adm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) adm[k] = 0u;
  int done = 0;                  // the stages of steps before it are refilled
  for (int s = 0; s < n;) {
    cp_async_wait<2>();
    __syncthreads();             // s_valid written; the last batch is done
    refill(done + R, s + R);
    cp_async_commit();
    done = s;
    unsigned m = 0u;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      uint32_t rw[K];
      load_words<K>(rw, ring + ((s + b) & (R - 1)) * WS + g * K);
      uint32_t hit = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) hit |= rw[k] & adm[k];
      m |= hit ? 1u << b : 0u;
    }
    m = __reduce_or_sync(kFull, m);
    if (lane == 0) s_part[g >> 5] = m;
    __syncthreads();
    m = 0u;
#pragma unroll
    for (int w = 0; w < kScanThreads / 32; ++w) m |= s_part[w];
    const int left = n - s;
    const int adv_all = left < B ? left : B;
    const unsigned live = adv_all == 32 ? kFull : (1u << adv_all) - 1u;
    const unsigned ok = __funnelshift_r(s_valid[s >> 5],
                                        s_valid[(s >> 5) + 1], s & 31) &
                        live & ~m;
    int adv = adv_all;
    if (ok) {                    // admit the first step that meets nothing
      const int b = __ffs(ok) - 1;
      adv = b + 1;
      const int i = s + b, wi = i >> 5;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (wi == g * K + k) adm[k] |= 1u << (i & 31);
    }
    s += adv;
  }
  cp_async_wait<0>();            // no copy may outlive the CTA
#pragma unroll
  for (int k = 0; k < K; ++k) store_bytes(admitted, g * K + k, adm[k], n);
}

// ---- twopl_admit and occ_admit, 2'. scan above n = 16,384: a CTA of 512
// threads, each its K words of admitted in registers, one step at a time
// with the next step's words loaded one step ahead and one
// __syncthreads_or a step.
template <int K>
__global__ void __launch_bounds__(kCtaThreads)
greedy_scan_cta_kernel(const uint32_t* __restrict__ rows,
                       const uint8_t* __restrict__ valid, int n,
                       uint8_t* __restrict__ admitted) {
  constexpr int WS = kCtaThreads * K;
  const int g = threadIdx.x;
  uint32_t adm[K], rw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) adm[k] = 0u;
  load_words<K>(rw, rows + g * K);
  bool v_i = valid[0];
  for (int i = 0; i < n; ++i) {
    uint32_t rn[K];
    const int nx = i + 1 < n ? i + 1 : i;
    load_words<K>(rn, rows + size_t(nx) * WS + g * K);
    const bool v_nx = valid[nx];
    uint32_t hit = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) hit |= rw[k] & adm[k];
    const bool any = __syncthreads_or(hit != 0u);
    if (v_i && !any) {
      const int wi = i >> 5;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (wi == g * K + k) adm[k] |= 1u << (i & 31);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) rw[k] = rn[k];
    v_i = v_nx;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) store_bytes(admitted, g * K + k, adm[k], n);
}

template <int K>
int launch_greedy_scan(const uint32_t* rows, const uint8_t* valid, int n,
                       uint8_t* admitted, cudaStream_t s) {
  const size_t bytes =
      (size_t(4 * greedy_batch(K)) * kScanThreads * K + n / 32 + 2) *
      sizeof(uint32_t);
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(greedy_scan_kernel<K>), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  greedy_scan_kernel<K><<<1, kScanThreads, bytes, s>>>(rows, valid, n,
                                                        admitted);
  return static_cast<int>(cudaGetLastError());
}

// twopl_admit (kOcc false) and occ_admit: the pack, then the scan of the
// width admit_row_words(n) gives.
template <bool kOcc>
int greedy_admit(const void* raw, const void* ww, const void* valid, int n,
                 void* rows, void* admitted, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ws = admit_row_words(n);
  if (!ws) return static_cast<int>(cudaErrorInvalidValue);
  greedy_pack_kernel<kOcc><<<dim3(ws / 4, (n + 255) / 256), 256, 0, s>>>(
      static_cast<const uint8_t*>(raw), static_cast<const uint8_t*>(ww), n,
      ws, static_cast<uint32_t*>(rows));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint32_t* r = static_cast<const uint32_t*>(rows);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* a = static_cast<uint8_t*>(admitted);
  if (n <= kScanThreads * 32 * kScanMaxK) {
    switch (ws / kScanThreads) {
      case 1: return launch_greedy_scan<1>(r, v, n, a, s);
      case 2: return launch_greedy_scan<2>(r, v, n, a, s);
      default: return launch_greedy_scan<4>(r, v, n, a, s);
    }
  }
  switch (ws / kCtaThreads) {
    case 2: greedy_scan_cta_kernel<2><<<1, kCtaThreads, 0, s>>>(r, v, n, a);
      break;
    case 4: greedy_scan_cta_kernel<4><<<1, kCtaThreads, 0, s>>>(r, v, n, a);
      break;
    case 8: greedy_scan_cta_kernel<8><<<1, kCtaThreads, 0, s>>>(r, v, n, a);
      break;
    default: greedy_scan_cta_kernel<16><<<1, kCtaThreads, 0, s>>>(r, v, n, a);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest n each of the three scans takes.
int admit_max_n() { return kCtaThreads * 32 * kCtaMaxK; }

// Words of one packed row (and column) in the three scans' scratch: 128 K
// up to n = 16,384, 512 K on the CTA route above; 0 for an n they do not
// take.
int admit_row_words(int n) {
  if (n < 1 || n > admit_max_n()) return 0;
  const int nw = (n + 31) / 32;
  int k = 1;
  if (n <= kScanThreads * 32 * kScanMaxK) {
    while (kScanThreads * k < nw) k *= 2;
    return kScanThreads * k;
  }
  k = 2;
  while (kCtaThreads * k < nw) k *= 2;
  return kCtaThreads * k;
}

// Each returns the cudaError_t of its launches on `stream`.  bool arrays
// are one byte each: raw and prec [n, n], valid and the outputs [n].
// ppcc_admit's scratch: rows and cols int32[n, admit_row_words(n)],
// steps int32[n rounded up to 4], bits int32[3, admit_row_words(n)]; prec
// needs no zero fill.  twopl_admit's and occ_admit's scratch: rows
// int32[n, admit_row_words(n)], the packed rows their scan tests.
int ppcc_admit_launch(const void* raw, const void* valid, const void* seq,
                      int n, void* rows, void* cols, void* steps, void* bits,
                      void* admitted, void* preceding, void* preceded,
                      void* prec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ws = admit_row_words(n);
  if (!ws) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (n + 31) / 32;
  ppcc_pack_kernel<<<dim3(ws / 4, ws / 8), 256, 0, s>>>(
      static_cast<const uint8_t*>(raw), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(seq), n, nw, ws,
      static_cast<uint32_t*>(rows), static_cast<uint32_t*>(cols),
      static_cast<uint32_t*>(steps));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* a[] = {rows, cols, steps, bits, admitted, preceding, preceded};
  int rc;
  if (n <= kScanThreads * 32 * kScanMaxK) {
    switch (ws / kScanThreads) {
      case 1: rc = launch_scan<1>(a, n, ws, s); break;
      case 2: rc = launch_scan<2>(a, n, ws, s); break;
      default: rc = launch_scan<4>(a, n, ws, s); break;
    }
  } else {
    switch (ws / kCtaThreads) {
      case 2: rc = launch_scan_cta<2>(a, n, ws, s); break;
      case 4: rc = launch_scan_cta<4>(a, n, ws, s); break;
      case 8: rc = launch_scan_cta<8>(a, n, ws, s); break;
      default: rc = launch_scan_cta<16>(a, n, ws, s); break;
    }
  }
  if (rc) return rc;
  const int groups = (n + 15) / 16;
  const int threads = groups < 256 ? (groups + 31) / 32 * 32 : 256;
  ppcc_prec_kernel<<<n, threads, 0, s>>>(static_cast<const uint32_t*>(rows),
                                         static_cast<const uint32_t*>(bits),
                                         n, ws, static_cast<uint8_t*>(prec));
  return static_cast<int>(cudaGetLastError());
}

int twopl_admit_launch(const void* raw, const void* ww, const void* valid,
                       int n, void* rows, void* admitted, void* stream) {
  return greedy_admit<false>(raw, ww, valid, n, rows, admitted, stream);
}

int occ_admit_launch(const void* raw, const void* ww, const void* valid,
                     int n, void* rows, void* survivors, void* stream) {
  return greedy_admit<true>(raw, ww, valid, n, rows, survivors, stream);
}

}  // extern "C"
