// Pairwise conflict relations of the batch scheduler for Hopper (sm_90a):
// two routes, three entry points.
//
// Replaces the Pallas TPU kernels of repro/kernels/conflict.py:
//   conflict_matrix      (_conflict_kernel)            raw only
//   conflict_fused       (_conflict_fused_kernel)      raw, ww, rdeg, wdeg
//   conflict_fused_full  (_conflict_fused_full_kernel) + cdeg, diag_raw,
//                                                        diag_ww
// and computes exactly what repro_torch/kernels/ref.py's plain versions
// compute, for any n >= 1 and any W >= 0 (the Pallas version asks n to be
// a multiple of its 256-row block):
//   raw[i,j] = read row i meets write row j     ww[i,j] = write rows meet
//   rdeg[i]  = #{j : raw[i,j]}   cdeg[j] = #{i : raw[i,j]}
//   wdeg[i]  = #{j : ww[i,j]}    diag_raw[i] = raw[i,i], diag_ww[i] = ww[i,i]
// (degrees count the diagonal, as the reference's do).
//
// Bound.  At the scheduler's full width (n = 4,096 transactions, W = 1,024
// words) the bytes are two 16 MB word arrays in and two 16 MB bool
// matrices out: 0.020 ms at 3.35 TB/s.  The work depends on the bits.  The
// scheduler's sets are almost empty (16 read and ~8 write pages of 32,768
// a transaction), so through an inverted index the relations take (16 + 8)
// x 128 word ORs a row, 2,700x less than the dense form's one LOP3
// (acc |= a & b) per word pair and relation, 2 x 4,096^2 x 1,024 = 3.4e10,
// which alone takes ~2 ms at 64 such results per SM per clock.
//
// The gather route (conflict_fused, conflict_fused_full; sparse sets):
//   raw[i, :] = OR over pages p of read row i of writers[p, :]
//   ww[i, :]  = OR over pages p of write row i of writers[p, :]
//   cdeg[j]   = popcount(OR over p of write row j of readers[p, :])
// where writers (readers) is the page-major bitset uint32[32 W, ceil(n/32)]
// whose bit i of page p is set when transaction i writes (reads) p.  A
// call is one memset (the scratch head and the index) and four kernels:
//   1. conflict_count streams both word arrays, a warp 8 lines (32 words,
//      128 bytes) of a row with all its loads in flight, and writes per
//      row a bitmap of its nonzero words (bit t of nz[i][j]: word 32 j + t)
//      and the route count: the set bits the gather route visits (read +
//      write bits, the write bits twice for conflict_fused_full).  It also
//      zeroes the degree vectors.
//   2. conflict_scatter (gather route): a warp per row copies the row's
//      nonzero lines into shared memory, one cp.async a lane and line, all
//      in flight together, and sets its bit in the index with one atomicOr
//      per set bit (about 33,000 at the YCSB batch, 65,000 more for
//      readers).  A pass that transposes 32 x 32 blocks of words in
//      shared memory with ballots needs no zeroing and no atomics, but was
//      several times slower than the memset and the atomics on the H100.
//   3. conflict_kernel, the dense route: exits at once unless the count
//      chooses it (below).
//   4. conflict_gather (gather route): a warp per row and slab of 4,096
//      columns (128 index words, word q in lane q % 32) stages the row's
//      nonzero lines as above and ORs the index row of each set bit into
//      registers, the loads of 8 pages (4 with two indexes) in flight
//      before the first OR; rdeg, wdeg and cdeg are the warp's popcount
//      sums, added with one integer atomicAdd a slab, the diagonals are
//      bit i.  raw's row is stored before the write row's gathers start.
//      Each store of the unpacked bools writes 16 bytes a lane and 512
//      contiguous bytes a warp.
//   Every sum is an integer, so every output is bit-exact in any order.
//
// The dense route (conflict_matrix always; the fused entries when the sets
// are dense): a CTA owns a 64 x 64 tile of (i, j) pairs; 256 threads each
// hold 4 x 4 pairs of both relations in registers.  Per chunk of 32 words
// the CTA stages the tile's read_i, write_i and write_j rows in shared
// memory, word-major, so that each thread reads its four i words and four
// j words of one word index as two 16-byte loads and spends 32 LOP3 on
// them.  Each tile's row and column popcounts are summed in shared memory
// and added to the degree vectors with one integer atomicAdd per row or
// column.  Shared memory per CTA: 3 x 32 x 68 x 4 B = 26 KB.
//
// The route is chosen on the device, per call, from the count: the gather
// route visits count x ceil(n/32) index words, the dense route does
// 2 n^2 W LOP3, and the gather route runs when
//   count x ceil(n/32) x kGatherCost <= 2 n^2 W.
// No host read: the scatter, dense and gather kernels read the count, and
// those of the other route exit at once.  kGatherCost is set from
// chip_smoke.py's route sweep (phase 5: random sets at n = 4,096,
// W = 1,024, each route forced; NVIDIA H100 80GB HBM3, 700.00 W):
//   conflict_fused, read density 1/8 (25.2 M bits visited): gather
//   1.9320 ms, dense 3.0607 ms; 1/4 (50.3 M): gather 3.6712, dense 3.0630.
//   Interpolating the gather time linearly between them, the two cross
//   at 41.5 M bits, a cost of 6.5 LOP3 a gathered word.
//   conflict_fused_full, 1/8 (33.6 M): gather 2.9175, dense 2.9941; 1/4
//   (67.1 M): gather 5.5253, dense 2.9960: they cross at 34.6 M, 7.8.
// 6.75 lies between, nearer conflict_fused's (59 calls on the scheduler's
// path against 8), which puts the switch at 39.8 M bits there.  The YCSB
// batch visits 98,474 bits (0.25% of it), random sets of read density 1/2
// 2.5 (conflict_fused) and 3.4 times it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // i rows and j rows of one CTA
constexpr int kChunk = 32;           // words staged per step
constexpr int kStride = kTile + 4;   // padded shared row, 16-byte aligned
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 pairs each

constexpr unsigned kAll = 0xffffffffu;
constexpr int kLines = 8;            // count pass: lines of a warp's row
constexpr int kSlabWords = 128;      // gather: index words of one warp
constexpr int kPer = kSlabWords / 32;      // index words of one lane
constexpr int kRowWarps = 8;         // gather: rows of one CTA
constexpr double kGatherCost = 6.75; // dense LOP3 worth one gathered word
constexpr int kHeadWords = 4;        // scratch head: count (2), ran (2)

enum Mode { kMatrix = 0, kFused = 1, kFull = 2 };

// route: -1 chooses from the count, 0 forces the dense route, 1 the gather
// route (the tests hold both against the plain version at every input)
__device__ __forceinline__ bool gather_route(
    const unsigned long long* count, int n, int w, int route) {
  if (count == nullptr) return false;              // conflict_matrix
  if (route >= 0) return route == 1;
  const double visited = double(*count) * double((n + 31) / 32);
  return visited * kGatherCost <= 2.0 * double(n) * double(n) * double(w);
}

__device__ inline void store4(uint8_t* out, size_t at, int n, int j,
                              const bool v[4]) {
  // four consecutive bools of one row: one 4-byte store when aligned and
  // whole, else byte by byte up to the row's end
  if ((at & 3) == 0 && j + 3 < n) {
    const uint32_t packed = uint32_t(v[0]) | (uint32_t(v[1]) << 8) |
                            (uint32_t(v[2]) << 16) | (uint32_t(v[3]) << 24);
    *reinterpret_cast<uint32_t*>(out + at) = packed;
  } else {
    for (int b = 0; b < 4 && j + b < n; ++b) out[at + b] = v[b];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
conflict_kernel(const uint32_t* __restrict__ read,
                const uint32_t* __restrict__ write, int n, int w,
                const unsigned long long* __restrict__ count, int route,
                uint32_t* __restrict__ ran, uint8_t* __restrict__ raw,
                uint8_t* __restrict__ ww, int32_t* __restrict__ rdeg,
                int32_t* __restrict__ cdeg, int32_t* __restrict__ wdeg,
                uint8_t* __restrict__ diag_raw,
                uint8_t* __restrict__ diag_ww) {
  constexpr bool kWW = kMode != kMatrix;
  if (gather_route(count, n, w, route)) return;
  if (ran != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    ran[1] = 1u;
  __shared__ __align__(16) uint32_t s_ri[kChunk][kStride];
  __shared__ __align__(16) uint32_t s_wi[kWW ? kChunk : 1][kStride];
  __shared__ __align__(16) uint32_t s_wj[kChunk][kStride];
  __shared__ int32_t s_rrow[kTile], s_rcol[kTile], s_wrow[kTile];

  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  if (kWW && threadIdx.x < kTile) {
    s_rrow[threadIdx.x] = 0;
    s_rcol[threadIdx.x] = 0;
    s_wrow[threadIdx.x] = 0;
  }
  __syncthreads();

  uint32_t acc_r[4][4], acc_w[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc_r[a][b] = acc_w[a][b] = 0u;

  for (int k0 = 0; k0 < w; k0 += kChunk) {
    const int kc = min(kChunk, w - k0);
    // a warp reads 32 consecutive words of one row (128 B, coalesced);
    // rows past n read as empty
    for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
      const int row = idx / kChunk, kk = idx % kChunk;
      if (kk >= kc) continue;
      const int gi = i0 + row, gj = j0 + row;
      const size_t oi = size_t(gi) * w + k0 + kk;
      const size_t oj = size_t(gj) * w + k0 + kk;
      s_ri[kk][row] = gi < n ? read[oi] : 0u;
      if (kWW) s_wi[kk][row] = gi < n ? write[oi] : 0u;
      s_wj[kk][row] = gj < n ? write[oj] : 0u;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const uint4 r4 = *reinterpret_cast<const uint4*>(&s_ri[kk][ty * 4]);
      const uint4 j4 = *reinterpret_cast<const uint4*>(&s_wj[kk][tx * 4]);
      const uint32_t ri[4] = {r4.x, r4.y, r4.z, r4.w};
      const uint32_t wj[4] = {j4.x, j4.y, j4.z, j4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc_r[a][b] |= ri[a] & wj[b];
      if (kWW) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(&s_wi[kk][ty * 4]);
        const uint32_t wi[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc_w[a][b] |= wi[a] & wj[b];
      }
    }
    __syncthreads();
  }

  int col_r[4] = {0, 0, 0, 0};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= n) continue;
    const int j = j0 + tx * 4;
    bool vr[4], vw[4];
    int row_r = 0, row_w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool inside = j + b < n;
      vr[b] = inside && acc_r[a][b] != 0u;
      vw[b] = inside && acc_w[a][b] != 0u;
      row_r += vr[b];
      row_w += vw[b];
      col_r[b] += vr[b];
      if (kMode == kFull && i == j + b) {
        diag_raw[i] = vr[b];
        diag_ww[i] = vw[b];
      }
    }
    if (j < n) {
      const size_t at = size_t(i) * n + j;
      store4(raw, at, n, j, vr);
      if (kWW) store4(ww, at, n, j, vw);
    }
    if (kWW) {
      if (row_r) atomicAdd(&s_rrow[ty * 4 + a], row_r);
      if (row_w) atomicAdd(&s_wrow[ty * 4 + a], row_w);
    }
  }
  if (kMode == kFull) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (col_r[b]) atomicAdd(&s_rcol[tx * 4 + b], col_r[b]);
  }
  if (kWW) {
    __syncthreads();
    const int t = threadIdx.x;
    if (t < kTile) {
      if (i0 + t < n && s_rrow[t]) atomicAdd(&rdeg[i0 + t], s_rrow[t]);
      if (i0 + t < n && s_wrow[t]) atomicAdd(&wdeg[i0 + t], s_wrow[t]);
      if (kMode == kFull && j0 + t < n && s_rcol[t])
        atomicAdd(&cdeg[j0 + t], s_rcol[t]);
    }
  }
}

// ---- the gather route ----

// The count pass.  A warp takes kLines lines (32 words, 128 bytes) of one
// row of both word arrays, all its loads in flight together: nz[i][j] has
// bit t set when word 32 j + t of row i is nonzero, and the count is the
// number of index rows the gather will OR: read bits + write bits, and the
// write bits once more in kFull (cdeg).  It also zeroes the degree
// vectors, which the relation kernels add into.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
conflict_count(const uint32_t* __restrict__ read,
               const uint32_t* __restrict__ write, int n, int w, int lw,
               uint32_t* __restrict__ nz_w, uint32_t* __restrict__ nz_r,
               unsigned long long* __restrict__ count,
               int32_t* __restrict__ rdeg, int32_t* __restrict__ cdeg,
               int32_t* __restrict__ wdeg) {
  __shared__ unsigned s_count;
  const int t = threadIdx.x, lane = t & 31;
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + t;
  if (gid < n) {
    rdeg[gid] = 0;
    wdeg[gid] = 0;
    if (kMode == kFull) cdeg[gid] = 0;
  }
  if (t == 0) s_count = 0u;
  __syncthreads();
  const int per_row = (lw + kLines - 1) / kLines;
  const long long item = gid >> 5;
  unsigned bits = 0u;
  if (item < static_cast<long long>(n) * per_row) {
    const int i = static_cast<int>(item / per_row);
    const int j0 = static_cast<int>(item % per_row) * kLines;
    const uint32_t* r = read + size_t(i) * w;
    const uint32_t* wr = write + size_t(i) * w;
    uint32_t xr[kLines], xw[kLines];
#pragma unroll
    for (int c = 0; c < kLines; ++c) {
      const int k = 32 * (j0 + c) + lane;
      xr[c] = k < w ? r[k] : 0u;
      xw[c] = k < w ? wr[k] : 0u;
    }
    uint32_t mr = 0u, mw = 0u;
#pragma unroll
    for (int c = 0; c < kLines; ++c) {
      const uint32_t br = __ballot_sync(kAll, xr[c] != 0u);
      const uint32_t bw = __ballot_sync(kAll, xw[c] != 0u);
      if (lane == c) {
        mr = br;
        mw = bw;
      }
      bits += __popc(xr[c]) + (kMode == kFull ? 2u : 1u) * __popc(xw[c]);
    }
    if (lane < kLines && j0 + lane < lw) {
      nz_r[size_t(i) * lw + j0 + lane] = mr;
      nz_w[size_t(i) * lw + j0 + lane] = mw;
    }
  }
  bits = __reduce_add_sync(kAll, bits);
  if (lane == 0 && bits) atomicAdd(&s_count, bits);
  __syncthreads();
  if (t == 0 && s_count)
    atomicAdd(count, static_cast<unsigned long long>(s_count));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          bool inside) {
  // 4 bytes into shared memory; zeros when the source is past the row
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(inside ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The nonzero lines j0 .. j0 + 31 of one row, from its nz bitmap: the
// warp copies each one into line[slot] (slots in the order of the live
// lanes) with one cp.async a lane, all in flight together.  Returns the
// lane's bitmap word; *live gets the ballot of the live lines.
__device__ __forceinline__ uint32_t stage_lines(
    const uint32_t* __restrict__ row, const uint32_t* __restrict__ nz, int w,
    int lw, int j0, int lane, uint32_t (*line)[32], unsigned* live) {
  const uint32_t mask = j0 + lane < lw ? nz[j0 + lane] : 0u;
  *live = __ballot_sync(kAll, mask != 0u);
  int slot = 0;
  for (unsigned l = *live; l; l &= l - 1, ++slot) {
    const int k = 32 * (j0 + __ffs(l) - 1) + lane;
    cp_async4(&line[slot][lane], row + (k < w ? k : 0), k < w);
  }
  cp_async_wait_all();
  __syncwarp();
  return mask;
}

// The scatter pass (gather route only): writers (and readers in kFull)
// from the set bits of each row, a warp per row, one atomicOr a bit; the
// launcher has zeroed both.
template <int kMode>
__global__ void __launch_bounds__(kRowWarps * 32)
conflict_scatter(const uint32_t* __restrict__ read,
                 const uint32_t* __restrict__ write, int n, int w, int nw,
                 int lw, const uint32_t* __restrict__ nz_w,
                 const uint32_t* __restrict__ nz_r,
                 const unsigned long long* __restrict__ count, int route,
                 uint32_t* __restrict__ writers,
                 uint32_t* __restrict__ readers) {
  __shared__ uint32_t s_line[kRowWarps][32][32];              // 32 KB
  if (!gather_route(count, n, w, route)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRowWarps + warp;
  if (i >= n) return;
  const uint32_t bit = 1u << (i & 31);
#pragma unroll 1
  for (int plane = 0; plane < (kMode == kFull ? 2 : 1); ++plane) {
    const uint32_t* row = (plane == 0 ? write : read) + size_t(i) * w;
    const uint32_t* nz = (plane == 0 ? nz_w : nz_r) + size_t(i) * lw;
    uint32_t* index = (plane == 0 ? writers : readers) + (i >> 5);
    for (int j0 = 0; j0 < lw; j0 += 32) {
      unsigned live;
      stage_lines(row, nz, w, lw, j0, lane, s_line[warp], &live);
      int slot = 0;
      for (unsigned l = live; l; l &= l - 1, ++slot) {
        const size_t page0 = size_t(32) * (32 * (j0 + __ffs(l) - 1) + lane);
        for (uint32_t b = s_line[warp][slot][lane]; b; b &= b - 1)
          atomicOr(index + (page0 + __ffs(b) - 1) * nw, bit);
      }
      __syncwarp();
    }
  }
}

// Pages whose loads the gather keeps in flight at once: 8 with one index,
// 4 with two (the same registers).
template <bool kTwo>
__host__ __device__ constexpr int queue_len() { return kTwo ? 4 : 8; }

// OR the index rows of the queued pages (q[e] for e < cnt, as offsets of
// the lane's first word) into the lane's accumulators: every load issued
// before the first OR.
template <bool kTwo, int kQ = queue_len<kTwo>()>
__device__ __forceinline__ void gather_flush(
    const size_t (&q)[kQ], int cnt, const uint32_t* __restrict__ ia,
    const uint32_t* __restrict__ ib, int nw, int s0, int lane,
    uint32_t (&acc_a)[kPer], uint32_t (&acc_b)[kPer]) {
  uint32_t va[kQ][kPer], vb[kQ][kPer];
#pragma unroll
  for (int e = 0; e < kQ; ++e)
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const bool ok = e < cnt && s0 + lane + 32 * m < nw;
      va[e][m] = ok ? ia[q[e] + 32 * m] : 0u;
      vb[e][m] = (kTwo && ok) ? ib[q[e] + 32 * m] : 0u;
    }
#pragma unroll
  for (int e = 0; e < kQ; ++e)
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      acc_a[m] |= va[e][m];
      if (kTwo) acc_b[m] |= vb[e][m];
    }
}

// OR the index rows of every set bit of one row's words into the lane's
// kPer accumulators (index words s0 + lane + 32 m of the slab); kTwo also
// ORs the second index into acc_b.  The row's nonzero lines come from its
// nz bitmap: the warp copies each one (128 bytes) into `line` with one
// cp.async a lane, all in flight together, then walks their set bits, the
// pages queued kQ at a time.
template <bool kTwo>
__device__ __forceinline__ void gather_row(
    const uint32_t* __restrict__ row, const uint32_t* __restrict__ nz,
    int w, int lw, int nw, int s0, int lane, uint32_t (*line)[32],
    const uint32_t* __restrict__ ia, const uint32_t* __restrict__ ib,
    uint32_t (&acc_a)[kPer], uint32_t (&acc_b)[kPer]) {
  constexpr int kQ = queue_len<kTwo>();
  size_t q[kQ];
  int cnt = 0;
  for (int j0 = 0; j0 < lw; j0 += 32) {
    unsigned live;
    const uint32_t mask = stage_lines(row, nz, w, lw, j0, lane, line, &live);
    int slot = 0;
    for (unsigned l = live; l; l &= l - 1, ++slot) {
      const int src = __ffs(l) - 1;
      const uint32_t x = line[slot][lane];
      const size_t page0 = size_t(32) * (32 * (j0 + src));
      for (uint32_t words = __shfl_sync(kAll, mask, src); words;
           words &= words - 1) {
        const int t = __ffs(words) - 1;
        const size_t base = (page0 + size_t(32) * t) * nw + s0 + lane;
        for (uint32_t b = __shfl_sync(kAll, x, t); b; b &= b - 1) {
#pragma unroll
          for (int e = kQ - 1; e > 0; --e) q[e] = q[e - 1];
          q[0] = base + size_t(__ffs(b) - 1) * nw;
          if (++cnt == kQ) {
            gather_flush<kTwo>(q, kQ, ia, ib, nw, s0, lane, acc_a, acc_b);
            cnt = 0;
          }
        }
      }
    }
    __syncwarp();
  }
  gather_flush<kTwo>(q, cnt, ia, ib, nw, s0, lane, acc_a, acc_b);
}

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  // bits 0..3 -> the low bit of bytes 0..3 (shifts 0, 7, 14, 21 overlap
  // nowhere, so the product carries nothing)
  return (nibble * 0x00204081u) & 0x01010101u;
}

// The slab's columns of one row as bools.  A warp store covers 512
// contiguous bytes: lane l writes 16 bytes, half l % 2 of index word
// 16 h + l / 2 of a group of 32.
__device__ __forceinline__ void store_bools(uint8_t* __restrict__ row,
                                            int n, int nw, int s0, int lane,
                                            const uint32_t (&acc)[kPer]) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (s0 + 32 * m >= nw) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = 16 * h + (lane >> 1);
      const uint32_t x = __shfl_sync(kAll, acc[m], src);
      const int g = s0 + 32 * m + src;
      if (g >= nw) continue;
      const int col = 32 * g + 16 * (lane & 1);
      const uint32_t v = x >> (16 * (lane & 1));
      uint8_t* out = row + col;
      const uintptr_t at = reinterpret_cast<uintptr_t>(out);
      if (col + 16 <= n && (at & 15) == 0) {
        *reinterpret_cast<uint4*>(out) =
            make_uint4(spread4(v & 15u), spread4((v >> 4) & 15u),
                       spread4((v >> 8) & 15u), spread4((v >> 12) & 15u));
      } else if (col + 16 <= n && (at & 3) == 0) {
        uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
        for (int q = 0; q < 4; ++q) o4[q] = spread4((v >> (4 * q)) & 15u);
      } else {
        for (int b = 0; b < 16 && col + b < n; ++b) out[b] = (v >> b) & 1u;
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kRowWarps * 32)
conflict_gather(const uint32_t* __restrict__ read,
                const uint32_t* __restrict__ write, int n, int w, int nw,
                int lw, const uint32_t* __restrict__ writers,
                const uint32_t* __restrict__ readers,
                const uint32_t* __restrict__ nz_w,
                const uint32_t* __restrict__ nz_r,
                const unsigned long long* __restrict__ count, int route,
                uint32_t* __restrict__ ran, uint8_t* __restrict__ raw,
                uint8_t* __restrict__ ww, int32_t* __restrict__ rdeg,
                int32_t* __restrict__ cdeg, int32_t* __restrict__ wdeg,
                uint8_t* __restrict__ diag_raw,
                uint8_t* __restrict__ diag_ww) {
  constexpr bool kCols = kMode == kFull;
  __shared__ uint32_t s_line[kRowWarps][32][32];              // 32 KB
  if (!gather_route(count, n, w, route)) return;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) ran[0] = 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRowWarps + warp;
  if (i >= n) return;
  const int s0 = blockIdx.y * kSlabWords;
  uint32_t acc_r[kPer], acc_w[kPer], acc_c[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) acc_r[m] = acc_w[m] = acc_c[m] = 0u;
  // raw first: its stores drain while the write row's gathers wait
  gather_row<false>(read + size_t(i) * w, nz_r + size_t(i) * lw, w, lw, nw,
                    s0, lane, s_line[warp], writers, nullptr, acc_r, acc_c);
  int r_sum = 0;
#pragma unroll
  for (int m = 0; m < kPer; ++m) r_sum += __popc(acc_r[m]);
  r_sum = __reduce_add_sync(kAll, r_sum);
  if (lane == 0 && r_sum) atomicAdd(&rdeg[i], r_sum);
  store_bools(raw + size_t(i) * n, n, nw, s0, lane, acc_r);
  gather_row<kCols>(write + size_t(i) * w, nz_w + size_t(i) * lw, w, lw, nw,
                    s0, lane, s_line[warp], writers, readers, acc_w, acc_c);
  int w_sum = 0, c_sum = 0;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    w_sum += __popc(acc_w[m]);
    c_sum += __popc(acc_c[m]);
  }
  w_sum = __reduce_add_sync(kAll, w_sum);
  if (kCols) c_sum = __reduce_add_sync(kAll, c_sum);
  if (lane == 0) {
    if (w_sum) atomicAdd(&wdeg[i], w_sum);
    if (kCols && c_sum) atomicAdd(&cdeg[i], c_sum);
  }
  if (kCols) {
    const int off = (i >> 5) - s0;   // index word of column i in the slab
    if (off >= 0 && off < kSlabWords && lane == (off & 31)) {
      uint32_t r = 0u, x = 0u;
#pragma unroll
      for (int m = 0; m < kPer; ++m)
        if (m == (off >> 5)) {
          r = acc_r[m];
          x = acc_w[m];
        }
      diag_raw[i] = (r >> (i & 31)) & 1u;
      diag_ww[i] = (x >> (i & 31)) & 1u;
    }
  }
  store_bools(ww + size_t(i) * n, n, nw, s0, lane, acc_w);
}

template <int kMode>
cudaError_t launch_fused(const uint32_t* r, const uint32_t* wr, int n,
                         int w, uint32_t* index, int route, uint8_t* o_raw,
                         uint8_t* o_ww, int32_t* o_rdeg, int32_t* o_cdeg,
                         int32_t* o_wdeg, uint8_t* o_dr, uint8_t* o_dw,
                         cudaStream_t s) {
  const int nw = (n + 31) / 32, lw = (w + 31) / 32;
  const size_t plane = size_t(32) * w * nw, bitmap = size_t(n) * lw;
  const int planes = kMode == kFull ? 2 : 1;
  unsigned long long* count = reinterpret_cast<unsigned long long*>(index);
  uint32_t* ran = index + 2;
  uint32_t* writers = index + kHeadWords;
  uint32_t* readers = kMode == kFull ? writers + plane : nullptr;
  uint32_t* nz_w = writers + planes * plane;
  uint32_t* nz_r = nz_w + bitmap;
  cudaError_t err = cudaMemsetAsync(index, 0, 4 * (kHeadWords +
                                                   planes * plane), s);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(n) *
                          ((lw + kLines - 1) / kLines);
  const long long ctas = (items + 7) / 8 > (n + kThreads - 1) / kThreads
                             ? (items + 7) / 8
                             : (n + kThreads - 1) / kThreads;
  conflict_count<kMode><<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
      r, wr, n, w, lw, nz_w, nz_r, count, o_rdeg, o_cdeg, o_wdeg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int rows = (n + kRowWarps - 1) / kRowWarps;
  conflict_scatter<kMode><<<rows, kRowWarps * 32, 0, s>>>(
      r, wr, n, w, nw, lw, nz_w, nz_r, count, route, writers, readers);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (n + kTile - 1) / kTile;
  conflict_kernel<kMode><<<dim3(tiles, tiles), kThreads, 0, s>>>(
      r, wr, n, w, count, route, ran, o_raw, o_ww, o_rdeg, o_cdeg, o_wdeg,
      o_dr, o_dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conflict_gather<kMode><<<dim3(rows, (nw + kSlabWords - 1) / kSlabWords),
                           kRowWarps * 32, 0, s>>>(
      r, wr, n, w, nw, lw, writers, readers, nz_w, nz_r, count, route, ran,
      o_raw, o_ww, o_rdeg, o_cdeg, o_wdeg, o_dr, o_dw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 32-bit words of the scratch that conflict_launch takes for `mode`: a
// head of four words (the 64-bit count; ran[0] = 1 when the gather route
// ran, ran[1] = 1 when the dense route did), then writers (and readers in
// mode 2), each uint32[32 w, ceil(n / 32)].  Mode 0 takes none.
long long conflict_scratch_words(int mode, int n, int w) {
  if (mode == kMatrix) return 0;
  const long long plane = 32LL * w * ((n + 31) / 32);
  const long long bitmap = 1LL * n * ((w + 31) / 32);
  return kHeadWords + (mode == kFull ? 2 : 1) * plane + 2 * bitmap;
}

// The route rule's constant, for the tests that build inputs on both
// sides of the switch.
double conflict_gather_cost() { return kGatherCost; }

// One call on `stream`; returns the first cudaError_t of its launches.
// mode 0: raw only, the dense route; 1: raw, ww, rdeg, wdeg; 2: all seven
// outputs; modes 1 and 2 choose their route on the device (route -1) or
// take the one forced (0 dense, 1 gather).  Words uint32[n, w]; bool
// outputs 1 byte each; degree vectors int32[n] (zeroed here); `index` the
// scratch of conflict_scratch_words(mode, n, w) words, 16-byte aligned.
// Unused outputs may be null.
int conflict_launch(int mode, const void* read, const void* write, int n,
                    int w, void* index, int route, void* raw, void* ww,
                    void* rdeg, void* cdeg, void* wdeg, void* diag_raw,
                    void* diag_ww, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* r = static_cast<const uint32_t*>(read);
  const uint32_t* wr = static_cast<const uint32_t*>(write);
  uint32_t* idx = static_cast<uint32_t*>(index);
  uint8_t* o_raw = static_cast<uint8_t*>(raw);
  uint8_t* o_ww = static_cast<uint8_t*>(ww);
  int32_t* o_rdeg = static_cast<int32_t*>(rdeg);
  int32_t* o_cdeg = static_cast<int32_t*>(cdeg);
  int32_t* o_wdeg = static_cast<int32_t*>(wdeg);
  uint8_t* o_dr = static_cast<uint8_t*>(diag_raw);
  uint8_t* o_dw = static_cast<uint8_t*>(diag_ww);
  if (route < -1 || route > 1) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kMatrix) {
    const int tiles = (n + kTile - 1) / kTile;
    conflict_kernel<kMatrix><<<dim3(tiles, tiles), kThreads, 0, s>>>(
        r, wr, n, w, nullptr, -1, nullptr, o_raw, o_ww, o_rdeg, o_cdeg,
        o_wdeg, o_dr, o_dw);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == kFused)
    return static_cast<int>(launch_fused<kFused>(
        r, wr, n, w, idx, route, o_raw, o_ww, o_rdeg, o_cdeg, o_wdeg, o_dr,
        o_dw, s));
  if (mode == kFull)
    return static_cast<int>(launch_fused<kFull>(
        r, wr, n, w, idx, route, o_raw, o_ww, o_rdeg, o_cdeg, o_wdeg, o_dr,
        o_dw, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
