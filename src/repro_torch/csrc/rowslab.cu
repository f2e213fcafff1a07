// Row-slab kernels for Hopper (sm_90a): the delta-maintained relations of
// every lane of a fleet.  Two entry points share the staging of a lane's
// words and op data: the drain, which the engine runs once per PPCC
// iteration, and the slab, the counterpart of the reference's
// rowslab(..., slab, valid) API.
//
// Replaces repro/kernels/megastep.py::_rowslab_kernel, the Pallas TPU
// kernel behind repro.kernels.megastep.rowslab, which the reference's
// jaxsim._delta_update launches once per K dirty slots in a while_loop.
// With party_j[k] = k == j, or active[k] and (is_write[j] ? R : W)[j,k],
// where W/R is slot j's fresh writers_at/readers_at row (bit item_j of
// write/read row k) when j is fresh, else its carried row:
//
// The drain (rowslab_drain_launch) computes exactly what
// repro_torch.kernels.ref.rowslab_drain_ref computes: with every slot of
// the lane's dirty mask fresh,
//   writers_at'[r,:] (readers_at') = fresh row of r if r is dirty, else the
//                                    carried row
//   dep'[r,j] = r != j and (party_r meets party_j, or item_r == item_j and
//               either op writes), if r or j is dirty; else carried
//   ww'[r,j]  = r != j and write rows r, j meet, if r or j is dirty; else
//               carried
// which is where the reference's chunked drain ends: each later chunk's
// mirrored columns repair the entries between its slots and earlier ones.
// The tables are written out of place: the engine's loop keeps a finished
// lane's parent state, so the carried tables are only read.
//
// The slab (rowslab_launch) computes what
// repro_torch.kernels.ref.rowslab_ref computes.  With sl[s] =
// clamp(slab[s], 0, n-1), x_s = item[sl[s]], and the valid slab ids fresh:
//   wat_rows[s,k] = valid[s] and bit x_s of write row k  (rat_rows: read)
//   dep_rows[s,j] = valid[s] and sl[s] != j and (party_{sl[s]} meets
//                   party_j, or x_s == item_j and either op writes)
//   ww_rows[s,j]  = valid[s] and sl[s] != j and write rows sl[s], j meet
// An invalid entry aliases slot n-1 but never substitutes a carried row,
// and its output rows are zero.
//
// Bound of the drain.  At the main path's shape (168 lanes, n = 160 slots,
// W = 16 words) a launch must write the four n x n tables, 17.2 MB, and
// read the carried entries it keeps: all four tables but the dirty rows
// and, of dep and ww, the dirty columns, at most 17.2 MB.  With the op
// data (0.19 MB) and the words of the lanes that have a dirty slot (at most
// 3.44 MB), that is at most 38.0 MB, 11.4 us at 3.35 TB/s; chip_smoke.py
// counts what the run's dirty masks need.  The logic (dirty rows and
// columns x n pairs of 5 party words and 16 write words) is far below the
// card's integer rate: bytes bound it.  The chunked drain it replaces made
// ceil(n/K) = 4 slab launches of 0.0762 ms each, plus a padded copy of the
// tables and two scatters per launch.
//
// Design of the drain.  CTA (part, lane) of 256 threads writes 56 rows of
// its lane, so a launch is 3 x 168 CTAs at the main shape, one wave at up
// to five CTAs an SM (38.6 KB of shared memory each), where one CTA per
// lane would leave each SM one or two lanes' copy to stream alone.  The
// lane's dirty mask is packed to bits with __ballot_sync in shared
// memory; a lane with no dirty slot skips the rest and copies.  Otherwise
// the CTA loads the lane's read and write words into shared memory (rows
// at an odd stride so that 32 threads reading 32 rows hit 32 banks) and
// packs the n party rows to bits: a clean slot's from its carried
// readers_at or writers_at row, read with coalesced 4-byte loads, eight
// in flight a thread, and OR-ed into the bits with shared atomics; a
// dirty slot's from the words, one warp per row.  Then it packs the fresh
// dep, ww, writers_at and readers_at rows of every dirty slot (dep as an
// AND over ceil(n/32) party words, ww over W write words), one warp per
// row.  Every part of a lane repeats this small step, from L2 after the
// first.  Last, each thread takes 4 columns of a row as one 32-bit word
// (1 where n % 4 != 0), four such items in flight: a dirty row is read
// from its fresh bits, a clean row is copied with its dirty columns taken
// from the dirty slots' fresh rows (dep and ww are symmetric).
// Consecutive threads write consecutive words of a row.  The phases of a
// CTA run one after another, so the copy's loads are in flight for only
// part of its life: the launch runs at about five times its byte bound
// (PERF.md).  Footprint (drain_layout() below): (2 n (W|1) + (5 n + 1)
// ceil(n/32) + n) x 4 + n bytes, 38,580 B at the main shape.
//
// Design of the slab.  One CTA per lane, 256 threads.  The lane's words
// are staged as above; a map from slot to "is a valid slab id" decides,
// per column slot, between the fresh row and the carried one (the tables
// may be strided views, rows contiguous).  The K slab party rows and the n
// column party rows are packed to bits with __ballot_sync.  Each warp owns
// whole output rows and its threads walk the columns.  Footprint (layout()
// below): (2 n (W|1) + (n + K) ceil(n/32) + n + K) x 4 + n + K bytes,
// 26,760 B at n = 160, K = 40.  Either wrapper raises beyond the card's
// 227 KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kIsWrite = 1, kActive = 2, kFresh = 4;

struct Layout {
  int stride;    // words of one set row in shared memory (odd)
  int pwords;    // party words per row: ceil(n / 32)
  size_t bytes;  // dynamic shared memory of one CTA
};

__host__ __device__ inline Layout layout(int n, int w, int k) {
  Layout l;
  l.stride = w | 1;
  l.pwords = (n + 31) / 32;
  l.bytes = (size_t(2) * n * l.stride + size_t(n + k) * l.pwords + n + k) *
                4 +
            size_t(n) + k;
  return l;
}

// The lane's read and write words into shared rows of `stride` words,
// kBatch loads of each in flight per thread.
constexpr int kBatch = 8;
__device__ __forceinline__ void stage_words(uint32_t* s_read,
                                            uint32_t* s_write,
                                            const uint32_t* read,
                                            const uint32_t* write, int n,
                                            int w, int stride) {
  for (int t0 = threadIdx.x; t0 < n * w; t0 += kBatch * blockDim.x) {
    uint32_t a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < n * w) {
        a[u] = read[t];
        b[u] = write[t];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < n * w) {
        const int r = t / w, c = t - r * w;
        s_read[r * stride + c] = a[u];
        s_write[r * stride + c] = b[u];
      }
    }
  }
}

// The lane's items and flags (kFresh from `fresh`, if given).
__device__ __forceinline__ void stage_ops(int32_t* s_item, uint8_t* s_flag,
                                          const int32_t* item,
                                          const uint8_t* is_write,
                                          const uint8_t* active,
                                          const uint8_t* fresh, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    s_item[t] = item[t];
    s_flag[t] = (is_write[t] ? kIsWrite : 0) | (active[t] ? kActive : 0) |
                (fresh && fresh[t] ? kFresh : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
rowslab_kernel(const uint32_t* __restrict__ read,
               const uint32_t* __restrict__ write,
               const uint8_t* __restrict__ wat_in,
               const uint8_t* __restrict__ rat_in,
               const int32_t* __restrict__ item,
               const uint8_t* __restrict__ is_write,
               const uint8_t* __restrict__ active,
               const int32_t* __restrict__ slab,
               const uint8_t* __restrict__ valid,
               uint8_t* __restrict__ dep, uint8_t* __restrict__ ww,
               uint8_t* __restrict__ wat, uint8_t* __restrict__ rat, int n,
               int w, int k, long long t_lane, long long t_row) {
  extern __shared__ uint32_t smem[];
  const Layout lay = layout(n, w, k);
  uint32_t* s_read = smem;
  uint32_t* s_write = s_read + size_t(n) * lay.stride;
  uint32_t* s_pcol = s_write + size_t(n) * lay.stride;   // n party rows
  uint32_t* s_pslab = s_pcol + size_t(n) * lay.pwords;   // k party rows
  int32_t* s_item = reinterpret_cast<int32_t*>(s_pslab + size_t(k) *
                                               lay.pwords);
  int32_t* s_sl = s_item + n;                            // clamped ids
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_sl + k);
  uint8_t* s_valid = s_flag + n;

  const int lane = blockIdx.x;  // fleet lane
  const size_t wbase = size_t(lane) * n * w;
  const size_t vbase = size_t(lane) * n;
  const long long mbase = lane * t_lane;  // carried tables: strided rows
  const size_t kbase = size_t(lane) * k;
  const size_t obase = size_t(lane) * k * n;

  stage_words(s_read, s_write, read + wbase, write + wbase, n, w, lay.stride);
  stage_ops(s_item, s_flag, item + vbase, is_write + vbase, active + vbase,
            nullptr, n);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const int id = slab[kbase + t];
    s_sl[t] = id < 0 ? 0 : (id > n - 1 ? n - 1 : id);
    s_valid[t] = valid[kbase + t];
  }
  __syncthreads();
  // mark the slots that are valid slab ids: each thread owns its slots
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    bool fresh = false;
    for (int s = 0; s < k; ++s) fresh = fresh || (s_valid[s] && s_sl[s] == t);
    if (fresh) s_flag[t] |= kFresh;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;

  // Phase 1: party rows of the n column slots, packed to bits.
  for (int j = warp; j < n; j += warps) {
    const int x = s_item[j];
    const int xw = x >> 5;
    const uint32_t xb = uint32_t(x & 31);
    const uint8_t fj = s_flag[j];
    const bool jw = fj & kIsWrite;
    const uint32_t* words = jw ? s_read : s_write;
    const uint8_t* carried = (jw ? rat_in : wat_in) + mbase + j * t_row;
    for (int c = 0; c < lay.pwords; ++c) {
      const int kk = c * 32 + tid;
      bool p = false;
      if (kk < n) {
        const bool at = (fj & kFresh)
                            ? ((words[kk * lay.stride + xw] >> xb) & 1u)
                            : carried[kk] != 0;
        p = (kk == j) || (at && (s_flag[kk] & kActive));
      }
      const uint32_t bits = __ballot_sync(kFull, p);
      if (tid == 0) s_pcol[j * lay.pwords + c] = bits;
    }
  }

  // Phase 2: fresh op-table rows of the slab slots (written out) and their
  // party rows, packed to bits.
  for (int s = warp; s < k; s += warps) {
    const int i = s_sl[s];
    const int x = s_item[i];
    const int xw = x >> 5;
    const uint32_t xb = uint32_t(x & 31);
    const bool iw = s_flag[i] & kIsWrite;
    const bool v = s_valid[s];
    for (int c = 0; c < lay.pwords; ++c) {
      const int kk = c * 32 + tid;
      bool p = false;
      if (kk < n) {
        const bool w_at = (s_write[kk * lay.stride + xw] >> xb) & 1u;
        const bool r_at = (s_read[kk * lay.stride + xw] >> xb) & 1u;
        wat[obase + size_t(s) * n + kk] = v && w_at;
        rat[obase + size_t(s) * n + kk] = v && r_at;
        p = (kk == i) || ((iw ? r_at : w_at) && (s_flag[kk] & kActive));
      }
      const uint32_t bits = __ballot_sync(kFull, p);
      if (tid == 0) s_pslab[s * lay.pwords + c] = bits;
    }
  }
  __syncthreads();

  // Phase 3: dep and ww rows of the slab.
  for (int s = warp; s < k; s += warps) {
    const int i = s_sl[s];
    const int x = s_item[i];
    const bool iw = s_flag[i] & kIsWrite;
    const bool v = s_valid[s];
    const uint32_t* ps = s_pslab + s * lay.pwords;
    const uint32_t* wi = s_write + i * lay.stride;
    for (int j = tid; j < n; j += 32) {
      bool d = false, o = false;
      if (v && j != i) {
        const uint32_t* pj = s_pcol + j * lay.pwords;
        uint32_t meet = 0;
        for (int q = 0; q < lay.pwords; ++q) meet |= ps[q] & pj[q];
        const bool same =
            (s_item[j] == x) && (iw || (s_flag[j] & kIsWrite));
        d = (meet != 0) || same;
        const uint32_t* wj = s_write + j * lay.stride;
        uint32_t wmeet = 0;
        for (int q = 0; q < w; ++q) wmeet |= wi[q] & wj[q];
        o = wmeet != 0;
      }
      dep[obase + size_t(s) * n + j] = d;
      ww[obase + size_t(s) * n + j] = o;
    }
  }
}

// ---- the drain: every dirty slot of every lane, one launch ----

constexpr int kDrainRows = 56;   // rows of a lane per CTA

struct DrainLayout {
  int stride;    // words of one set row in shared memory (odd)
  int pwords;    // bit words per row: ceil(n / 32)
  size_t bytes;  // dynamic shared memory of one CTA
};

// words (read, write), party bits, fresh bits of dep, ww, writers_at and
// readers_at, the dirty mask and items as 32-bit words; then the flags
__host__ __device__ inline DrainLayout drain_layout(int n, int w) {
  DrainLayout l;
  l.stride = w | 1;
  l.pwords = (n + 31) / 32;
  l.bytes = (size_t(2) * n * l.stride + size_t(5 * n + 1) * l.pwords + n) *
                4 +
            size_t(n);
  return l;
}

// kQ consecutive bools as one word (kQ = 4, aligned) or one byte (kQ = 1)
template <int kQ>
__device__ __forceinline__ uint32_t load_q(const uint8_t* p) {
  return kQ == 4 ? *reinterpret_cast<const uint32_t*>(p) : uint32_t(*p);
}
template <int kQ>
__device__ __forceinline__ void store_q(uint8_t* p, uint32_t v) {
  if (kQ == 4)
    *reinterpret_cast<uint32_t*>(p) = v;
  else
    *p = static_cast<uint8_t>(v);
}

// kQ bits of a packed row, from column j0, as kQ bytes
template <int kQ>
__device__ __forceinline__ uint32_t bytes_of(const uint32_t* bits, int j0) {
  const uint32_t b = bits[j0 >> 5] >> (j0 & 31);
  uint32_t v = b & 1u;
  if (kQ == 4)
    v |= ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 | ((b >> 3) & 1u) << 24;
  return v;
}

// dep and ww of slots r, j as a full recompute gives them
__device__ __forceinline__ bool fresh_dep(int r, int j,
                                          const uint32_t* s_party,
                                          const int32_t* s_item,
                                          const uint8_t* s_flag,
                                          int pwords) {
  if (r == j) return false;
  uint32_t meet = 0;
#pragma unroll 4
  for (int q = 0; q < pwords; ++q)
    meet |= s_party[r * pwords + q] & s_party[j * pwords + q];
  return meet != 0 || (s_item[r] == s_item[j] &&
                       ((s_flag[r] | s_flag[j]) & kIsWrite));
}

__device__ __forceinline__ bool fresh_ww(int r, int j,
                                         const uint32_t* s_write, int stride,
                                         int w) {
  if (r == j) return false;
  uint32_t meet = 0;
#pragma unroll 8
  for (int q = 0; q < w; ++q)
    meet |= s_write[r * stride + q] & s_write[j * stride + q];
  return meet != 0;
}

// The next iteration's four relation tables of every lane, out of place:
// an entry of dep or ww is recomputed where its row or its column slot is
// dirty, a row of writers_at or readers_at where its slot is dirty, and
// every other entry is copied from the carried tables.  CTA (part, lane)
// writes rows [56 part, 56 part + 56) of its lane.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
rowslab_drain_kernel(const uint32_t* __restrict__ read,
                     const uint32_t* __restrict__ write,
                     const uint8_t* __restrict__ dep_in,
                     const uint8_t* __restrict__ ww_in,
                     const uint8_t* __restrict__ wat_in,
                     const uint8_t* __restrict__ rat_in,
                     const int32_t* __restrict__ item,
                     const uint8_t* __restrict__ is_write,
                     const uint8_t* __restrict__ active,
                     const uint8_t* __restrict__ dirty,
                     uint8_t* __restrict__ dep, uint8_t* __restrict__ ww,
                     uint8_t* __restrict__ wat, uint8_t* __restrict__ rat,
                     int n, int w) {
  extern __shared__ uint32_t smem[];
  const DrainLayout lay = drain_layout(n, w);
  const int pw = lay.pwords;
  uint32_t* s_read = smem;
  uint32_t* s_write = s_read + size_t(n) * lay.stride;
  uint32_t* s_party = s_write + size_t(n) * lay.stride;  // [n][pw]
  uint32_t* s_fresh = s_party + size_t(n) * pw;         // [4][n][pw]
  uint32_t* s_dirty = s_fresh + size_t(4) * n * pw;     // [pw]
  int32_t* s_item = reinterpret_cast<int32_t*>(s_dirty + pw);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_item + n);

  const int lane = blockIdx.y;
  const int r_lo = blockIdx.x * kDrainRows;
  const int r_hi = min(n, r_lo + kDrainRows);
  const size_t vbase = size_t(lane) * n;
  const size_t tbase = size_t(lane) * n * n;
  const int per_row = n / kQ;
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;

  stage_ops(s_item, s_flag, item + vbase, is_write + vbase, active + vbase,
            dirty + vbase, n);
  __syncthreads();
  for (int c = warp; c < pw; c += warps) {
    const int kk = c * 32 + tid;
    const uint32_t bits =
        __ballot_sync(kFull, kk < n && (s_flag[kk] & kFresh));
    if (tid == 0) s_dirty[c] = bits;
  }
  __syncthreads();
  uint32_t any = 0;
  for (int c = 0; c < pw; ++c) any |= s_dirty[c];
  if (any) {                 // a lane with no dirty slot only copies
    stage_words(s_read, s_write, read + size_t(lane) * n * w,
                write + size_t(lane) * n * w, n, w, lay.stride);
    for (int t = threadIdx.x; t < n * pw; t += blockDim.x) s_party[t] = 0;
    __syncthreads();
    // a clean slot's party row from its carried readers_at or writers_at
    // row, kQ bytes a load, kBatch loads in flight, OR-ed into its bits
    for (int e0 = threadIdx.x; e0 < n * per_row;
         e0 += kBatch * blockDim.x) {
      uint32_t v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        v[u] = 0;
        if (e >= n * per_row) continue;
        const int j = e / per_row, at = j * n + (e - j * per_row) * kQ;
        if (!(s_flag[j] & kFresh))
          v[u] = load_q<kQ>(((s_flag[j] & kIsWrite) ? rat_in : wat_in) +
                            tbase + at);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e >= n * per_row) continue;
        const int j = e / per_row, k0 = (e - j * per_row) * kQ;
        if (s_flag[j] & kFresh) continue;
        uint32_t bits = 0;
#pragma unroll
        for (int c = 0; c < kQ; ++c) {
          const int k = k0 + c;
          if (k == j || (((v[u] >> (8 * c)) & 0xffu) &&
                         (s_flag[k] & kActive)))
            bits |= 1u << c;
        }
        if (bits) atomicOr(&s_party[j * pw + (k0 >> 5)], bits << (k0 & 31));
      }
    }
    // a dirty slot's party row from the fresh words, one warp per row
    for (int j = warp; j < n; j += warps) {
      if (!(s_flag[j] & kFresh)) continue;
      const int x = s_item[j];
      const int xw = x >> 5;
      const uint32_t xb = uint32_t(x & 31);
      const uint32_t* words = (s_flag[j] & kIsWrite) ? s_read : s_write;
      for (int c = 0; c < pw; ++c) {
        const int k = c * 32 + tid;
        const uint32_t bits = __ballot_sync(
            kFull, k < n && (k == j || (((words[k * lay.stride + xw] >> xb)
                                         & 1u) &&
                                        (s_flag[k] & kActive))));
        if (tid == 0) s_party[j * pw + c] = bits;
      }
    }
    __syncthreads();
    // the fresh dep, ww, writers_at and readers_at rows of the dirty
    // slots, packed to bits, one warp per row
    for (int r = warp; r < n; r += warps) {
      if (!(s_flag[r] & kFresh)) continue;
      const int x = s_item[r];
      const int xw = x >> 5;
      const uint32_t xb = uint32_t(x & 31);
      for (int c = 0; c < pw; ++c) {
        const int j = c * 32 + tid;
        const bool in = j < n;
        const uint32_t b0 = __ballot_sync(
            kFull, in && fresh_dep(r, j, s_party, s_item, s_flag, pw));
        const uint32_t b1 =
            __ballot_sync(kFull, in && fresh_ww(r, j, s_write, lay.stride, w));
        const uint32_t b2 = __ballot_sync(
            kFull, in && ((s_write[j * lay.stride + xw] >> xb) & 1u));
        const uint32_t b3 = __ballot_sync(
            kFull, in && ((s_read[j * lay.stride + xw] >> xb) & 1u));
        if (tid == 0) {
          s_fresh[(0 * n + r) * pw + c] = b0;
          s_fresh[(1 * n + r) * pw + c] = b1;
          s_fresh[(2 * n + r) * pw + c] = b2;
          s_fresh[(3 * n + r) * pw + c] = b3;
        }
      }
    }
    __syncthreads();
  }

  // kQ columns of one row per thread and item, kOut items per thread in
  // flight: consecutive threads write consecutive words of a row
  constexpr int kOut = 4;
  const int items = (r_hi - r_lo) * per_row;
  for (int e0 = threadIdx.x; e0 < items; e0 += kOut * blockDim.x) {
    uint32_t v[kOut][4];
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= items) continue;
      const int r = r_lo + e / per_row, j0 = (e - (r - r_lo) * per_row) * kQ;
      const size_t at = tbase + size_t(r) * n + j0;
      if (s_flag[r] & kFresh) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[u][t] = bytes_of<kQ>(s_fresh + (t * n + r) * pw, j0);
      } else {
        v[u][0] = load_q<kQ>(dep_in + at);
        v[u][1] = load_q<kQ>(ww_in + at);
        v[u][2] = load_q<kQ>(wat_in + at);
        v[u][3] = load_q<kQ>(rat_in + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= items) continue;
      const int r = r_lo + e / per_row, j0 = (e - (r - r_lo) * per_row) * kQ;
      const size_t at = tbase + size_t(r) * n + j0;
      // a clean row's entries at the dirty slots' columns: dep and ww are
      // symmetric, so they are bit r of the dirty slots' fresh rows
      const uint32_t cols = (s_flag[r] & kFresh)
                                ? 0u
                                : (s_dirty[j0 >> 5] >> (j0 & 31)) &
                                      ((1u << kQ) - 1u);
      if (cols) {
        const int rw = r >> 5;
        const uint32_t rb = uint32_t(r & 31);
#pragma unroll
        for (int c = 0; c < kQ; ++c) {
          if (!((cols >> c) & 1u)) continue;
          const int j = j0 + c;
          const uint32_t keep = ~(0xffu << (8 * c));
#pragma unroll
          for (int t = 0; t < 2; ++t)
            v[u][t] = (v[u][t] & keep) |
                      (((s_fresh[(t * n + j) * pw + rw] >> rb) & 1u)
                       << (8 * c));
        }
      }
      store_q<kQ>(dep + at, v[u][0]);
      store_q<kQ>(ww + at, v[u][1]);
      store_q<kQ>(wat + at, v[u][2]);
      store_q<kQ>(rat + at, v[u][3]);
    }
  }
}

template <int kQ>
int drain_launch(const void* const* p, void* const* out, int lanes, int n,
                 int w, cudaStream_t stream) {
  const size_t bytes = drain_layout(n, w).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rowslab_drain_kernel<kQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + kDrainRows - 1) / kDrainRows, lanes);
  rowslab_drain_kernel<kQ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint32_t*>(p[0]), static_cast<const uint32_t*>(p[1]),
      static_cast<const uint8_t*>(p[2]), static_cast<const uint8_t*>(p[3]),
      static_cast<const uint8_t*>(p[4]), static_cast<const uint8_t*>(p[5]),
      static_cast<const int32_t*>(p[6]), static_cast<const uint8_t*>(p[7]),
      static_cast<const uint8_t*>(p[8]), static_cast<const uint8_t*>(p[9]),
      static_cast<uint8_t*>(out[0]), static_cast<uint8_t*>(out[1]),
      static_cast<uint8_t*>(out[2]), static_cast<uint8_t*>(out[3]), n, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at (n, w, k).
long long rowslab_smem_bytes(int n, int w, int k) {
  return static_cast<long long>(layout(n, w, k).bytes);
}

// One launch over `lanes` lanes on `stream`; returns the cudaError_t of the
// launch (0 on success).  Pointers are device pointers: words
// uint32[lanes, n, w], item int32[lanes, n], flags bool[lanes, n], slab
// int32[lanes, k], valid bool[lanes, k] and the outputs bool[lanes, k, n]
// contiguous; the carried tables bool[lanes, n, n] with lane stride t_lane
// and row stride t_row (elements), columns contiguous, the same for both.
int rowslab_launch(const void* read, const void* write, const void* wat_in,
                   const void* rat_in, const void* item,
                   const void* is_write, const void* active,
                   const void* slab, const void* valid, void* dep, void* ww,
                   void* wat, void* rat, int lanes, int n, int w, int k,
                   long long t_lane, long long t_row, void* stream) {
  const size_t bytes = layout(n, w, k).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rowslab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rowslab_kernel<<<lanes, kThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(read), static_cast<const uint32_t*>(write),
      static_cast<const uint8_t*>(wat_in),
      static_cast<const uint8_t*>(rat_in), static_cast<const int32_t*>(item),
      static_cast<const uint8_t*>(is_write),
      static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(slab), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(dep), static_cast<uint8_t*>(ww),
      static_cast<uint8_t*>(wat), static_cast<uint8_t*>(rat), n, w, k,
      t_lane, t_row);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory one drain CTA needs at (n, w).
long long rowslab_drain_smem_bytes(int n, int w) {
  return static_cast<long long>(drain_layout(n, w).bytes);
}

// The drain: one launch over `lanes` lanes on `stream`; returns the
// cudaError_t of the launch (0 on success).  Device pointers, contiguous:
// words uint32[lanes, n, w], the carried dep, ww, writers_at, readers_at
// bool[lanes, n, n], item int32[lanes, n], is_write, active and dirty
// bool[lanes, n], and the four output tables bool[lanes, n, n], which must
// not alias the carried ones.
int rowslab_drain_launch(const void* read, const void* write,
                         const void* dep_in, const void* ww_in,
                         const void* wat_in, const void* rat_in,
                         const void* item, const void* is_write,
                         const void* active, const void* dirty, void* dep,
                         void* ww, void* wat, void* rat, int lanes, int n,
                         int w, void* stream) {
  const void* in[10] = {read,  write, dep_in,   ww_in,  wat_in,
                        rat_in, item, is_write, active, dirty};
  void* out[4] = {dep, ww, wat, rat};
  bool aligned = n % 4 == 0;
  for (int i = 2; i < 6; ++i)
    aligned = aligned && reinterpret_cast<uintptr_t>(in[i]) % 4 == 0;
  for (int i = 0; i < 4; ++i)
    aligned = aligned && reinterpret_cast<uintptr_t>(out[i]) % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aligned ? drain_launch<4>(in, out, lanes, n, w, s)
                 : drain_launch<1>(in, out, lanes, n, w, s);
}

}  // extern "C"
