// Row-slab kernel for Hopper (sm_90a): the relation rows of K dirty slots of
// every lane of a fleet, in one launch (delta-maintained relations).
//
// Replaces repro/kernels/megastep.py::_rowslab_kernel, the Pallas TPU
// kernel behind repro.kernels.megastep.rowslab.  It computes exactly what
// repro_torch.kernels.ref.rowslab_ref computes, lane by lane.  With
// sl[s] = clamp(slab[s], 0, n-1), x_s = item[sl[s]]:
//   wat_rows[s,k] = valid[s] and bit x_s of write row k  (rat_rows: read)
//   party_s[s,k]  = k == sl[s], or active[k] and
//                   (is_write[sl[s]] ? rat_rows : wat_rows)[s,k]
//   party_j[j,k]  = k == j, or active[k] and (is_write[j] ? R : W)[j,k],
//                   where W/R is the fresh row of slot j (bit item_j of
//                   write/read row k) when j is a valid slab id, else the
//                   carried writers_at/readers_at row j
//   dep_rows[s,j] = valid[s] and sl[s] != j and (party_s[s] meets
//                   party_j[j], or x_s == item_j and either op writes)
//   ww_rows[s,j]  = valid[s] and sl[s] != j and write rows sl[s], j meet
// An invalid entry aliases slot n-1 but never substitutes a carried row,
// and its output rows are zero.
//
// Bound.  At the main path's shape (168 lanes, n = 160 slots, W = 16 words,
// K = 40) a launch must read 2 x 160 x 16 x 4 B of words, 160 x 6 B of op
// data and, for each slot j that is not in the slab, the one carried row
// its party needs (is_write[j] picks readers_at or writers_at): at most
// 160 x 160 B per lane.  It writes 4 x 40 x 160 B of rows.  That is at most
// 3.44 + 0.16 + 4.30 + 4.30 MB = 12.2 MB, about 3.6 us at 3.35 TB/s;
// chip_smoke.py counts the carried rows the run's slabs really need.  The
// logic, 168 x 40 x 160 pairs of 5 party words and 16 write words, is
// far below the card's integer rate: bytes bound it.
//
// Design.  One CTA per lane, 256 threads, as csrc/megastep.cu.  The lane's
// read and write words are loaded once into shared memory, rows at an odd
// stride so that 32 threads reading 32 rows hit 32 banks.  A map from slot
// to "is a valid slab id" decides, per column slot, between the fresh row
// (from the words in shared memory) and the carried row (read from global
// memory, 32 consecutive bytes per warp step; the tables may be strided
// views, rows contiguous, as the engine's padded relation buffer gives
// them).  The K slab party rows and
// the n column party rows are packed to bits with __ballot_sync, so that
// dep[s,j] is an AND over ceil(n/32) words; ww is an AND over W words.
// Each warp owns whole output rows and its threads walk the columns, so
// every row is stored as runs of 32 consecutive bytes.  Footprint (layout()
// below): (2 n (W|1) + (n + K) ceil(n/32) + n + K) x 4 + n + K bytes,
// 26,760 B at the main shape; the wrapper raises beyond the card's 227 KB.
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

  for (int t = threadIdx.x; t < n * w; t += blockDim.x) {
    const int r = t / w, c = t - r * w;
    s_read[r * lay.stride + c] = read[wbase + t];
    s_write[r * lay.stride + c] = write[wbase + t];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const size_t v = vbase + t;
    s_item[t] = item[v];
    s_flag[t] = (is_write[v] ? kIsWrite : 0) | (active[v] ? kActive : 0);
  }
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

}  // extern "C"
