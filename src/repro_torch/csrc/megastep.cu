// Cohort-step megakernel for Hopper (sm_90a): every pairwise relation of a
// fused PPCC cohort step, for every lane of a fleet, in one launch.
//
// Replaces repro/kernels/megastep.py::_megastep_kernel, the Pallas TPU
// kernel behind repro.kernels.megastep.megastep.  It computes exactly what
// repro_torch.kernels.ref.megastep_ref computes, lane by lane:
//   writers_at[i,k] = bit item_i of write row k   (readers_at: read row k)
//   party[i,k]      = k == i, or active[k] and
//                     (is_write[i] ? readers_at : writers_at)[i,k]
//   dep[i,j]        = i != j and (party rows i and j meet, or
//                     item_i == item_j and either op writes)
//   ww[i,j]         = i != j and write rows i and j meet
//   deg[i]          = #{j : dep[i,j] and ready[j]}
//   lockhit[i]      = some j has ww[i,j] and haslocks[j]
//   dirty_hit[i]    = read row i meets dirty row i
//
// Bound.  At the main path's shape (168 lanes, n = 160 slots, W = 16 words
// of 32 items) a launch reads 3 x 160 x 16 x 4 B of words and 160 x 8 B of
// op data per lane, 5.4 MB in all, and writes 4 x 160 x 160 B of bool
// tables and 160 x 6 B of vectors per lane, 17.4 MB: 22.8 MB, about 6.8 us
// at 3.35 TB/s.  Its logic, one AND-OR per word pair (5 party words and 16
// write words for each of 168 x 160 x 160 pairs, 90 M), takes 5.4 us at
// the card's 32-bit logic rate, so bytes bound it, and three quarters of
// them are the four n x n outputs.
//
// Design.  Each lane is split over CTAs of 256 threads by blocks of kRows =
// 96 rows (2 CTAs a lane at n = 160, 336 in all, one wave at three CTAs an
// SM), and the CTAs of a lane form one thread-block cluster.  Each CTA:
//   1. stages, in one pass of 16-byte loads, the lane's read and write words
//      in shared memory (about 20 KiB at the main shape): the read words at
//      an odd word stride, for the column reads of step 2 and the row reads
//      of step 6, and the write words as rows of 16-byte chunks at an odd
//      chunk stride, for step 4 (step 2's column reads of them meet 4-way
//      bank conflicts, which cost less than a second copy of the words);
//      items with is_write in the top bit, and active / ready / haslocks
//      packed to bits by ballot;
//   2. packs the party rows of its own rows, and their writers_at and
//      readers_at bits: a warp takes 32 columns k of 32 rows, one ballot per
//      row and table; the lane of row i keeps row i's words;
//   3. after a cluster barrier, copies the other parts' party rows from
//      their shared memory (dep[i, j] needs party row j for every j), and
//      meets them at a second barrier, which keeps each CTA's shared memory
//      alive until the others have read it;
//   4. walks items of 32 rows x 16 columns, one per warp: a thread holds
//      row i and ORs, over the 16-byte chunks, the AND of its chunk with
//      each of the 16 column rows' chunk, 16 accumulators in registers; the
//      column rows' loads are the same address for the whole warp (one
//      broadcast), row i's are conflict-free at the odd chunk stride; deg
//      and lockhit gather in shared memory with shared atomics;
//   5. writes the four tables: where n is a multiple of 16, the 16-bit
//      masks of the items wait in shared memory and the CTA's rows of each
//      table, one contiguous range of the output, leave as 16-byte stores
//      by consecutive threads; otherwise each item is stored at once, in
//      4-byte pieces where n is a multiple of 4, else by byte;
//   6. writes deg, lockhit and dirty_hit of its rows.
// Any n fits as long as the footprint (layout() below) fits in shared
// memory; the wrapper raises otherwise.  A lane takes at most 8 parts (a
// portable cluster): past 8 x 96 slots the rows of a part grow instead.
// The footprint holds the party rows in 16-byte chunks and each CTA's rows
// of the four tables as bits, so it reaches a smaller n than one CTA a lane
// did: n = 672 at W = 16 (904 before), 896 at W = 1, 352 at W = 64
// (megastep_max_n in kernels/megastep.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 96;       // least rows of a lane per CTA
constexpr int kMaxParts = 8;    // CTAs of a lane: a portable cluster
constexpr int kCols = 16;       // columns of one thread's item
constexpr int kMinBlocks = 3;   // CTAs an SM holds: 396 >= 336 at n = 160
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kWriteBit = 0x80000000u;
enum { kActive, kReady, kHasLocks, kFlags };

struct Layout {
  int rows;   // rows of a lane per CTA: kRows, more where n > 8 kRows
  int parts;  // CTAs (one cluster) per lane
  int n16;    // party rows: n padded to kCols (zero past n)
  int pw;     // party words per row: ceil(n / 32); 32 pw staged word rows
  int pc;     // 16-byte chunks of a party row: ceil(pw / 4)
  int wc;     // 16-byte chunks of a write row: ceil(w / 4)
  int ps;     // chunk stride of the party rows (odd)
  int ws;     // chunk stride of the chunked write rows (odd)
  int os;     // word stride of the staged read rows (odd)
  size_t party, ro, wat, rat, item, flags, deg, lock, mask;  // words
  size_t bytes;  // dynamic shared memory of one CTA
};

// chunked write rows and read rows at the odd stride (32 pw rows each,
// zero past n), party rows, the own rows' writers_at / readers_at bits,
// items, flag bits, deg, lock, and the own rows' 16-column bits of the four
// tables (uint16)
__host__ __device__ inline Layout layout(int n, int w) {
  Layout l;
  const int spread = ((n + kMaxParts - 1) / kMaxParts + 31) / 32 * 32;
  l.rows = spread > kRows ? spread : kRows;
  l.parts = n > 0 ? (n + l.rows - 1) / l.rows : 1;
  l.n16 = (n + kCols - 1) / kCols * kCols;
  l.pw = (n + 31) / 32;
  l.pc = (l.pw + 3) / 4;
  l.wc = (w + 3) / 4;
  l.ps = l.pc | 1;
  l.ws = l.wc | 1;
  l.os = w | 1;
  l.party = size_t(32) * l.pw * l.ws * 4;
  l.ro = l.party + size_t(l.n16) * l.ps * 4;
  l.wat = l.ro + size_t(32) * l.pw * l.os;
  l.rat = l.wat + size_t(l.rows) * l.pw;
  l.item = l.rat + size_t(l.rows) * l.pw;
  l.flags = l.item + l.n16;
  l.deg = l.flags + size_t(kFlags) * l.pw;
  l.lock = l.deg + l.rows;
  l.mask = l.lock + l.rows;
  l.bytes = (l.mask + (size_t(4) * l.rows * (l.n16 / kCols) + 1) / 2) * 4;
  return l;
}

// bits 0-3 of b as four bytes of 0 or 1, lowest bit first
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return ((b & 0xfu) * 0x00204081u) & 0x01010101u;
}

// bytes out[off .. off + cnt) = bits 0 .. cnt - 1 of `bits`: 4-byte stores
// where vec is 4, byte stores where it is 1
__device__ __forceinline__ void store_bits(uint8_t* __restrict__ out,
                                           size_t off, uint32_t bits,
                                           int cnt, int vec) {
  int q = 0;
  if (vec == 4)
    for (; q + 4 <= cnt; q += 4)
      *reinterpret_cast<uint32_t*>(out + off + q) = spread4(bits >> q);
  for (; q < cnt; ++q) out[off + q] = (bits >> q) & 1u;
}

// every thread of the cluster, with release / acquire of shared memory at
// cluster scope (cooperative_groups' sync also fences the whole GPU)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t and_or(uint4 a, uint4 b) {
  return (a.x & b.x) | (a.y & b.y) | (a.z & b.z) | (a.w & b.w);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
megastep_kernel(const uint32_t* __restrict__ read,
                const uint32_t* __restrict__ write,
                const uint32_t* __restrict__ dirty,
                const int32_t* __restrict__ item,
                const uint8_t* __restrict__ is_write,
                const uint8_t* __restrict__ active,
                const uint8_t* __restrict__ ready,
                const uint8_t* __restrict__ haslocks,
                uint8_t* __restrict__ dep, uint8_t* __restrict__ ww,
                uint8_t* __restrict__ wat, uint8_t* __restrict__ rat,
                int32_t* __restrict__ deg, uint8_t* __restrict__ lockhit,
                uint8_t* __restrict__ dirty_hit, int n, int w, int vec,
                bool vec_in) {
  extern __shared__ uint4 smem4[];
  const Layout lay = layout(n, w);
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  uint4* s_w4 = smem4;                                  // [32 pw][ws]
  uint4* s_p4 = reinterpret_cast<uint4*>(smem + lay.party);  // [n16][ps]
  uint32_t* s_party = smem + lay.party;                 // word view
  uint32_t* s_ro = smem + lay.ro;                       // [32 pw][os]
  uint32_t* s_wat = smem + lay.wat;                     // [rows][pw]
  uint32_t* s_rat = smem + lay.rat;                     // [rows][pw]
  int32_t* s_item = reinterpret_cast<int32_t*>(smem + lay.item);  // [n16]
  uint32_t* s_flag = smem + lay.flags;                  // [kFlags][pw]
  int32_t* s_deg = reinterpret_cast<int32_t*>(smem + lay.deg);    // [rows]
  uint32_t* s_lock = smem + lay.lock;                   // [rows]
  uint16_t* s_mask =                                    // [4][rows][groups]
      reinterpret_cast<uint16_t*>(smem + lay.mask);
  const int groups = lay.n16 / kCols;

  cg::cluster_group cluster = cg::this_cluster();
  const int part = static_cast<int>(cluster.block_rank());
  const int lane_id = blockIdx.x / lay.parts;  // fleet lane
  const int r0 = part * lay.rows;
  const int r1 = min(n, r0 + lay.rows);
  const size_t wbase = size_t(lane_id) * n * w;
  const size_t vbase = size_t(lane_id) * n;
  const size_t mbase = size_t(lane_id) * n * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. stage, every global load of the CTA in one pass: the words into
  // the odd-stride rows and the chunked write rows, items, the flags packed
  // to bits; the padding that later steps read is zeroed alongside (party
  // rows whole, since step 2 and the copy fill only their first pw words of
  // rows below n)
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int t = tid; t < lay.n16 * lay.ps; t += kThreads) s_p4[t] = zero;
  for (int t = tid; t < (32 * lay.pw - n) * lay.ws; t += kThreads)
    s_w4[n * lay.ws + t] = zero;
  for (int t = tid; t < (32 * lay.pw - n) * lay.os; t += kThreads)
    s_ro[n * lay.os + t] = 0;
  if (w % 4)
    for (int t = tid; t < n; t += kThreads)
      for (int c = w; c < lay.wc * 4; ++c)
        smem[size_t(t) * lay.ws * 4 + c] = 0;
  for (int t = tid; t < lay.rows; t += kThreads) {
    s_deg[t] = 0;
    s_lock[t] = 0;
  }
  for (int t0 = 0; t0 < lay.pw * 32; t0 += kThreads) {
    const int t = t0 + tid;
    const bool in = t < n;
    int32_t x = -1;
    bool a = false, r = false, h = false;
    if (in) {
      x = int32_t(uint32_t(item[vbase + t]) |
                  (is_write[vbase + t] ? kWriteBit : 0u));
      a = active[vbase + t];
      r = ready[vbase + t];
      h = haslocks[vbase + t];
    }
    if (t < lay.n16) s_item[t] = x;
    const uint32_t ab = __ballot_sync(kFull, a);
    const uint32_t rb = __ballot_sync(kFull, r);
    const uint32_t hb = __ballot_sync(kFull, h);
    if (lane == 0 && t < lay.pw * 32) {
      s_flag[kActive * lay.pw + (t >> 5)] = ab;
      s_flag[kReady * lay.pw + (t >> 5)] = rb;
      s_flag[kHasLocks * lay.pw + (t >> 5)] = hb;
    }
  }
  // words: 16-byte loads where the lane's rows allow, eight in flight
  auto put = [&](int e, uint32_t rv, uint32_t wv) {
    const int r = e / w, c = e - r * w;
    s_ro[r * lay.os + c] = rv;
    smem[size_t(r) * lay.ws * 4 + c] = wv;
  };
  if (vec_in) {
    const uint4* r4 = reinterpret_cast<const uint4*>(read + wbase);
    const uint4* w4 = reinterpret_cast<const uint4*>(write + wbase);
    const int nw4 = n * w / 4;
    for (int t0 = tid; t0 < nw4; t0 += 4 * kThreads) {
      uint4 rv[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t0 + u * kThreads < nw4) {
          rv[u] = r4[t0 + u * kThreads];
          wv[u] = w4[t0 + u * kThreads];
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t0 + u * kThreads < nw4) {
          const int e = 4 * (t0 + u * kThreads);
          put(e, rv[u].x, wv[u].x);
          put(e + 1, rv[u].y, wv[u].y);
          put(e + 2, rv[u].z, wv[u].z);
          put(e + 3, rv[u].w, wv[u].w);
        }
    }
  } else {
    const int nw = n * w;
    for (int t0 = tid; t0 < nw; t0 += 4 * kThreads) {
      uint32_t rv[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t0 + u * kThreads < nw) {
          rv[u] = read[wbase + t0 + u * kThreads];
          wv[u] = write[wbase + t0 + u * kThreads];
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t0 + u * kThreads < nw) put(t0 + u * kThreads, rv[u], wv[u]);
    }
  }
  __syncthreads();

  // 2. the party rows and op-table bits of the own rows: a warp takes 32
  // columns k of 32 rows, one ballot per row and table (rows of the staged
  // words past n are zero), and lane ii keeps row ii's words
  const int blocks = (r1 - r0 + 31) / 32;
  for (int it = warp; it < lay.pw * blocks; it += kWarps) {
    const int c = it % lay.pw;
    const int i0 = r0 + (it / lay.pw) * 32;
    const int k = c * 32 + lane;
    uint32_t my_r = 0, my_w = 0;
    int32_t my_x = 0;
#pragma unroll 8
    for (int ii = 0; ii < 32; ++ii) {
      const int i = min(i0 + ii, r1 - 1);
      const int32_t xi = s_item[i];
      const int xw = (xi & 0x7fffffff) >> 5;
      const uint32_t xm = 1u << (xi & 31);
      const uint32_t rb = __ballot_sync(kFull, s_ro[k * lay.os + xw] & xm);
      const uint32_t wb =
          __ballot_sync(kFull, smem[size_t(k) * lay.ws * 4 + xw] & xm);
      my_r = lane == ii ? rb : my_r;
      my_w = lane == ii ? wb : my_w;
      my_x = lane == ii ? xi : my_x;
    }
    const int i = i0 + lane;
    if (i < r1) {
      const uint32_t diag = (i >> 5) == c ? 1u << (i & 31) : 0u;
      s_party[size_t(i) * lay.ps * 4 + c] =
          ((my_x < 0 ? my_r : my_w) & s_flag[kActive * lay.pw + c]) | diag;
      s_wat[(i - r0) * lay.pw + c] = my_w;
      s_rat[(i - r0) * lay.pw + c] = my_r;
    }
  }
  // 3. every part's party rows, from the other CTAs of the cluster; the
  // second barrier keeps each CTA's shared memory alive until the others
  // have read it
  cluster_sync();
  for (int q = 0; q < lay.parts; ++q) {
    if (q == part) continue;
    const uint4* remote = cluster.map_shared_rank(s_p4, q);
    const int lo = q * lay.rows * lay.ps;
    const int hi = min(n, (q + 1) * lay.rows) * lay.ps;
    for (int t = lo + tid; t < hi; t += kThreads) s_p4[t] = remote[t];
  }
  cluster_sync();

  // 4. items of 32 rows x kCols columns, one per warp
  const int items = blocks * groups;
  for (int it = warp; it < items; it += kWarps) {
    const int g = it % groups;
    const int i = r0 + (it / groups) * 32 + lane;
    const bool valid = i < r1;
    const int il = valid ? i : r1 - 1;
    const int j0 = g * kCols;
    uint32_t acc[kCols];

#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[jj] = 0;
    for (int c = 0; c < lay.pc; ++c) {
      const uint4 a = s_p4[il * lay.ps + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        acc[jj] |= and_or(a, s_p4[(j0 + jj) * lay.ps + c]);
    }
    const int32_t xi = s_item[il];
    uint32_t d_bits = 0;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int32_t xj = s_item[j0 + jj];
      const bool same = ((xi ^ xj) & 0x7fffffff) == 0 && (xi | xj) < 0;
      d_bits |= uint32_t((acc[jj] != 0 || same) && j0 + jj != i) << jj;
    }

#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[jj] = 0;
    for (int c = 0; c < lay.wc; ++c) {
      const uint4 a = s_w4[il * lay.ws + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        acc[jj] |= and_or(a, s_w4[(j0 + jj) * lay.ws + c]);
    }
    uint32_t w_bits = 0;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      w_bits |= uint32_t(acc[jj] != 0 && j0 + jj != i) << jj;

    if (valid) {
      const int cnt = min(kCols, n - j0);
      const uint32_t cols = (1u << cnt) - 1u;
      d_bits &= cols;
      w_bits &= cols;
      const int q = j0 >> 5, sh = j0 & 31;
      const int row = i - r0;
      const uint32_t wa = (s_wat[row * lay.pw + q] >> sh) & cols;
      const uint32_t ra = (s_rat[row * lay.pw + q] >> sh) & cols;
      const uint32_t rdy = s_flag[kReady * lay.pw + q] >> sh;
      const uint32_t lck = s_flag[kHasLocks * lay.pw + q] >> sh;
      atomicAdd(&s_deg[row], __popc(d_bits & rdy));
      if (w_bits & lck) atomicOr(&s_lock[row], 1u);
      if (vec == 16) {        // whole items: kept for coalesced stores
        uint16_t* m = s_mask + size_t(row) * groups + g;
        const size_t tbl = size_t(lay.rows) * groups;
        m[0] = d_bits;
        m[tbl] = w_bits;
        m[2 * tbl] = wa;
        m[3 * tbl] = ra;
      } else {
        const size_t off = mbase + size_t(i) * n + j0;
        store_bits(dep, off, d_bits, cnt, vec);
        store_bits(ww, off, w_bits, cnt, vec);
        store_bits(wat, off, wa, cnt, vec);
        store_bits(rat, off, ra, cnt, vec);
      }
    }
  }
  __syncthreads();

  // 5. the own rows of each table are one contiguous range of the output:
  // consecutive threads write consecutive 16-byte pieces of it
  if (vec == 16) {
    const int pieces = (r1 - r0) * n / kCols;
    for (int tb = 0; tb < 4; ++tb) {
      uint8_t* out = (tb == 0 ? dep : tb == 1 ? ww : tb == 2 ? wat : rat) +
                     mbase + size_t(r0) * n;
      const uint16_t* m = s_mask + size_t(tb) * lay.rows * groups;
      for (int u = tid; u < pieces; u += kThreads) {
        const int row = u * kCols / n;
        const uint32_t bits = m[row * groups + (u * kCols - row * n) / kCols];
        *reinterpret_cast<uint4*>(out + size_t(u) * kCols) =
            make_uint4(spread4(bits), spread4(bits >> 4), spread4(bits >> 8),
                       spread4(bits >> 12));
      }
    }
  }

  // 6. the row vectors of the own rows
  for (int t = tid; t < r1 - r0; t += kThreads) {
    const int i = r0 + t;
    uint32_t dh = 0;
    for (int q = 0; q < w; ++q)
      dh |= s_ro[i * lay.os + q] & dirty[wbase + size_t(i) * w + q];
    deg[vbase + i] = s_deg[t];
    lockhit[vbase + i] = s_lock[t] != 0;
    dirty_hit[vbase + i] = dh != 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at (n, w).
long long megastep_smem_bytes(int n, int w) {
  return static_cast<long long>(layout(n, w).bytes);
}

// One launch over `lanes` lanes on `stream`; returns the cudaError_t of the
// launch (0 on success).  Pointers are device pointers to contiguous
// tensors: words uint32[lanes, n, w], item int32[lanes, n], flags and bool
// outputs 1 byte each, deg int32[lanes, n].
int megastep_launch(const void* read, const void* write, const void* dirty,
                    const void* item, const void* is_write,
                    const void* active, const void* ready,
                    const void* haslocks, void* dep, void* ww, void* wat,
                    void* rat, void* deg, void* lockhit, void* dirty_hit,
                    int lanes, int n, int w, void* stream) {
  const Layout lay = layout(n, w);
  if (lay.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(lay.bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the widest store every row start of the four tables is aligned to
  const uintptr_t tables =
      reinterpret_cast<uintptr_t>(dep) | reinterpret_cast<uintptr_t>(ww) |
      reinterpret_cast<uintptr_t>(wat) | reinterpret_cast<uintptr_t>(rat);
  const int vec = (n % 16 == 0 && tables % 16 == 0) ? 16
                  : (n % 4 == 0 && tables % 4 == 0) ? 4
                                                    : 1;
  // 16-byte loads of the words where every lane's rows start aligned
  const bool vec_in = (size_t(n) * w) % 4 == 0 &&
                      ((reinterpret_cast<uintptr_t>(read) |
                        reinterpret_cast<uintptr_t>(write)) % 16) == 0;
  // CTA lane * parts + part; the parts of a lane form one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(lanes) * lay.parts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lay.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, megastep_kernel, static_cast<const uint32_t*>(read),
      static_cast<const uint32_t*>(write),
      static_cast<const uint32_t*>(dirty), static_cast<const int32_t*>(item),
      static_cast<const uint8_t*>(is_write),
      static_cast<const uint8_t*>(active), static_cast<const uint8_t*>(ready),
      static_cast<const uint8_t*>(haslocks), static_cast<uint8_t*>(dep),
      static_cast<uint8_t*>(ww), static_cast<uint8_t*>(wat),
      static_cast<uint8_t*>(rat), static_cast<int32_t*>(deg),
      static_cast<uint8_t*>(lockhit), static_cast<uint8_t*>(dirty_hit), n, w,
      vec, vec_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
