// PPCC batch admission of an op list, one host call per admission, for
// Hopper (sm_90a).  It is not a TPU kernel: it replaces the XLA scan
// (lax.scan) of repro/core/ppcc.py::admit_ops, which walks the op list one
// try_op at a time; a loop of torch operations would cost some thirty
// launches per op.
//
//   admit_ops   for each lane, in list order, every valid op (txn t, item
//               x, read or write) runs try_read or try_write
//               (ppcc.py:127-186) on the state its predecessors left: the
//               lock verdict (an owner of x other than t holds wait-to-
//               commit locks: ABORT if t precedes it, else BLOCK), then the
//               Prudent Precedence Rule on the arcs the op would add
//               (a read: t -> every active writer of x it does not yet
//               precede; a write: every active reader of x not yet
//               preceding t -> t), and where admitted the set bit, the
//               arcs and the class bits.  An invalid op changes nothing.
//
// It computes exactly its plain version, kernels/ref.py::admit_ops_ref.
//
// Design.  A step is a chain (its verdict decides what the next step
// reads), so a lane's walk is one warp, and the work is to make each step a
// few dependent instructions on words that one load brings:
//   * the state is packed to bits first, slot k of a word at bit k % 32:
//     prec becomes bit rows P[t] (bit k: prec[t][k]) and bit columns PT[t]
//     (bit k: prec[k][t]); the sets become item-major columns R[x], WC[x]
//     (bit k: slot k reads / writes x); the four flags bit vectors.  Bits
//     are gathered with __ballot_sync (prec's bytes) and 32 x 32 blocks
//     are transposed with five __shfl_xor_sync stages (transpose32);
//   * lane j of the walking warp owns KU consecutive words of every row
//     (KU = 1, 2 or 4: n up to 1,024, 2,048 or 4,096), loaded as one
//     vector, and holds its flag words and the step's new-arc words in
//     registers (walk_regs): an op loads WC[x] and P[t] (and R[x], PT[t]
//     for a write) and forms the five predicates of the rule as word
//     operations (locked by another, t precedes the owner, any new arc, a
//     violated class bit, t's own class bit).  Above n = 4,096 lane j owns
//     the words j, j + 32, ... and the flags and new-arc words stay in
//     shared memory (walk_wide);
//   * an admitted op sets bit t of its column, ORs the new arcs into P[t]
//     (a read) or PT[t] (a write), sets bit t of each new arc's row in the
//     other orientation (few a step under contention) and the class bits,
//     each word by the lane that owns it (its own registers, or one red.or
//     for a word in memory: no warp aggregation, no wait); it writes the
//     bool prec byte of each new arc directly, and each lane sets bit x of
//     row t of the int32 set for its admitted op at the end of the chunk
//     (below), so no pass unpacks the state after the walk (the flags
//     alone are unpacked, n bytes).  Only an op that adds arcs writes a
//     word another lane reads (bit t of an arc's row), so only it ends
//     with a __syncwarp;
//   * each lane holds the op of one position of a chunk of 32 in
//     registers, the next chunk loaded while this one walks; the walk
//     skips invalid ops by a ballot and broadcasts each op by __shfl_sync;
//     at the chunk's end each lane writes its position's three verdict
//     bytes and, if admitted, its set bit (one red.or).
// Two routes, picked by the wrapper from n and W (kernels/admit_ops.py,
// route()):
//   shared  the whole packed state in the walking CTA's shared memory,
//           packed by the CTA's 16 warps in one kernel (one device kernel
//           a call); row stride nw | 1 words (odd: the transposes' stores
//           meet 32 banks);
//   global  the flags in shared memory, P, PT, R and WC in a scratch the
//           wrapper allocates (L2-resident at the scheduler's scale:
//           n = 4,096, W = 1,024 is 36 MB), packed by two kernels over the
//           whole card before the walk (three device kernels a call).  Row
//           stride nw rounded up to 4.
// Ownership: every word a step writes is written by one lane, so a step
// needs no atomics for correctness (red.or is used for its fire-and-forget
// store); __syncwarp orders one step's writes before the next step's
// loads.  A valid op out of range ([0, n) for t, [0, 32 W) for x)
// is skipped: the caller (ppcc.admit_ops) raises on it before the launch,
// and the kernel never touches memory outside its rows.
//
// Bound.  Each step is a chain: the op's broadcast, the loads of its words
// (shared memory, or L2 on the global route), the warp's OR, the verdict
// and the apply; chip_smoke.py gives the chain and byte bounds beside the
// time.  On the card a step takes about 400 cycles from shared memory and
// 1,000 from L2 (PERF.md, PR 26).  Measured and dropped there: windows of
// four ops evaluated together against the state before the window (one
// REDUX for all, cut at the first dependent op), and loading the next
// op's words during a step with patches after it; both were slower, the
// instructions they add costing more than the latency they hide.  The
// packing reads its inputs with ld.global.cs (evict first), which kept
// more of the packed state in L2 and cut the walk by about 14%.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kProceed = 0, kBlock = 1, kAbort = 2;
// predicate bits of a step's reduction
constexpr unsigned kLocked = 1, kPrecOwner = 2, kAnyNew = 4, kViolate = 8,
                   kSelf = 16;
constexpr int kShared = 0, kGlobal = 1;          // the routes
constexpr int kWalkThreads = 512;                // warp 0 walks
constexpr int kPrepThreads = 256;
constexpr size_t kSmemLimit = 232448;            // 227 KB a block on sm_90

__host__ __device__ __forceinline__ int words_of(int n) {
  return (n + 31) >> 5;
}

// words between two packed rows: odd on the shared route (conflict-free
// transposes), a multiple of 4 on the global route
__host__ __device__ __forceinline__ int stride_of(int route, int n) {
  const int nw = words_of(n);
  return route == kShared ? (nw | 1) : ((nw + 3) & ~3);
}

// words of one lane's packed P, PT, R and WC
__host__ __device__ __forceinline__ size_t packed_words(int route, int n,
                                                        int W) {
  return (2 * static_cast<size_t>(n) + 64 * static_cast<size_t>(W)) *
         stride_of(route, n);
}

// dynamic shared memory of the walk: HL, AC, PG, PD and the step's new-arc
// words (nw each), and on the shared route the packed state
size_t smem_bytes(int route, int n, int W) {
  size_t words = 5 * static_cast<size_t>(words_of(n));
  if (route == kShared) words += packed_words(route, n, W);
  return 4 * words;
}

// 32 x 32 bit transpose across the warp: lane i holds row i (bit b is
// column b); lane b returns column b (bit i is row i's bit b).  Each stage
// swaps the off-diagonal j x j blocks of every 2j x 2j block.
__device__ __forceinline__ unsigned transpose32(unsigned v, int lane) {
  unsigned m = 0x0000ffffu;                  // the columns whose bit j is 0
#pragma unroll
  for (int j = 16; j; j >>= 1, m ^= m << j) {
    const unsigned p = __shfl_xor_sync(kFull, v, j);
    v = (lane & j) ? ((v & ~m) | ((p >> j) & m))
                   : ((v & m) | ((p << j) & ~m));
  }
  return v;
}

// P[t * S + g] bit i = prec[t * n + 32 g + i] over the tasks (t, g) of
// [first, end), 32 consecutive tasks a warp at a time (lane b stores task
// b's word), the warps' blocks `step` tasks apart.  Warp-uniform.  prec is
// read once, evicted first from L2 (ld.global.cs): the packed state that
// the walk reads should stay there.
__device__ __forceinline__ void pack_rows(const bool* __restrict__ prec,
                                          int n, int S, uint32_t* P,
                                          long long first, long long step,
                                          int lane) {
  const int nw = words_of(n);
  const long long end = static_cast<long long>(n) * nw;
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(prec);
  for (long long base = first; base < end; base += step) {
    int t = static_cast<int>(base / nw), g = static_cast<int>(base % nw);
    unsigned v[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int k = 32 * g + lane;
      v[b] = (base + b < end && k < n)
                 ? __ldcs(bytes + static_cast<size_t>(t) * n + k)
                 : 0u;
      if (++g == nw) {
        g = 0;
        ++t;
      }
    }
    unsigned mine = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const unsigned word = __ballot_sync(kFull, v[b] != 0u);
      if (lane == b) mine = word;
    }
    const long long task = base + lane;
    if (task < end)
      P[static_cast<size_t>(task / nw) * S + task % nw] = mine;
  }
}

// B[(32 c + b) * S + G] bit i = bit b of A[(32 G + i) * astride + c] over
// the 32 x 32 blocks (G, c) of A (rows < `rows`, words < cw; rows past the
// end read as 0), stored where 32 c + b < orows; four blocks a warp at a
// time (their loads in flight together), the warps `step` blocks apart.
// Warp-uniform.  kStream: A is an input read once (evict first from L2).
template <bool kStream>
__device__ __forceinline__ void transpose_blocks(
    const uint32_t* __restrict__ A, int rows, int cw, size_t astride,
    uint32_t* B, int orows, int S, long long first, long long step,
    int lane) {
  constexpr int U = 8;
  const long long blocks = static_cast<long long>(words_of(rows)) * cw;
  for (long long b0 = first * U; b0 < blocks; b0 += step * U) {
    unsigned v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long blk = b0 + u;
      const int G = static_cast<int>(blk / cw), c = static_cast<int>(blk % cw);
      const int r = 32 * G + lane;
      v[u] = blk < blocks && r < rows
                 ? (kStream ? __ldcs(A + r * astride + c) : A[r * astride + c])
                 : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long blk = b0 + u;
      if (blk >= blocks) break;                 // warp-uniform
      const unsigned col = transpose32(v[u], lane);
      const int G = static_cast<int>(blk / cw), c = static_cast<int>(blk % cw);
      const int o = 32 * c + lane;
      if (o < orows) B[static_cast<size_t>(o) * S + G] = col;
    }
  }
}

// One lane's OR into a word, nothing returned: red, so that the compiler
// neither waits for it nor aggregates it over the warp.
template <int kRoute>
__device__ __forceinline__ void red_or(uint32_t* p, unsigned v) {
  if constexpr (kRoute == kGlobal)
    asm volatile("red.relaxed.gpu.global.or.b32 [%0], %1;\n" ::"l"(p),
                 "r"(v)
                 : "memory");
  else
    asm volatile("red.shared.or.b32 [%0], %1;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(p))),
                 "r"(v)
                 : "memory");
}

// A lane's packed state: rows P[t], PT[t] and columns R[x], WC[x], S words
// apart.  The walk reads them with plain loads on either route: its own
// stores and reds are ordered before a later load by program order (the
// same lane) or by __syncwarp (another lane), which bar.warp.sync
// guarantees for memory (PTX ISA); ld.global.cg and ld.global.nc measured
// no faster on the card.
struct Packed {
  uint32_t *P, *PT, *R, *WC;
  int S;
};

// The op of one position of a chunk: txn, item, bit 0 valid, bit 1 write.
struct OpRef {
  int t, x;
  unsigned f;
};

__device__ __forceinline__ OpRef load_op(const int32_t* __restrict__ txn,
                                         const int32_t* __restrict__ item,
                                         const bool* __restrict__ is_write,
                                         const bool* __restrict__ valid,
                                         int j, int m) {
  OpRef o{0, 0, 0u};
  if (j < m) {
    o.t = txn[j];
    o.x = item[j];
    o.f = (valid[j] ? 1u : 0u) | (is_write[j] ? 2u : 0u);
  }
  return o;
}

// After the chunk: each position's verdict bytes, and the set bit of each
// admitted op (bit x of row t of the int32 set), one red a lane.
__device__ __forceinline__ void chunk_out(
    int j, int m, int verdict, const OpRef& o, int W, int32_t* read_set,
    int32_t* write_set, bool* __restrict__ admitted,
    bool* __restrict__ blocked, bool* __restrict__ aborted) {
  if (j >= m) return;
  admitted[j] = verdict == kProceed;
  blocked[j] = verdict == kBlock;
  aborted[j] = verdict == kAbort;
  if (verdict == kProceed)
    red_or<kGlobal>(reinterpret_cast<uint32_t*>(
                        (o.f & 2u) ? write_set : read_set) +
                        static_cast<size_t>(o.t) * W + (o.x >> 5),
                    1u << (o.x & 31));
}

// The words one step reads, lane j's words j + 32 u: WC[x], R[x], P[t],
// PT[t].
template <int KU>
struct Words {
  unsigned wc[KU], rc[KU], pr[KU], pc[KU];
};

template <int kRoute, int KU>
__device__ __forceinline__ void load_words(Words<KU>& v, const Packed& s,
                                           int nw, int lane, int t, int x) {
  const size_t xo = static_cast<size_t>(x) * s.S;
  const size_t to = static_cast<size_t>(t) * s.S;
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const int i = lane + 32 * u;
    const bool in = i < nw;
    v.wc[u] = in ? s.WC[xo + i] : 0u;
    v.rc[u] = in ? s.R[xo + i] : 0u;
    v.pr[u] = in ? s.P[to + i] : 0u;
    v.pc[u] = in ? s.PT[to + i] : 0u;
  }
}

// A lane's KU words of a row from p (KU words aligned), as one vector
// load, each word outside the row (`in`) masked; `any` is whether the first
// is inside (a vector that starts inside ends inside the row's stride).
template <int KU>
__device__ __forceinline__ void load_run(unsigned (&v)[KU],
                                         const uint32_t* p, bool any,
                                         const bool (&in)[KU]) {
  if constexpr (KU == 4) {
    const uint4 q = any ? *reinterpret_cast<const uint4*>(p) : uint4{};
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (KU == 2) {
    const uint2 q = any ? *reinterpret_cast<const uint2*>(p) : uint2{};
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = any ? *p : 0u;
  }
#pragma unroll
  for (int u = 0; u < KU; ++u)
    if (!in[u]) v[u] = 0u;
}

// The walk of one lane's op list by one warp where a lane's words fit in
// registers (n <= 32 x 32 x KU): lane j owns the KU words KU j to KU j +
// KU - 1 of every row, loaded as one vector (the global route's rows are 4
// words apart at least, and a multiple of 4); the flags and the step's
// new-arc words live in registers; a read loads WC[x] and P[t], a write also
// R[x] and PT[t], and the read and write bodies are separate (w is the same
// for the whole warp).  HL, AC, PG, PD: the flag words in shared memory (PG
// and PD written back at the end).
template <int kRoute, int KU>
__device__ __forceinline__ void walk_regs(
    int n, int W, int m, int lane, const Packed& s, const uint32_t* HL,
    const uint32_t* AC, uint32_t* PG, uint32_t* PD, int32_t* read_set,
    int32_t* write_set, bool* prec, const int32_t* __restrict__ txn,
    const int32_t* __restrict__ item, const bool* __restrict__ is_write,
    const bool* __restrict__ valid, bool* __restrict__ admitted,
    bool* __restrict__ blocked, bool* __restrict__ aborted) {
  const int nw = words_of(n), items = 32 * W;
  unsigned hl[KU], ac[KU], pg[KU], pd[KU];
  bool in[KU];
  const bool any_in = KU * lane < nw;
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const int i = KU * lane + u;
    in[u] = i < nw;
    hl[u] = in[u] ? HL[i] : 0u;
    ac[u] = in[u] ? AC[i] : 0u;
    pg[u] = in[u] ? PG[i] : 0u;
    pd[u] = in[u] ? PD[i] : 0u;
  }
  OpRef nxt = load_op(txn, item, is_write, valid, lane, m);
  for (int base = 0; base < m; base += 32) {
    const OpRef mine = nxt;                    // position base + lane
    nxt = load_op(txn, item, is_write, valid, base + 32 + lane, m);
    unsigned todo = __ballot_sync(
        kFull, (mine.f & 1u) && mine.t >= 0 && mine.t < n && mine.x >= 0 &&
                   mine.x < items);
    // x and the write bit in one word: x < 2**31
    const unsigned mine_xw =
        static_cast<unsigned>(mine.x) | ((mine.f & 2u) << 30);
    int verdict = -1;
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int t = __shfl_sync(kFull, mine.t, src);
      const unsigned xw = __shfl_sync(kFull, mine_xw, src);
      const bool w = xw >> 31;
      const int x = static_cast<int>(xw & 0x7fffffffu);
      const int tw = t >> 5;
      const unsigned tb = 1u << (t & 31);
      // bit t of lane-word u: lane tw / KU, u = tw % KU
      const unsigned me_lane = lane == tw / KU ? tb : 0u;
      const size_t xo = static_cast<size_t>(x) * s.S + KU * lane;
      const size_t to = static_cast<size_t>(t) * s.S + KU * lane;
      // 1. the predicates on the pre-step state over this lane's words:
      //    locked by another, t precedes the owner, the new arcs, a
      //    violated class bit, t's own class bit
      unsigned locked = 0, owner_prec = 0, any_new = 0, violate = 0,
               self = 0, nb[KU];
      if (w) {
        unsigned wc[KU], rc[KU], pr[KU], pc[KU];
        load_run<KU>(wc, s.WC + xo, any_in, in);
        load_run<KU>(rc, s.R + xo, any_in, in);
        load_run<KU>(pr, s.P + to, any_in, in);
        load_run<KU>(pc, s.PT + to, any_in, in);
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const unsigned me = u == tw % KU ? me_lane : 0u;
          const unsigned own = wc[u] & hl[u];
          locked |= own & ~me;
          owner_prec |= own & pr[u];
          nb[u] = rc[u] & ac[u] & ~me & ~pc[u];
          violate |= nb[u] & pd[u];
          self |= me & pg[u];
          any_new |= nb[u];
        }
      } else {
        unsigned wc[KU], pr[KU];
        load_run<KU>(wc, s.WC + xo, any_in, in);
        load_run<KU>(pr, s.P + to, any_in, in);
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const unsigned me = u == tw % KU ? me_lane : 0u;
          const unsigned own = wc[u] & hl[u];
          locked |= own & ~me;
          owner_prec |= own & pr[u];
          nb[u] = wc[u] & ac[u] & ~me & ~pr[u];
          violate |= nb[u] & pg[u];
          self |= me & pd[u];
          any_new |= nb[u];
        }
      }
      // 2. one OR over the warp gives the verdict
      const unsigned all = __reduce_or_sync(
          kFull, (locked ? kLocked : 0u) | (owner_prec ? kPrecOwner : 0u) |
                     (any_new ? kAnyNew : 0u) | (violate ? kViolate : 0u) |
                     (self ? kSelf : 0u));
      const int lock_v = (all & kLocked)
                             ? ((all & kPrecOwner) ? kAbort : kBlock)
                             : kProceed;
      const bool arcs = all & kAnyNew;
      const bool allowed =
          lock_v == kProceed && (!arcs || !(all & (kViolate | kSelf)));
      if (lane == src)
        verdict = lock_v != kProceed ? lock_v
                                     : (allowed ? kProceed : kBlock);
      if (!allowed) continue;
      // 3. apply: bit t of the column (by the lane that owns word tw); with
      //    arcs, t's class bit, the arcs into t's row (a read: P[t]) or
      //    column (a write: PT[t]) and their class bits, each lane its own
      //    words, then bit t of each new arc's row in the other
      //    orientation, and the prec byte of each arc
      if (me_lane)
        red_or<kRoute>((w ? s.WC : s.R) + xo - KU * lane + tw, tb);
      if (!arcs) continue;
      uint32_t* own_row = (w ? s.PT : s.P) + to;
      uint32_t* other = w ? s.P : s.PT;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const unsigned me = u == tw % KU ? me_lane : 0u;
        if (w) {
          pd[u] |= me;
          pg[u] |= nb[u];
        } else {
          pg[u] |= me;
          pd[u] |= nb[u];
        }
        if (!nb[u]) continue;
        red_or<kRoute>(own_row + u, nb[u]);
        for (unsigned bits = nb[u]; bits; bits &= bits - 1) {
          const int k = 32 * (KU * lane + u) + __ffs(bits) - 1;
          red_or<kRoute>(other + static_cast<size_t>(k) * s.S + tw, tb);
          prec[w ? static_cast<size_t>(k) * n + t
                 : static_cast<size_t>(t) * n + k] = true;
        }
      }
      // another lane's word (bit t of row k) is read in a later step
      __syncwarp();
    }
    chunk_out(base + lane, m, verdict, mine, W, read_set, write_set,
              admitted, blocked, aborted);
  }
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const int i = KU * lane + u;
    if (in[u]) {
      PG[i] = pg[u];
      PD[i] = pd[u];
    }
  }
}

// The walk where a lane's words do not fit in registers (n > 4,096, the
// global route only): the flags and the step's new-arc words NB in shared
// memory, KW words a lane loaded together, no prefetch.
template <int kRoute>
__device__ __forceinline__ void walk_wide(
    int n, int W, int m, int lane, const Packed& s, const uint32_t* HL,
    const uint32_t* AC, uint32_t* PG, uint32_t* PD, uint32_t* NB,
    int32_t* read_set, int32_t* write_set, bool* prec,
    const int32_t* __restrict__ txn, const int32_t* __restrict__ item,
    const bool* __restrict__ is_write, const bool* __restrict__ valid,
    bool* __restrict__ admitted, bool* __restrict__ blocked,
    bool* __restrict__ aborted) {
  constexpr int KW = 4;
  const int nw = words_of(n), items = 32 * W;
  OpRef nxt = load_op(txn, item, is_write, valid, lane, m);
  for (int base = 0; base < m; base += 32) {
    const OpRef mine = nxt;
    nxt = load_op(txn, item, is_write, valid, base + 32 + lane, m);
    unsigned todo = __ballot_sync(
        kFull, (mine.f & 1u) && mine.t >= 0 && mine.t < n && mine.x >= 0 &&
                   mine.x < items);
    int verdict = -1;
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int t = __shfl_sync(kFull, mine.t, src);
      const int x = __shfl_sync(kFull, mine.x, src);
      const bool w = __shfl_sync(kFull, mine.f, src) & 2u;
      const int tw = t >> 5;
      const unsigned tb = 1u << (t & 31);
      const unsigned self = (w ? PG[tw] : PD[tw]) & tb;
      unsigned locked = 0, owner_prec = 0, any_new = 0, violate = 0;
      for (int w0 = 0; w0 < nw; w0 += 32 * KW) {
        Words<KW> v;
        const Packed sw{s.P + w0, s.PT + w0, s.R + w0, s.WC + w0, s.S};
        load_words<kRoute, KW>(v, sw, nw - w0, lane, t, x);
#pragma unroll
        for (int u = 0; u < KW; ++u) {
          const int i = w0 + lane + 32 * u;
          if (i >= nw) break;
          const unsigned me = i == tw ? tb : 0u;
          const unsigned own = v.wc[u] & HL[i];
          locked |= own & ~me;
          owner_prec |= own & v.pr[u];
          unsigned nb;
          if (w) {
            nb = v.rc[u] & AC[i] & ~me & ~v.pc[u];
            violate |= nb & PD[i];
          } else {
            nb = v.wc[u] & AC[i] & ~me & ~v.pr[u];
            violate |= nb & PG[i];
          }
          any_new |= nb;
          NB[i] = nb;
        }
      }
      const unsigned all = __reduce_or_sync(
          kFull, (locked ? kLocked : 0u) | (owner_prec ? kPrecOwner : 0u) |
                     (any_new ? kAnyNew : 0u) | (violate ? kViolate : 0u));
      const int lock_v = (all & kLocked)
                             ? ((all & kPrecOwner) ? kAbort : kBlock)
                             : kProceed;
      const bool arcs = all & kAnyNew;
      const bool allowed =
          lock_v == kProceed && (!arcs || !((all & kViolate) || self));
      if (lane == src)
        verdict = lock_v != kProceed ? lock_v
                                     : (allowed ? kProceed : kBlock);
      if (!allowed) continue;
      if (lane == (tw & 31))
        red_or<kRoute>((w ? s.WC : s.R) + static_cast<size_t>(x) * s.S + tw,
                       tb);
      if (arcs) {
        if (lane == (tw & 31)) (w ? PD : PG)[tw] |= tb;
        uint32_t* own_row = (w ? s.PT : s.P) + static_cast<size_t>(t) * s.S;
        uint32_t* other = w ? s.P : s.PT;
        uint32_t* cls = w ? PG : PD;
        for (int i = lane; i < nw; i += 32) {
          const unsigned nb = NB[i];
          if (!nb) continue;
          red_or<kRoute>(own_row + i, nb);
          cls[i] |= nb;
          for (unsigned bits = nb; bits; bits &= bits - 1) {
            const int k = 32 * i + __ffs(bits) - 1;
            red_or<kRoute>(other + static_cast<size_t>(k) * s.S + tw, tb);
            prec[w ? static_cast<size_t>(k) * n + t
                   : static_cast<size_t>(t) * n + k] = true;
          }
        }
      }
      __syncwarp();
    }
    chunk_out(base + lane, m, verdict, mine, W, read_set, write_set,
              admitted, blocked, aborted);
  }
}

// One CTA per lane.  Every warp packs the flags (and on the shared route
// the whole state); warp 0 walks while the others wait at the barrier;
// every warp unpacks the class flags.  The sets and prec are the outputs
// (copies of the input the wrapper made), updated in place; the flags are
// read from the inputs and written to the outputs.  KU: the words a lane
// holds in registers (walk_regs), 0 for walk_wide.
template <int kRoute, int KU>
__global__ void __launch_bounds__(kWalkThreads)
admit_ops_walk(int n, int W, int m, int32_t* __restrict__ read_set,
               int32_t* __restrict__ write_set, bool* __restrict__ prec,
               const bool* __restrict__ preceding_in,
               const bool* __restrict__ preceded_in,
               bool* __restrict__ preceding, bool* __restrict__ preceded,
               const bool* __restrict__ active,
               const bool* __restrict__ haslocks,
               const int32_t* __restrict__ txn,
               const int32_t* __restrict__ item,
               const bool* __restrict__ is_write,
               const bool* __restrict__ valid, bool* __restrict__ admitted,
               bool* __restrict__ blocked, bool* __restrict__ aborted,
               uint32_t* __restrict__ scratch) {
  extern __shared__ uint32_t smem[];
  const int ln = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nw = words_of(n), S = stride_of(kRoute, n), items = 32 * W;
  uint32_t* HL = smem;
  uint32_t* AC = HL + nw;
  uint32_t* PG = AC + nw;
  uint32_t* PD = PG + nw;
  uint32_t* NB = PD + nw;
  uint32_t* P = kRoute == kShared
                    ? NB + nw
                    : scratch + ln * packed_words(kRoute, n, W);
  uint32_t* PT = P + static_cast<size_t>(n) * S;
  uint32_t* R = PT + static_cast<size_t>(n) * S;
  uint32_t* WC = R + static_cast<size_t>(items) * S;

  const size_t rows = static_cast<size_t>(ln) * n;
  read_set += rows * W;
  write_set += rows * W;
  prec += rows * n;
  preceding_in += rows;
  preceded_in += rows;
  preceding += rows;
  preceded += rows;
  active += rows;
  haslocks += rows;
  const size_t ops = static_cast<size_t>(ln) * m;

  for (int g = warp; g < nw; g += nwarps) {
    const int k = 32 * g + lane;
    const bool in = k < n;
    const unsigned hl = __ballot_sync(kFull, in && haslocks[k]);
    const unsigned ac = __ballot_sync(kFull, in && active[k]);
    const unsigned pg = __ballot_sync(kFull, in && preceding_in[k]);
    const unsigned pd = __ballot_sync(kFull, in && preceded_in[k]);
    if (lane == 0) {
      HL[g] = hl;
      AC[g] = ac;
      PG[g] = pg;
      PD[g] = pd;
    }
  }
  if constexpr (kRoute == kShared) {
    const uint32_t* rs = reinterpret_cast<const uint32_t*>(read_set);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(write_set);
    pack_rows(prec, n, S, P, 32LL * warp, 32LL * nwarps, lane);
    transpose_blocks<true>(rs, n, W, W, R, items, S, warp, nwarps, lane);
    transpose_blocks<true>(ws, n, W, W, WC, items, S, warp, nwarps, lane);
    __syncthreads();
    transpose_blocks<false>(P, n, nw, S, PT, n, S, warp, nwarps, lane);
  }
  __syncthreads();
  if (warp == 0) {
    const Packed st{P, PT, R, WC, S};
    if constexpr (KU > 0)
      walk_regs<kRoute, KU>(n, W, m, lane, st, HL, AC, PG, PD, read_set,
                            write_set, prec, txn + ops, item + ops,
                            is_write + ops, valid + ops, admitted + ops,
                            blocked + ops, aborted + ops);
    else
      walk_wide<kRoute>(n, W, m, lane, st, HL, AC, PG, PD, NB, read_set,
                        write_set, prec, txn + ops, item + ops,
                        is_write + ops, valid + ops, admitted + ops,
                        blocked + ops, aborted + ops);
  }
  __syncthreads();
  for (int k = tid; k < n; k += blockDim.x) {
    preceding[k] = (PG[k >> 5] >> (k & 31)) & 1u;
    preceded[k] = (PD[k >> 5] >> (k & 31)) & 1u;
  }
}

// The global route's packing, over the whole card: P from prec's bytes.
__global__ void __launch_bounds__(kPrepThreads)
admit_ops_pack_rows(int lanes, int n, int W, const bool* __restrict__ prec,
                    uint32_t* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long gw = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const long long nwarps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int S = stride_of(kGlobal, n);
  for (int ln = blockIdx.y; ln < lanes; ln += gridDim.y)
    pack_rows(prec + static_cast<size_t>(ln) * n * n, n, S,
              scratch + ln * packed_words(kGlobal, n, W), 32 * gw,
              32 * nwarps, lane);
}

// The global route's transposes, over the whole card: R and WC from the
// sets (blockIdx.z 0 and 1), PT from P (blockIdx.z 2).
__global__ void __launch_bounds__(kPrepThreads)
admit_ops_transpose(int lanes, int n, int W,
                    const int32_t* __restrict__ read_set,
                    const int32_t* __restrict__ write_set,
                    uint32_t* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const long long gw = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const long long nwarps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int S = stride_of(kGlobal, n), items = 32 * W;
  for (int ln = blockIdx.y; ln < lanes; ln += gridDim.y) {
    uint32_t* P = scratch + ln * packed_words(kGlobal, n, W);
    uint32_t* PT = P + static_cast<size_t>(n) * S;
    uint32_t* R = PT + static_cast<size_t>(n) * S;
    uint32_t* WC = R + static_cast<size_t>(items) * S;
    const size_t set = static_cast<size_t>(ln) * n * W;
    if (blockIdx.z == 2)
      transpose_blocks<false>(P, n, words_of(n), S, PT, n, S, gw, nwarps,
                              lane);
    else
      transpose_blocks<true>(reinterpret_cast<const uint32_t*>(
                           (blockIdx.z ? write_set : read_set) + set),
                       n, W, W, blockIdx.z ? WC : R, items, S, gw, nwarps,
                       lane);
  }
}

int grid_for(long long warp_tasks) {
  const long long warps_per_block = kPrepThreads / 32;
  long long b = (warp_tasks + warps_per_block - 1) / warps_per_block;
  return static_cast<int>(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

template <int kRoute, int KU>
cudaError_t launch_walk(int lanes, int n, int W, int m, void* read_set,
                        void* write_set, void* prec,
                        const void* preceding_in, const void* preceded_in,
                        void* preceding, void* preceded, const void* active,
                        const void* haslocks, const void* txn,
                        const void* item, const void* is_write,
                        const void* valid, void* admitted, void* blocked,
                        void* aborted, void* scratch, cudaStream_t stream) {
  auto kernel = admit_ops_walk<kRoute, KU>;
  const size_t smem = smem_bytes(kRoute, n, W);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<lanes, kWalkThreads, smem, stream>>>(
      n, W, m, static_cast<int32_t*>(read_set),
      static_cast<int32_t*>(write_set), static_cast<bool*>(prec),
      static_cast<const bool*>(preceding_in),
      static_cast<const bool*>(preceded_in), static_cast<bool*>(preceding),
      static_cast<bool*>(preceded), static_cast<const bool*>(active),
      static_cast<const bool*>(haslocks), static_cast<const int32_t*>(txn),
      static_cast<const int32_t*>(item), static_cast<const bool*>(is_write),
      static_cast<const bool*>(valid), static_cast<bool*>(admitted),
      static_cast<bool*>(blocked), static_cast<bool*>(aborted),
      static_cast<uint32_t*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the walk on `route` (0 shared, 1 global) at n
// slots and W words of items: the wrapper's route() must agree.
long long admit_ops_smem_bytes(int route, int n, int W) {
  return static_cast<long long>(smem_bytes(route, n, W));
}

// Words of the global route's scratch at lanes x n x W (0 on the shared
// route).
long long admit_ops_scratch_words(int route, int lanes, int n, int W) {
  return route == kGlobal
             ? static_cast<long long>(lanes) *
                   static_cast<long long>(packed_words(route, n, W))
             : 0;
}

// One host call: on the shared route one kernel (a CTA per lane), on the
// global route the two packing kernels and the walk.  The sets
// (int32[L, n, W]) and prec (bool[L, n, n]) are the outputs, copies of the
// input state that the kernel updates in place; the class flags are read
// from preceding_in / preceded_in and written to preceding / preceded
// (bool[L, n]); the ops are [L, m]; the three verdict outputs bool[L, m]
// are written whole.  `scratch` holds admit_ops_scratch_words int32 words.
// Returns a cudaError_t (0 on success).
int admit_ops_launch(int route, int lanes, int n, int W, int m,
                     void* read_set, void* write_set, void* prec,
                     const void* preceding_in, const void* preceded_in,
                     void* preceding, void* preceded, const void* active,
                     const void* haslocks, const void* txn, const void* item,
                     const void* is_write, const void* valid, void* admitted,
                     void* blocked, void* aborted, void* scratch,
                     long long scratch_words, void* stream) {
  if ((route != kShared && route != kGlobal) || lanes < 0 || n < 1 ||
      W < 1 || W >= (1 << 26) || m < 0 ||
      smem_bytes(route, n, W) > kSmemLimit ||
      scratch_words < admit_ops_scratch_words(route, lanes, n, W))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 || m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* scr = static_cast<uint32_t*>(scratch);
  if (route == kGlobal) {
    const int nw = words_of(n);
    const int ly = lanes < 65535 ? lanes : 65535;
    admit_ops_pack_rows<<<dim3(grid_for((static_cast<long long>(n) * nw +
                                         31) / 32), ly),
                          kPrepThreads, 0, s>>>(
        lanes, n, W, static_cast<const bool*>(prec), scr);
    const long long blocks =
        static_cast<long long>(nw) * (W > nw ? W : nw);
    admit_ops_transpose<<<dim3(grid_for((blocks + 3) / 4), ly, 3),
                          kPrepThreads, 0, s>>>(
        lanes, n, W, static_cast<const int32_t*>(read_set),
        static_cast<const int32_t*>(write_set), scr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int K = (words_of(n) + 31) >> 5;
#define ADMIT_OPS_WALK(R_, KU_)                                             \
  launch_walk<R_, KU_>(lanes, n, W, m, read_set, write_set, prec,         \
                       preceding_in, preceded_in, preceding, preceded,    \
                       active, haslocks, txn, item, is_write, valid,      \
                       admitted, blocked, aborted, scr, s)
  cudaError_t e;
  if (route == kShared)          // n <= 928 here: one word a lane
    e = K == 1 ? ADMIT_OPS_WALK(kShared, 1) : cudaErrorInvalidValue;
  else
    e = K == 1   ? ADMIT_OPS_WALK(kGlobal, 1)
        : K == 2 ? ADMIT_OPS_WALK(kGlobal, 2)
        : K <= 4 ? ADMIT_OPS_WALK(kGlobal, 4)
                 : ADMIT_OPS_WALK(kGlobal, 0);
#undef ADMIT_OPS_WALK
  return static_cast<int>(e);
}

}  // extern "C"
