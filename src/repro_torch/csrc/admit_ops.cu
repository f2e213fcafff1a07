// PPCC batch admission of an op list, one launch per call, for Hopper
// (sm_90a).  It is not a TPU kernel: it replaces the XLA scan (lax.scan) of
// repro/core/ppcc.py::admit_ops, which walks the op list one try_op at a
// time; a loop of torch operations would cost some thirty launches per op.
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
// Design: one CTA per lane walks the lane's m ops in order; its threads
// split the n slots, thread tid owning slots tid, tid + T, ... (T threads,
// at most 32 slots a thread, so n <= 32 x 1,024).  The state is a copy the
// wrapper made; the kernel mutates it in place.  Everything a step reads or
// writes of slot k -- bit x of k's read and write rows, k's flags, and
// prec[t][k] (a read) or prec[k][t] (a write) -- is touched by k's owner
// only, so a step needs one reduction and no other barrier:
//   1. each thread tests its slots against the pre-step state and ORs five
//      predicates into one word (locked by another, t precedes the owner,
//      an arc to add, an arc to a slot whose class bit forbids it, t's own
//      class bit forbids it), remembering which of its slots get an arc;
//   2. __reduce_or_sync per warp, one word per warp into shared memory
//      (two buffers, alternating, so the next step's writes cannot meet
//      this step's reads), one __syncthreads, and every thread ORs the
//      warps' words: the verdict is known to all;
//   3. if admitted, t's owner sets the bit and t's class bit, each owner of
//      a slot that gets an arc sets it and that slot's class bit.
// One exception to the ownership: prec[a][b] is slot b's in a read by a and
// slot a's in a write by b.  So a step that added arcs ends with a
// __syncthreads, and a step that added none (most, under contention) does
// not.  The four flag vectors live in shared memory, one byte a slot; the
// sets and prec stay in global memory.  A valid op out of range ([0, n) for
// t, [0, 32 W) for x) is skipped: the caller (ppcc.admit_ops) raises on it
// before the launch, and the kernel never touches memory outside its rows.
//
// Bound.  Each step is a chain: the loads of its rows, the reduction and
// the verdict; chip_smoke.py gives the chain and byte bounds beside the
// time.  Making it fast is later work (per step a few scattered loads a
// slot, 16 KB of words at n = 4,096 and W = 1,024).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kProceed = 0, kBlock = 1, kAbort = 2;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSlotsPerThread = 32;

// flag bits of a slot in shared memory
constexpr unsigned char kPreceding = 1, kPreceded = 2, kActive = 4,
                        kHaslocks = 8;
// predicate bits of a step's reduction
constexpr unsigned kLocked = 1, kPrecOwner = 2, kAnyNew = 4, kViolate = 8,
                   kSelf = 16;

__global__ void __launch_bounds__(kMaxThreads)
admit_ops_kernel(int n, int W, int m, int32_t* __restrict__ read_set,
                 int32_t* __restrict__ write_set, bool* __restrict__ prec,
                 bool* __restrict__ preceding, bool* __restrict__ preceded,
                 const bool* __restrict__ active,
                 const bool* __restrict__ haslocks,
                 const int32_t* __restrict__ txn,
                 const int32_t* __restrict__ item,
                 const bool* __restrict__ is_write,
                 const bool* __restrict__ valid, bool* __restrict__ admitted,
                 bool* __restrict__ blocked, bool* __restrict__ aborted) {
  extern __shared__ unsigned char smem[];
  unsigned* red = reinterpret_cast<unsigned*>(smem);   // 2 x 32 words
  unsigned char* flags = smem + 2 * 32 * sizeof(unsigned);
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, nwarps = T >> 5;
  const size_t rows = static_cast<size_t>(lane) * n;
  read_set += rows * W;
  write_set += rows * W;
  prec += rows * n;
  preceding += rows;
  preceded += rows;
  active += rows;
  haslocks += rows;
  const size_t ops = static_cast<size_t>(lane) * m;
  txn += ops;
  item += ops;
  is_write += ops;
  valid += ops;
  admitted += ops;
  blocked += ops;
  aborted += ops;

  for (int k = tid; k < n; k += T)
    flags[k] = (preceding[k] ? kPreceding : 0) |
               (preceded[k] ? kPreceded : 0) | (active[k] ? kActive : 0) |
               (haslocks[k] ? kHaslocks : 0);
  __syncthreads();

  const int xmax = 32 * W;
  int parity = 0;
  for (int j = 0; j < m; ++j) {
    if (!valid[j]) continue;
    const int t = txn[j], x = item[j];
    if (t < 0 || t >= n || x < 0 || x >= xmax) continue;
    const bool w = is_write[j];
    const int wd = x >> 5;
    const unsigned bit = 1u << (x & 31);

    // 1. the predicates on the pre-step state, over this thread's slots
    unsigned pred = 0, mine = 0;
    int s = 0;
    for (int k = tid; k < n; k += T, ++s) {
      const unsigned char f = flags[k];
      const size_t kw = static_cast<size_t>(k) * W + wd;
      const bool wbit = static_cast<unsigned>(write_set[kw]) & bit;
      const bool prow = prec[static_cast<size_t>(t) * n + k];
      const bool me = k == t;
      const bool owner = wbit && (f & kHaslocks);
      if (owner && !me) pred |= kLocked;
      if (owner && prow) pred |= kPrecOwner;
      bool nw;
      if (w) {
        const bool rbit = static_cast<unsigned>(read_set[kw]) & bit;
        const bool pcol = prec[static_cast<size_t>(k) * n + t];
        nw = rbit && (f & kActive) && !me && !pcol;
        if (nw && (f & kPreceded)) pred |= kViolate;
        if (me && (f & kPreceding)) pred |= kSelf;
      } else {
        nw = wbit && (f & kActive) && !me && !prow;
        if (nw && (f & kPreceding)) pred |= kViolate;
        if (me && (f & kPreceded)) pred |= kSelf;
      }
      if (nw) {
        pred |= kAnyNew;
        mine |= 1u << s;
      }
    }

    // 2. OR the predicates over the CTA
    const unsigned r = __reduce_or_sync(0xffffffffu, pred);
    if ((tid & 31) == 0) red[parity * 32 + warp] = r;
    __syncthreads();
    unsigned all = 0;
    for (int q = 0; q < nwarps; ++q) all |= red[parity * 32 + q];
    parity ^= 1;

    const int lock_v = (all & kLocked)
                           ? ((all & kPrecOwner) ? kAbort : kBlock)
                           : kProceed;
    const bool any_new = all & kAnyNew;
    const bool rule_ok = !(all & (kViolate | kSelf));
    const bool allowed = lock_v == kProceed && (!any_new || rule_ok);
    const int verdict =
        lock_v != kProceed ? lock_v : (allowed ? kProceed : kBlock);
    if (tid == 0) {
      admitted[j] = verdict == kProceed;
      blocked[j] = verdict == kBlock;
      aborted[j] = verdict == kAbort;
    }
    if (!allowed) continue;

    // 3. apply: each owner writes its own slots
    s = 0;
    for (int k = tid; k < n; k += T, ++s) {
      if (k == t) {
        int32_t* word = (w ? write_set : read_set) +
                        static_cast<size_t>(k) * W + wd;
        *word = static_cast<int32_t>(static_cast<unsigned>(*word) | bit);
        if (any_new) flags[k] |= w ? kPreceded : kPreceding;
      }
      if (mine & (1u << s)) {
        if (w) {
          prec[static_cast<size_t>(k) * n + t] = true;
          flags[k] |= kPreceding;
        } else {
          prec[static_cast<size_t>(t) * n + k] = true;
          flags[k] |= kPreceded;
        }
      }
    }
    // prec[a][b] changes owner between a read by a and a write by b
    if (any_new) __syncthreads();
  }

  __syncthreads();
  for (int k = tid; k < n; k += T) {
    preceding[k] = flags[k] & kPreceding;
    preceded[k] = flags[k] & kPreceded;
  }
}

int threads_for(int n) {
  int t = ((n + 31) / 32) * 32;
  if (t < 32) t = 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

extern "C" {

// The largest n the kernel takes: 32 slots a thread of a CTA of 1,024.
int admit_ops_max_n() { return kMaxThreads * kMaxSlotsPerThread; }

// One CTA per lane.  The state (sets int32[L, n, W], prec bool[L, n, n],
// the four flags bool[L, n]) is mutated in place; the ops are [L, m]; the
// three verdict outputs bool[L, m] must hold zeros.  Returns a cudaError_t
// (0 on success).
int admit_ops_launch(int lanes, int n, int W, int m, void* read_set,
                     void* write_set, void* prec, void* preceding,
                     void* preceded, const void* active,
                     const void* haslocks, const void* txn, const void* item,
                     const void* is_write, const void* valid, void* admitted,
                     void* blocked, void* aborted, void* stream) {
  if (lanes < 0 || n < 1 || n > admit_ops_max_n() || W < 1 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 || m == 0) return 0;
  const int T = threads_for(n);
  // at most 33,024 bytes: under the 48 KB a launch gets without opting in
  const size_t smem = 2 * 32 * sizeof(unsigned) + n;
  admit_ops_kernel<<<lanes, T, smem, static_cast<cudaStream_t>(stream)>>>(
      n, W, m, static_cast<int32_t*>(read_set),
      static_cast<int32_t*>(write_set), static_cast<bool*>(prec),
      static_cast<bool*>(preceding), static_cast<bool*>(preceded),
      static_cast<const bool*>(active), static_cast<const bool*>(haslocks),
      static_cast<const int32_t*>(txn), static_cast<const int32_t*>(item),
      static_cast<const bool*>(is_write), static_cast<const bool*>(valid),
      static_cast<bool*>(admitted), static_cast<bool*>(blocked),
      static_cast<bool*>(aborted));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
