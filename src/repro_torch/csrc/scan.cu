// The two sequential scans of the fleet body, one launch each, for Hopper
// (sm_90a).  They are not TPU kernels: they replace XLA scans of the JAX
// reference, which a loop of torch operations would turn into one launch
// per slot.
//
//   reserve_cohort  repro/core/jaxsim.py::_reserve_cohort — FCFS
//                   reservation over the slots in index order: a slot that
//                   asks for a CPU (a disk) takes the first server of least
//                   free_at and is done at max(t_req, free_at) + duration.
//   occ_validate    the OCC same-iteration validation scan
//                   (occ_validate_multi in jaxsim._cohort_body): a would-be
//                   committer fails when its read row meets its dirty row
//                   or the write rows of the lower committers that passed.
//
// Each computes exactly its plain version in repro_torch/kernels/ref.py.
// The kernels only add, compare, take maxima and combine bits; they are
// built with --fmad=false all the same, and the one addition is written as
// __fadd_rn.
//
// Design of reserve_cohort.  What the semantics allow: a CPU step reads and
// writes only the CPU pool and a disk step only the disk pool, so the two
// pools are two independent chains; and a slot whose mask is off leaves
// its pool alone and outputs INF, so only the masked slots are steps.  One
// CTA of two warps per lane: warp 0 walks the CPU pool, warp 1 the disk
// pool.  A warp takes its slots 32 at a time, one slot a thread, with the
// next 32 slots' inputs already loaded (coalesced) while it steps through
// these; a ballot of the masks compacts the chunk's steps, the unmasked
// slots write INF at once, and each step's request time and duration come
// to the warp by shuffle, off the chain.  The pool lives in registers, one
// server per thread (server s in register s / 32 of thread s % 32, pools
// up to 384 servers).  A step is then:
//   key*  = min over the warp of the servers' order keys (__reduce_min_sync
//           on keys that order as the floats do, +0 and -0 alike)
//   owner = the lowest server index whose key is key* (a ballot, so ties,
//           the normal case at init and in the INF tails of the padded
//           pools, go to the lowest index as jnp.argmin and torch.argmin
//           send them)
//   the owner writes done = __fadd_rn(fmaxf(t_req, free), dur) into its
//   register and to cpu_done / disk_done.
// Free times are never NaN.  A second layout, the whole pool in every
// thread's registers with an unrolled compare tree, measured slower
// (PERF.md) and is not kept.
//
// Bound of reserve_cohort.  At the main path's shape (168 lanes, n = 160,
// 16 CPUs, 32 disks) a launch moves 168 x (160 x (3 x 4 + 2 + 2 x 4) + 2 x
// 48 x 4) B, about 0.66 MB: 0.2 us at 3.35 TB/s.  What bounds it is the
// longest chain of dependent steps, the most masked slots of one pool of
// one lane; chip_smoke.py models it (the kernel row's chain bound).
//
// Design of occ_validate.  What the semantics allow: a slot whose
// commit_pre is off is no step (its fail is 0 and it adds nothing to the
// accumulated writes), and a committer's read, dirty and write rows do not
// depend on the chain, only acc does.  One warp per lane (a CTA of one
// warp): word q of the lane's rows is word r = q / 32 of thread q % 32, and
// acc lives in registers the same way (W up to 384, 12 words a thread).
// The warp takes its slots in chunks of up to 32: a ballot of commit_pre
// compacts the chunk's committers, whose three rows are copied by cp.async
// into a shared-memory buffer (16-byte copies where W % 4 == 0), the next
// chunk's while the warp steps through this one (two buffers; commit_pre
// is loaded two chunks ahead).  Each thread keeps the fail of its own slot
// and the warp stores the chunk's 32 fail bytes at once, 0 at the slots
// that are no step.  A step, with the committer's words read from shared
// memory one step ahead, is then
//   meet = read[q] & (dirty[q] | acc[q])        (one LOP3 a word)
//   f    = __any_sync over the warp of meet != 0
//   acc  = f ? acc : acc | write                (the OR taken off the chain)
// four dependent instructions.  A chunk is 32 slots while its two buffers
// of 32 x 3 rows fit a CTA's shared memory (W <= 302), fewer above.
//
// Bound of occ_validate.  At the main shape (168 lanes, n = 160, W = 16) a
// launch moves at most 168 x (160 x 3 x 16 x 4 + 2 x 160) B, about 5.2 MB,
// 1.6 us at 3.35 TB/s, and only the committers' rows are needed; the chain
// is the most committers in one lane x 4 dependent instructions, which
// chip_smoke.py models beside the byte bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kResThreads = 64;       // reserve_cohort: two warps per lane
constexpr int kMaxServersPerThread = 12;
constexpr int kMaxWordsPerThread = 12;  // occ_validate: W up to 384
constexpr int kSmemMax = 232448;        // shared memory one CTA may use
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoServer = 0xffffffffu;  // above every float's key

// A key whose unsigned order is the float order, with +0 and -0 equal.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? 0x80000000u - (b & 0x7fffffffu)
                           : b + 0x80000000u;
}

// The pool of one warp: its inputs and outputs for one lane.
struct Pool {
  const float* free_in;
  float* free_out;
  const float* dur;
  const uint8_t* mask;
  float* done;
  int np;
};

// Walk the lane's slots 32 at a time and call step(t_req, dur, slot) for
// each masked slot in index order; write INF for the unmasked ones.  The
// inputs of the next chunk are loaded before this chunk's steps.
template <typename Step>
__device__ __forceinline__ void walk_masked(const float* __restrict__ t_req,
                                            const Pool& p, int n, float inf,
                                            Step step) {
  const int lane = threadIdx.x & 31;
  float t_nx = 0.f, d_nx = 0.f;
  bool m_nx = false;
  if (lane < n) {
    t_nx = t_req[lane];
    d_nx = p.dur[lane];
    m_nx = p.mask[lane] != 0;
  }
  for (int c0 = 0; c0 < n; c0 += 32) {
    const float tc = t_nx, dc = d_nx;
    const bool mc = m_nx;
    const int nx = c0 + 32 + lane;
    m_nx = false;
    if (nx < n) {
      t_nx = t_req[nx];
      d_nx = p.dur[nx];
      m_nx = p.mask[nx] != 0;
    }
    if (c0 + lane < n && !mc) p.done[c0 + lane] = inf;
    uint32_t todo = __ballot_sync(kFull, mc);
    while (todo) {
      const int b = __ffs(todo) - 1;
      todo &= todo - 1;
      step(__shfl_sync(kFull, tc, b), __shfl_sync(kFull, dc, b), c0 + b);
    }
  }
}

// Server s in register s / 32 of thread s % 32.
template <int S>
__device__ void reserve_pool_warp(const float* __restrict__ t_req,
                                  const Pool& p, int n, float inf) {
  const int lane = threadIdx.x & 31;
  float v[S];
  uint32_t key[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int s = r * 32 + lane;
    v[r] = s < p.np ? p.free_in[s] : 0.f;
    key[r] = s < p.np ? order_key(v[r]) : kNoServer;
  }
  uint32_t me;  // this thread's bit of a ballot
  asm("mov.u32 %0, %%lanemask_eq;" : "=r"(me));
  walk_masked(t_req, p, n, inf, [&](float t, float d, int slot) {
    uint32_t kmin = key[0];
#pragma unroll
    for (int r = 1; r < S; ++r) kmin = min(kmin, key[r]);
    kmin = __reduce_min_sync(kFull, kmin);
    // the lowest register holding key*, then its lowest thread
    int rr = 0;
    uint32_t hit = 0;
#pragma unroll
    for (int r = S - 1; r >= 0; --r) {
      const uint32_t h = __ballot_sync(kFull, key[r] == kmin);
      if (h) {
        hit = h;
        rr = r;
      }
    }
    float vo = v[0];
#pragma unroll
    for (int r = 1; r < S; ++r) vo = r == rr ? v[r] : vo;
    const float dn = __fadd_rn(fmaxf(t, vo), d);
    const bool mine = (hit & (0u - hit)) == me;
    const uint32_t kn = order_key(dn);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const bool upd = mine && r == rr;
      v[r] = upd ? dn : v[r];
      key[r] = upd ? kn : key[r];
    }
    if (mine) p.done[slot] = dn;
  });
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int s = r * 32 + lane;
    if (s < p.np) p.free_out[s] = v[r];
  }
}

template <int S>
__global__ void __launch_bounds__(kResThreads)
reserve_cohort_kernel(const float* __restrict__ cpu_in,
                      const float* __restrict__ disk_in,
                      const float* __restrict__ t_req,
                      const float* __restrict__ cpu_dur,
                      const float* __restrict__ io_dur,
                      const uint8_t* __restrict__ cpu_m,
                      const uint8_t* __restrict__ disk_m,
                      float* __restrict__ cpu_out,
                      float* __restrict__ disk_out,
                      float* __restrict__ cpu_done,
                      float* __restrict__ disk_done, int n, int nc, int nd,
                      float inf) {
  const size_t l = blockIdx.x;
  const size_t v = l * n;
  const bool disk = threadIdx.x >= 32;
  const Pool p = disk ? Pool{disk_in + l * nd, disk_out + l * nd, io_dur + v,
                             disk_m + v, disk_done + v, nd}
                      : Pool{cpu_in + l * nc, cpu_out + l * nc, cpu_dur + v,
                             cpu_m + v, cpu_done + v, nc};
  reserve_pool_warp<S>(t_req + v, p, n, inf);
}

template <int S>
int launch_reserve(const void* const* a, int lanes, int n, int nc, int nd,
                   float inf, cudaStream_t stream) {
  reserve_cohort_kernel<S><<<lanes, kResThreads, 0, stream>>>(
      static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
      static_cast<const float*>(a[2]), static_cast<const float*>(a[3]),
      static_cast<const float*>(a[4]), static_cast<const uint8_t*>(a[5]),
      static_cast<const uint8_t*>(a[6]), (float*)a[7], (float*)a[8],
      (float*)a[9], (float*)a[10], n, nc, nd, inf);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Committer b's words of this thread from its rows in shared memory
// (read, dirty, write, each w words); 0 past the row.
template <int S>
__device__ __forceinline__ void committer_words(const uint32_t* rows, int b,
                                                int w, uint32_t (&x)[S],
                                                uint32_t (&d)[S],
                                                uint32_t (&v)[S]) {
  const uint32_t* rr = rows + b * 3 * w;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int q = r * 32 + lane;
    const bool in = q < w;
    x[r] = in ? rr[q] : 0u;
    d[r] = in ? rr[w + q] : 0u;
    v[r] = in ? rr[2 * w + q] : 0u;
  }
}

// S = ceil(W / 32) words a thread.  Shared memory: two buffers of `chunk`
// slots x (read, dirty, write) rows of w words.
template <int S>
__global__ void __launch_bounds__(32)
occ_validate_kernel(const uint8_t* __restrict__ commit_pre,
                    const uint32_t* __restrict__ read,
                    const uint32_t* __restrict__ dirty,
                    const uint32_t* __restrict__ write,
                    uint8_t* __restrict__ fail, int n, int w, int chunk,
                    bool vec) {
  extern __shared__ __align__(16) uint32_t rows_s[];
  const int t = threadIdx.x;
  const size_t l = blockIdx.x;
  const uint8_t* cp = commit_pre + l * n;
  uint8_t* fo = fail + l * n;
  const size_t lw = l * size_t(n) * w;
  const int buf_words = chunk * 3 * w;

  // copy the rows of the committers in `bal` (slots c0 + bit) into buffer
  // `buf`, as one cp.async group
  auto stage = [&](int c0, uint32_t bal, int buf) {
    uint32_t* dst = rows_s + buf * buf_words;
    const int unit = vec ? 4 : 1;
    const int units = w / unit;          // copies a row
    while (bal) {
      const int b = __ffs(bal) - 1;
      bal &= bal - 1;
      const size_t g = lw + size_t(c0 + b) * w;
      uint32_t* d = dst + b * 3 * w;
      for (int u = t; u < 3 * units; u += 32) {
        const int a = u >= 2 * units ? 2 : u >= units ? 1 : 0;
        const int o = (u - a * units) * unit;
        const uint32_t* src = (a == 0 ? read : a == 1 ? dirty : write) + g + o;
        if (vec)
          cp_async16(d + a * w + o, src);
        else
          cp_async4(d + a * w + o, src);
      }
    }
    cp_async_commit();
  };

  uint32_t acc[S];
#pragma unroll
  for (int r = 0; r < S; ++r) acc[r] = 0u;
  uint32_t bal = __ballot_sync(kFull, t < chunk && t < n && cp[t]);
  stage(0, bal, 0);
  bool m_nx = t < chunk && chunk + t < n && cp[chunk + t];
  int buf = 0;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const uint32_t bal_nx = __ballot_sync(kFull, m_nx);
    if (c0 + chunk < n)
      stage(c0 + chunk, bal_nx, buf ^ 1);
    else
      cp_async_commit();                 // keeps one group per chunk
    const int c2 = c0 + 2 * chunk + t;
    m_nx = t < chunk && c2 < n && cp[c2];
    cp_async_wait<1>();                  // this chunk's rows have landed
    __syncwarp();

    const uint32_t* rows = rows_s + buf * buf_words;
    bool my_fail = false;
    uint32_t todo = bal;
    int b = todo ? __ffs(todo) - 1 : 0;
    uint32_t x[S], d[S], v[S];
    committer_words<S>(rows, b, w, x, d, v);
    while (todo) {
      todo &= todo - 1;
      const int b_nx = todo ? __ffs(todo) - 1 : b;
      uint32_t xn[S], dn[S], vn[S];
      committer_words<S>(rows, b_nx, w, xn, dn, vn);
      uint32_t meet = 0u;
#pragma unroll
      for (int r = 0; r < S; ++r) meet |= x[r] & (d[r] | acc[r]);
      const bool f = __any_sync(kFull, meet != 0u);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        acc[r] = f ? acc[r] : acc[r] | v[r];
        x[r] = xn[r];
        d[r] = dn[r];
        v[r] = vn[r];
      }
      my_fail = t == b ? f : my_fail;
      b = b_nx;
    }
    if (t < chunk && c0 + t < n) fo[c0 + t] = my_fail;
    __syncwarp();                        // before the buffer is refilled
    bal = bal_nx;
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// The slots of a chunk: 32 while two buffers of 32 committers' three
// rows fit one CTA's shared memory.
int occ_chunk(int w) {
  const int c = kSmemMax / (2 * 3 * 4 * (w > 0 ? w : 1));
  return c < 32 ? c : 32;
}

template <int S>
int launch_occ(const void* const* a, int lanes, int n, int w,
               cudaStream_t stream) {
  const int chunk = occ_chunk(w);
  const size_t bytes = size_t(2) * chunk * 3 * w * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        occ_validate_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bool vec = w % 4 == 0;
  for (int k = 1; k < 4; ++k)
    vec = vec && reinterpret_cast<uintptr_t>(a[k]) % 16 == 0;
  occ_validate_kernel<S><<<lanes, 32, bytes, stream>>>(
      static_cast<const uint8_t*>(a[0]), static_cast<const uint32_t*>(a[1]),
      static_cast<const uint32_t*>(a[2]), static_cast<const uint32_t*>(a[3]),
      (uint8_t*)a[4], n, w, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest pool one launch of reserve_cohort takes.
int reserve_cohort_max_pool() { return 32 * kMaxServersPerThread; }

// FCFS reservation; returns the cudaError_t of the launch (or
// cudaErrorInvalidValue for a pool it does not take).  cpu_in/disk_in
// float[lanes, nc] / [lanes, nd]; t_req, durations and the *_done outputs
// float[lanes, n]; masks 1 byte each.
int reserve_cohort_launch(const void* cpu_in, const void* disk_in,
                          const void* t_req, const void* cpu_dur,
                          const void* io_dur, const void* cpu_m,
                          const void* disk_m, void* cpu_out, void* disk_out,
                          void* cpu_done, void* disk_done, int lanes, int n,
                          int nc, int nd, float inf, void* stream) {
  const void* a[] = {cpu_in, disk_in, t_req,   cpu_dur,  io_dur,   cpu_m,
                     disk_m, cpu_out, disk_out, cpu_done, disk_done};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np = nc > nd ? nc : nd;
  if (nc < 1 || nd < 1 || np > reserve_cohort_max_pool())
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((np + 31) / 32) {
    case 1: return launch_reserve<1>(a, lanes, n, nc, nd, inf, s);
    case 2: return launch_reserve<2>(a, lanes, n, nc, nd, inf, s);
    case 3: return launch_reserve<3>(a, lanes, n, nc, nd, inf, s);
    case 4: return launch_reserve<4>(a, lanes, n, nc, nd, inf, s);
    case 5: return launch_reserve<5>(a, lanes, n, nc, nd, inf, s);
    case 6: return launch_reserve<6>(a, lanes, n, nc, nd, inf, s);
    case 7: return launch_reserve<7>(a, lanes, n, nc, nd, inf, s);
    case 8: return launch_reserve<8>(a, lanes, n, nc, nd, inf, s);
    case 9: return launch_reserve<9>(a, lanes, n, nc, nd, inf, s);
    case 10: return launch_reserve<10>(a, lanes, n, nc, nd, inf, s);
    case 11: return launch_reserve<11>(a, lanes, n, nc, nd, inf, s);
    default: return launch_reserve<12>(a, lanes, n, nc, nd, inf, s);
  }
}

// The most words a row of occ_validate may have.
int occ_validate_max_words() { return 32 * kMaxWordsPerThread; }

// OCC validation scan; returns the cudaError_t of the launch (or
// cudaErrorInvalidValue for rows it does not take).  Words
// uint32[lanes, n, w]; commit_pre and fail 1 byte each, [lanes, n].
int occ_validate_launch(const void* commit_pre, const void* read,
                        const void* dirty, const void* write, void* fail,
                        int lanes, int n, int w, void* stream) {
  const void* a[] = {commit_pre, read, dirty, write, fail};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 0 || w > occ_validate_max_words())
    return static_cast<int>(cudaErrorInvalidValue);
  switch (w > 32 ? (w + 31) / 32 : 1) {
    case 1: return launch_occ<1>(a, lanes, n, w, s);
    case 2: return launch_occ<2>(a, lanes, n, w, s);
    case 3: return launch_occ<3>(a, lanes, n, w, s);
    case 4: return launch_occ<4>(a, lanes, n, w, s);
    case 5: return launch_occ<5>(a, lanes, n, w, s);
    case 6: return launch_occ<6>(a, lanes, n, w, s);
    case 7: return launch_occ<7>(a, lanes, n, w, s);
    case 8: return launch_occ<8>(a, lanes, n, w, s);
    case 9: return launch_occ<9>(a, lanes, n, w, s);
    case 10: return launch_occ<10>(a, lanes, n, w, s);
    case 11: return launch_occ<11>(a, lanes, n, w, s);
    default: return launch_occ<12>(a, lanes, n, w, s);
  }
}

}  // extern "C"
