// The batch scheduler's three admission scans, one launch per tick each,
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
//                precedence rows and columns follow, in the reference's
//                update order (row i of prec, then column i).
//   twopl_admit  twopl_tick's step (:223-228): i in index order is
//                admitted unless (raw | raw^T | ww) meets an admitted j.
//   occ_admit    occ_tick's step (:247-254): i survives unless raw | ww
//                meets an earlier survivor.
//
// Each computes exactly its plain version in repro_torch/kernels/ref.py.
//
// Bound.  A step reads one or two rows of n bools: at n = 4,096 a tick
// reads 2 x 16 MB (ppcc) and writes at most 16 MB of prec, about 15 us of
// bytes at 3.35 TB/s.  What bounds the scans in practice is the chain of
// n dependent steps, each ending in a block-wide reduction.
//
// Design.  One CTA of 1,024 threads walks the transactions in order, its
// threads striding over j; only the entries of admitted j are read, and a
// thread issues its loads of one j together, not one after another.
// Thread t owns the j = t (mod 1,024) entries of the per-transaction flags
// in shared memory and is the only thread that reads or writes them, so a
// step needs no barrier but its reduction.
// ppcc_admit reads column i of raw as row i of its transpose, which the
// wrapper passes contiguous, and folds its four any-reductions into one:
// a warp ORs a 4-bit mask with __reduce_or_sync, one lane per warp ORs it
// into a shared word, and one __syncthreads publishes it.  The shared word
// rotates through three slots, so the slot that thread 0 clears was last
// read a whole step earlier.  twopl_admit and occ_admit need one bit and
// use __syncthreads_or.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
ppcc_admit_kernel(const uint8_t* __restrict__ raw,
                  const uint8_t* __restrict__ raw_t,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ seq, int n,
                  uint8_t* __restrict__ admitted,
                  uint8_t* __restrict__ preceding,
                  uint8_t* __restrict__ preceded, uint8_t* __restrict__ prec) {
  extern __shared__ uint8_t s_flags[];  // admitted, preceding, preceded
  __shared__ unsigned s_any[3];
  uint8_t* s_adm = s_flags;
  uint8_t* s_pg = s_flags + n;
  uint8_t* s_pd = s_flags + 2 * n;
  const int tid = threadIdx.x, bs = blockDim.x;
  for (int j = tid; j < n; j += bs) s_adm[j] = s_pg[j] = s_pd[j] = 0;
  if (tid < 3) s_any[tid] = 0u;
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    const int i = seq[t];
    const uint8_t* ri = raw + size_t(i) * n;    // raw[i, :]
    const uint8_t* wi = raw_t + size_t(i) * n;  // raw[:, i]
    unsigned f = 0u;
    for (int j = tid; j < n; j += bs) {
      const bool a = s_adm[j];
      const bool r = a && ri[j];
      const bool w = a && wi[j];
      f |= unsigned(r) | (unsigned(w) << 1) | (unsigned(r && s_pg[j]) << 2) |
           (unsigned(w && s_pd[j]) << 3);
    }
    f = __reduce_or_sync(0xffffffffu, f);
    const int slot = t % 3;
    if ((tid & 31) == 0 && f) atomicOr(&s_any[slot], f);
    __syncthreads();
    f = s_any[slot];
    if (tid == 0) s_any[(t + 2) % 3] = 0u;   // last read in step t - 1
    const bool any_r = f & 1u, any_w = f & 2u;
    const bool ok = valid[i] && !(any_r && any_w) && !(f & 4u) && !(f & 8u);
    if (ok) {
      for (int j = tid; j < n; j += bs) {
        const bool a = s_adm[j];
        const bool r = a && ri[j];
        const bool w = a && wi[j];
        if (j == i) {
          s_pg[j] = any_r || w;     // preceding.at[i].set(ok & any_r) | w_i
          s_pd[j] = any_w || r;
        } else {
          s_pg[j] |= w;
          s_pd[j] |= r;
        }
        prec[size_t(i) * n + j] = r;   // prec[i, :] = r_i first,
        prec[size_t(j) * n + i] = w;   // then prec[:, i] = w_i
      }
    }
    if (i % bs == tid) s_adm[i] = ok;
  }
  __syncthreads();
  for (int j = tid; j < n; j += bs) {
    admitted[j] = s_adm[j];
    preceding[j] = s_pg[j];
    preceded[j] = s_pd[j];
  }
}

__global__ void __launch_bounds__(kThreads)
twopl_admit_kernel(const uint8_t* __restrict__ raw,
                   const uint8_t* __restrict__ raw_t,
                   const uint8_t* __restrict__ ww,
                   const uint8_t* __restrict__ valid, int n,
                   uint8_t* __restrict__ admitted) {
  extern __shared__ uint8_t s_adm[];
  const int tid = threadIdx.x, bs = blockDim.x;
  for (int j = tid; j < n; j += bs) s_adm[j] = 0;
  for (int i = 0; i < n; ++i) {
    const size_t row = size_t(i) * n;
    bool hit = false;
    for (int j = tid; j < n; j += bs)   // three loads in flight at once
      if (j != i && s_adm[j])
        hit |= (raw[row + j] | raw_t[row + j] | ww[row + j]) != 0;
    const bool ok = valid[i] && !__syncthreads_or(hit);
    if (i % bs == tid) s_adm[i] = ok;
  }
  __syncthreads();
  for (int j = tid; j < n; j += bs) admitted[j] = s_adm[j];
}

__global__ void __launch_bounds__(kThreads)
occ_admit_kernel(const uint8_t* __restrict__ raw,
                 const uint8_t* __restrict__ ww,
                 const uint8_t* __restrict__ valid, int n,
                 uint8_t* __restrict__ survivors) {
  extern __shared__ uint8_t s_surv[];
  const int tid = threadIdx.x, bs = blockDim.x;
  for (int j = tid; j < n; j += bs) s_surv[j] = 0;
  for (int i = 0; i < n; ++i) {
    const size_t row = size_t(i) * n;
    bool hit = false;
    for (int j = tid; j < i; j += bs)    // earlier = j < i
      if (s_surv[j]) hit |= (raw[row + j] | ww[row + j]) != 0;
    const bool ok = valid[i] && !__syncthreads_or(hit);
    if (i % bs == tid) s_surv[i] = ok;
  }
  __syncthreads();
  for (int j = tid; j < n; j += bs) survivors[j] = s_surv[j];
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch on `stream`.  bool arrays are
// one byte each: raw, raw_t (raw transposed, contiguous) and ww [n, n];
// valid and the outputs [n]; prec [n, n], zeroed by the caller.
int ppcc_admit_launch(const void* raw, const void* raw_t, const void* valid,
                      const void* seq, int n, void* admitted,
                      void* preceding, void* preceded, void* prec,
                      void* stream) {
  const size_t bytes = size_t(3) * n;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(ppcc_admit_kernel),
                             bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ppcc_admit_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const uint8_t*>(raw_t),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(seq), n,
      static_cast<uint8_t*>(admitted), static_cast<uint8_t*>(preceding),
      static_cast<uint8_t*>(preceded), static_cast<uint8_t*>(prec));
  return static_cast<int>(cudaGetLastError());
}

int twopl_admit_launch(const void* raw, const void* raw_t, const void* ww,
                       const void* valid, int n, void* admitted,
                       void* stream) {
  const size_t bytes = size_t(n);
  cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(twopl_admit_kernel), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  twopl_admit_kernel<<<1, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const uint8_t*>(raw_t),
      static_cast<const uint8_t*>(ww), static_cast<const uint8_t*>(valid), n,
      static_cast<uint8_t*>(admitted));
  return static_cast<int>(cudaGetLastError());
}

int occ_admit_launch(const void* raw, const void* ww, const void* valid,
                     int n, void* survivors, void* stream) {
  const size_t bytes = size_t(n);
  cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(occ_admit_kernel), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  occ_admit_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const uint8_t*>(ww),
      static_cast<const uint8_t*>(valid), n,
      static_cast<uint8_t*>(survivors));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
