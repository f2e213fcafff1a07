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
// One thread walks one lane's slots in order; a CTA holds 32 lanes.  Each
// thread keeps its lane's running state (the two server pools, or the
// accumulated write words) in shared memory, interleaved across threads so
// that the 32 threads of a warp touch 32 banks.  The kernels only add,
// compare, take maxima and combine bits; they are built with --fmad=false
// all the same, and the one addition is written as __fadd_rn.
//
// Bound.  At the main path's shape (168 lanes, n = 160, 16 CPUs, 32 disks,
// W = 16) reserve_cohort moves 168 x (160 x 4 x 4 + 160 x 2 + 48 x 8) B,
// about 0.55 MB, and occ_validate 168 x (160 x 3 x 16 x 4 + 160 x 2) B,
// about 5.2 MB: a few microseconds or less at 3.35 TB/s.  What bounds them
// in practice is the serial chain of 160 dependent steps per lane, which a
// single thread cannot hide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
reserve_cohort_kernel(const float* __restrict__ cpu_in,
                      const float* __restrict__ disk_in,
                      const float* __restrict__ t_req,
                      const float* __restrict__ cpu_dur,
                      const float* __restrict__ io_dur,
                      const uint8_t* __restrict__ cpu_m,
                      const uint8_t* __restrict__ disk_m,
                      float* __restrict__ cpu_out, float* __restrict__ disk_out,
                      float* __restrict__ cpu_done,
                      float* __restrict__ disk_done, int lanes, int n, int nc,
                      int nd, float inf) {
  extern __shared__ float pools[];  // [(nc + nd) x blockDim.x]
  const int bs = blockDim.x;
  const int t = threadIdx.x;
  const int l = blockIdx.x * bs + t;
  if (l >= lanes) return;
  float* cpu = pools + t;             // server c at cpu[c * bs]
  float* disk = pools + nc * bs + t;  // server k at disk[k * bs]
  for (int c = 0; c < nc; ++c) cpu[c * bs] = cpu_in[size_t(l) * nc + c];
  for (int k = 0; k < nd; ++k) disk[k * bs] = disk_in[size_t(l) * nd + k];

  for (int i = 0; i < n; ++i) {
    const size_t v = size_t(l) * n + i;
    const float tr = t_req[v];

    int ci = 0;
    float cv = cpu[0];
    for (int c = 1; c < nc; ++c) {
      const float f = cpu[c * bs];
      if (f < cv) { cv = f; ci = c; }
    }
    const float cdone = __fadd_rn(fmaxf(tr, cv), cpu_dur[v]);
    if (cpu_m[v]) {
      cpu[ci * bs] = cdone;
      cpu_done[v] = cdone;
    } else {
      cpu_done[v] = inf;
    }

    int di = 0;
    float dv = disk[0];
    for (int k = 1; k < nd; ++k) {
      const float f = disk[k * bs];
      if (f < dv) { dv = f; di = k; }
    }
    const float ddone = __fadd_rn(fmaxf(tr, dv), io_dur[v]);
    if (disk_m[v]) {
      disk[di * bs] = ddone;
      disk_done[v] = ddone;
    } else {
      disk_done[v] = inf;
    }
  }
  for (int c = 0; c < nc; ++c) cpu_out[size_t(l) * nc + c] = cpu[c * bs];
  for (int k = 0; k < nd; ++k) disk_out[size_t(l) * nd + k] = disk[k * bs];
}

__global__ void __launch_bounds__(kThreads)
occ_validate_kernel(const uint8_t* __restrict__ commit_pre,
                    const uint32_t* __restrict__ read,
                    const uint32_t* __restrict__ dirty,
                    const uint32_t* __restrict__ write,
                    uint8_t* __restrict__ fail, int lanes, int n, int w) {
  extern __shared__ uint32_t acc_s[];  // [w x blockDim.x]
  const int bs = blockDim.x;
  const int t = threadIdx.x;
  const int l = blockIdx.x * bs + t;
  if (l >= lanes) return;
  uint32_t* acc = acc_s + t;  // word q at acc[q * bs]
  for (int q = 0; q < w; ++q) acc[q * bs] = 0;

  for (int i = 0; i < n; ++i) {
    const size_t v = size_t(l) * n + i;
    if (!commit_pre[v]) {
      fail[v] = 0;
      continue;
    }
    const uint32_t* r = read + v * w;
    const uint32_t* d = dirty + v * w;
    uint32_t meet = 0;
    for (int q = 0; q < w; ++q) meet |= r[q] & (d[q] | acc[q * bs]);
    const bool f = meet != 0;
    fail[v] = f;
    if (!f) {
      const uint32_t* wr = write + v * w;
      for (int q = 0; q < w; ++q) acc[q * bs] |= wr[q];
    }
  }
}

}  // namespace

extern "C" {

int scan_threads() { return kThreads; }

// FCFS reservation; returns the cudaError_t of the launch.  cpu_in/disk_in
// float[lanes, nc] / [lanes, nd]; t_req, durations and the *_done outputs
// float[lanes, n]; masks 1 byte each.
int reserve_cohort_launch(const void* cpu_in, const void* disk_in,
                          const void* t_req, const void* cpu_dur,
                          const void* io_dur, const void* cpu_m,
                          const void* disk_m, void* cpu_out, void* disk_out,
                          void* cpu_done, void* disk_done, int lanes, int n,
                          int nc, int nd, float inf, void* stream) {
  const size_t bytes = size_t(nc + nd) * kThreads * sizeof(float);
  const int blocks = (lanes + kThreads - 1) / kThreads;
  reserve_cohort_kernel<<<blocks, kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cpu_in), static_cast<const float*>(disk_in),
      static_cast<const float*>(t_req), static_cast<const float*>(cpu_dur),
      static_cast<const float*>(io_dur), static_cast<const uint8_t*>(cpu_m),
      static_cast<const uint8_t*>(disk_m), static_cast<float*>(cpu_out),
      static_cast<float*>(disk_out), static_cast<float*>(cpu_done),
      static_cast<float*>(disk_done), lanes, n, nc, nd, inf);
  return static_cast<int>(cudaGetLastError());
}

// OCC validation scan; returns the cudaError_t of the launch.  Words
// uint32[lanes, n, w]; commit_pre and fail 1 byte each, [lanes, n].
int occ_validate_launch(const void* commit_pre, const void* read,
                        const void* dirty, const void* write, void* fail,
                        int lanes, int n, int w, void* stream) {
  const size_t bytes = size_t(w) * kThreads * sizeof(uint32_t);
  const int blocks = (lanes + kThreads - 1) / kThreads;
  occ_validate_kernel<<<blocks, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(commit_pre),
      static_cast<const uint32_t*>(read), static_cast<const uint32_t*>(dirty),
      static_cast<const uint32_t*>(write), static_cast<uint8_t*>(fail), lanes,
      n, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
