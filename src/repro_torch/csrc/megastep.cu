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
// at 3.35 TB/s.  Its arithmetic, ANDs over 5 party words and 16 write
// words for each of 168 x 160 x 160 pairs, is far below the card's integer
// rate, so bytes bound it, and three quarters of them are the four n x n
// outputs.
//
// Design.  One CTA per lane.  The lane's read and write words and its op
// data are loaded once into shared memory, rows padded to an odd stride so
// that 32 threads reading 32 rows hit 32 banks; only the outputs go back to
// device memory.  The party matrix is packed to bits in shared memory,
// n x ceil(n/32) words (3.2 KiB at n = 160): a warp builds one row with
// __ballot_sync, and dep[i,j] is then an AND over 5 words rather than the
// int32 product the TPU ran on its matrix unit.  Each warp owns whole rows
// i and its 32 threads walk the columns j, so a row is stored as runs of
// 32 consecutive bytes and deg / lockhit / dirty_hit are warp reductions
// with no atomics.  Any n fits as long as the footprint (layout() below)
// fits in shared memory; the wrapper raises otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kIsWrite = 1, kActive = 2, kReady = 4, kHasLocks = 8;

struct Layout {
  int stride;    // words of one set row in shared memory (odd)
  int pwords;    // party words per row: ceil(n / 32)
  size_t bytes;  // dynamic shared memory of one CTA
};

__host__ __device__ inline Layout layout(int n, int w) {
  Layout l;
  l.stride = w | 1;
  l.pwords = (n + 31) / 32;
  l.bytes = (size_t(2) * n * l.stride + size_t(n) * l.pwords + n) * 4 + n;
  return l;
}

__global__ void __launch_bounds__(kThreads)
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
                uint8_t* __restrict__ dirty_hit, int n, int w) {
  extern __shared__ uint32_t smem[];
  const Layout lay = layout(n, w);
  uint32_t* s_read = smem;
  uint32_t* s_write = s_read + size_t(n) * lay.stride;
  uint32_t* s_party = s_write + size_t(n) * lay.stride;
  int32_t* s_item =
      reinterpret_cast<int32_t*>(s_party + size_t(n) * lay.pwords);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_item + n);

  const int lane = blockIdx.x;  // fleet lane
  const size_t wbase = size_t(lane) * n * w;
  const size_t vbase = size_t(lane) * n;
  const size_t mbase = size_t(lane) * n * n;

  for (int t = threadIdx.x; t < n * w; t += blockDim.x) {
    const int r = t / w, c = t - r * w;
    s_read[r * lay.stride + c] = read[wbase + t];
    s_write[r * lay.stride + c] = write[wbase + t];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const size_t v = vbase + t;
    s_item[t] = item[v];
    s_flag[t] = (is_write[v] ? kIsWrite : 0) | (active[v] ? kActive : 0) |
                (ready[v] ? kReady : 0) | (haslocks[v] ? kHasLocks : 0);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;

  // Phase 1: the op tables, and the party rows packed to bits.
  for (int i = warp; i < n; i += warps) {
    const int x = s_item[i];
    const int xw = x >> 5;
    const uint32_t xb = uint32_t(x & 31);
    const bool iw = s_flag[i] & kIsWrite;
    for (int c = 0; c < lay.pwords; ++c) {
      const int k = c * 32 + tid;
      bool p = false;
      if (k < n) {
        const bool w_at = (s_write[k * lay.stride + xw] >> xb) & 1u;
        const bool r_at = (s_read[k * lay.stride + xw] >> xb) & 1u;
        wat[mbase + size_t(i) * n + k] = w_at;
        rat[mbase + size_t(i) * n + k] = r_at;
        p = (k == i) || ((iw ? r_at : w_at) && (s_flag[k] & kActive));
      }
      const uint32_t bits = __ballot_sync(kFull, p);
      if (tid == 0) s_party[i * lay.pwords + c] = bits;
    }
  }
  __syncthreads();

  // Phase 2: dep and ww, and the row reductions deg / lockhit / dirty_hit.
  for (int i = warp; i < n; i += warps) {
    const int x = s_item[i];
    const bool iw = s_flag[i] & kIsWrite;
    const uint32_t* pi = s_party + i * lay.pwords;
    const uint32_t* wi = s_write + i * lay.stride;
    int count = 0;
    bool hit = false;
    for (int c = 0; c < lay.pwords; ++c) {
      const int j = c * 32 + tid;
      bool d = false, o = false;
      uint8_t fj = 0;
      if (j < n) {
        fj = s_flag[j];
        if (j != i) {
          const uint32_t* pj = s_party + j * lay.pwords;
          uint32_t meet = 0;
          for (int q = 0; q < lay.pwords; ++q) meet |= pi[q] & pj[q];
          const bool same = (s_item[j] == x) && (iw || (fj & kIsWrite));
          d = (meet != 0) || same;
          const uint32_t* wj = s_write + j * lay.stride;
          uint32_t wmeet = 0;
          for (int q = 0; q < w; ++q) wmeet |= wi[q] & wj[q];
          o = wmeet != 0;
        }
        dep[mbase + size_t(i) * n + j] = d;
        ww[mbase + size_t(i) * n + j] = o;
      }
      count += __popc(__ballot_sync(kFull, d && (fj & kReady)));
      const bool any_hit = __any_sync(kFull, o && (fj & kHasLocks));
      hit = hit || any_hit;
    }
    bool dh = false;
    for (int q = tid; q < w; q += 32) {
      const uint32_t r = s_read[i * lay.stride + q];
      dh = dh || ((r & dirty[wbase + size_t(i) * w + q]) != 0);
    }
    dh = __any_sync(kFull, dh);
    if (tid == 0) {
      deg[vbase + i] = count;
      lockhit[vbase + i] = hit;
      dirty_hit[vbase + i] = dh;
    }
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
  const size_t bytes = layout(n, w).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  megastep_kernel<<<lanes, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(read), static_cast<const uint32_t*>(write),
      static_cast<const uint32_t*>(dirty), static_cast<const int32_t*>(item),
      static_cast<const uint8_t*>(is_write),
      static_cast<const uint8_t*>(active), static_cast<const uint8_t*>(ready),
      static_cast<const uint8_t*>(haslocks), static_cast<uint8_t*>(dep),
      static_cast<uint8_t*>(ww), static_cast<uint8_t*>(wat),
      static_cast<uint8_t*>(rat), static_cast<int32_t*>(deg),
      static_cast<uint8_t*>(lockhit), static_cast<uint8_t*>(dirty_hit), n,
      w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
