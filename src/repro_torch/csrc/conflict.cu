// Pairwise conflict relations of the batch scheduler for Hopper (sm_90a):
// one template, three entry points.
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
// words) the fused relations take one three-input logic op, acc |= a & b,
// per word pair and relation: 2 x 4,096^2 x 1,024 = 3.4e10 ops, about 2 ms
// at Hopper's 64 such results per SM per clock.  The bytes (two 16 MB word
// arrays in, two 16 MB bool matrices out) take ~19 us at 3.35 TB/s, so the
// logic rate bounds it by two orders of magnitude.
//
// Design.  A CTA owns a 64 x 64 tile of (i, j) pairs; 256 threads each
// hold 4 x 4 pairs of both relations in registers.  Per chunk of 32 words
// the CTA stages the tile's read_i, write_i and write_j rows in shared
// memory, word-major, so that each thread reads its four i words and four
// j words of one word index as two 16-byte loads and spends 32 LOP3 on
// them.  The Pallas kernel carried its row degrees in an output block that
// the sequential j grid revisits; blocks here run in no order, so each
// tile's row and column popcounts are summed in shared memory and added to
// the degree vectors with one integer atomicAdd per row or column.
// Integer sums do not depend on order, so every output is bit-exact.
// Shared memory per CTA: 3 x 32 x 68 x 4 B = 26 KB.  Tuning (TMA staging,
// larger register blocks, a tensor-core form) is left for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // i rows and j rows of one CTA
constexpr int kChunk = 32;           // words staged per step
constexpr int kStride = kTile + 4;   // padded shared row, 16-byte aligned
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 pairs each

enum Mode { kMatrix = 0, kFused = 1, kFull = 2 };

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
                uint8_t* __restrict__ raw, uint8_t* __restrict__ ww,
                int32_t* __restrict__ rdeg, int32_t* __restrict__ cdeg,
                int32_t* __restrict__ wdeg, uint8_t* __restrict__ diag_raw,
                uint8_t* __restrict__ diag_ww) {
  constexpr bool kWW = kMode != kMatrix;
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

}  // namespace

extern "C" {

// One launch on `stream`; returns the cudaError_t of the launch.  mode 0:
// raw only; 1: raw, ww, rdeg, wdeg; 2: all seven outputs.  Words
// uint32[n, w]; bool outputs 1 byte each; degree vectors int32[n], which
// the caller zeroes (the kernel adds into them).  Unused outputs may be
// null.
int conflict_launch(int mode, const void* read, const void* write, int n,
                    int w, void* raw, void* ww, void* rdeg, void* cdeg,
                    void* wdeg, void* diag_raw, void* diag_ww,
                    void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* r = static_cast<const uint32_t*>(read);
  const uint32_t* wr = static_cast<const uint32_t*>(write);
  uint8_t* o_raw = static_cast<uint8_t*>(raw);
  uint8_t* o_ww = static_cast<uint8_t*>(ww);
  int32_t* o_rdeg = static_cast<int32_t*>(rdeg);
  int32_t* o_cdeg = static_cast<int32_t*>(cdeg);
  int32_t* o_wdeg = static_cast<int32_t*>(wdeg);
  uint8_t* o_dr = static_cast<uint8_t*>(diag_raw);
  uint8_t* o_dw = static_cast<uint8_t*>(diag_ww);
  if (mode == kMatrix)
    conflict_kernel<kMatrix><<<grid, kThreads, 0, s>>>(
        r, wr, n, w, o_raw, o_ww, o_rdeg, o_cdeg, o_wdeg, o_dr, o_dw);
  else if (mode == kFused)
    conflict_kernel<kFused><<<grid, kThreads, 0, s>>>(
        r, wr, n, w, o_raw, o_ww, o_rdeg, o_cdeg, o_wdeg, o_dr, o_dw);
  else if (mode == kFull)
    conflict_kernel<kFull><<<grid, kThreads, 0, s>>>(
        r, wr, n, w, o_raw, o_ww, o_rdeg, o_cdeg, o_wdeg, o_dr, o_dw);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
