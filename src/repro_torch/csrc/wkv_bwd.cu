// The backward of the chunked RWKV6 WKV (csrc/wkv.cu) for Hopper (sm_90a),
// on the CUDA cores.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the chunk scan repro/models/rwkv.py:131 (wkv_chunked).  It computes what
// repro_torch/kernels/ref.py::wkv_chunked_bwd_ref computes: per (b, h) the
// chunks in reverse, carrying G, the float32 [D, D] gradient of the state a
// chunk writes (the final state's gradient, or 0, at the start), with the
// forward's state S entering each chunk read from the forward's saved
// states.  Per chunk, with cum the inclusive cumsum of log w, ce = cum -
// log w, L = cum_last, the forward's centring c = L / 2, r' = r e^{ce - c},
// k' = k e^{c - cum}, A = r' k'^T strictly below the diagonal and the bonus
// ru = r . (u k):
//   dA  = dO v^T strictly below,  dru = rowsum(dO * v),
//   dv  = A^T dO + ru dO + k' (e^c G),
//   dr  = e^{ce - c} (dA k' + dO (e^c S)^T) + dru u k,
//   dk  = e^{c - cum} (dA^T r' + v (e^c G)^T) + dru u r,
//   du += sum_t dru r k,
//   dlog w[t] = sum_{t' > t} gce[t'] + sum_{t' >= t} gcum[t'] + gL, with
//         gce = r' (dA k' + dO (e^c S)^T), gcum = -k' (dA^T r' + v (e^c
//         G)^T) and gL = sum_j e^L S G + sum_s k' (v (e^c G)^T), the same
//         for every step of the chunk,
//   G  <- e^L G + e^c (r'^T dO), the gradient of the state entering it.
// The exponentials are the forward's, centred, so nothing overflows where
// the forward does not.  D in {16, 32, 64}, C from 1 to 128; r, k, v (and
// dr, dk, dv) float32 or bf16, log w, dO, u, the states and dlog w, du,
// dstate0 float32.
//
// Bound.  At rwkv6-3b's training call (B = 8, H = 48, S = 1,024, D = 64, C =
// 128, bf16 r/k/v) the chunk products are about 2.1 times the forward's
// 12.83 GFLOP (chip_smoke.py counts them), 0.4 ms at the card's 67 TFLOP/s
// of float32 on the CUDA cores; its bytes (r, k, v, log w, dO and the
// states read, dr, dk, dv, dlog w written) about 0.2 ms at 3.35 TB/s.  The
// operations bound it.
//
// Design: simple first.  One CTA of 256 threads per (b, h), 226 KB of
// shared memory at D = 64 (one CTA an SM): r', k', v, dO of the chunk as
// float32 rows of D + 1 (conflict-free column reads), one C x (C + 1)
// matrix that holds A, then dA, and one D x (D + 1) matrix that holds e^c
// G, then e^c S.  Every product is a register tile a thread (8 rows, the
// columns strided by 16) over shared-memory operands, in fmaf, with the
// triangular ones' loops cut at the diagonal.  G and the partial du stay
// in registers across the chunks.  cum is kept in dlog w's rows until the
// chunk's dlog w overwrites it.  Reductions run in a fixed order (no
// atomics): the reverse scan of dlog w as 8 rows a thread and then the
// later row groups' totals, du per (b, h) over the row groups and then,
// in a second kernel, over the batch.  Two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxC = 128;
constexpr int kThreads = 256;
constexpr int kGroups = 16;         // row groups of 8 rows (128 / 8)
constexpr int kLA = kMaxC + 1;      // A / dA row stride

template <int kD>
struct Smem {
  static constexpr int LD = kD + 1;            // r', k', v, dO, M rows
  static constexpr size_t R = 0;
  static constexpr size_t K = R + size_t(kMaxC) * LD;
  static constexpr size_t V = K + size_t(kMaxC) * LD;
  static constexpr size_t O = V + size_t(kMaxC) * LD;
  static constexpr size_t A = O + size_t(kMaxC) * LD;
  static constexpr size_t M = A + size_t(kMaxC) * kLA;
  static constexpr size_t PART = M + size_t(kD) * LD;      // [16][D]
  static constexpr size_t PART2 = PART + kGroups * kD;     // [16][D]
  static constexpr size_t FIRST = PART2 + kGroups * kD;    // [16][D]
  static constexpr size_t CC = FIRST + kGroups * kD;       // c
  static constexpr size_t EC = CC + kD;                    // e^c
  static constexpr size_t EL = EC + kD;                    // e^L
  static constexpr size_t U = EL + kD;
  static constexpr size_t GL = U + kD;                     // gL
  static constexpr size_t RU = GL + kD;                    // r . (u k)
  static constexpr size_t DRU = RU + kMaxC;                // rowsum(dO v)
  static constexpr size_t FLOATS = DRU + kMaxC;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {       // element strides (batch, head, step) of a tensor
  long long b, h, t;
};

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u,
               const float* __restrict__ states,
               const float* __restrict__ dout,
               const float* __restrict__ dstate, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ dstate0, int h_n, int s_n, int c_n,
               Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
               Strides sdr, Strides sdk, Strides sdv, Strides sdw) {
  using L = Smem<kD>;
  constexpr int LD = L::LD;
  constexpr int NQ = kD / 16;                  // columns a thread: i = cg + 16q
  constexpr int kSeg = kThreads / kD;          // prefix segments a channel
  constexpr int kSegRows = kMaxC / kSeg;
  extern __shared__ float smem[];
  float* s_r = smem + L::R;
  float* s_k = smem + L::K;
  float* s_v = smem + L::V;
  float* s_o = smem + L::O;
  float* s_a = smem + L::A;
  float* s_m = smem + L::M;
  float* s_part = smem + L::PART;
  float* s_part2 = smem + L::PART2;
  float* s_first = smem + L::FIRST;
  float* s_cc = smem + L::CC;
  float* s_ec = smem + L::EC;
  float* s_el = smem + L::EL;
  float* s_u = smem + L::U;
  float* s_gl = smem + L::GL;
  float* s_ru = smem + L::RU;
  float* s_dru = smem + L::DRU;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;      // the row group, the column
  const int t0 = rg * 8;                       // a thread's rows t0 .. t0 + 7
  const int nc = s_n / c_n;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  const float* ob = dout + b * so.b + h * so.h;
  T* drb = dr + b * sdr.b + h * sdr.h;
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
  float* dwb = dw + b * sdw.b + h * sdw.h;
  const size_t bh = size_t(b) * h_n + h;

  for (int e = tid; e < kD; e += kThreads) s_u[e] = u[h * kD + e];
  // G [D, D] in registers: rows i = rg * NQ + a, columns j = cg + 16 q
  float g[NQ][NQ];
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      g[a][q] = dstate ? dstate[bh * kD * kD + (rg * NQ + a) * kD + cg +
                                16 * q]
                       : 0.f;
  float du_acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) du_acc[q] = 0.f;

  for (int ci = nc - 1; ci >= 0; --ci) {
    const long long c0 = (long long)ci * c_n;
    const int n = c_n;
    __syncthreads();            // the last chunk is done with shared memory
    // ---- 1. log w into dO's rows, cum by channel into A's (D + 1 stride)
    for (int e = tid; e < n * kD; e += kThreads) {
      const int t = e / kD, i = e % kD;
      s_o[t * LD + i] = wb[(c0 + t) * sw.t + i];
    }
    __syncthreads();
    {
      const int i = tid % kD, seg = tid / kD;
      const int lo = seg * kSegRows, hi = min(lo + kSegRows, n);
      float x = 0.f;
      for (int t = lo; t < hi; ++t) {
        x += s_o[t * LD + i];
        s_a[t * LD + i] = x;
      }
      s_part[seg * kD + i] = x;
      __syncthreads();
      float off = 0.f, last = 0.f;
      for (int sq = 0; sq < kSeg; ++sq) {
        if (sq == seg) off = last;
        last += s_part[sq * kD + i];
      }
      for (int t = lo; t < hi; ++t) s_a[t * LD + i] += off;
      if (seg == 0) {
        const float c = last * 0.5f;
        s_cc[i] = c;
        s_ec[i] = expf(c);
        s_el[i] = expf(last);
      }
    }
    __syncthreads();
    // r', k', r u k (into v's rows), and cum kept in dlog w's rows
    for (int e = tid; e < n * kD; e += kThreads) {
      const int t = e / kD, i = e % kD;
      const float cum = s_a[t * LD + i], lw = s_o[t * LD + i];
      const float c = s_cc[i];
      const float rr = ld(rb + (c0 + t) * sr.t + i);
      const float kk = ld(kb + (c0 + t) * sk.t + i);
      s_r[t * LD + i] = rr * expf((cum - lw) - c);
      s_k[t * LD + i] = kk * expf(c - cum);
      s_v[t * LD + i] = (rr * s_u[i]) * kk;
      dwb[(c0 + t) * sdw.t + i] = cum;
    }
    __syncthreads();
    if (tid < n) {
      float x = 0.f;
      for (int i = 0; i < kD; ++i) x += s_v[tid * LD + i];
      s_ru[tid] = x;
    }
    __syncthreads();
    // v and dO; e^c G into M
    for (int e = tid; e < n * kD; e += kThreads) {
      const int t = e / kD, i = e % kD;
      s_v[t * LD + i] = ld(vb + (c0 + t) * sv.t + i);
      s_o[t * LD + i] = ob[(c0 + t) * so.t + i];
    }
#pragma unroll
    for (int a = 0; a < NQ; ++a) {
      const int i = rg * NQ + a;
#pragma unroll
      for (int q = 0; q < NQ; ++q) s_m[i * LD + cg + 16 * q] = s_ec[i] * g[a][q];
    }
    __syncthreads();
    if (tid < n) {
      float x = 0.f;
      for (int j = 0; j < kD; ++j) x += s_o[tid * LD + j] * s_v[tid * LD + j];
      s_dru[tid] = x;
    }
    // ---- 2. A = r' k'^T below the diagonal: rows t0 + a, columns cg + 16 q
    {
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
      if (t0 < n) {
        for (int i = 0; i < kD; ++i) {
          float x[8], y[8];
#pragma unroll
          for (int a = 0; a < 8; ++a) x[a] = s_r[(t0 + a) * LD + i];
#pragma unroll
          for (int q = 0; q < 8; ++q) y[q] = s_k[(cg + 16 * q) * LD + i];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int t = t0 + a, s = cg + 16 * q;
          s_a[t * kLA + s] = (s < t && t < n) ? acc[a][q] : 0.f;
        }
    }
    __syncthreads();
    // ---- 3. dv = A^T dO + ru dO + k' (e^c G): rows s = t0 + a
    {
      float acc[8][NQ];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[a][q] = 0.f;
      for (int t = t0 + 1; t < n; ++t) {
        float x[8], y[NQ];
#pragma unroll
        for (int a = 0; a < 8; ++a) x[a] = s_a[t * kLA + t0 + a];
#pragma unroll
        for (int q = 0; q < NQ; ++q) y[q] = s_o[t * LD + cg + 16 * q];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
      }
      if (t0 < n) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            acc[a][q] = fmaf(s_ru[t0 + a], s_o[(t0 + a) * LD + cg + 16 * q],
                             acc[a][q]);
        for (int i = 0; i < kD; ++i) {
          float x[8], y[NQ];
#pragma unroll
          for (int a = 0; a < 8; ++a) x[a] = s_k[(t0 + a) * LD + i];
#pragma unroll
          for (int q = 0; q < NQ; ++q) y[q] = s_m[i * LD + cg + 16 * q];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (t0 + a >= n) continue;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          st(dvb + (c0 + t0 + a) * sdv.t + cg + 16 * q, acc[a][q]);
      }
    }
    __syncthreads();
    // ---- 4. dA = dO v^T below the diagonal, in A's place
    {
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
      if (t0 < n) {
        for (int j = 0; j < kD; ++j) {
          float x[8], y[8];
#pragma unroll
          for (int a = 0; a < 8; ++a) x[a] = s_o[(t0 + a) * LD + j];
#pragma unroll
          for (int q = 0; q < 8; ++q) y[q] = s_v[(cg + 16 * q) * LD + j];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int t = t0 + a, s = cg + 16 * q;
          s_a[t * kLA + s] = (s < t && t < n) ? acc[a][q] : 0.f;
        }
    }
    __syncthreads();
    // ---- 5. dk = e^{c - cum} (dA^T r' + v (e^c G)^T) + dru u r: rows s =
    // t0 + a, columns i = cg + 16 q; gcum = -k' (...) kept for dlog w, and
    // this thread's part of gL's second term
    float hsum[8][NQ];          // gcum, then + gce of the next row
    {
      float acc[8][NQ], acc2[8][NQ];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[a][q] = acc2[a][q] = 0.f;
      for (int t = t0 + 1; t < n; ++t) {
        float x[8], y[NQ];
#pragma unroll
        for (int a = 0; a < 8; ++a) x[a] = s_a[t * kLA + t0 + a];
#pragma unroll
        for (int q = 0; q < NQ; ++q) y[q] = s_r[t * LD + cg + 16 * q];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
      }
      if (t0 < n) {
        for (int j = 0; j < kD; ++j) {
          float x[8], y[NQ];
#pragma unroll
          for (int a = 0; a < 8; ++a) x[a] = s_v[(t0 + a) * LD + j];
#pragma unroll
          for (int q = 0; q < NQ; ++q) y[q] = s_m[(cg + 16 * q) * LD + j];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              acc2[a][q] = fmaf(x[a], y[q], acc2[a][q]);
        }
      }
      float part[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) part[q] = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int s = t0 + a;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int i = cg + 16 * q;
          hsum[a][q] = 0.f;
          if (s >= n) continue;
          const float kp = s_k[s * LD + i];
          const float pre = acc[a][q] + acc2[a][q];
          part[q] = fmaf(kp, acc2[a][q], part[q]);
          hsum[a][q] = -(kp * pre);
          const float cum = dwb[(c0 + s) * sdw.t + i];
          const float rr = ld(rb + (c0 + s) * sr.t + i);
          const float y = expf(s_cc[i] - cum) * pre +
                          (s_dru[s] * s_u[i]) * rr;
          st(dkb + (c0 + s) * sdk.t + i, y);
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) s_part2[rg * kD + cg + 16 * q] = part[q];
    }
    __syncthreads();
    // ---- 6. e^c S into M, and gL's first term sum_j e^L S G by row
    {
      const float* sb = states + (bh * nc + ci) * kD * kD;
#pragma unroll
      for (int a = 0; a < NQ; ++a) {
        const int i = rg * NQ + a;
        float x = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int j = cg + 16 * q;
          const float sv_ = sb[i * kD + j];
          s_m[i * LD + j] = s_ec[i] * sv_;
          x = fmaf(s_el[i] * sv_, g[a][q], x);
        }
        // over the 16 lanes of the row group (a fixed butterfly)
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (cg == 0) s_gl[i] = x;
      }
    }
    __syncthreads();
    // ---- 7. dr = e^{ce - c} (dA k' + dO (e^c S)^T) + dru u k: rows t =
    // t0 + a; gce = r' (...) into dlog w's sums; du's part
    float gce0[NQ];
    {
      float acc[8][NQ];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[a][q] = 0.f;
      const int s_end = min(t0 + 7, n);        // s < t <= t0 + 7
      for (int s = 0; s < s_end; ++s) {
        float x[8], y[NQ];
#pragma unroll
        for (int a = 0; a < 8; ++a) x[a] = s_a[(t0 + a) * kLA + s];
#pragma unroll
        for (int q = 0; q < NQ; ++q) y[q] = s_k[s * LD + cg + 16 * q];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
      }
      if (t0 < n) {
        for (int j = 0; j < kD; ++j) {
          float x[8], y[NQ];
#pragma unroll
          for (int a = 0; a < 8; ++a) x[a] = s_o[(t0 + a) * LD + j];
#pragma unroll
          for (int q = 0; q < NQ; ++q) y[q] = s_m[(cg + 16 * q) * LD + j];
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int t = t0 + a;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int i = cg + 16 * q;
          float gce = 0.f;
          if (t < n) {
            const float pre = acc[a][q];
            gce = s_r[t * LD + i] * pre;
            const float cum = dwb[(c0 + t) * sdw.t + i];
            const float lw = wb[(c0 + t) * sw.t + i];
            const float rr = ld(rb + (c0 + t) * sr.t + i);
            const float kk = ld(kb + (c0 + t) * sk.t + i);
            const float y = expf((cum - lw) - s_cc[i]) * pre +
                            (s_dru[t] * s_u[i]) * kk;
            st(drb + (c0 + t) * sdr.t + i, y);
            du_acc[q] = fmaf(s_dru[t] * rr, kk, du_acc[q]);
          }
          // dlog w[t'] takes gce[t] for t' < t: row t - 1 of the sums
          if (a == 0) gce0[q] = gce;
          else hsum[a > 0 ? a - 1 : 0][q] += gce;
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) s_first[rg * kD + cg + 16 * q] = gce0[q];
    }
    __syncthreads();
    // ---- 8. dlog w: the reverse scan of the sums over the chunk's rows,
    // plus gL
    {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int i = cg + 16 * q;
        if (rg + 1 < kGroups) hsum[7][q] += s_first[(rg + 1) * kD + i];
#pragma unroll
        for (int a = 6; a >= 0; --a) hsum[a][q] += hsum[a + 1][q];
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) s_part[rg * kD + cg + 16 * q] = hsum[0][q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int i = cg + 16 * q;
        float later = 0.f, gl = s_gl[i];
        for (int g2 = kGroups - 1; g2 > rg; --g2) later += s_part[g2 * kD + i];
        for (int g2 = 0; g2 < kGroups; ++g2) gl += s_part2[g2 * kD + i];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int t = t0 + a;
          if (t < n) dwb[(c0 + t) * sdw.t + i] = (hsum[a][q] + later) + gl;
        }
      }
    }
    // ---- 9. G <- e^L G + e^c (r'^T dO): rows i = rg * NQ + a
    {
      float acc[NQ][NQ];
#pragma unroll
      for (int a = 0; a < NQ; ++a)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[a][q] = 0.f;
      for (int t = 0; t < n; ++t) {
        float x[NQ], y[NQ];
#pragma unroll
        for (int a = 0; a < NQ; ++a) x[a] = s_r[t * LD + rg * NQ + a];
#pragma unroll
        for (int q = 0; q < NQ; ++q) y[q] = s_o[t * LD + cg + 16 * q];
#pragma unroll
        for (int a = 0; a < NQ; ++a)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
      }
#pragma unroll
      for (int a = 0; a < NQ; ++a) {
        const int i = rg * NQ + a;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          g[a][q] = s_el[i] * g[a][q] + s_ec[i] * acc[a][q];
      }
    }
  }
  // dstate0, and du's part of this (b, h) over the row groups in order
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      dstate0[bh * kD * kD + (rg * NQ + a) * kD + cg + 16 * q] = g[a][q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) s_part[rg * kD + cg + 16 * q] = du_acc[q];
  __syncthreads();
  if (tid < kD) {
    float x = 0.f;
    for (int g2 = 0; g2 < kGroups; ++g2) x += s_part[g2 * kD + tid];
    du_part[bh * kD + tid] = x;
  }
}

// du [h, D] = sum over the batch of du_part [b, h, D], in order
__global__ void wkv_du_sum(const float* __restrict__ du_part,
                           float* __restrict__ du, int b_n, int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hd) return;
  float x = 0.f;
  for (int b = 0; b < b_n; ++b) x += du_part[(long long)b * hd + e];
  du[e] = x;
}

template <typename T, int kD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* states,
                   const void* dout, const void* dstate, void* dr, void* dk,
                   void* dv, void* dw, void* du_part, void* du,
                   void* dstate0, int b, int h, int s, int c,
                   const long long* st, cudaStream_t stream) {
  const size_t bytes = Smem<kD>::FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  Strides s9[9];
  for (int i = 0; i < 9; ++i)
    s9[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  wkv_bwd_kernel<T, kD><<<dim3(h, b), kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(states),
      static_cast<const float*>(dout), static_cast<const float*>(dstate),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part),
      static_cast<float*>(dstate0), h, s, c, s9[0], s9[1], s9[2], s9[3],
      s9[4], s9[5], s9[6], s9[7], s9[8]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int hd = h * kD;
  wkv_du_sum<<<(hd + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), b, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* states,
                     const void* dout, const void* dstate, void* dr,
                     void* dk, void* dv, void* dw, void* du_part, void* du,
                     void* dstate0, int b, int h, int s, int c,
                     const long long* st, cudaStream_t stream) {
  if (d == 16)
    return launch<T, 16>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw,
                         du_part, du, dstate0, b, h, s, c, st, stream);
  if (d == 32)
    return launch<T, 32>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw,
                         du_part, du, dstate0, b, h, s, c, st, stream);
  return launch<T, 64>(r, k, v, w, u, states, dout, dstate, dr, dk, dv, dw,
                       du_part, du, dstate0, b, h, s, c, st, stream);
}

}  // namespace

extern "C" {

// One host call on `stream` (two device kernels: the walk, then du's sum
// over the batch); returns the cudaError_t (0 on success).  dtype 0 =
// float32, 1 = bf16 (r, k, v, dr, dk, dv).  r, k, v, log w, dout, dr, dk,
// dv, dw are [b, h, s, d] with a contiguous last axis and element strides
// (batch, head, step) in `strides`, in that order (27 values); u is [h, d];
// states [b, h, s / c, d, d], dstate (null for zeros) and dstate0 [b, h, d,
// d] contiguous float32; du_part a float32 scratch of b * h * d, du [h, d].
// Requires d in {16, 32, 64}, 1 <= c <= 128 and s % c == 0.
int wkv_bwd_launch(int dtype, const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* states,
                   const void* dout, const void* dstate, void* dr, void* dk,
                   void* dv, void* dw, void* du_part, void* du,
                   void* dstate0, int b, int h, int s, int d, int c,
                   const long long* strides, void* stream) {
  if ((d != 16 && d != 32 && d != 64) || c < 1 || c > kMaxC || s % c)
    return cudaErrorInvalidValue;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0
          ? dispatch<float>(d, r, k, v, w, u, states, dout, dstate, dr, dk,
                            dv, dw, du_part, du, dstate0, b, h, s, c,
                            strides, cs)
          : dispatch<__nv_bfloat16>(d, r, k, v, w, u, states, dout, dstate,
                                    dr, dk, dv, dw, du_part, du, dstate0, b,
                                    h, s, c, strides, cs);
  return static_cast<int>(e);
}

}  // extern "C"
