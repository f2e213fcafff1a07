// Chunked RWKV6 WKV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wkv.py (wkv_chunked,
// _wkv_kernel) and computes what repro_torch/kernels/ref.py::
// wkv_chunked_ref computes: per (b, h) and chunk of C steps, with the
// float32 state S [D, D] carried across chunks,
//   cum   = inclusive cumsum of log w over the chunk,  ce = cum - log w,
//   c     = cum_last / 2 (the centring offset),
//   out_t = (r_t e^{ce_t}) S                                   (inter-chunk)
//         + sum_{s<t} (r_t e^{ce_t - c} . k_s e^{c - cum_s}) v_s  (intra)
//         + (r_t . u k_t) v_t                                  (bonus)
//   S'    = diag(e^{cum_last}) S + sum_s (k_s e^{cum_last - cum_s})^T v_s.
// It also starts from a given state and writes the final one.  D in
// {16, 32, 64}, C from 1 to 128; r, k, v float32 or bf16, log w and u
// float32, out and state float32.
//
// Bound.  At the RWKV prefill's shape (rwkv6-3b: B = 8, H = 48, S = 1,024,
// D = 64, chunk 128, bf16 r/k/v) one launch moves 352 MB (r, k, v, log w
// read once, out and the state written once): 0.105 ms at 3.35 TB/s.  Its
// ~12.9 GFLOP of float32 chunk products take 0.19 ms at the card's 67
// TFLOP/s float32 CUDA-core rate, so this formulation is bound by its
// operations.
//
// Design.  One CTA of 256 threads per (b, h) walks the chunks in order;
// the Pallas kernel carried the state in scratch across its sequential
// chunk axis, here it stays in shared memory across the loop.  Per chunk:
// r, k, v and log w are staged as float32 rows padded to D + 1 words (the
// kernel reads the model's [B, S, H*D] layout through strides); one warp
// per row sums r.u.k; D threads walk the chunk in order to form cum and
// rescale r to r e^{ce - c} and k to k e^{c - cum} in place.  Since
// e^{ce} = e^{ce - c} e^{c} and e^{cum_last - cum} = e^{c - cum} e^{c},
// these two scaled copies serve the inter-chunk term and the state update
// too, scaled by e^{c} per channel, so r and k are held once.  The C x C
// matrix of decayed r.k products (strict lower triangle) goes to shared
// memory; thread (ty, tx) then owns rows ty + 16a and columns tx + 16j of
// the output and of the state update.  Shared memory at C = 128, D = 64:
// 184 KB, so the launch opts in above 48 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 128;
constexpr int kThreads = 256;    // 16 x 16
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Layout {
  int ld, la;                      // row strides of the [C, D] and A tiles
  size_t r, k, v, a, s, ru, ec, el, u, floats;
};

__host__ __device__ inline Layout layout(int c, int d) {
  Layout L;
  L.ld = d + 1;
  L.la = (c > d ? c : d) + 1;      // A, or log w before A is formed
  L.r = 0;
  L.k = L.r + size_t(c) * L.ld;
  L.v = L.k + size_t(c) * L.ld;
  L.a = L.v + size_t(c) * L.ld;
  L.s = L.a + size_t(c) * L.la;
  L.ru = L.s + size_t(d) * d;
  L.ec = L.ru + c;
  L.el = L.ec + d;
  L.u = L.el + d;
  L.floats = L.u + d;
  return L;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ state0,
           float* __restrict__ out, float* __restrict__ state_out, int h_n,
           int s_n, int c_n, long long r_sb, long long r_sh, long long r_st,
           long long k_sb, long long k_sh, long long k_st, long long v_sb,
           long long v_sh, long long v_st, long long w_sb, long long w_sh,
           long long w_st, long long o_sb, long long o_sh, long long o_st) {
  constexpr int kJ = kD / 16;                // columns of D per thread
  constexpr int kA = kMaxC / 16;             // rows of C per thread
  extern __shared__ float smem[];
  const Layout L = layout(c_n, kD);
  float* s_r = smem + L.r;     // r, then r e^{ce - c}
  float* s_k = smem + L.k;     // k, then k e^{c - cum}
  float* s_v = smem + L.v;
  float* s_a = smem + L.a;     // log w, then the intra-chunk matrix A
  float* s_s = smem + L.s;     // the state [D][D]
  float* s_ru = smem + L.ru;   // r . u k per row
  float* s_ec = smem + L.ec;   // e^{c} per channel
  float* s_el = smem + L.el;   // e^{cum_last} per channel
  float* s_u = smem + L.u;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* rb = r + b * r_sb + h * r_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* wb = w + b * w_sb + h * w_sh;
  float* ob = out + b * o_sb + h * o_sh;
  const size_t sbase = (size_t(b) * h_n + h) * kD * kD;

  for (int e = threadIdx.x; e < kD * kD; e += kThreads)
    s_s[e] = state0 ? state0[sbase + e] : 0.f;
  for (int e = threadIdx.x; e < kD; e += kThreads) s_u[e] = u[h * kD + e];

  for (int c0 = 0; c0 < s_n; c0 += c_n) {
    __syncthreads();          // the last chunk's state update is done
    for (int e = threadIdx.x; e < c_n * kD; e += kThreads) {
      const int t = e / kD, i = e - t * kD;
      const long long g = c0 + t;
      s_r[t * L.ld + i] = to_f(rb[g * r_st + i]);
      s_k[t * L.ld + i] = to_f(kb[g * k_st + i]);
      s_v[t * L.ld + i] = to_f(vb[g * v_st + i]);
      s_a[t * L.la + i] = wb[g * w_st + i];
    }
    __syncthreads();
    // the bonus r_t . (u k_t), one warp per row
    for (int t = warp; t < c_n; t += kWarps) {
      float x = 0.f;
      for (int i = lane; i < kD; i += 32)
        x += s_r[t * L.ld + i] * s_u[i] * s_k[t * L.ld + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) s_ru[t] = x;
    }
    __syncthreads();
    // per channel, in order: cum, the offsets, r and k rescaled in place
    if (threadIdx.x < kD) {
      const int i = threadIdx.x;
      float last = 0.f;
      for (int t = 0; t < c_n; ++t) last += s_a[t * L.la + i];
      const float c = last * 0.5f;
      s_ec[i] = expf(c);
      s_el[i] = expf(last);
      float cum = 0.f;
      for (int t = 0; t < c_n; ++t) {
        const float wt = s_a[t * L.la + i];
        cum += wt;
        s_r[t * L.ld + i] *= expf((cum - wt) - c);
        s_k[t * L.ld + i] *= expf(c - cum);
      }
    }
    __syncthreads();
    // A[t][s] = r'_t . k'_s for s < t, else 0
    {
      float acc[kA][kA];
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int j = 0; j < kA; ++j) acc[a][j] = 0.f;
      if (ty < c_n) {
#pragma unroll 4
        for (int i = 0; i < kD; ++i) {
          float ra[kA], kj[kA];
#pragma unroll
          for (int a = 0; a < kA; ++a)
            ra[a] = ty + 16 * a < c_n ? s_r[(ty + 16 * a) * L.ld + i] : 0.f;
#pragma unroll
          for (int j = 0; j < kA; ++j)
            kj[j] = tx + 16 * j < c_n ? s_k[(tx + 16 * j) * L.ld + i] : 0.f;
#pragma unroll
          for (int a = 0; a < kA; ++a)
#pragma unroll
            for (int j = 0; j < kA; ++j)
              acc[a][j] = fmaf(ra[a], kj[j], acc[a][j]);
        }
      }
      __syncthreads();        // every read of log w is long done; A over it
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const int t = ty + 16 * a;
#pragma unroll
        for (int j = 0; j < kA; ++j) {
          const int s = tx + 16 * j;
          if (t < c_n && s < c_n) s_a[t * L.la + s] = s < t ? acc[a][j] : 0.f;
        }
      }
    }
    __syncthreads();
    // out_t = r'_t diag(e^c) S + sum_{s<t} A[t][s] v_s + ru_t v_t
    for (int a = 0; a < kA; ++a) {
      const int t = ty + 16 * a;
      if (t >= c_n) break;
      float ys[kJ], yi[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) ys[j] = yi[j] = 0.f;
#pragma unroll 4
      for (int i = 0; i < kD; ++i) {
        const float x = s_r[t * L.ld + i] * s_ec[i];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          ys[j] = fmaf(x, s_s[i * kD + tx + 16 * j], ys[j]);
      }
      for (int s = 0; s < t; ++s) {
        const float x = s_a[t * L.la + s];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          yi[j] = fmaf(x, s_v[s * L.ld + tx + 16 * j], yi[j]);
      }
      const float ru = s_ru[t];
      float* orow = ob + (c0 + t) * o_st;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        orow[tx + 16 * j] = (ys[j] + yi[j]) + ru * s_v[t * L.ld + tx + 16 * j];
    }
    __syncthreads();          // every read of S is done
    // S[i][j] = e^{last_i} S[i][j] + sum_s k'_s[i] e^{c_i} v_s[j]
#pragma unroll
    for (int a = 0; a < kJ; ++a) {
      const int i = ty + 16 * a;
      const float ec = s_ec[i];
      float ds[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) ds[j] = 0.f;
      for (int s = 0; s < c_n; ++s) {
        const float x = s_k[s * L.ld + i] * ec;
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          ds[j] = fmaf(x, s_v[s * L.ld + tx + 16 * j], ds[j]);
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float* sij = s_s + i * kD + tx + 16 * j;
        *sij = s_el[i] * *sij + ds[j];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kD * kD; e += kThreads)
    state_out[sbase + e] = s_s[e];
}

template <typename T, int kD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* state0,
                   void* out, void* state, int b, int h, int s, int c,
                   const long long* st, cudaStream_t stream) {
  const size_t bytes = layout(c, kD).floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  wkv_kernel<T, kD><<<dim3(h, b), kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(out), static_cast<float*>(state), h, s, c, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* state0,
                     void* out, void* state, int b, int h, int s, int d,
                     int c, const long long* st, cudaStream_t stream) {
  if (d == 16)
    return launch<T, 16>(r, k, v, w, u, state0, out, state, b, h, s, c, st,
                         stream);
  if (d == 32)
    return launch<T, 32>(r, k, v, w, u, state0, out, state, b, h, s, c, st,
                         stream);
  return launch<T, 64>(r, k, v, w, u, state0, out, state, b, h, s, c, st,
                       stream);
}

}  // namespace

extern "C" {

// One launch on `stream`; returns the cudaError_t of the launch (0 on
// success).  dtype 0 = float32, 1 = bf16 (r, k, v).  r, k, v, log w and out
// are [b, h, s, d] with element strides (batch, head, step) given in that
// order for r, k, v, w, out and a contiguous last axis; u is [h, d];
// state0 (null for zeros) and state are contiguous [b, h, d, d].  Requires
// d in {16, 32, 64}, 1 <= c <= 128 and s % c == 0.
int wkv_launch(int dtype, const void* r, const void* k, const void* v,
               const void* w, const void* u, const void* state0, void* out,
               void* state, int b, int h, int s, int d, int c,
               long long r_sb, long long r_sh, long long r_st,
               long long k_sb, long long k_sh, long long k_st,
               long long v_sb, long long v_sh, long long v_st,
               long long w_sb, long long w_sh, long long w_st,
               long long o_sb, long long o_sh, long long o_st,
               void* stream) {
  if ((d != 16 && d != 32 && d != 64) || c < 1 || c > kMaxC || s % c)
    return cudaErrorInvalidValue;
  const long long st[15] = {r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh,
                            v_st, w_sb, w_sh, w_st, o_sb, o_sh, o_st};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? dispatch<float>(r, k, v, w, u, state0, out, state, b, h,
                                   s, d, c, st, cs)
                 : dispatch<__nv_bfloat16>(r, k, v, w, u, state0, out, state,
                                           b, h, s, d, c, st, cs);
  return static_cast<int>(e);
}

}  // extern "C"
