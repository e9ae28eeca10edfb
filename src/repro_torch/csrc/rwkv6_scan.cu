// RWKV6 (Finch) token recurrence on Hopper -- kernel B6 of the port.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// (rwkv6_scan -> _rwkv6_kernel).  Per head row, with an (N x N) float32
// state S and a data-dependent per-channel decay w_t:
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// The state stays on chip for the whole sequence, so device memory sees
// r, k, v, w and o only.  The bonus term factors:
//     o_t[j] = sum_i r_t[i] * S[i][j] + c_t * v_t[j],
//     c_t = sum_i r_t[i] * u[i] * k_t[i],
// so each state element costs three operations a step (an FMA into o, the
// product k_i v_j, an FMA into S) and the bonus O(N).
//
// What bounds it on an H100: 3 N operations per output element against 5
// elements moved -- near the card's operations-per-byte ratio in float32,
// and the recurrence is sequential in T.  What limits this kernel is the
// issue rate of each row's serial chain and the number of rows in flight
// (one block per row).
//
// Design:
// * the TPU's sequential chunk grid axis becomes one loop over T inside
//   the block; one block per (batch x head) row, N threads, thread j
//   owning the state column S[:, j] in registers;
// * 32 steps of r, k, w and v are staged in shared memory at a time
//   (coalesced row loads); every thread reads the same r_i, k_i, w_i
//   (broadcasts, four at a time as float4), its own v_j; thread t then
//   sums the staged step t's bonus c_t, so no thread repeats it;
// * the sum over i runs in four interleaved partial sums, added in a
//   fixed order, so every run gives the same bits;
// * the wrapper keeps the TPU kernel's `t % chunk == 0 or t < chunk`
//   check; the loop covers exactly T steps, so no step is padded;
// * the state comes in from an optional initial state and goes out to an
//   optional final state (decode carries it from token to token), and the
//   bonus u is per head, row b*H + h taking u[h];
// * w, u and the states are float32 whatever r, k, v are: a decay of
//   0.9975 rounded to bf16 would be 0.99609 or 1.
#include "common.cuh"

namespace {

constexpr int TC = 32;  // steps staged per pass

template <typename T, int N>
__global__ void __launch_bounds__(N)
    rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, int H,
              const float* __restrict__ s_in, float* __restrict__ s_out,
              T* __restrict__ o, int Tn) {
  __shared__ __align__(16) float rs[TC][N];
  __shared__ __align__(16) float ks[TC][N];
  __shared__ __align__(16) float ws[TC][N];
  __shared__ float us[N];
  __shared__ float vs[TC][N];
  __shared__ float cs[TC];  // c_t of the staged steps

  const int j = threadIdx.x;
  const size_t base = size_t(blockIdx.x) * Tn * N;
  const size_t sbase = size_t(blockIdx.x) * N * N;
  us[j] = u[size_t(blockIdx.x % H) * N + j];
  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s_in ? s_in[sbase + i * N + j] : 0.f;

  for (int t0 = 0; t0 < Tn; t0 += TC) {
    const int n = min(TC, Tn - t0);
    __syncthreads();  // the last pass's reads are done (and us written)
    for (int t = 0; t < n; ++t) {
      const size_t g = base + size_t(t0 + t) * N + j;
      rs[t][j] = to_float(r[g]);
      ks[t][j] = to_float(k[g]);
      ws[t][j] = w[g];
      vs[t][j] = to_float(v[g]);
    }
    __syncthreads();
    for (int t = j; t < n; t += N) {
      // thread t starts at column t, so the warp's reads hit 32 banks
      float c = 0.f;
      for (int ii = 0; ii < N; ++ii) {
        const int i = (ii + t) % N;
        c = fmaf(rs[t][i] * us[i], ks[t][i], c);
      }
      cs[t] = c;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      const float4* r4 = reinterpret_cast<const float4*>(rs[t]);
      const float4* k4 = reinterpret_cast<const float4*>(ks[t]);
      const float4* w4 = reinterpret_cast<const float4*>(ws[t]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i4 = 0; i4 < N / 4; ++i4) {
        const float4 rv = r4[i4], kv = k4[i4], wv = w4[i4];
        const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
        const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
        const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * i4 + e;
          acc[e] = fmaf(rr[e], S[i], acc[e]);
          S[i] = fmaf(ww[e], S[i], kk[e] * vj);
        }
      }
      o[base + size_t(t0 + t) * N + j] = from_float<T>(
          fmaf(cs[t], vj, (acc[0] + acc[1]) + (acc[2] + acc[3])));
    }
  }
  if (s_out) {
#pragma unroll
    for (int i = 0; i < N; ++i) s_out[sbase + i * N + j] = S[i];
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, int H, const float* s_in, float* s_out, void* o,
           int BH, int Tn, cudaStream_t stream) {
  rwkv6_fwd<T, N><<<BH, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, H, s_in, s_out, static_cast<T*>(o),
      Tn);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int N, const void* r, const void* k, const void* v,
             const float* w, const float* u, int H, const float* s_in,
             float* s_out, void* o, int BH, int Tn, cudaStream_t st) {
  switch (N) {
    case 32: return launch<T, 32>(r, k, v, w, u, H, s_in, s_out, o, BH, Tn, st);
    case 64: return launch<T, 64>(r, k, v, w, u, H, s_in, s_out, o, BH, Tn, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, o: (BH, T, N) contiguous, of `dtype` (DTYPE_F32 or DTYPE_BF16);
// w: (BH, T, N) float32; u: (H, N) float32, row b*H + h taking u[h];
// s_in, s_out: (BH, N, N) float32 or null (zeros in; no state out);
// N in {32, 64}.
extern "C" int repro_rwkv6_scan_fwd(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* s_in,
                                    void* s_out, void* o, int dtype, int BH,
                                    int Tn, int N, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  if (dtype == DTYPE_F32)
    return dispatch<float>(N, r, k, v, wf, uf, H, si, so, o, BH, Tn, st);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(N, r, k, v, wf, uf, H, si, so, o, BH, Tn,
                                   st);
  return cudaErrorInvalidValue;
}
