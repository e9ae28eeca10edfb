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
//
// A decode step (T == 1) takes another form.  There the state's bytes
// bound the call (read and written once, 5 MB at the RWKV6-3B decode step:
// 0.0016 ms), and one block of N threads a row (160 blocks) leaves most of
// the card idle with N serial loads a thread.  Instead a block of 128
// threads runs 16 columns of a row (N / 16 blocks a row: 640 at that
// decode step), thread (slice, j) holding E = N / 8 elements
// S[slice*E .. +E, j] of column j, so 8x more loads are in flight, spread
// over 4x more blocks; the 8 partial sums of o_j meet in shared memory and
// add in one fixed order, and each block sums the bonus by one warp's
// shuffle tree.  Nothing is staged.  Each thread reads its state elements
// before it writes them and rows own disjoint states, so the final state
// may overwrite the initial one in place (s_out == s_in), as the decode
// graph's static cache has it; the long form's thread j likewise reads
// column j whole before it writes it.
#include "common.cuh"

namespace {

constexpr int TC = 32;         // steps staged per pass
constexpr int SLICES = 8;      // threads per state column in the step form
constexpr int STEP_COLS = 16;  // state columns of a step-form block

template <typename T, int N>
__global__ void __launch_bounds__(N)
    rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, int H,
              const float* s_in, float* s_out,
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
__global__ void __launch_bounds__(SLICES * STEP_COLS)
    rwkv6_step(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, int H, const float* s_in,
               float* s_out, T* __restrict__ o) {
  constexpr int E = N / SLICES;         // state elements a thread
  constexpr int TILES = N / STEP_COLS;  // blocks a row
  __shared__ float rs[N], ks[N], ws[N], vs[STEP_COLS];
  __shared__ float part[SLICES][STEP_COLS];
  __shared__ float cb;  // the bonus sum_i r_i u_i k_i
  const int tid = threadIdx.x, jl = tid % STEP_COLS, sl = tid / STEP_COLS;
  const int row = blockIdx.x / TILES;
  const int j0 = (blockIdx.x % TILES) * STEP_COLS, j = j0 + jl;
  const size_t sbase = size_t(row) * N * N + size_t(sl) * E * N + j;
  const size_t g = size_t(row) * N;
  float S[E];
#pragma unroll
  for (int e = 0; e < E; ++e) S[e] = s_in ? s_in[sbase + e * N] : 0.f;
  if (tid < N) {
    rs[tid] = to_float(r[g + tid]);
    ks[tid] = to_float(k[g + tid]);
    ws[tid] = w[g + tid];
  }
  if (tid < STEP_COLS) vs[tid] = to_float(v[g + j0 + tid]);
  __syncthreads();
  if (tid < 32) {
    float c = 0.f;
#pragma unroll
    for (int i = tid; i < N; i += 32)
      c = fmaf(rs[i] * u[size_t(row % H) * N + i], ks[i], c);
#pragma unroll
    for (int m = 16; m > 0; m /= 2) c += __shfl_xor_sync(0xffffffffu, c, m);
    if (tid == 0) cb = c;
  }
  const float vj = vs[jl];
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = sl * E + e;
    acc = fmaf(rs[i], S[e], acc);
    S[e] = fmaf(ws[i], S[e], ks[i] * vj);
  }
  part[sl][jl] = acc;
  __syncthreads();
  if (sl == 0) {
    float sum = part[0][jl];
#pragma unroll
    for (int q = 1; q < SLICES; ++q) sum += part[q][jl];
    o[g + j] = from_float<T>(fmaf(cb, vj, sum));
  }
  if (s_out) {
#pragma unroll
    for (int e = 0; e < E; ++e) s_out[sbase + e * N] = S[e];
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, int H, const float* s_in, float* s_out, void* o,
           int BH, int Tn, cudaStream_t stream) {
  if (Tn == 1) {
    rwkv6_step<T, N><<<BH * (N / STEP_COLS), SLICES * STEP_COLS, 0,
                       stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), w, u, H, s_in, s_out, static_cast<T*>(o));
    return cudaGetLastError();
  }
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
// s_in, s_out: (BH, N, N) float32 or null (zeros in; no state out), the
// same storage allowed (in place); N in {32, 64}.
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
