// RWKV6 (Finch) recurrence in chunks of C tokens on Hopper -- kernel B7 of
// the port.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel_chunked.py
// (rwkv6_chunked -> _rwkv6_chunk_kernel).  The function is B6's: per head
// row, an (N x N) float32 state S and a per-token, per-channel decay w_t,
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j].
// The reference's chunk algebra, with Cum_t = prod_{tau <= t} w_tau inside
// the chunk (Cum_{-1} = 1), r~_t = r_t * Cum_{t-1} and k~_t = k_t / Cum_t:
//     o_t = r~_t . S_0                          (inter-chunk)
//         + sum_{tau < t} (r~_t . k~_tau) v_tau  (intra, strictly causal)
//         + ((r_t * u) . k_t) v_t                (bonus diagonal)
//     S_C = diag(Cum_{C-1}) (S_0 + k~^T V)      (state update)
//
// What bounds it on an H100: per token and row the function needs about
// 3 N^2 operations against 5 N elements moved, in float32, so the card's
// float32 rate, not its bytes; the chunk algebra does a little more work
// (the masked C x C scores) in exchange for products with no serial chain
// inside a chunk.  What limits this kernel is its float32 FMAs read from
// shared memory and the rows in flight: one block per (batch x head) row.
//
// Design:
// * the TPU's sequential chunk grid axis becomes one loop over the chunks
//   inside the block; one block of 4 N threads per (batch x head) row;
// * S lives in shared memory for the whole sequence (16 KB at N = 64),
//   loaded from the optional initial state and written to the optional
//   final state, so device memory sees r, k, v, w, o (and the states) once;
// * a chunk's r, k and v are staged in shared memory as float32; N threads
//   then take the cumulative product per channel, with w read from device
//   memory in float32 (never rounded to the inputs' bf16) into registers
//   before the staging, and turn r and k into r~ and k~ in place;
// * the three products are float32 FMAs from shared memory, laid out so
//   that most loads are 16-byte broadcasts: each thread holds C/4 outputs
//   of one column (inter and intra: r~ and the scores read 4 at a time,
//   the same for the whole warp), or N/4 consecutive state rows of one
//   column (update: k~ read 4 at a time); for the C x C scores lane tau of
//   a warp holds k~_tau against broadcast rows r~_t, k~'s rows padded by 4
//   floats so the 32 lanes' 16-byte loads hit distinct banks;
// * every sum runs in one fixed order, so a rerun gives the same bits;
// * a ragged last chunk is handled by index: its missing steps read as
//   r = k = v = 0 and w = 1, as the reference pads.
// Numerics stay in float32: k / Cum grows within a chunk (1/Cum leaves the
// float32 range once a channel's decay product over a chunk does; ROADMAP
// C11), and TF32's 10 mantissa bits would eat the reference's tolerance.
#include "common.cuh"

namespace {

constexpr int CMAX = 32;  // the longest chunk (the reference's C)

template <typename T, int N>
__global__ void __launch_bounds__(4 * N)
    rwkv6_chunked_fwd(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, int H,
                      const float* __restrict__ s_in,
                      float* __restrict__ s_out, T* __restrict__ o, int Tn,
                      int C) {
  constexpr int NT = 4 * N;         // threads
  constexpr int ROWS = NT / N;      // 4 token (or state) rows per pass
  constexpr int KS = N + 4;         // k~'s padded row: lanes reading rows
                                    // tau = 0..31 hit distinct banks
  constexpr int WARPS = NT / 32;
  __shared__ __align__(16) float rt[CMAX][N];   // r, then r~
  __shared__ __align__(16) float kt[CMAX][KS];  // k, then k~
  __shared__ __align__(16) float vs[CMAX][N];
  __shared__ __align__(16) float S[N][N];
  __shared__ __align__(16) float A[CMAX][CMAX];  // masked r~_t . k~_tau
  __shared__ float us[N];
  __shared__ float cum_last[N];
  __shared__ float bonus[CMAX];

  const int tid = threadIdx.x;
  const int j = tid % N;            // the column this thread works on
  const int row0 = tid / N;         // its row group (the same in a warp)
  const size_t base = size_t(blockIdx.x) * Tn * N;
  const size_t sbase = size_t(blockIdx.x) * N * N;
  if (tid < N) us[tid] = u[size_t(blockIdx.x % H) * N + tid];
  for (int e = tid; e < N * N; e += NT)
    (&S[0][0])[e] = s_in ? s_in[sbase + e] : 0.f;

  for (int t0 = 0; t0 < Tn; t0 += C) {
    const int n = min(C, Tn - t0);  // real steps in this chunk
    // the decays of channel tid, fetched before the staging so their
    // latency hides behind it
    float wv[CMAX];
    if (tid < N) {
#pragma unroll
      for (int t = 0; t < CMAX; ++t)
        wv[t] = t < n ? w[base + size_t(t0 + t) * N + tid] : 1.f;
    }
    __syncthreads();  // the last chunk's reads of rt, kt, vs are done
    for (int e = tid; e < CMAX * N; e += NT) {
      const int t = e / N, c = e % N;
      const size_t g = base + size_t(t0) * N + e;
      rt[t][c] = t < n ? to_float(r[g]) : 0.f;
      kt[t][c] = t < n ? to_float(k[g]) : 0.f;
      vs[t][c] = t < n ? to_float(v[g]) : 0.f;
    }
    __syncthreads();
    // the bonus of step t: sum_i (r_t[i] u[i]) k_t[i], from the raw r, k;
    // thread t starts at column t so a warp's reads hit 32 banks
    if (tid < C) {
      float c = 0.f;
      for (int ii = 0; ii < N; ++ii) {
        const int i = (ii + tid) % N;
        c = fmaf(rt[tid][i] * us[i], kt[tid][i], c);
      }
      bonus[tid] = c;
    }
    __syncthreads();
    // the cumulative decay of channel i, sequential over the chunk
    if (tid < N) {
      float cum = 1.f;
#pragma unroll
      for (int t = 0; t < CMAX; ++t) {
        rt[t][tid] *= cum;          // r * Cum_{t-1}
        cum *= wv[t];               // Cum_t (padding steps: w = 1)
        kt[t][tid] /= cum;          // k / Cum_t
      }
      cum_last[tid] = cum;
    }
    __syncthreads();
    // scores A[t][tau] = r~_t . k~_tau for tau < t, else 0: lane tau of
    // warp q takes the rows t = q + WARPS m, so r~_t is a broadcast and
    // k~_tau one conflict-free 16-byte load for all of them
    {
      constexpr int M = CMAX / WARPS;
      const int tau = tid % 32, q = tid / 32;
      float a[M];
#pragma unroll
      for (int m = 0; m < M; ++m) a[m] = 0.f;
      const float4* k4 = reinterpret_cast<const float4*>(kt[tau]);
#pragma unroll 4
      for (int i4 = 0; i4 < N / 4; ++i4) {
        const float4 kk = k4[i4];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 rr = reinterpret_cast<const float4*>(
              rt[q + WARPS * m])[i4];
          a[m] = fmaf(rr.x, kk.x, a[m]);
          a[m] = fmaf(rr.y, kk.y, a[m]);
          a[m] = fmaf(rr.z, kk.z, a[m]);
          a[m] = fmaf(rr.w, kk.w, a[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int t = q + WARPS * m;
        A[t][tau] = tau < t && t < C ? a[m] : 0.f;
      }
    }
    __syncthreads();
    // o_t[j] = (r~_t . S_0[:, j] + sum_tau A[t][tau] v_tau[j])
    //          + bonus_t v_t[j], for the rows t = row0 + ROWS m; r~ and A
    // are read as broadcast 16-byte loads (rows of missing steps are
    // zeros, and A is 0 past the chunk)
    {
      constexpr int M = CMAX / ROWS;
      float inter[M], intra[M];
#pragma unroll
      for (int m = 0; m < M; ++m) inter[m] = intra[m] = 0.f;
      for (int i4 = 0; i4 < N / 4; ++i4) {
        const float s0 = S[4 * i4][j], s1 = S[4 * i4 + 1][j],
                    s2 = S[4 * i4 + 2][j], s3 = S[4 * i4 + 3][j];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 rr = reinterpret_cast<const float4*>(
              rt[row0 + ROWS * m])[i4];
          inter[m] = fmaf(rr.x, s0, inter[m]);
          inter[m] = fmaf(rr.y, s1, inter[m]);
          inter[m] = fmaf(rr.z, s2, inter[m]);
          inter[m] = fmaf(rr.w, s3, inter[m]);
        }
      }
      for (int tau4 = 0; tau4 < CMAX / 4; ++tau4) {
        const float v0 = vs[4 * tau4][j], v1 = vs[4 * tau4 + 1][j],
                    v2 = vs[4 * tau4 + 2][j], v3 = vs[4 * tau4 + 3][j];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 aa = reinterpret_cast<const float4*>(
              A[row0 + ROWS * m])[tau4];
          intra[m] = fmaf(aa.x, v0, intra[m]);
          intra[m] = fmaf(aa.y, v1, intra[m]);
          intra[m] = fmaf(aa.z, v2, intra[m]);
          intra[m] = fmaf(aa.w, v3, intra[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int t = row0 + ROWS * m;
        if (t < n)
          o[base + size_t(t0 + t) * N + j] = from_float<T>(
              fmaf(bonus[t], vs[t][j], inter[m] + intra[m]));
      }
    }
    __syncthreads();  // every read of S_0 is done
    // S[i][j] = Cum_{C-1}[i] (S_0[i][j] + sum_tau k~_tau[i] v_tau[j]), for
    // the state rows i = i0 .. i0 + M - 1, k~ read as broadcast 16-byte
    // loads
    {
      constexpr int M = N / ROWS;
      const int i0 = row0 * M;
      float acc[M];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = 0.f;
      for (int tau = 0; tau < C; ++tau) {
        const float vt = vs[tau][j];
        const float4* k4 = reinterpret_cast<const float4*>(kt[tau] + i0);
#pragma unroll
        for (int m4 = 0; m4 < M / 4; ++m4) {
          const float4 kk = k4[m4];
          acc[4 * m4] = fmaf(kk.x, vt, acc[4 * m4]);
          acc[4 * m4 + 1] = fmaf(kk.y, vt, acc[4 * m4 + 1]);
          acc[4 * m4 + 2] = fmaf(kk.z, vt, acc[4 * m4 + 2]);
          acc[4 * m4 + 3] = fmaf(kk.w, vt, acc[4 * m4 + 3]);
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
        S[i0 + m][j] = cum_last[i0 + m] * (S[i0 + m][j] + acc[m]);
    }
  }
  if (s_out) {
    __syncthreads();
    for (int e = tid; e < N * N; e += NT) s_out[sbase + e] = (&S[0][0])[e];
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, int H, const float* s_in, float* s_out, void* o,
           int BH, int Tn, int C, cudaStream_t stream) {
  rwkv6_chunked_fwd<T, N><<<BH, 4 * N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, H, s_in, s_out, static_cast<T*>(o),
      Tn, C);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int N, const void* r, const void* k, const void* v,
             const float* w, const float* u, int H, const float* s_in,
             float* s_out, void* o, int BH, int Tn, int C, cudaStream_t st) {
  switch (N) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, H, s_in, s_out, o, BH, Tn, C, st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, H, s_in, s_out, o, BH, Tn, C, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, o: (BH, T, N) contiguous, of `dtype` (DTYPE_F32 or DTYPE_BF16);
// w: (BH, T, N) float32; u: (H, N) float32, row b*H + h taking u[h];
// s_in, s_out: (BH, N, N) float32 or null (zeros in; no state out);
// N in {32, 64}; 1 <= C <= 32.
extern "C" int repro_rwkv6_chunked_fwd(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* s_in,
                                       void* s_out, void* o, int dtype,
                                       int BH, int Tn, int N, int H, int C,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || C > CMAX || H < 1) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  if (dtype == DTYPE_F32)
    return dispatch<float>(N, r, k, v, wf, uf, H, si, so, o, BH, Tn, C, st);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(N, r, k, v, wf, uf, H, si, so, o, BH, Tn,
                                   C, st);
  return cudaErrorInvalidValue;
}
