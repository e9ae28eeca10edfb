// Selective state-space (Mamba) scan on Hopper -- kernel B5 of the port.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py
// (mamba_scan -> _mamba_kernel):
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
//     y_t = h_t . C_t + D * x_t
// with the (d_inner x d_state) float32 state kept on chip for the whole
// sequence, so device memory sees x, dt, B, C and y only.
//
// What bounds it on an H100: per (token, channel) it reads x and dt and
// writes y (B_t and C_t are shared by all channels), and does d_state
// exponentials and a few FMAs per state.  That is about 1 operation per
// byte, below the card's ratio, so its bound is bytes; but the scan is
// sequential in T, so what limits this kernel is how many independent
// (batch, channel) chains keep the SMs busy and how cheaply each step
// issues.
//
// Design:
// * the TPU's sequential chunk grid axis becomes one loop over T inside
//   the block; work splits over (batch, channel): a block owns 64 channels
//   of one batch row, 4 lanes per channel, each lane holding SPL of the
//   channel's d_state states in registers (SPL = 4 for d_state = 16) and
//   the lanes' partial dot products with C_t summed by two shuffles -- a
//   fixed order, so every run gives the same bits;
// * 32 steps at a time are staged in shared memory: x and dt for the
//   block's 64 channels, and B_t and C_t, which every channel of the batch
//   row reads; y is staged the same way and stored coalesced;
// * exp is expf (the accurate one, not __expf); the chunk size of the TPU
//   kernel only tiles its grid and changes nothing here.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 4;                 // lanes per channel
constexpr int CH = THREADS / LANES;      // channels per block
constexpr int TC = 32;                   // steps staged per pass

template <typename T, int SPL>
__global__ void __launch_bounds__(THREADS)
    mamba_fwd(const T* __restrict__ x, const T* __restrict__ dt,
              const T* __restrict__ bm, const T* __restrict__ cm,
              const T* __restrict__ a, const T* __restrict__ dv,
              T* __restrict__ y, int Tn, int Di, int Ds) {
  constexpr int GS = LANES * SPL;  // padded d_state
  __shared__ float xs[TC][CH], dts[TC][CH], ys[TC][CH];
  __shared__ float bs[TC][GS], cs[TC][GS];

  const int tid = threadIdx.x, cl = tid / LANES, lane = tid % LANES;
  const int c0 = blockIdx.x * CH, b = blockIdx.y, ch = c0 + cl;
  const bool chan_ok = ch < Di;

  float av[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = lane * SPL + j;
    av[j] = chan_ok && s < Ds ? to_float(a[size_t(ch) * Ds + s]) : 0.f;
    h[j] = 0.f;
  }
  const float dd = chan_ok ? to_float(dv[ch]) : 0.f;
  const size_t xrow = size_t(b) * Tn * Di, srow = size_t(b) * Tn * Ds;

  for (int t0 = 0; t0 < Tn; t0 += TC) {
    const int n = min(TC, Tn - t0);
    for (int e = tid; e < TC * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      const bool ok = r < n && c0 + c < Di;
      const size_t g = xrow + size_t(t0 + r) * Di + c0 + c;
      xs[r][c] = ok ? to_float(x[g]) : 0.f;
      dts[r][c] = ok ? to_float(dt[g]) : 0.f;
    }
    for (int e = tid; e < TC * GS; e += THREADS) {
      const int r = e / GS, s = e % GS;
      const bool ok = r < n && s < Ds;
      const size_t g = srow + size_t(t0 + r) * Ds + s;
      bs[r][s] = ok ? to_float(bm[g]) : 0.f;
      cs[r][s] = ok ? to_float(cm[g]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float xv = xs[r][cl], dtv = dts[r][cl];
      const float dx = dtv * xv;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = lane * SPL + j;
        h[j] = expf(dtv * av[j]) * h[j] + dx * bs[r][s];
        p = fmaf(h[j], cs[r][s], p);
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) ys[r][cl] = p + dd * xv;
    }
    __syncthreads();
    for (int e = tid; e < TC * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      if (r < n && c0 + c < Di)
        y[xrow + size_t(t0 + r) * Di + c0 + c] = from_float<T>(ys[r][c]);
    }
    __syncthreads();  // ys and the staged inputs are free for the next pass
  }
}

template <typename T, int SPL>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* d, void* y, int B, int Tn, int Di,
           int Ds, cudaStream_t stream) {
  const dim3 grid((Di + CH - 1) / CH, B);
  mamba_fwd<T, SPL><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(a), static_cast<const T*>(d), static_cast<T*>(y),
      Tn, Di, Ds);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* b, const void* c,
             const void* a, const void* d, void* y, int B, int Tn, int Di,
             int Ds, cudaStream_t st) {
  if (Ds <= 4) return launch<T, 1>(x, dt, b, c, a, d, y, B, Tn, Di, Ds, st);
  if (Ds <= 8) return launch<T, 2>(x, dt, b, c, a, d, y, B, Tn, Di, Ds, st);
  if (Ds <= 16) return launch<T, 4>(x, dt, b, c, a, d, y, B, Tn, Di, Ds, st);
  if (Ds <= 32) return launch<T, 8>(x, dt, b, c, a, d, y, B, Tn, Di, Ds, st);
  if (Ds <= 64) return launch<T, 16>(x, dt, b, c, a, d, y, B, Tn, Di, Ds, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dt, y: (B, T, Di); b, c: (B, T, Ds); a: (Di, Ds); d: (Di,); all
// contiguous, of one dtype (DTYPE_F32 or DTYPE_BF16); 1 <= Ds <= 64.
extern "C" int repro_mamba_scan_fwd(const void* x, const void* dt,
                                    const void* b, const void* c,
                                    const void* a, const void* d, void* y,
                                    int dtype, int B, int Tn, int Di, int Ds,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch<float>(x, dt, b, c, a, d, y, B, Tn, Di, Ds, st);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(x, dt, b, c, a, d, y, B, Tn, Di, Ds, st);
  return cudaErrorInvalidValue;
}
