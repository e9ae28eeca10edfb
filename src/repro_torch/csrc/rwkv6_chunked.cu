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
//     o_t = r~_t . S_c                          (inter-chunk)
//         + sum_{tau < t} (r~_t . k~_tau) v_tau  (intra, strictly causal)
//         + ((r_t * u) . k_t) v_t                (bonus diagonal)
//     S_{c+1} = diag(Cum_{C-1}) (S_c + k~^T V)  (state update)
//
// What bounds it on an H100: per chunk and row four products -- the scores
// P = r~ k~^T (masked to tau < t), P V, r~ S and the state contribution
// D = k~^T V: about 2 N^2 C + N C^2 multiply-adds -- against r, k, v, w
// read and o written once.  On the FP64 tensor cores this kernel uses
// (67 TFLOP/s) that is 0.025 ms at an RWKV6-3B prefill (160 rows x 512
// tokens, bf16 r/k/v, N = 64), beside 0.020 ms of bytes.
//
// Design: one launch, one block of 4 warps per (row, tile of 32 state
// columns) -- 320 blocks at that prefill, all resident at once (3 an SM:
// the register cap of __launch_bounds__; 72 KB of dynamic shared memory
// each) -- walking the chunks in order (the TPU kernel's sequential grid
// axis) with its 64 x 32 slice of S in shared memory.  Per chunk:
// * r, k and the tile's v are staged in shared memory; the next chunk's
//   are fetched in 16-byte loads into registers as stored (unpacked only
//   when staged) once this one's outputs are done, so that their latency
//   hides behind the state update and their registers stay clear of the
//   products' (a prefetch of one scalar load an element spilled);
// * the bonus of each step, four threads a step and a fixed butterfly;
// * Cum: each of N threads takes its channel's running product of the
//   decays (read in float32, never rounded) into shared memory, then every
//   thread turns its elements of r into r~ and of k into k~, in float32 as
//   the reference rounds them, each converted to float64 once (64-bit
//   conversions issue at a quarter of the float32 rate), neighbouring
//   lanes on neighbouring elements so the stores meet no bank conflict;
// * the four products on the FP64 tensor cores (mma.sync m8n8k4 .f64): the
//   float32 operands are exact in float64, their products exact and their
//   sums rounded to 53 bits.  The float32 routes fail the tolerance:
//   TF32 tensor-core products (10-bit operands) break the 3e-4 the state is
//   held to, because k / Cum grows within a chunk (ROADMAP C11;
//   tests/test_torch_rwkv_passes.py); the 3xTF32 form keeps the operands
//   but the tensor core truncates its float32 sum relative to its largest
//   term, and the outputs cancel terms of the state's size (|S| up to 800
//   at the model's first layer, outputs down to 0.06): it left the kernel
//   1.26x the allowance from the plain version; float32 FMAs hold it but
//   wait on shared memory, one broadcast load per FMA (PERF.md §6, B7).
//   The outputs o = r~ S + P V + bonus v are rounded once; D is taken last,
//   so that its accumulators live only beside the update S = Cum_{C-1}
//   (S + D), which rounds D to float32 and is taken in float32 as the
//   reference takes it;
// * operands come from shared memory in float64 at row strides of 4 mod 16
//   doubles, so that a half-warp's fragment loads, (row, k) and (k, row)
//   alike, hit 16 distinct bank pairs.
// Every sum runs in one fixed order, no atomics: a rerun gives the same
// bits.  A ragged last chunk, and chunks shorter than 32, by index: the
// missing steps read as r = k = v = 0 and w = 1, as the reference pads.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int CMAX = 32;        // the longest chunk (the reference's C)
constexpr int NT = 128;         // threads of a block: 4 warps
constexpr int COLS = 32;        // state columns of a block
constexpr int MIN_BLOCKS = 3;   // blocks an SM holds: 320 fit one wave
constexpr int kMaxDevices = 64;
static_assert(NT == 4 * CMAX, "the bonus takes four threads a step");

// shared memory of one instance, in doubles: r~ and k~ (CMAX x N), v's
// tile and the scores (CMAX x 32), the state's tile (N x 32); Cum (CMAX x
// N floats) shares the scores' place, and r and k as float32 r~'s and
// k~'s, each free while the other lives
template <int N>
struct Smem {
  static constexpr int SA = N + 4, SV = COLS + 4, SP = CMAX + 4,
                       SS = COLS + 4;
  static constexpr int RT = 0, KT = RT + CMAX * SA, VS = KT + CMAX * SA,
                       P = VS + CMAX * SV, S = P + CMAX * SP,
                       DOUBLES = S + N * SS;
  static constexpr size_t BYTES = sizeof(double) * DOUBLES;
  static_assert(SA % 16 == 4 && SV % 16 == 4 && SP % 16 == 4 &&
                    SS % 16 == 4, "conflict-free fragment loads");
  static_assert(sizeof(float) * CMAX * N <= sizeof(double) * CMAX * SP,
                "Cum fits the scores' place");
};

// c += a b: A 8 x 4 (row), B 4 x 8 (col), C 8 x 8, all float64.  With g =
// lane / 4 and t = lane % 4: a = A[g][t], b = B[t][g], c = C[g][2t .. 2t+1]
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// a chunk's inputs travel as 16-byte loads: kVec elements each, kLoads of
// a (CMAX x N) row block a thread, kColLoads of the block's COLS columns
template <typename T>
constexpr int kVec = 16 / sizeof(T);
template <typename T, int N>
constexpr int kLoads = CMAX * N / kVec<T> / NT;
template <typename T>
constexpr int kColLoads = CMAX * COLS / kVec<T> / NT;

// the steps [0, n) of a chunk's (CMAX x N) rows, load p = tid + q NT
// holding elements kVec p .. (zeros past step n): every load of a block is
// issued before any is used, and none is unpacked until it is staged
template <typename T, int N>
__device__ __forceinline__ void fetch(uint4 (&x)[kLoads<T, N>], const T* src,
                                      int n, int tid) {
#pragma unroll
  for (int q = 0; q < kLoads<T, N>; ++q) {
    const int p = tid + q * NT;
    x[q] = p * kVec<T> / N < n ? reinterpret_cast<const uint4*>(src)[p]
                               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ... and of the block's COLS columns of them (src at the first column)
template <typename T, int N>
__device__ __forceinline__ void fetch_cols(uint4 (&x)[kColLoads<T>],
                                           const T* src, int n, int tid) {
#pragma unroll
  for (int q = 0; q < kColLoads<T>; ++q) {
    const int e = (tid + q * NT) * kVec<T>, tt = e / COLS;
    x[q] = tt < n ? *reinterpret_cast<const uint4*>(src + size_t(tt) * N +
                                                     e % COLS)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the kVec values of one load as float32: four float32, or eight bf16
// (two a word, the first in the low half)
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[8]) {
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    f[2 * h] = __uint_as_float(words[h] << 16);
    f[2 * h + 1] = __uint_as_float(words[h] & 0xffff0000u);
  }
}

// one (row, 32-column tile) of the state, over every chunk in order
template <typename T, int N>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    chunked_tile(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, int H,
                 const float* __restrict__ s_in, float* __restrict__ s_out,
                 T* __restrict__ o, int Tn, int C) {
  using L = Smem<N>;
  constexpr int SA = L::SA, SV = L::SV, SP = L::SP, SS = L::SS;
  constexpr int TILES = N / COLS;             // blocks a row
  constexpr int SI = N * COLS / NT;           // state elements a thread
  constexpr int DW = N * COLS / 64 / 4;       // 8 x 8 tiles of D a warp
  constexpr int JT = COLS / 8;                // 8-column tiles across
  extern __shared__ __align__(16) double smem[];
  double* rt = smem + L::RT;  // r, then r~
  double* kt = smem + L::KT;  // k, then k~
  double* vs = smem + L::VS;
  double* P = smem + L::P;
  double* S = smem + L::S;
  float* cs = reinterpret_cast<float*>(P);
  __shared__ float us[N], cl[N], bonus[CMAX];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int row = blockIdx.x / TILES, j0 = (blockIdx.x % TILES) * COLS;
  const size_t rbase = size_t(row) * Tn * N;
  const size_t sbase = size_t(row) * N * N + j0;
#pragma unroll
  for (int q = 0; q < SI; ++q) {
    const int e = tid + q * NT, i = e / COLS, j = e % COLS;
    S[i * SS + j] = s_in ? s_in[sbase + size_t(i) * N + j] : 0.f;
  }
  if (tid < N) us[tid] = u[size_t(row % H) * N + tid];

  // the first chunk's inputs; each chunk fetches the next one's while it
  // computes
  constexpr int V = kVec<T>, RL = kLoads<T, N>, VL = kColLoads<T>;
  constexpr int WL = kLoads<float, N>;
  uint4 xr[RL], xk[RL], xv[VL], xw[WL];
  {
    const int n = min(C, Tn);
    fetch<T, N>(xr, r + rbase, n, tid);
    fetch<T, N>(xk, k + rbase, n, tid);
    fetch_cols<T, N>(xv, v + rbase + j0, n, tid);
    fetch<float, N>(xw, w + rbase, n, tid);
  }
  for (int t0 = 0; t0 < Tn; t0 += C) {
    const int n = min(C, Tn - t0);
    const int n1 = min(C, Tn - t0 - C);  // the next chunk's steps (<= 0: none)
    __syncthreads();  // the last chunk's reads of rt, kt, vs and P are done
    // this chunk's r and k as float32 over r~'s and k~'s places (16-byte
    // stores), v into its tile, w over the scores' place (1 past the
    // chunk's steps)
    float* rf32 = reinterpret_cast<float*>(rt);
    float* kf32 = reinterpret_cast<float*>(kt);
#pragma unroll
    for (int q = 0; q < RL; ++q) {
      float fr[V], fk[V];
      unpack(xr[q], fr);
      unpack(xk[q], fk);
      const int e = (tid + q * NT) * V, at = (e / N) * SA + e % N;
#pragma unroll
      for (int m = 0; m < V; m += 4) {
        *reinterpret_cast<float4*>(rf32 + at + m) =
            make_float4(fr[m], fr[m + 1], fr[m + 2], fr[m + 3]);
        *reinterpret_cast<float4*>(kf32 + at + m) =
            make_float4(fk[m], fk[m + 1], fk[m + 2], fk[m + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < VL; ++q) {
      float fv[V];
      unpack(xv[q], fv);
      const int e = (tid + q * NT) * V, tt = e / COLS, j = e % COLS;
#pragma unroll
      for (int m = 0; m < V; ++m) vs[tt * SV + j + m] = fv[m];
    }
#pragma unroll
    for (int q = 0; q < WL; ++q) {
      float fw[4];
      unpack(xw[q], fw);
      const int e = (tid + q * NT) * 4;
#pragma unroll
      for (int m = 0; m < 4; ++m) cs[e + m] = e / N < n ? fw[m] : 1.f;
    }
    __syncthreads();
    // Cum_t of channel tid, one sequential product over the staged decays,
    // in place
    if (tid < N) {
      float wt[CMAX];
#pragma unroll
      for (int tt = 0; tt < CMAX; ++tt) wt[tt] = cs[tt * N + tid];
      float cum = 1.f;
#pragma unroll
      for (int tt = 0; tt < CMAX; ++tt) {
        cum *= wt[tt];
        cs[tt * N + tid] = cum;
      }
      cl[tid] = cum;
    }
    // the bonus of step tt = tid / 4: sum_i (r[i] u[i]) k[i], four threads
    // a step over every fourth channel (a warp's reads hit 32 banks), added
    // by a butterfly that gives the four the same bits
    {
      const int tt = tid / 4, part = tid % 4;
      float c = 0.f;
#pragma unroll
      for (int i = part; i < N; i += 4)
        c += rf32[tt * SA + i] * us[i] * kf32[tt * SA + i];
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      if (part == 0) bonus[tt] = c;
    }
    // each thread's elements e = tid + q NT (neighbouring channels in
    // neighbouring lanes) into registers, before any is overwritten
    constexpr int EL = CMAX * N / NT;
    float rf[EL], kf[EL];
#pragma unroll
    for (int q = 0; q < EL; ++q) {
      const int e = tid + q * NT, at = (e / N) * SA + e % N;
      rf[q] = rf32[at];
      kf[q] = kf32[at];
    }
    __syncthreads();
    // r~ = r Cum_{t-1} and k~ = k / Cum_t in float32, each converted to
    // float64 once
#pragma unroll
    for (int q = 0; q < EL; ++q) {
      const int e = tid + q * NT, tt = e / N, i = e % N, at = tt * SA + i;
      rt[at] = tt > 0 ? rf[q] * cs[(tt - 1) * N + i] : rf[q];
      kt[at] = kf[q] / cs[tt * N + i];
    }
    __syncthreads();
    // the scores P = r~ k~^T over the 10 tiles of 8 x 8 on or below the
    // diagonal (tile a of steps t, tile b of steps tau, b <= a), masked to
    // tau < t; warp w takes tiles w, w + 4, w + 8, side by side
    // (independent chains of tensor-core products)
    {
      double c[3][2];
      const double* ra[3];
      const double* kb[3];
#pragma unroll
      for (int s3 = 0; s3 < 3; ++s3) {
        const int q = min(warp + 4 * s3, 9);
        const int a = q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : 3;
        const int b = q - a * (a + 1) / 2;
        ra[s3] = rt + (8 * a + g) * SA + t;
        kb[s3] = kt + (8 * b + g) * SA + t;
        c[s3][0] = c[s3][1] = 0.0;
      }
      const bool third = warp + 8 < 10;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 4) {
#pragma unroll
        for (int s3 = 0; s3 < 3; ++s3)
          if (s3 < 2 || third) dmma(c[s3], ra[s3][k0], kb[s3][k0]);
      }
#pragma unroll
      for (int s3 = 0; s3 < 3; ++s3) {
        const int q = warp + 4 * s3;
        if (q >= 10) continue;
        const int a = q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : 3;
        const int b = q - a * (a + 1) / 2;
        const int tt = 8 * a + g, tau = 8 * b + 2 * t;
        P[tt * SP + tau] = tau < tt ? c[s3][0] : 0.0;
        P[tt * SP + tau + 1] = tau + 1 < tt ? c[s3][1] : 0.0;
      }
    }
    __syncthreads();
    // o = r~ S + P V + bonus v for rows 8 warp .. + 8, every column of the
    // tile: the products summed in float64, rounded once
    {
      const int a = warp, tt = 8 * a + g;
      double c[JT][2];
#pragma unroll
      for (int jb = 0; jb < JT; ++jb) c[jb][0] = c[jb][1] = 0.0;
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 4) {
        const double x = rt[tt * SA + k0 + t];
#pragma unroll
        for (int jb = 0; jb < JT; ++jb)
          dmma(c[jb], x, S[(k0 + t) * SS + 8 * jb + g]);
      }
      // P is zero from the diagonal on: steps tau < 8 (a + 1)
      for (int k0 = 0; k0 < 8 * (a + 1); k0 += 4) {
        const double x = P[tt * SP + k0 + t];
#pragma unroll
        for (int jb = 0; jb < JT; ++jb)
          dmma(c[jb], x, vs[(k0 + t) * SV + 8 * jb + g]);
      }
      if (tt < n) {
        const double b = bonus[tt];
        T* orow = o + rbase + size_t(t0 + tt) * N + j0;
#pragma unroll
        for (int jb = 0; jb < JT; ++jb) {
          const int j = 8 * jb + 2 * t;
          orow[j] = from_float<T>(float(c[jb][0] + b * vs[tt * SV + j]));
          orow[j + 1] =
              from_float<T>(float(c[jb][1] + b * vs[tt * SV + j + 1]));
        }
      }
    }
    __syncthreads();  // every read of S_c is done
    // the next chunk's inputs, in flight while the state is updated and
    // the next chunk starts (not before: their registers would crowd the
    // products')
    if (n1 > 0) {
      const size_t nb = rbase + size_t(t0 + C) * N;
      fetch<T, N>(xr, r + nb, n1, tid);
      fetch<T, N>(xk, k + nb, n1, tid);
      fetch_cols<T, N>(xv, v + nb + j0, n1, tid);
      fetch<float, N>(xw, w + nb, n1, tid);
    }
    // the state contribution D = k~^T V over the tile, DW tiles of 8 x 8 a
    // warp (rows i of tile q / JT, columns j of tile q % JT), and S =
    // Cum_{C-1} (S + D) in float32 at the warp's own elements
    {
      double d[DW][2];
#pragma unroll
      for (int q = 0; q < DW; ++q) d[q][0] = d[q][1] = 0.0;
#pragma unroll
      for (int k0 = 0; k0 < CMAX; k0 += 4) {
#pragma unroll
        for (int q = 0; q < DW; ++q) {
          const int tile = warp * DW + q;
          dmma(d[q], kt[(k0 + t) * SA + (tile / JT) * 8 + g],
               vs[(k0 + t) * SV + (tile % JT) * 8 + g]);
        }
      }
#pragma unroll
      for (int q = 0; q < DW; ++q) {
        const int tile = warp * DW + q, i = (tile / JT) * 8 + g,
                  j = (tile % JT) * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          S[i * SS + j + e] =
              cl[i] * (float(S[i * SS + j + e]) + float(d[q][e]));
      }
    }
  }
  if (s_out) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < SI; ++q) {
      const int e = tid + q * NT, i = e / COLS, j = e % COLS;
      s_out[sbase + size_t(i) * N + j] = float(S[i * SS + j]);
    }
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, int H, const float* s_in, float* s_out, void* o,
           int BH, int Tn, int C, cudaStream_t stream) {
  auto kern = chunked_tile<T, N>;
  // the limit is raised once per device, so a launch captured in a CUDA
  // graph after a first launch makes no attribute call
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load()) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(Smem<N>::BYTES));
    if (err != cudaSuccess) return err;
    raised[dev].store(true);
  }
  kern<<<BH * (N / COLS), NT, Smem<N>::BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, H, s_in, s_out, static_cast<T*>(o), Tn,
      C);
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
