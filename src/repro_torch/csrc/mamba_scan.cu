// Selective state-space (Mamba) scan on Hopper -- kernel B5 of the port.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py
// (mamba_scan -> _mamba_kernel):
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
//     y_t = h_t . C_t + D * x_t
// with the (d_inner x d_state) float32 state kept on chip for the whole
// sequence, so device memory sees x, dt, B, C and y only.  One launch.
// The state may start from a given float32 h_0 (B, d_inner, d_state) and
// its final value h_T may be written out, over h_0 itself if asked (a
// served decode step updates its cache in place): each thread reads its
// own states before the scan and writes the same ones after it, and no
// other thread touches them.
//
// What bounds it on an H100: per (token, channel) it reads x and dt and
// writes y (B_t and C_t are shared by all channels): 12 bytes in float32.
// Per (token, channel, state) it takes one exponential and four float32
// operations.  The SFU (MUFU.EX2) gives 16 exponentials a clock an SM, an
// eighth of the float32 rate; a share of them could instead run on the
// FMA pipe as a polynomial (about 7 float32 operations each).  On the
// Jamba-v0.1 layer (B 2, T 4096, d_inner 8192, d_state 16) the 1.07e9
// exponentials on the SFU alone take at least 0.2568 ms, split at best
// between the SFU and the FMA pipe 0.190 ms, and the 806 MB at least
// 0.2409 ms: its bound is the bytes.  This kernel takes every exponential
// on the SFU, which leaves the FMA pipe most of each step, and streams
// the loads in underneath the scan.
//
// Design:
// * the TPU's sequential chunk grid axis becomes one loop over T inside
//   the block; the B x d_inner x d_state independent recurrences split
//   over blocks of CH channels of one batch row.  A thread holds K
//   channels x SPL states in registers, and L lanes (threads) cover a
//   channel's d_state (L x SPL >= d_state).  Thread tid is lane tid / CG
//   of channel group tid % CG (CG = CH / K), so a warp is 32 groups at
//   one lane: its B_t and C_t reads are broadcasts, its x and dt reads
//   one contiguous 512-byte row piece.  K = GROUP and CH = CHANNELS are
//   constants of this file, SPL a template argument (2 or 4) and L a
//   launch argument; kernels/mamba_scan/kernel.py:layout picks L and SPL
//   for each d_state, and tools/mamba_layouts.py builds this file with
//   other values to time them;
// * shared memory feeds registers at 128 bytes a clock an SM, broadcast
//   or not, and at the SFU's pace a 1 x 16 layout (a thread a channel)
//   needs its B_t and C_t values -- 2 floats a state and step -- at about
//   that rate.  With K channels a thread each B/C value serves K
//   channels and each x/dt value SPL states.  2 channels x 4 states a
//   thread reads 1.75 floats a state and step (with the partial sums'
//   store) and keeps 8 warps an SM busy on the Jamba-v0.1 layer; 4 x 4
//   reads 1.25 but leaves 4 warps an SM, too few to hide the latency;
// * one SFU operation a state and step: A is held pre-scaled by log2(e)
//   in registers, so the decay is ex2.approx(dt * A') -- an FMUL and one
//   MUFU.EX2 -- in place of the accurate expf;
// * the next step's operands are read from shared memory while the
//   current step computes;
// * no shuffle and no per-step divergent store: each thread writes its K
//   partial y_t (lane 0's start from D x_t) to a shared tile as one
//   vector, and once a tile of TC steps is done each thread sums the L
//   lanes' partials, in lane order, for rows lane, lane + L, ... and
//   stores them as a vector -- a fixed order, so every run gives the same
//   bits; no integer division in any per-step or per-element loop;
// * loads overlap the scan: a ring of STAGES tiles (x and dt for the
//   block's channels, B and C) filled by cp.async 16 bytes at a time,
//   STAGES - 1 tiles ahead of the scan; one __syncthreads a tile hands a
//   landed stage over, one more hands the partial sums to the epilogue.
//   Shapes whose rows are not 16-byte multiples (odd d_state or d_inner,
//   offset views) take the same ring filled by plain loads.
// The chunk size of the TPU kernel only tiles its grid and changes
// nothing here.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int STAGES = 3;               // tiles in flight: the scan's + 2
constexpr int GROUP = 2;                // channels a thread
constexpr int CHANNELS = 64;            // channels a block
constexpr int MAX_STATE = 64;           // the widest d_state (kernel.py's)
static_assert(CHANNELS % (32 * GROUP) == 0, "a warp is 32 channel groups");
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 227 * 1024;    // a block's dynamic shared memory
constexpr size_t SM_SMEM = 228 * 1024;  // an SM's, 1 KB a block reserved

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive values of type T from shared memory (aligned to
// min(16, N * sizeof(T)) bytes) as float32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[N]) {
  constexpr int BYTES = N * int(sizeof(T));
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / int(sizeof(T));
#pragma unroll
    for (int q = 0; q < N / PER; ++q) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) v[q * PER + i] = to_float(e[i]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_float(p[i]);
  }
}

// K consecutive values of type T to memory (aligned to K * sizeof(T)
// bytes) from float32
template <typename T, int K>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[K]) {
  if constexpr (K * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < K; ++i) e[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else if constexpr (K * sizeof(T) == 8) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < K; ++i) e[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = from_float<T>(v[i]);
  }
}

// the most threads a block of an instance may have: the K * SPL states a
// thread holds (about 6 registers each with the prefetched step) bound it,
// and so do the lanes that cover the widest state (MAX_STATE / SPL) for
// each of a block's CHANNELS / K channel groups.  The bound sets the
// registers a thread may take (65536 / bound): at 1024, 64, too few for 2
// channels x 4 states once the state's offset is held across the scan (it
// spilled, 10% slower); at 512 the Jamba-v0.1 case takes 106 registers
// and runs 2.5% faster than the stateless kernel did at 64
// (tools/mamba_layouts.py)
template <int K, int SPL>
struct MaxThreads {
  static constexpr int by_states = K * SPL >= 16 ? 512 : 1024;
  static constexpr int by_lanes = (MAX_STATE + SPL - 1) / SPL * CHANNELS / K;
  static constexpr int value = by_lanes < by_states ? by_lanes : by_states;
};

struct Geometry {
  int L, CH, TC, GP;  // lanes a channel, channels a block, steps a tile,
                      // padded B/C row (a multiple of 8 elements)
  __host__ __device__ size_t stage_elems() const {
    return size_t(2) * TC * CH + size_t(2) * TC * GP;
  }
  __host__ __device__ size_t smem_bytes(int elem) const {
    return STAGES * stage_elems() * elem + size_t(TC) * L * CH * 4;
  }
};

// One tile of TC steps from step t0 (n of them real) into a stage: x and
// dt for the block's channels, B and C.  By cp.async, 16 bytes at a time,
// when every row is a 16-byte multiple and the bases are aligned; else by
// plain loads, zeros past the edges.
template <typename T>
__device__ void load_tile(T* st, const T* __restrict__ x,
                          const T* __restrict__ dt, const T* __restrict__ bm,
                          const T* __restrict__ cm, const Geometry g, int nth,
                          size_t xrow, size_t srow, int c0, int t0, int n,
                          int Di, int Ds, bool aligned) {
  T* xs = st;
  T* dts = xs + g.TC * g.CH;
  T* bs = dts + g.TC * g.CH;
  T* cs = bs + g.TC * g.GP;
  const int tid = threadIdx.x;
  if (aligned) {
    constexpr int EPC = 16 / int(sizeof(T));  // elements a 16-byte chunk
    // a row of x is kx chunks, and kx divides the block's threads
    const int kx = g.CH / EPC, k = tid % kx, c = c0 + k * EPC;
    for (int r = tid / kx; r < g.TC; r += nth / kx) {
      const bool ok = r < n && c < Di;
      const size_t off = ok ? xrow + size_t(t0 + r) * Di + c : 0;
      cp_async16(xs + r * g.CH + k * EPC, x + off, ok);
      cp_async16(dts + r * g.CH + k * EPC, dt + off, ok);
    }
    const int ks = g.GP / EPC;
    for (int e = tid; e < g.TC * ks; e += nth) {
      const int r = e / ks, s = e % ks * EPC;
      const bool ok = r < n && s < Ds;
      const size_t off = ok ? srow + size_t(t0 + r) * Ds + s : 0;
      cp_async16(bs + r * g.GP + s, bm + off, ok);
      cp_async16(cs + r * g.GP + s, cm + off, ok);
    }
    return;
  }
  const T zero = from_float<T>(0.f);
  for (int e = tid; e < g.TC * g.CH; e += nth) {
    const int r = e / g.CH, c = e % g.CH;
    const bool ok = r < n && c0 + c < Di;
    const size_t off = xrow + size_t(t0 + r) * Di + c0 + c;
    xs[e] = ok ? x[off] : zero;
    dts[e] = ok ? dt[off] : zero;
  }
  for (int e = tid; e < g.TC * g.GP; e += nth) {
    const int r = e / g.GP, s = e % g.GP;
    const bool ok = r < n && s < Ds;
    const size_t off = srow + size_t(t0 + r) * Ds + s;
    bs[e] = ok ? bm[off] : zero;
    cs[e] = ok ? cm[off] : zero;
  }
}

// One step's operands of a thread, read from a stage in shared memory
template <typename T, int K, int SPL>
struct Step {
  float x[K], dt[K], b[SPL], c[SPL];
  __device__ __forceinline__ void load(const T* xs, const T* dts,
                                       const T* bs, const T* cs) {
    load_vec<T, K>(xs, x);
    load_vec<T, K>(dts, dt);
    load_vec<T, SPL>(bs, b);
    load_vec<T, SPL>(cs, c);
  }
};

// y for row r of a tile from its partial sums q (laid out [TC][L][CH]):
// the thread's K channels, the L lanes' partials added in lane order
template <typename T, int K>
__device__ __forceinline__ void store_row(const float* q, int r, int L,
                                          int CH, T* out, int left,
                                          bool vec) {
  q += size_t(r) * L * CH;
  float acc[K];
  load_vec<float, K>(q, acc);
  for (int l = 1; l < L; ++l) {
    float part[K];
    load_vec<float, K>(q + l * CH, part);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += part[k];
  }
  if (vec && left >= K) {
    store_vec<T, K>(out, acc);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < left) out[k] = from_float<T>(acc[k]);
  }
}

template <typename T, int SPL, int K = GROUP>
__global__ void __launch_bounds__(MaxThreads<K, SPL>::value)
    mamba_fwd(const T* __restrict__ x, const T* __restrict__ dt,
              const T* __restrict__ bm, const T* __restrict__ cm,
              const T* __restrict__ a, const T* __restrict__ dv,
              const float* h0, float* hT, T* __restrict__ y, int Tn, int Di,
              int Ds, Geometry g, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  float* ps = reinterpret_cast<float*>(stages + STAGES * g.stage_elems());

  // thread tid: lane tid / CG (its SPL states) of the K channels of group
  // tid % CG; a warp is 32 groups of one lane
  const int CG = g.CH / K, nth = g.L * CG, LC = g.L * g.CH;
  const int tid = threadIdx.x, lane = tid / CG, cg = tid % CG;
  const int c0 = blockIdx.x * g.CH, b = blockIdx.y, cb = c0 + cg * K;
  const int left = Di - cb;  // the thread's channels in range, if < K

  // the thread's states: h0 / hT row (b, cb + k), columns lane * SPL + j
  const size_t hrow = (size_t(b) * Di + cb) * Ds;
  float a2[K][SPL], h[K][SPL], dd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool ok = k < left;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int s = lane * SPL + j;
      const bool in = ok && s < Ds;
      a2[k][j] = in ? to_float(a[size_t(cb + k) * Ds + s]) * LOG2E : 0.f;
      h[k][j] = in && h0 ? h0[hrow + size_t(k) * Ds + s] : 0.f;
    }
    // lane 0's partial sums start from D x_t
    dd[k] = ok && lane == 0 ? to_float(dv[cb + k]) : 0.f;
  }
  const size_t xrow = size_t(b) * Tn * Di, srow = size_t(b) * Tn * Ds;
  const int ntiles = (Tn + g.TC - 1) / g.TC;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles)
      load_tile(stages + s * g.stage_elems(), x, dt, bm, cm, g, nth, xrow,
                srow, c0, s * g.TC, min(g.TC, Tn - s * g.TC), Di, Ds,
                aligned);
    cp_async_commit();
  }

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed; tile i - 1's stage and sums are free
    {
      const int nt = i + STAGES - 1;
      if (nt < ntiles)
        load_tile(stages + (nt % STAGES) * g.stage_elems(), x, dt, bm, cm, g,
                  nth, xrow, srow, c0, nt * g.TC, min(g.TC, Tn - nt * g.TC),
                  Di, Ds, aligned);
      cp_async_commit();
    }
    const T* xs = stages + (i % STAGES) * g.stage_elems() + cg * K;
    const T* dts = xs + g.TC * g.CH;
    const T* bs = dts - cg * K + g.TC * g.CH + lane * SPL;
    const T* cs = bs + g.TC * g.GP;
    const int n = min(g.TC, Tn - i * g.TC);
    float* pr = ps + lane * g.CH + cg * K;
    // the next step's operands are read while this one computes (a read
    // past the tile's last row stays inside the shared memory and is
    // never used)
    Step<T, K, SPL> cur;
    cur.load(xs, dts, bs, cs);
    for (int r = 0; r < n; ++r) {
      Step<T, K, SPL> nxt;
      nxt.load(xs + (r + 1) * g.CH, dts + (r + 1) * g.CH,
               bs + (r + 1) * g.GP, cs + (r + 1) * g.GP);
      float p[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dx = cur.dt[k] * cur.x[k];
        p[k] = dd[k] * cur.x[k];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          h[k][j] = fmaf(ex2(cur.dt[k] * a2[k][j]), h[k][j], dx * cur.b[j]);
          p[k] = fmaf(h[k][j], cur.c[j], p[k]);
        }
      }
      store_vec<float, K>(pr + r * LC, p);
      cur = nxt;
    }
    __syncthreads();  // the tile's partial sums are in
    // y: rows lane, lane + L, ... of the thread's K channels
    T* yt = y + xrow + size_t(i) * g.TC * Di + cb;
#pragma unroll 4
    for (int r = lane; r < n; r += g.L)
      store_row<T, K>(ps + cg * K, r, g.L, g.CH, yt + size_t(r) * Di, left,
                      aligned);
  }
  cp_async_wait<0>();
  if (hT) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = lane * SPL + j;
        if (k < left && s < Ds) hT[hrow + size_t(k) * Ds + s] = h[k][j];
      }
  }
}

// The launch of one layout: its grid, tile and shared memory.  32 steps a
// tile, halved (to 8 at least) until the blocks an SM must hold at once
// for the grid to run in one wave fit its shared memory.
struct Plan {
  dim3 grid;
  Geometry g;
  size_t smem;
};

template <typename T, int SPL>
int plan(int B, int Di, int Ds, int L, Plan* p) {
  const int threads = L * CHANNELS / GROUP;
  if (L < 1 || L * SPL < Ds || threads > MaxThreads<GROUP, SPL>::value)
    return cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = sms > 0 ? sms : 1;
  }
  static bool attr_set = false;  // once an instance, before any capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_fwd<T, SPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  p->grid = dim3((Di + CHANNELS - 1) / CHANNELS, B);
  const size_t blocks = size_t(p->grid.x) * p->grid.y;
  const size_t resident = std::min<size_t>(
      {(blocks + sms - 1) / sms, size_t(2048 / threads), size_t(32)});
  p->g = Geometry{L, CHANNELS, 32, (L * SPL + 7) / 8 * 8};
  while (resident * (p->g.smem_bytes(sizeof(T)) + 1024) > SM_SMEM &&
         p->g.TC > 8)
    p->g.TC /= 2;
  p->smem = p->g.smem_bytes(sizeof(T));
  return p->smem > MAX_SMEM ? cudaErrorInvalidValue : cudaSuccess;
}

struct Args {
  const void *x, *dt, *b, *c, *a, *d;
  const float* h0;
  float* hT;
  void* y;
  int B, Tn, Di, Ds, L;
};

template <typename T, int SPL>
int launch(const Args& r, cudaStream_t stream) {
  Plan p;
  const int err = plan<T, SPL>(r.B, r.Di, r.Ds, r.L, &p);
  if (err != cudaSuccess) return err;
  const auto aligned_ptr = [](const void* q) {
    return reinterpret_cast<size_t>(q) % 16 == 0;
  };
  const int aligned = aligned_ptr(r.x) && aligned_ptr(r.dt) &&
                      aligned_ptr(r.b) && aligned_ptr(r.c) &&
                      aligned_ptr(r.y) && r.Di * sizeof(T) % 16 == 0 &&
                      r.Ds * sizeof(T) % 16 == 0;
  mamba_fwd<T, SPL><<<p.grid, r.L * CHANNELS / GROUP, p.smem, stream>>>(
      static_cast<const T*>(r.x), static_cast<const T*>(r.dt),
      static_cast<const T*>(r.b), static_cast<const T*>(r.c),
      static_cast<const T*>(r.a), static_cast<const T*>(r.d), r.h0, r.hT,
      static_cast<T*>(r.y), r.Tn, r.Di, r.Ds, p.g, aligned);
  return cudaGetLastError();
}

// f(T(), std::integral_constant<int, SPL>()) for the instance of that
// dtype and SPL states a thread holds of each channel: the instances the
// kernel is built in (kernels/mamba_scan/kernel.py:layout uses each)
template <int N>
using I = std::integral_constant<int, N>;

template <typename T, typename F>
int with_spl(int SPL, F f) {
  switch (SPL) {
    case 2: return f(T(), I<2>());
    case 4: return f(T(), I<4>());
  }
  return cudaErrorInvalidValue;
}

template <typename F>
int with_type(int dtype, int SPL, F f) {
  if (dtype == DTYPE_F32) return with_spl<float>(SPL, f);
  if (dtype == DTYPE_BF16) return with_spl<__nv_bfloat16>(SPL, f);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dt, y: (B, T, Di); b, c: (B, T, Ds); a: (Di, Ds); d: (Di,); all
// contiguous, of one dtype (DTYPE_F32 or DTYPE_BF16); h0, hT: null or
// contiguous float32 (B, Di, Ds), the initial state (zeros when null) and
// where the final one goes (hT may be h0); L lanes a channel holding SPL
// states each (L * SPL >= Ds), SPL one of with_spl's.
extern "C" int repro_mamba_scan_fwd(const void* x, const void* dt,
                                    const void* b, const void* c,
                                    const void* a, const void* d,
                                    const void* h0, void* hT, void* y,
                                    int dtype, int B, int Tn, int Di, int Ds,
                                    int L, int SPL, void* stream) {
  const Args r{x, dt, b, c, a, d, static_cast<const float*>(h0),
               static_cast<float*>(hT), y, B, Tn, Di, Ds, L};
  return with_type(dtype, SPL, [&](auto t, auto s) {
    return launch<decltype(t), decltype(s)::value>(
        r, static_cast<cudaStream_t>(stream));
  });
}
