// Flash attention forward on Hopper -- kernel B3 of the port.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention -> _attn_kernel): online-softmax attention with GQA,
// causal and sliding-window masks and logit soft-capping.
//
// What bounds it on an H100: two matrix products per (query, key) pair,
// 4 * D operations, against q/k/v/o bytes read or written once.  At the
// model shapes (D = 128 or 256, a few thousand keys) that is far above the
// card's operations-per-byte ratio, so it is bound by operations.  This
// first version does them as float32 FMAs from shared memory (the card's
// non-tensor-core rate); tensor-core products (mma.sync / wgmma) are later
// work.
//
// Design:
// * one block of 256 threads per (batch, query head, 64-query tile); the
//   TPU's sequential KV grid axis becomes a loop over key tiles inside the
//   block, with the running max, normaliser and accumulator in registers,
//   so nothing crosses blocks and every run gives the same bits;
// * the loop visits only the key tiles that hold an unmasked key for some
//   row of the tile (causal and window bounds); a skipped tile would only
//   have added terms that the running rescale wipes out exactly.  When a
//   row of the tile has no unmasked key at all, every key is visited, so
//   such a row averages v over all keys as the reference does;
// * GQA reads kv head h / (Hq / Hkv), as the TPU kernel's index map does;
// * the ragged edges are masked by index: keys past Sk never enter a sum
//   and queries past Sq are never stored, so nothing is padded or copied;
// * masked scores take the finite NEG_INF = -1e30 of the TPU kernel, never
//   -inf: a tile whose scores are all masked gives exp(0) = 1 terms that a
//   later alpha = exp(-1e30 - m) = 0 wipes, where -inf would give NaN;
// * q is scaled before the product, and the result is acc / max(l, 1e-30),
//   both as in the TPU kernel;
// * tiles are staged in dynamic shared memory (Q and K transposed, rows
//   padded by one float against bank conflicts): 141 KB at D = 256, above
//   the 48 KB static limit, so the launcher raises the kernel's limit with
//   cudaFuncSetAttribute (once per device) and returns its error if that is
//   refused.
#include <atomic>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int BQ = 64;        // query rows per block
constexpr int RI = BQ / 16;   // query rows per thread
constexpr int kMaxDevices = 64;

template <int D, int BK>
constexpr size_t smem_floats() {
  return size_t(D) * (BQ + 1) + size_t(D) * (BK + 1) + size_t(BK) * D +
         size_t(BQ) * (BK + 1);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
              int Sq, int Sk, float scale, int causal, int use_window,
              int window, int use_softcap, float softcap) {
  constexpr int CJ = BK / 16;  // key columns per thread
  constexpr int DJ = D / 16;   // head-dim columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                 // [D][BQ + 1], scaled q, transposed
  float* Kt = Qt + D * (BQ + 1);    // [D][BK + 1], k transposed
  float* Vs = Kt + D * (BK + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK + 1], probabilities

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (size_t(b) * Hq + h) * Sq * D;
  const T* kb = k + (size_t(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t(b) * Hkv + hk) * Sk * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    Qt[c * (BQ + 1) + r] =
        q0 + r < Sq ? to_float(qb[size_t(q0 + r) * D + c]) * scale : 0.f;
  }

  // keys [lo(q), hi(q)) are unmasked for query q; both grow with q
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int hi_last = causal ? min(Sk, q_last + 1) : Sk;
  const int lo_last = use_window ? max(0, q_last - window + 1) : 0;
  int k_lo = use_window ? max(0, q0 - window + 1) : 0;
  int k_hi = hi_last;
  if (lo_last >= hi_last) {  // the tile's last row sees no key: visit all
    k_lo = 0;
    k_hi = Sk;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the last tile's reads of Kt, Vs and Ps are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Sk;
      const size_t g = size_t(k0 + r) * D + c;
      Kt[c * (BK + 1) + r] = in ? to_float(kb[g]) : 0.f;
      Vs[r * D + c] = in ? to_float(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qt[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (use_softcap) x = softcap * tanhf(x / softcap);
        const bool ok = (!causal || kp <= qp) &&
                        (!use_window || kp > qp - window);
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        if (kp < Sk) mc = fmaxf(mc, x);
      }
      mc = row_max16(mc);
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = kp < Sk ? expf(s[i][j] - mn) : 0.f;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
      ps = row_sum16(ps);
      l[i] = alpha * l[i] + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[size_t(qp) * D + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Sq, int Sk, float scale, int causal, int use_window,
           int window, int use_softcap, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D, BK>() * sizeof(float);
  auto kern = flash_fwd<T, D, BK>;
  // the limit is raised once per device, so a launch captured in a CUDA
  // graph after a first launch makes no attribute call
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load()) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    raised[dev].store(true);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, scale,
      causal, use_window, window, use_softcap, softcap);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
             int use_window, int window, int use_softcap, float softcap,
             cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                               use_window, window, use_softcap, softcap, st);
    case 64:
      return launch<T, 64, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                               use_window, window, use_softcap, softcap, st);
    case 128:
      return launch<T, 128, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                                use_window, window, use_softcap, softcap, st);
    case 256:
      return launch<T, 256, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                                use_window, window, use_softcap, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); o: (B, Hq, Sq, D); all
// contiguous, of one dtype (DTYPE_F32 or DTYPE_BF16); D in {32, 64, 128,
// 256}; Hq a multiple of Hkv.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    int use_window, int window, int use_softcap, float softcap,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                           use_window, window, use_softcap, softcap, st);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, scale,
                                   causal, use_window, window, use_softcap,
                                   softcap, st);
  return cudaErrorInvalidValue;
}
