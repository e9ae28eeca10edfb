// Decode attention on Hopper: each row's one new token attends over its KV
// cache where the cache lies, in the cache's own dtype.
//
// Replaces no TPU kernel.  The JAX package's decode step attends in plain
// jnp (src/repro/models/layers.py:attention, the one-token branch), and so
// did the port (models/layers.py) before this kernel: it wrote the token
// into a copy of each cache, widened both caches to float32 and permuted
// the keys into a contiguous copy for the score product, and the decode
// graph then copied the new caches into its static ones, so a step moved
// several times each cache's bytes a layer.  This kernel reads each valid
// key and value once and writes one row of output a query head.
//
// What bounds it on an H100: bytes.  A call must read the valid keys and
// values, 2 * B * valid * Hkv * hd * esize bytes, at 3.35 TB/s; its
// arithmetic is 2 * group multiply-adds a cached element (group = H / Hkv
// query heads read each KV head), far below the card's 295 operations a
// byte even in float32 on the CUDA cores.  So the design spends everything
// on keeping loads in flight on every SM and reading nothing twice.
//
// Design (split-KV, as flash-decoding):
// * grid (B * Hkv * chunks, splits): a block serves GT query heads of one
//   KV head of one row (GT = 2 where the group is even, else 1; a larger
//   group is served in chunks of GT heads by neighbouring blocks, which
//   meet the same rows in L2, so a K/V byte leaves device memory about
//   once) and one split of the valid keys.  Two heads, not the whole
//   group: a block of 4 heads held 151 registers a thread, 3 blocks an SM,
//   and read Jamba-v0.1's cache at 0.103 ms against 0.089 ms for two
//   blocks of 2 heads (H100, split counts swept);
// * the valid keys are read on the device from idx, so a CUDA graph that
//   captured the launch stays right at every replay: a linear cache takes
//   keys lo..idx (lo = idx - window + 1 with a window, else 0), a ring
//   cache slots 0..min(idx + 1, T) - 1; the wrapper's split count depends
//   on the shapes only, and split s takes the s-th of `splits` equal runs
//   of that range; a split with no key writes a neutral partial and reads
//   nothing;
// * inside a block, 4 warps; a group of LPK lanes holds one key row, lane
//   l its 16-byte pieces l, l + LPK, ... (a 256-byte bf16 row of hd 128 is
//   16 lanes x 16 bytes, so a warp reads two whole rows a load); each lane
//   group loads UNROLL rows of K and of V before it uses any, and a few
//   blocks an SM keep the rest of the card's bytes in flight; each lane
//   uses exactly the bytes it loaded, so nothing is staged in shared
//   memory;
// * scores in float32 from the cache's dtype: each lane's partial dot
//   over its pieces, a butterfly of shuffles over the lane group (every
//   lane ends with the same bits), divided by sqrt(hd) with a correctly
//   rounded divide (as the plain version), then softcap * tanh(s /
//   softcap) where there is one; an online softmax in float32 a lane group
//   and head (running max m, sum l, unnormalised P.V in float32);
// * the lane groups of a warp merge by shuffles, the warps through shared
//   memory, all in one fixed order; one split writes its output in q's
//   dtype, more write (m, l, o) to float32 scratch and a second kernel
//   merges them in split order.  No atomics: two runs give the same bits.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// 16 bytes of T, widened to floats
template <typename T> struct Piece;

template <> struct Piece<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <> struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2i is the low half of word i (little endian); a bf16 is the
  // top half of its float32
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// exp(m - mx), 0 for a state or score that saw no key (m = -inf)
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(THREADS)
    decode_split(const T* __restrict__ q, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int* __restrict__ idx_ptr,
                 T* __restrict__ out, float* __restrict__ part_o,
                 float* __restrict__ part_ml, int H, int Hkv, int Tn,
                 int chunks, int ring, int window, float sqrt_hd, int has_cap,
                 float cap) {
  constexpr int VEC = Piece<T>::N;                  // elements a piece
  constexpr int PIECES = HD / VEC;                  // pieces a row
  constexpr int LPK = PIECES < 32 ? PIECES : 32;    // lanes a key row
  constexpr int CPL = PIECES / LPK;                 // pieces a lane
  constexpr int KPW = 32 / LPK;                     // lane groups a warp
  constexpr int NG = WARPS * KPW;                   // lane groups a block
  constexpr int E = CPL * VEC;                      // elements a lane
  constexpr int UNROLL = 4;                         // rows loaded at once

  __shared__ float sm_acc[WARPS][GT][HD];
  __shared__ float sm_m[WARPS][GT];
  __shared__ float sm_l[WARPS][GT];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane % LPK;                        // place in the group
  const int gid = warp * KPW + lane / LPK;          // the lane group
  const int bk = blockIdx.x / chunks;               // row * Hkv + kv head
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int h0 = kvh * (H / Hkv) + (blockIdx.x % chunks) * GT;
  const int split = blockIdx.y, splits = gridDim.y;

  // the valid keys [lo, hi), then this split's run [k0, k1) of them
  const int idx = *idx_ptr;
  const int hi = min(idx + 1, Tn);
  const int lo = (!ring && window > 0) ? max(0, idx - window + 1) : 0;
  const int n = max(hi - lo, 0);
  const int per = (n + splits - 1) / splits;
  const int k0 = lo + split * per;
  const int k1 = min(k0 + per, hi);

  float qf[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const T* row = q + (size_t(b) * H + h0 + g) * HD;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      Piece<T>::widen(load16(row + (sl + j * LPK) * VEC), qf[g] + j * VEC);
  }
  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t kstride = size_t(Hkv) * HD;          // elements a key
  const size_t first = (size_t(b) * Tn * Hkv + kvh) * HD;
  const T* kbase = kc + first;
  const T* vbase = vc + first;

  for (int base = k0; base < k1; base += NG * UNROLL) {
    uint4 kr[UNROLL][CPL], vr[UNROLL][CPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * NG + gid;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (t < k1) {
          const size_t off = size_t(t) * kstride + (sl + j * LPK) * VEC;
          kr[u][j] = load16(kbase + off);
          vr[u][j] = load16(vbase + off);
        } else {
          kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    float sc[UNROLL][GT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[E];
#pragma unroll
      for (int j = 0; j < CPL; ++j) Piece<T>::widen(kr[u][j], kf + j * VEC);
      const bool ok = base + u * NG + gid < k1;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        float s = __fdiv_rn(d, sqrt_hd);
        if (has_cap) s = cap * tanhf(__fdiv_rn(s, cap));
        sc[u][g] = ok ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -INFINITY) continue;                // no valid key yet
      const float a = weight(m[g], mx);
      l[g] *= a;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= a;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[E];
#pragma unroll
      for (int j = 0; j < CPL; ++j) Piece<T>::widen(vr[u][j], vf + j * VEC);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = weight(sc[u][g], m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // the lane groups of a warp into its group 0 (a fixed pairing: group 0
  // always takes the same side)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = weight(m[g], mx), c = weight(mo, mx);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mx;
    }
  }
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][g][(sl + j * LPK) * VEC + e] = acc[g][j * VEC + e];
      }
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // the warps, in order; then the output or this split's partial
  for (int i = threadIdx.x; i < GT * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = weight(sm_m[w][g], mx);
      L = fmaf(c, sm_l[w][g], L);
      O = fmaf(c, sm_acc[w][g][d], O);
    }
    const size_t row = size_t(b) * H + h0 + g;
    if (splits == 1) {
      out[row * HD + d] = from_float<T>(__fdiv_rn(O, L));
    } else {
      const size_t r = row * splits + split;
      part_o[r * HD + d] = O;
      if (d == 0) {
        part_ml[2 * r] = mx;
        part_ml[2 * r + 1] = L;
      }
    }
  }
}

// one block a (row, query head), a thread an output element: the splits'
// partials in split order
template <typename T>
__global__ void decode_merge(const float* __restrict__ part_o,
                             const float* __restrict__ part_ml,
                             T* __restrict__ out, int HD, int splits) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * splits * 2;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float c = weight(ml[2 * s], mx);
    L = fmaf(c, ml[2 * s + 1], L);
    O = fmaf(c, part_o[(row * splits + s) * HD + d], O);
  }
  out[row * HD + d] = from_float<T>(__fdiv_rn(O, L));
}

struct Args {
  const void *q, *k, *v;
  const int* idx;
  void* out;
  float *part_o, *part_ml;
  int B, H, Hkv, Tn, splits, ring, window;
  float sqrt_hd;
  int has_cap;
  float cap;
};

template <typename T, int HD, int GT>
int launch(const Args& a, cudaStream_t st) {
  const int chunks = (a.H / a.Hkv) / GT;
  const dim3 grid(a.B * a.Hkv * chunks, a.splits);
  decode_split<T, HD, GT><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.idx, static_cast<T*>(a.out), a.part_o,
      a.part_ml, a.H, a.Hkv, a.Tn, chunks, a.ring, a.window, a.sqrt_hd,
      a.has_cap, a.cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  decode_merge<T><<<a.B * a.H, HD, 0, st>>>(a.part_o, a.part_ml,
                                            static_cast<T*>(a.out), HD,
                                            a.splits);
  return cudaGetLastError();
}

template <typename T, int HD>
int by_group(int gt, const Args& a, cudaStream_t st) {
  switch (gt) {
    case 1: return launch<T, HD, 1>(a, st);
    case 2: return launch<T, HD, 2>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int by_head_dim(int hd, int gt, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 32: return by_group<T, 32>(gt, a, st);
    case 64: return by_group<T, 64>(gt, a, st);
    case 128: return by_group<T, 128>(gt, a, st);
    case 256: return by_group<T, 256>(gt, a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, 1, H, hd); k, v (B, Tn, Hkv, hd) caches, the token already written
// at idx; idx one int32 on the device; out (B, 1, H, hd) in q's dtype;
// part_o (B * H * splits * hd) and part_ml (B * H * splits * 2) float32
// scratch (unused, may be null, when splits == 1).  gt query heads a block
// (it divides H / Hkv); window 0 for none.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* idx, void* out,
    void* part_o, void* part_ml, int dtype, int B, int H, int Hkv, int Tn,
    int hd, int gt, int splits, int ring, int window, float sqrt_hd,
    int has_cap, float cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || H % Hkv || (H / Hkv) % gt || Tn < 1 ||
      splits < 1 || splits > 65535 || window < 0)
    return cudaErrorInvalidValue;
  if (splits > 1 && (part_o == nullptr || part_ml == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(idx), out,
               static_cast<float*>(part_o), static_cast<float*>(part_ml), B,
               H, Hkv, Tn, splits, ring, window, sqrt_hd, has_cap, cap};
  if (dtype == DTYPE_F32) return by_head_dim<float>(hd, gt, a, st);
  if (dtype == DTYPE_BF16) return by_head_dim<__nv_bfloat16>(hd, gt, a, st);
  return cudaErrorInvalidValue;
}
