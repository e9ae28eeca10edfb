// Flash attention forward on Hopper's tensor cores -- kernel B3 of the port.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention -> _attn_kernel): online-softmax attention with GQA,
// causal and sliding-window masks and logit soft-capping.
//
// What bounds it on an H100: two matrix products per unmasked (query, key)
// pair, 2 * D multiply-adds, against q, k, v read and o written once.  At
// the model shapes (D = 128 or 256, hundreds to thousands of keys a row)
// that is far above the card's operations-per-byte ratio, so it is bound
// by the tensor cores, with the softmax's exp (and the softcap's tanh) per
// pair on the CUDA cores beside them.
//
// Design (FlashAttention-2's, on mma.sync):
// * one block per (query head, batch, tile of 16 * NW queries) of NW warps,
//   each warp owning 16 query rows.  The TPU's sequential KV grid axis is a
//   loop over key tiles inside the block.  The running max, the running sum
//   and the output stay in the mma accumulator fragments; the row max and
//   the final row sum are 4-lane shuffles.  No atomics and one fixed order
//   of every sum, so a rerun gives the same bits.
// * both products on the tensor cores.  bf16: mma m16n8k16 with float32
//   accumulators (bf16 x bf16 products are exact there).  P is split into
//   bf16 hi + lo and multiplied twice against V: one bf16 rounding of P, as
//   FlashAttention does, is 2^-9 relative and breaks the plain version's
//   tolerance.  float32: mma m16n8k8 TF32 in the 3xTF32 form, each operand
//   x = hi + lo with hi = tf32(x) and lo = x - hi (truncated to TF32 by
//   the tensor core), each product lo*hi + hi*lo + hi*hi: float32
//   accuracy, where one TF32 product's 10 mantissa bits would not keep it
//   (tests/test_torch_flash_precision.py emulates both choices on the
//   CPU).
// * operands from shared memory: bf16 through ldmatrix (V through
//   ldmatrix.trans); float32 through 8-byte loads in the fragment layout,
//   with the k axis of each 8-wide step permuted (fragment column t takes
//   element 2t, column t + 4 element 2t + 1), which leaves every sum the
//   same and puts a thread's two elements side by side.  P goes from the
//   score accumulators into A fragments in registers, never through shared
//   memory.
// * K and V tiles double-buffered in shared memory in their own type,
//   loaded with 16-byte cp.async, so tile j + 1's load overlaps tile j's
//   products.  Rows are padded (8 elements; 4 for float32 V) so that every
//   ldmatrix and fragment load is free of bank conflicts.
// * masks by index, no padding copies: the block visits only the key tiles
//   that hold an unmasked key for one of its rows, and each warp computes
//   only those that hold one for one of its own rows (a skipped tile would
//   add terms that the running rescale wipes exactly).  A row with no
//   unmasked key at all visits every key and averages v over them, as the
//   plain version does.  Tiles inside every row's range skip the mask.
//   Masked scores take the TPU kernel's finite NEG_INF = -1e30; keys past
//   Sk take -inf, so they enter no max and no sum; rows and keys past the
//   ends are zero-filled by cp.async, and queries past Sq are not stored.
// * scale: float32 multiplies q before the split, as the TPU kernel does;
//   bf16 multiplies the float32 scores, with log2(e) folded in so that
//   exp2f takes the place of expf (float32 keeps expf and the softcap's
//   division, for its 2e-5).  The result is acc / max(l, 1e-30).  tanhf
//   is the accurate one (tanh.approx's 2^-11 relative error would be 0.02
//   in a score softcapped at 50).  A warp skips the output's rescale when
//   every alpha is exactly 1.
// * query tiles run heaviest first (the slowest grid axis, reversed), so a
//   causal launch's last wave holds the short tiles.
// * shared memory: the Q tile and two stages of K and V, 30-198 KB a
//   block, mostly above the 48 KB static limit: the launcher raises the
//   kernel's limit once per device and returns its error if that is
//   refused.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

// Tile shape of each instance: warps a block (16 query rows each) and key
// rows a tile.  For the two instances chip_smoke.py times (float32 D 128,
// bf16 D 256), a shape that tools/flash_shapes.py's sweep found fastest,
// or within its noise, among those that spill no register; the others
// take 8 warps on 64-key tiles, or at float32 D 256 on the 16-key tiles
// that fit.
template <int NW_, int BK_>
struct ShapeOf {
  static constexpr int NW = NW_, BK = BK_;
};
template <typename T, int D> struct Shape;
template <> struct Shape<float, 32> : ShapeOf<8, 64> {};
template <> struct Shape<float, 64> : ShapeOf<8, 64> {};
template <> struct Shape<float, 128> : ShapeOf<4, 32> {};
template <> struct Shape<float, 256> : ShapeOf<8, 16> {};
template <> struct Shape<bf16, 32> : ShapeOf<8, 64> {};
template <> struct Shape<bf16, 64> : ShapeOf<8, 64> {};
template <> struct Shape<bf16, 128> : ShapeOf<8, 64> {};
template <> struct Shape<bf16, 256> : ShapeOf<4, 16> {};

// Sizes and shared-memory layout of one instance (strides in elements).
template <typename T, int D>
struct Tile {
  static constexpr bool kBF16 = std::is_same<T, bf16>::value;
  static constexpr int NW = Shape<T, D>::NW;
  static constexpr int BK = Shape<T, D>::BK;
  static constexpr int NT = 32 * NW;            // threads
  static constexpr int BQ = 16 * NW;            // query rows
  static constexpr int QS = D + 8;              // Q row stride
  static constexpr int KS = D + 8;              // K row stride
  static constexpr int VS = kBF16 ? D + 8 : D + 4;  // V row stride
  static constexpr int STAGE = BK * (KS + VS);  // one K tile and one V tile
  static constexpr size_t SMEM = sizeof(T) * (size_t(BQ) * QS + 2 * STAGE);
  static constexpr int NS = BK / 8;             // score n-tiles of a warp
  static constexpr int NO = D / 8;              // output n-tiles of a warp
  static_assert(BK % 16 == 0 && D % 16 == 0, "tile shapes");
  static_assert(SMEM <= 232448, "above the 227 KB a block can use");
};

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !in (then src
// is only a valid address, no byte of it is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), C 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: A 16 x 8 TF32 (row), B 8 x 8 TF32 (col), C 16 x 8 float32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32(x); lo = x - hi exactly, of which the tensor
// core reads the top 19 bits (it drops the low 13 of a TF32 operand), so
// lo needs no rounding of its own
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b in 3xTF32: lo*hi + hi*lo + hi*hi, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  uint32_t r;
  memcpy(&r, &x, sizeof(r));
  return r;
}

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// ---- tiles ----------------------------------------------------------------

// rows [row0, row0 + ROWS) of a (n_rows, D) matrix into shared memory at
// row stride S, 16 bytes a copy; rows past n_rows are zero-filled
template <typename T, int D, int ROWS, int S, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int n_rows, int tid) {
  constexpr int E = 16 / sizeof(T);  // elements a copy
  constexpr int CPR = D / E;         // copies a row
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (N % NT != 0 && c >= N) break;
    const int r = c / CPR, col = (c % CPR) * E;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * S + col,
               in ? src + size_t(row0 + r) * D + col : src, in);
  }
}

// s = q k^T over one key tile for the warp's 16 rows (Qw) -- bf16
template <int D, int BK, int QS, int KS>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const bf16* Qw,
                                       const bf16* Ks, int lane, float) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, Qw + (lane % 16) * QS + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int p = 0; p < BK / 16; ++p) {
      uint32_t b[4];
      ldsm_x4(b, Ks + (16 * p + lane % 8 + (lane / 16) * 8) * KS + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma_bf16(s[2 * p], a, b[0], b[1]);
      mma_bf16(s[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// the same in float32 (3xTF32); q is scaled before the split.  The small
// terms go to accumulators of their own, added once at the end: two
// independent chains of products per score tile, and the large term's
// sum is not rounded at the small terms' additions
template <int D, int BK, int QS, int KS>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const float* Qw,
                                       const float* Ks, int lane,
                                       float scale) {
  const int g = lane / 4, t = lane % 4;
  float small[BK / 8][4];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[n][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(Qw + g * QS + kk * 8 +
                                                       2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(
        Qw + (g + 8) * QS + kk * 8 + 2 * t);
    uint32_t ah[4], al[4];
    split_tf32(x0.x * scale, ah[0], al[0]);  // (g,     t)
    split_tf32(x1.x * scale, ah[1], al[1]);  // (g + 8, t)
    split_tf32(x0.y * scale, ah[2], al[2]);  // (g,     t + 4)
    split_tf32(x1.y * scale, ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(
          Ks + (8 * n + g) * KS + kk * 8 + 2 * t);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(y.x, bh0, bl0);  // (k t,     key g)
      split_tf32(y.y, bh1, bl1);  // (k t + 4, key g)
      mma_tf32(small[n], al, bh0, bh1);
      mma_tf32(small[n], ah, bl0, bl1);
      mma_tf32(s[n], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += small[n][e];
}

// o += p v over one key tile -- bf16, p split into bf16 hi + lo
template <int D, int BK, int VS>
__device__ __forceinline__ void apply_v(float (&o)[D / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const bf16* Vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, ..)
      // two row neighbours in one register, the lower column in the low
      // half
      const float* x = &p[2 * kk + i / 2][(i % 2) * 2];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[0], x[1]);
      const float2 back = __bfloat1622float2(hi);
      ah[i] = bits(hi);
      al[i] = bits(__floats2bfloat162_rn(x[0] - back.x, x[1] - back.y));
    }
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      ldsm_x4_trans(b, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * VS +
                           n2 * 16 + (lane / 16) * 8);
      mma_bf16(o[2 * n2], al, b[0], b[1]);
      mma_bf16(o[2 * n2], ah, b[0], b[1]);
      mma_bf16(o[2 * n2 + 1], al, b[2], b[3]);
      mma_bf16(o[2 * n2 + 1], ah, b[2], b[3]);
    }
  }
}

// the same in float32 (3xTF32); the keys of each 8-wide step are permuted
// as the scores' d axis is: fragment column t is key 2t, t + 4 is 2t + 1
template <int D, int BK, int VS>
__device__ __forceinline__ void apply_v(float (&o)[D / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const float* Vs, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);  // (g,     key 2t)
    split_tf32(p[j][2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32(p[j][1], ah[2], al[2]);  // (g,     key 2t + 1)
    split_tf32(p[j][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
    const float* v0 = Vs + (8 * j + 2 * t) * VS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(v0[8 * n], bh0, bl0);
      split_tf32(v0[VS + 8 * n], bh1, bl1);
      mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// e^x, or 2^x for scores kept in log2 units
template <bool kLog2>
__device__ __forceinline__ float exp_of(float x) {
  return kLog2 ? exp2f(x) : expf(x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// keys [lo, hi) of the rows [first, last] that some row leaves unmasked,
// and [full_lo, full_hi) that every row leaves unmasked; when the last row
// has no unmasked key, every key (such a row averages v over all keys)
struct KeyRange {
  int lo, hi, full_lo, full_hi;
  __device__ KeyRange(int first, int last, int Sk, int causal, int use_window,
                      int window) {
    lo = use_window ? max(0, first - window + 1) : 0;
    hi = causal ? min(Sk, last + 1) : Sk;
    full_lo = use_window ? max(0, last - window + 1) : 0;
    full_hi = causal ? min(Sk, first + 1) : Sk;
    if (full_lo >= hi) {
      lo = 0;
      hi = Sk;
      full_hi = 0;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::NT, 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
              int Sq, int Sk, float scale, int causal, int use_window,
              int window, int use_softcap, float softcap) {
  using C = Tile<T, D>;
  constexpr int BK = C::BK, NS = C::NS, NO = C::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][QS]
  T* KV = Qs + C::BQ * C::QS;              // 2 x ([BK][KS], then [BK][VS])

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (size_t(b) * Hq + h) * Sq * D;
  const T* kb = k + (size_t(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t(b) * Hkv + hk) * Sk * D;

  const KeyRange blk(q0, min(q0 + C::BQ, Sq) - 1, Sk, causal, use_window,
                     window);
  const int wq0 = q0 + 16 * warp;  // the warp's first row
  const bool has_rows = wq0 < Sq;
  const KeyRange wr(wq0, min(wq0 + 15, Sq - 1), Sk, causal, use_window,
                    window);
  const int n_tiles = (blk.hi - blk.lo + BK - 1) / BK;

  load_rows<T, D, C::BQ, C::QS, C::NT>(Qs, qb, q0, Sq, tid);
  load_rows<T, D, BK, C::KS, C::NT>(KV, kb, blk.lo, Sk, tid);
  load_rows<T, D, BK, C::VS, C::NT>(KV + BK * C::KS, vb, blk.lo, Sk, tid);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const T* Qw = Qs + 16 * warp * C::QS;
  // bf16 scores go to log2 units, so exp2f takes the place of expf:
  // x * scale * log2(e), or softcap * log2(e) * tanh(x * scale / softcap)
  const float in_scale = use_softcap ? scale / softcap : scale * kLog2e;
  const float cap_log2 = softcap * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = blk.lo + j * BK;
    cp_async_wait_all();  // tile j is in
    __syncthreads();      // ... for every thread; tile j - 1 is done with
    if (j + 1 < n_tiles) {
      T* next = KV + ((j + 1) & 1) * C::STAGE;
      load_rows<T, D, BK, C::KS, C::NT>(next, kb, k0 + BK, Sk, tid);
      load_rows<T, D, BK, C::VS, C::NT>(next + BK * C::KS, vb, k0 + BK, Sk,
                                        tid);
      cp_async_commit();
    }
    if (!has_rows || k0 >= wr.hi || k0 + BK <= wr.lo) continue;
    const T* Ks = KV + (j & 1) * C::STAGE;
    const T* Vs = Ks + BK * C::KS;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    scores<D, BK, C::QS, C::KS>(s, Qw, Ks, lane, scale);

    const bool full = k0 >= wr.full_lo && k0 + BK <= wr.full_hi;
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (C::kBF16)  // log2 units
          x = use_softcap ? cap_log2 * tanhf(x * in_scale) : x * in_scale;
        else if (use_softcap)
          x = softcap * tanhf(x / softcap);
        if (!full) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qp = wq0 + g + 8 * (e >> 1);
          const bool ok = (!causal || kp <= qp) &&
                          (!use_window || kp > qp - window);
          x = kp >= Sk ? -INFINITY : ok ? x : NEG_INF;
        }
        s[n][e] = x;
        mc[e >> 1] = fmaxf(mc[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mc[r]));
      alpha[r] = exp_of<C::kBF16>(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_of<C::kBF16>(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    // once the row maxima settle, alpha is exactly 1 and the rescale is
    // the identity: the warp skips it
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }
    apply_v<D, BK, C::VS>(acc, s, Vs, lane);
  }

  if (!has_rows) return;
  T* ob = o + (size_t(b) * Hq + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wq0 + g + 8 * r;
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qp >= Sq) continue;
    T* row = ob + size_t(qp) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(row + 8 * n, acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Sq, int Sk, float scale, int causal, int use_window,
           int window, int use_softcap, float softcap, cudaStream_t stream) {
  using C = Tile<T, D>;
  auto kern = flash_fwd<T, D>;
  // the limit is raised once per device, so a launch captured in a CUDA
  // graph after a first launch makes no attribute call
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load()) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
    if (err != cudaSuccess) return err;
    raised[dev].store(true);
  }
  const int n_q_tiles = (Sq + C::BQ - 1) / C::BQ;
  if (B > 65535 || n_q_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(Hq, B, n_q_tiles);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
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
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                           use_window, window, use_softcap, softcap, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                           use_window, window, use_softcap, softcap, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                            use_window, window, use_softcap, softcap, st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                            use_window, window, use_softcap, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); o: (B, Hq, Sq, D); all
// contiguous and 16-byte aligned, of one dtype (DTYPE_F32 or DTYPE_BF16);
// D in {32, 64, 128, 256}; Hq a multiple of Hkv.
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
    return dispatch<bf16>(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, scale, causal,
                          use_window, window, use_softcap, softcap, st);
  return cudaErrorInvalidValue;
}
