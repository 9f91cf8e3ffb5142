// int8 flash-attention forward (W8A8 serving, P.V in int8) on Hopper's
// tensor cores (sm_90a).
//
// Replaces, for every pv_int8 call at head_dim 72 with 16-byte aligned q, k,
// v, the Pallas kernel `_flash_int8_kernel` of latte_tpu/kernels/attention.py
// together with what its wrapper `flash_attention_int8` does around it (the
// per-head quantize of q, k, v, `to_i8`), and with scale_block = 0 the fused
// int8 core `int8_attention` of latte_tpu/quant/int8.py. The route is chosen
// in Python before the launch (`int8_route`,
// latte_tpu_torch/kernels/attention_int8.py); the "qk" mode, other head dims
// and misaligned views keep flash_attention_int8.cu.
//
// Arithmetic: flash_attention_int8.cu's, step for step, each fp32 step a
// separate correctly rounded one (__fdiv_rn, __fmul_rn, __fadd_rn, rintf):
//   x8 = clip(rint(x / s), -127, 127),  s_j = float(q8 . k8_j) * ls
//   flash (scale_block > 0): per scale block, m' = max(m, blockmax(s)),
//     p = exp(s - m'), p_max = max(exp(blockmax - m'), 1e-30),
//     p8 = rint(p * (127 / p_max)), l = l exp(m - m') + sum(p),
//     acc = acc exp(m - m') + float(p8 . v8) * (p_max / 127); out = (acc / l) vs
//   fused (scale_block = 0): P = p / l, p_max = 1 / l,
//     out = float(P8 . v8) * (p_max / 127) * vs
// The int32 sums are exact in any order, so the two kernels differ only
// where l, an fp32 sum, is summed in another order.
//
// Bound: at Latte-XL/2 256^2 the spatial call (B*H = 256, N = 256, D = 72)
// reads bf16 q, k, v and writes bf16 o, 37.7 MB, 11.3 us at 3.35 TB/s; its
// 4 * B*H * N^2 * D = 4.8 G int8 operations take 2.4 us at 1,979 TOP/s (the
// kernel computes QK^T twice, 7.2 G). Temporal (B*H = 4096, N = 16) the same
// bytes. Bound by bytes.
//
// What held flash_attention_int8.cu back, and what this design does:
//   1. Quantize once. There every block re-quantized the K tiles of its head
//      in two passes (three for the fused arithmetic), four query blocks a
//      head at N = 256. Here one block owns a whole (batch, head) sequence:
//      it quantizes K and V once into shared memory (k8 rows, v8 transposed)
//      and its 8 warps take the 16-row query tiles in turn, each quantizing
//      its own q rows. The other way, a quantize pre-pass kernel writing
//      int8 q, k, v to device memory, moves 28.3 MB read + 14.2 MB written +
//      14.2 MB read again + 9.4 MB out = 66 MB (19.8 us at 3.35 TB/s) against
//      the whole-head block's 37.7 MB (11.3 us) and adds a launch. The cost:
//      256 blocks on 132 SMs, two a SM resident (50 KB of shared memory
//      each). K and V of up to 1024 keys stay resident (T2V's N = 1024: 163
//      KB); past that a block takes 8 query tiles and streams K/V in spans of
//      1024 keys, re-quantizing them for each pass. The per-head scales are
//      computed in the kernel from the amax (the wrapper launches nothing
//      else), and every value is quantized by the correctly rounded
//      division; padding is skipped, since a zero dividend takes the
//      division's slow path.
//   2. Products on the tensor cores: mma.sync m16n8k32 s8.s8.s32. QK^T over
//      head_dim 72 = two k32 steps and one m16n8k16 step on bytes 64-79 (q8
//      and k8 rows zero-padded to 80 bytes: 5 16-byte chunks, odd, so the 8
//      rows an ldmatrix reads fall on 8 distinct groups of 4 banks). P.V as
//      9 n8 tiles over k32 steps of 32 keys.
//   3. p8 stays in registers. The int32 C fragment of QK^T gives a thread
//      keys 8j + 2t, 8j + 2t + 1 of n8 tile j; the s8 A fragment of P.V wants
//      4 adjacent k values 4t..4t+3. So within each 32-key chunk the rows of
//      V^T are stored permuted: position 16h + 4t + i holds key
//      16h + (2t, 2t+1, 8+2t, 9+2t)[i], and the C fragments of tiles 2h,
//      2h+1, packed as bytes, are the A fragment. The int32 sum is exact in
//      any order.
//   4. The P scale needs the maximum over the whole scale block before any
//      p8: a first pass over the block's K computes the int32 logits and
//      their row maximum (max commutes with float() * ls for a positive ls;
//      a row's 4 threads take two shuffles), a second recomputes them, forms
//      p8 and runs P.V (the fused arithmetic adds a pass for l). Recomputing
//      QK^T on the tensor cores costs less than keeping the logits.
//   5. Keys outside the scale block or past N give p8 = 0 (k8 and v8 rows
//      past N are zero); query rows past N are zero and not stored.
// Short sequences (N <= 32, the temporal N = 16): a warp per (batch, head)
// sequence, 8 a block, its K, V^T and q in its own shared memory.

#include <climits>

#include "common.cuh"

namespace latte {
namespace i8tc {

constexpr int kD = 72;            // head_dim
constexpr int kPitch = 80;        // bytes of a q8 / k8 row in shared memory: 72 values, 8 zeros
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;        // keys of a P.V step
constexpr int kMaxSpan = 1024;    // keys of K / V resident in shared memory at once
constexpr int kMaxShortN = 32;    // the short route: a warp per sequence
constexpr int kOutTiles = kD / 8;  // n8 tiles of the output: 9
constexpr int kQBytes = 16 * kPitch;  // a warp's q8 rows
// the short route's shared memory a warp: K (32 rows), V^T (72 rows of 32 + 16), q8
constexpr int kShortBytes = kChunk * kPitch + kD * (kChunk + 16) + kQBytes;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* amax[3];  // contiguous fp32 (H,) calibrated amax of q, k, v
  float dscale;          // D^-1/2 rounded to fp32
  void* o;               // contiguous (B, N, H, D)
  int BH, N, H;
  int scale_block;  // keys of one P scale (flash); N for the fused arithmetic
  long long st[3][3];  // element strides (batch, token, head) of q, k, v
};

// The per-head scales of the plain version (`_scales`, kernels/attention_int8.py):
// s = max(amax, 1e-8) / 127 for q, k, v, and the logit scale (qs * ks) * D^-1/2,
// the same correctly rounded fp32 operations.
struct Scales {
  float q, k, v, logit;
};

__device__ __forceinline__ Scales head_scales(const Args& a, int h) {
  Scales s;
  s.q = __fdiv_rn(fmaxf(a.amax[0][h], 1e-8f), 127.f);
  s.k = __fdiv_rn(fmaxf(a.amax[1][h], 1e-8f), 127.f);
  s.v = __fdiv_rn(fmaxf(a.amax[2][h], 1e-8f), 127.f);
  s.logit = __fmul_rn(__fmul_rn(s.q, s.k), a.dscale);
  return s;
}

template <typename T>
struct Vec {  // 16 bytes of T
  static constexpr int N = 16 / sizeof(T);
};

// The floats of 16 bytes of T.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float (&x)[Vec<T>::N]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      x[i] = __uint_as_float(w[i]);
    } else {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// 16 bytes at p (16-byte aligned), or zeros
__device__ __forceinline__ uint4 load16(const void* p, bool valid) {
  return valid ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(c & 0xff) << 16 |
         (uint32_t)(d & 0xff) << 24;
}

// E quantized values of 16 bytes of T (quantize_i8, common.cuh), as E bytes
// (E = 8: a uint2; 4: a word); zeros, without a division, where the load
// was masked.
template <typename T>
__device__ __forceinline__ void store_q8(uint8_t* d, const uint4& raw, bool valid, float s) {
  constexpr int E = Vec<T>::N;
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = 0;
  if (valid) {
    float x[E];
    unpack16<T>(raw, x);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = quantize_i8(x[e], s);
  }
  if constexpr (E == 8) {
    *reinterpret_cast<uint2*>(d) =
        make_uint2(pack_s8(v[0], v[1], v[2], v[3]), pack_s8(v[4], v[5], v[6], v[7]));
  } else {
    *reinterpret_cast<uint32_t*>(d) = pack_s8(v[0], v[1], v[2], v[3]);
  }
}

// Loads in flight a thread while it fills shared memory: each thread issues
// BATCH 16-byte loads before it quantizes any of them. On the H100 1-4 load
// and quantize about as fast, 8 and 16 slower: the warps of an SM then all
// wait, and then all quantize, at once.
constexpr int kBatch = 4;

// Quantized rows n0 .. n0+rows-1 of one sequence (src: its base, stride: its
// token stride) into rows of kPitch bytes; rows at or past `end`, and bytes
// 72-79, are zero. Thread t of nt.
template <typename T, int BATCH = kBatch>
__device__ __forceinline__ void quantize_rows(uint8_t* dst, const T* src, long long stride, int n0,
                                              int rows, int end, float s, int t, int nt) {
  constexpr int E = Vec<T>::N, TASKS = kPitch / E;  // E bytes of a row each
  const int total = rows * TASKS;
  for (int i0 = t; i0 < total; i0 += BATCH * nt) {
    uint4 raw[BATCH];
    bool valid[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * nt, r = i / TASKS, c = i - r * TASKS;
      valid[u] = i < total && n0 + r < end && c * E < kD;
      raw[u] = load16(src + (n0 + r) * stride + c * E, valid[u]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * nt, r = i / TASKS, c = i - r * TASKS;
      if (i < total) store_q8<T>(dst + r * kPitch + c * E, raw[u], valid[u], s);
    }
  }
}

// v8 of keys k0 .. k0+keys-1 (keys a multiple of 32), transposed: row d of
// vt (pitch bytes) holds the keys' values at d, each 32-key chunk permuted
// (position 16h + 4t + i holds key 16h + (2t, 2t+1, 8+2t, 9+2t)[i] of the
// chunk; see the header). A task is 4 positions x E head_dim values: 4 row
// loads, E 32-bit stores. Keys at or past `end` are zero.
template <typename T, int BATCH = kBatch>
__device__ __forceinline__ void quantize_vt(uint8_t* vt, int pitch, const T* src, long long stride,
                                            int k0, int keys, int end, float s, int t, int nt) {
  constexpr int E = Vec<T>::N, DG = kD / E, U = BATCH < 4 ? 1 : BATCH / 4;
  const int groups = keys / 4, total = groups * DG;
  for (int i0 = t; i0 < total; i0 += U * nt) {
    uint4 raw[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt, dg = i / groups, pg = i - dg * groups;
      const int key = k0 + 16 * (pg >> 2) + 2 * (pg & 3);  // the task's keys: +0, +1, +8, +9
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = key + (j & 1) + 8 * (j >> 1);
        raw[u][j] = load16(src + kj * stride + dg * E, i < total && kj < end);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt, dg = i / groups, pg = i - dg * groups;
      if (i >= total) continue;
      const int key = k0 + 16 * (pg >> 2) + 2 * (pg & 3);
      int v[4][E];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x[E];
        unpack16<T>(raw[u][j], x);
        const bool valid = key + (j & 1) + 8 * (j >> 1) < end;
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] = valid ? quantize_i8(x[e], s) : 0;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        *reinterpret_cast<uint32_t*>(vt + (dg * E + e) * pitch + 4 * pg) =
            pack_s8(v[0][e], v[1][e], v[2][e], v[3][e]);
      }
    }
  }
}

// c += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// A fragments of a warp's 16 q8 rows: a[s] bytes 32s..32s+31, tail 64-79.
struct QFrags {
  uint32_t a[2][4];
  uint32_t tail[2];
};

__device__ __forceinline__ void load_q(const uint8_t* sq, QFrags& f, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // matrix mi of an x4: rows (mi & 1) * 8 + r, bytes (mi >> 1) * 16 of the step
  const uint8_t* row = sq + ((mi & 1) * 8 + r) * kPitch;
  ldsm_x4(f.a[0], row + (mi >> 1) * 16);
  ldsm_x4(f.a[1], row + 32 + (mi >> 1) * 16);
  ldsm_x2(f.tail[0], f.tail[1], row + 64);  // lanes 0-15: rows 0-7, 8-15
}

// s[jj] = the warp's 16 q8 rows against k8 rows 8j..8j+7 of sk, j = 2h + jj
// (half h of a 32-key chunk), int32: c0, c1 of row g = lane / 4, keys
// 8j + 2t, 8j + 2t + 1 (t = lane % 4); c2, c3 row g+8.
__device__ __forceinline__ void scores(const QFrags& q, const uint8_t* sk, int h, int (&s)[2][4],
                                       int lane) {
  const int r = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const uint8_t* row = sk + (16 * h + 8 * jj + r) * kPitch;
    uint32_t kb[4], kt;
    ldsm_x4(kb, row + 16 * mi);  // chunk mi of the rows
    ldsm_x1(kt, row + 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[jj][i] = 0;
    mma_k32(s[jj], q.a[0], kb[0], kb[1]);
    mma_k32(s[jj], q.a[1], kb[2], kb[3]);
    mma_k16(s[jj], q.tail[0], q.tail[1], kt);
  }
}

// acc8 += P (16 x 32, A fragment pa) . V (the chunk at byte off of each vt row)
__device__ __forceinline__ void pv_chunk(const uint32_t (&pa)[4], const uint8_t* vt, int pitch,
                                         int off, int (&acc8)[kOutTiles][4], int lane) {
  const int r = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    // matrix mi of an x4: head_dim rows 8 (n + (mi >> 1)) + r, positions 16 (mi & 1) ..
    uint32_t b[4];
    ldsm_x4(b, vt + (8 * (n + (mi >> 1)) + r) * pitch + off + 16 * (mi & 1));
    mma_k32(acc8[n], pa, b[0], b[1]);
    mma_k32(acc8[n + 1], pa, b[2], b[3]);
  }
  uint32_t b0, b1;
  ldsm_x2(b0, b1, vt + (64 + r) * pitch + off + 16 * (mi & 1));  // lanes 0-15
  mma_k32(acc8[8], pa, b0, b1);
}

__device__ __forceinline__ float logit(int s, float ls) { return __fmul_rn(__int2float_rn(s), ls); }

__device__ __forceinline__ int quad_max(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The arithmetic of a call, a compile-time choice so that the flash loops
// hold no division: flash with one scale block (the main path's), flash
// with several (acc carries over them), fused.
enum Rule { kFlash = 0, kFlashBlocks, kFused };

// The warp's 16 query rows (fragments q) against keys 0 .. N-1: res[n][i] is
// the output of row g (i < 2) or g+8 at head_dim 8n + 2t + (i & 1).
// chunk(c) makes the 32-key chunk c resident and returns its key offset in
// sk / vt.
template <int RULE, typename Chunk>
__device__ __forceinline__ void attend(const Args& a, const QFrags& q, const uint8_t* sk,
                                       const uint8_t* vt, int vpitch, Chunk&& chunk, float ls,
                                       float vs, float (&res)[kOutTiles][4], int lane) {
  constexpr bool MULTI = RULE == kFlashBlocks, FUSED = RULE == kFused;
  const int t2 = 2 * (lane & 3);
  const int SB = a.scale_block;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, pscale[2];
  float acc[MULTI ? kOutTiles : 1][4];
  int acc8[kOutTiles][4];
  if constexpr (MULTI) {
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  for (int sb0 = 0; sb0 < a.N; sb0 += SB) {
    const int sb1 = min(sb0 + SB, a.N);
    const int c0 = sb0 / kChunk, c1 = (sb1 + kChunk - 1) / kChunk;
    // pass 1: the row maxima of the scale block's int32 logits
    int imax[2] = {INT_MIN, INT_MIN};
    for (int c = c0; c < c1; ++c) {
      const int off = chunk(c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int s[2][4];
        scores(q, sk + off * kPitch, h, s, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = c * kChunk + 16 * h + 8 * jj + t2 + (i & 1);
            if (key >= sb0 && key < sb1) imax[i >> 1] = max(imax[i >> 1], s[jj][i]);
          }
        }
      }
    }
    float m_new[2], p_max[2], q127[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float bmax = logit(quad_max(imax[r]), ls);
      m_new[r] = FUSED ? bmax : fmaxf(m[r], bmax);
      p_max[r] = fmaxf(expf(bmax - m_new[r]), 1e-30f);
    }
    if constexpr (FUSED) {
      // pass 1b: l over the row, so P can be normalised before it is
      // rounded; the row's largest P is exp(0) / l = 1 / l
      float lsum[2] = {0.f, 0.f};
      for (int c = c0; c < c1; ++c) {
        const int off = chunk(c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int s[2][4];
          scores(q, sk + off * kPitch, h, s, lane);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int key = c * kChunk + 16 * h + 8 * jj + t2 + (i & 1);
              if (key >= sb0 && key < sb1) {
                lsum[i >> 1] += expf(logit(s[jj][i], ls) - m_new[i >> 1]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(lsum[r]);
        p_max[r] = __fdiv_rn(1.f, l[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) q127[r] = __fdiv_rn(127.f, p_max[r]);

    // pass 2: p, its rounding and P.V over the scale block
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) acc8[n][0] = acc8[n][1] = acc8[n][2] = acc8[n][3] = 0;
    float psum[2] = {0.f, 0.f};
    for (int c = c0; c < c1; ++c) {
      const int off = chunk(c);
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int s[2][4], p8[2][4];
        scores(q, sk + off * kPitch, h, s, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = c * kChunk + 16 * h + 8 * jj + t2 + (i & 1), r = i >> 1;
            const float p = key >= sb0 && key < sb1 ? expf(logit(s[jj][i], ls) - m_new[r]) : 0.f;
            psum[r] += p;
            const float pn = FUSED ? __fdiv_rn(p, l[r]) : p;
            p8[jj][i] = (int)rintf(__fmul_rn(pn, q127[r]));
          }
        }
        // the C fragments of tiles 2h, 2h+1 are the A fragment of k values 16h..
        pa[2 * h] = pack_s8(p8[0][0], p8[0][1], p8[1][0], p8[1][1]);
        pa[2 * h + 1] = pack_s8(p8[0][2], p8[0][3], p8[1][2], p8[1][3]);
      }
      pv_chunk(pa, vt, vpitch, off, acc8, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) pscale[r] = __fdiv_rn(p_max[r], 127.f);
    if constexpr (!FUSED) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = expf(m[r] - m_new[r]);
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha), quad_sum(psum[r]));
        m[r] = m_new[r];
        if constexpr (MULTI) {
#pragma unroll
          for (int n = 0; n < kOutTiles; ++n) {
#pragma unroll
            for (int i = 2 * r; i < 2 * r + 2; ++i) {
              const float pv = __fmul_rn(__int2float_rn(acc8[n][i]), pscale[r]);
              acc[n][i] = __fadd_rn(__fmul_rn(acc[n][i], alpha), pv);
            }
          }
        }
      }
    }
  }
  // one scale block (not MULTI): acc = 0 * alpha + pv = pv
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const float pv = __fmul_rn(__int2float_rn(acc8[n][i]), pscale[r]);
      if constexpr (FUSED) {
        res[n][i] = __fmul_rn(pv, vs);
      } else {
        float out;
        if constexpr (MULTI) {
          out = acc[n][i];
        } else {
          out = pv;
        }
        res[n][i] = __fmul_rn(__fdiv_rn(out, l[r]), vs);
      }
    }
  }
}

// The warp's rows q0 + g, q0 + g + 8 of sequence (b, h), those before N.
template <typename T>
__device__ __forceinline__ void store_rows(const Args& a, int b, int h, int q0,
                                           const float (&res)[kOutTiles][4], int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + g + 8 * r;
    if (n >= a.N) continue;
    T* row = static_cast<T*>(a.o) + (((long long)b * a.N + n) * a.H + h) * kD + t2;
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(row + 8 * nt) = make_float2(res[nt][2 * r], res[nt][2 * r + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt) =
            __floats2bfloat162_rn(res[nt][2 * r], res[nt][2 * r + 1]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* seq_base(const Args& a, const void* x, int o, int b, int h) {
  return static_cast<const T*>(x) + b * a.st[o][0] + h * a.st[o][2];
}

// One query tile of the warp: quantize its 16 q rows into sq, then attend
// and store.
template <typename T, int RULE, typename Chunk>
__device__ __forceinline__ void query_tile(const Args& a, int b, int h, int q0, uint8_t* sq,
                                           const uint8_t* sk, const uint8_t* vt, int vpitch,
                                           Chunk&& chunk, int lane) {
  const Scales sc = head_scales(a, h);
  __syncwarp();  // every lane is done with the previous tile's q rows
  quantize_rows<T>(sq, seq_base<T>(a, a.q, 0, b, h), a.st[0][1], q0, 16, a.N, sc.q, lane, 32);
  __syncwarp();
  QFrags q;
  load_q(sq, q, lane);
  float res[kOutTiles][4];
  attend<RULE>(a, q, sk, vt, vpitch, chunk, sc.logit, sc.v, res, lane);
  store_rows<T>(a, b, h, q0, res, lane);
}

// N > 32: block = one (batch, head) sequence, or with K/V longer than one
// span (N > kMaxSpan) 8 query tiles of it ("rounds" blocks a sequence).
// Shared memory: k8 rows of the span, v8^T (72 rows of span + 16 bytes), a
// warp's q8 rows each.
template <typename T, int RULE>
__global__ void __launch_bounds__(kThreads, RULE == kFlash ? 2 : 1)
    flash_int8_tc_kernel(const Args a, int span, int rounds) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int vpitch = span + 16;
  uint8_t* sk = smem;
  uint8_t* svt = sk + span * kPitch;
  const int bh = blockIdx.x / rounds, round = blockIdx.x - bh * rounds;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* sq = svt + kD * vpitch + warp * kQBytes;
  const T* kb = seq_base<T>(a, a.k, 1, b, h);
  const T* vb = seq_base<T>(a, a.v, 2, b, h);
  const Scales sc = head_scales(a, h);
  quantize_rows<T>(sk, kb, a.st[1][1], 0, span, a.N, sc.k, tid, kThreads);
  quantize_vt<T>(svt, vpitch, vb, a.st[2][1], 0, span, a.N, sc.v, tid, kThreads);
  __syncthreads();
  int loaded = 0;
  auto chunk = [&](int c) {
    const int want = c * kChunk / span;
    if (want != loaded) {  // uniform over the block: every warp runs the same chunk sequence
      __syncthreads();  // every warp is done with the span in place
      quantize_rows<T, 2>(sk, kb, a.st[1][1], want * span, span, a.N, sc.k, tid, kThreads);
      quantize_vt<T, 2>(svt, vpitch, vb, a.st[2][1], want * span, span, a.N, sc.v, tid, kThreads);
      __syncthreads();
      loaded = want;
    }
    return c * kChunk - loaded * span;
  };
  const int nqt = (a.N + 15) / 16;
  if (rounds == 1) {  // one span, loaded: no barrier follows, warps run free
    for (int qt = warp; qt < nqt; qt += kWarps) {
      query_tile<T, RULE>(a, b, h, 16 * qt, sq, sk, svt, vpitch, chunk, lane);
    }
  } else {  // every warp takes part in each reload, a tile past N too
    query_tile<T, RULE>(a, b, h, 16 * (round * kWarps + warp), sq, sk, svt, vpitch, chunk, lane);
  }
}

// N <= 32: a warp per (batch, head) sequence, kWarps sequences a block.
template <typename T, int RULE>
__global__ void __launch_bounds__(kThreads, RULE == kFlash ? 2 : 1)
    flash_int8_tc_short_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kWarps + warp;
  if (bh >= a.BH) return;  // no block-wide barrier follows
  const int b = bh / a.H, h = bh - b * a.H;
  uint8_t* sk = smem + warp * kShortBytes;
  uint8_t* svt = sk + kChunk * kPitch;
  uint8_t* sq = svt + kD * (kChunk + 16);
  const Scales sc = head_scales(a, h);
  quantize_rows<T>(sk, seq_base<T>(a, a.k, 1, b, h), a.st[1][1], 0, kChunk, a.N, sc.k, lane, 32);
  quantize_vt<T>(svt, kChunk + 16, seq_base<T>(a, a.v, 2, b, h), a.st[2][1], 0, kChunk, a.N,
                 sc.v, lane, 32);
  auto chunk = [](int c) { return c * kChunk; };
  for (int q0 = 0; q0 < a.N; q0 += 16) {
    query_tile<T, RULE>(a, b, h, q0, sq, sk, svt, kChunk + 16, chunk, lane);
  }
}

template <typename Kernel, typename... Extra>
cudaError_t launch_i8(Kernel kernel, long long blocks, size_t smem, cudaStream_t stream,
                      const Args& a, Extra... extra) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a, extra...);
  return cudaGetLastError();
}

template <typename T, int RULE>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  if (a.N <= kMaxShortN) {
    return launch_i8(flash_int8_tc_short_kernel<T, RULE>, (a.BH + kWarps - 1) / kWarps,
                     (size_t)kWarps * kShortBytes, stream, a);
  }
  const int keys = (a.N + kChunk - 1) / kChunk * kChunk;
  const int span = min(keys, kMaxSpan);
  const int nqt = (a.N + 15) / 16;
  const int rounds = keys > span ? (nqt + kWarps - 1) / kWarps : 1;
  const size_t smem = (size_t)span * kPitch + (size_t)kD * (span + 16) + kWarps * kQBytes;
  return launch_i8(flash_int8_tc_kernel<T, RULE>, (long long)a.BH * rounds, smem, stream, a,
                   span, rounds);
}

template <typename T>
cudaError_t launch_by_rule(const Args& a, bool fused, cudaStream_t stream) {
  if (fused) return launch_tc<T, kFused>(a, stream);
  if (a.scale_block < a.N) return launch_tc<T, kFlashBlocks>(a, stream);
  return launch_tc<T, kFlash>(a, stream);
}

}  // namespace i8tc
}  // namespace latte

// q, k, v: (B, N, H, D) with the element strides `st` (batch, token, head of
// q, then of k, then of v), base pointers and strides 16-byte aligned, a
// contiguous last axis; q_amax, k_amax, v_amax: contiguous fp32 (H,); o:
// contiguous (B, N, H, D); dscale: D^-1/2 as fp32. scale_block: 0 for the
// fused core's arithmetic, else the keys of one P scale (flash). P.V in
// int8 only, D = 72.
extern "C" int latte_flash_attention_int8_tc(int dtype, const void* q, const void* k,
                                             const void* v, const void* q_amax,
                                             const void* k_amax, const void* v_amax, void* o,
                                             int B, int N, int H, int D, int scale_block,
                                             const long long* st, float dscale, int device,
                                             void* stream) {
  using namespace latte::i8tc;
  if (D != kD || N < 1 || B < 1 || H < 1 || scale_block < 0) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  Args a{q, k, v, {(const float*)q_amax, (const float*)k_amax, (const float*)v_amax}, dscale, o,
         B * H, N, H, scale_block > 0 ? scale_block : N, {}};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) a.st[i][j] = st[3 * i + j];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bool fused = scale_block == 0;
  if (dtype == latte::kBFloat16) return (int)launch_by_rule<__nv_bfloat16>(a, fused, s);
  if (dtype == latte::kFloat32) return (int)launch_by_rule<float>(a, fused, s);
  return (int)cudaErrorInvalidValue;
}
