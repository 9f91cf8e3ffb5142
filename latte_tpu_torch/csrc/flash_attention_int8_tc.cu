// int8 flash-attention forward (W8A8 serving) on Hopper's tensor cores
// (sm_90a), in both P.V modes: P.V in int8 (pv_int8) and P.V in the storage
// type (the "qk" mode, `int8_attention: qk`).
//
// Replaces, for every call at head_dim 72 with 16-byte aligned q, k, v, the
// Pallas kernel `_flash_int8_kernel` of latte_tpu/kernels/attention.py
// together with what its wrapper `flash_attention_int8` does around it (the
// per-head quantize of q, k, v, `to_i8`), and with scale_block = 0 the fused
// int8 core `int8_attention` of latte_tpu/quant/int8.py. The route is chosen
// in Python before the launch (`int8_route`,
// latte_tpu_torch/kernels/attention_int8.py); other head dims and misaligned
// views keep flash_attention_int8.cu (dp4a), in both modes.
//
// Arithmetic: flash_attention_int8.cu's, step for step, each fp32 step a
// separate correctly rounded one (__fdiv_rn, __fmul_rn, __fadd_rn, rintf):
//   x8 = clip(rint(x / s), -127, 127),  s_j = float(q8 . k8_j) * ls
//   flash (scale_block > 0): per scale block, m' = max(m, blockmax(s)),
//     p = exp(s - m'), l = l exp(m - m') + sum(p), and
//     pv_int8: p_max = max(exp(blockmax - m'), 1e-30),
//       p8 = rint(p * (127 / p_max)),
//       acc = acc exp(m - m') + float(p8 . v8) * (p_max / 127); out = (acc / l) vs
//     "qk": acc = acc exp(m - m') + sum(T(p) v) in fp32; out = acc / l
//   fused (scale_block = 0): P = p / l, and
//     pv_int8: p_max = 1 / l, out = float(P8 . v8) * (p_max / 127) * vs
//     "qk": out = sum(T(P) v) in fp32
// (T(x): x rounded to the storage type, bf16 or fp32.) The int32 sums are
// exact in any order, so the two kernels differ only where an fp32 sum (l,
// and in "qk" mode P.V) is summed in another order.
//
// Bound: at Latte-XL/2 256^2 the spatial call (B*H = 256, N = 256, D = 72)
// reads bf16 q, k, v and writes bf16 o, 37.7 MB, 11.3 us at 3.35 TB/s; its
// 4 * B*H * N^2 * D = 4.8 G int8 operations take 2.4 us at 1,979 TOP/s (the
// kernel computes QK^T twice, 7.2 G). Temporal (B*H = 4096, N = 16) the same
// bytes. Bound by bytes. "qk" in bf16: the same bytes, and P.V's 2.42 GFLOP
// take 2.4 us at 989 TFLOP/s: 11.3 us, bytes. "qk" in fp32: 75.5 MB, 22.5
// us; P.V on the CUDA cores takes 36 us at 67 TFLOP/s (and QK^T 1.2 us):
// 0.037 ms spatially, bound by operations; temporally P.V takes 2.3 us and
// the bytes bound it, 22.5 us.
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
//
// The "qk" mode keeps 1-5 (its QK^T, passes and masks are the same code)
// and differs in P.V, which reads V as it is stored:
//   6. bf16: p stays in registers. The C fragments of QK^T's n8 tiles 2h and
//      2h+1 give a thread keys 16h + 2t, +1 and 16h + 8 + 2t, +1 of rows g
//      and g+8; each p rounded to bf16 and packed in pairs, they are the A
//      fragment of k16 step h of mma.sync m16n8k16 (bf16 in, fp32
//      accumulate; FlashAttention-2's layout). V stays bf16 rows in shared
//      memory at their 144-byte pitch and gives the B fragments through
//      ldmatrix.trans (mma_bf16.cuh's pv_product): no permuted rows, unlike
//      v8^T. 9 n8 tiles of head_dim, 2 k16 steps a 32-key chunk.
//   7. fp32: TF32 would change the function, so P.V runs on the CUDA cores.
//      A warp writes the p of a 32-key chunk to its own shared rows and adds
//      them to f32_tiles.cuh's register tile (8 rows x 4 columns and 4 tail
//      values a thread, 9 FFMA a shared load: shared-memory traffic, not
//      the FMA rate, bounds an fp32 flash kernel), V as fp32 rows at a pitch
//      of 76 floats.
//   8. Shared memory: V in bf16 or fp32 takes 2x or 4.2x the bytes of
//      v8^T. 1024 resident keys would take 80 KiB of k8 and 144 KiB of bf16
//      V, past 227 KiB with the warps' q8 rows, so the "qk" mode keeps spans
//      of up to 512 keys (bf16 122 KiB, fp32 222 KiB with its p rows), and
//      1's span machinery streams longer sequences (T2V's N = 1024, N =
//      2048): a block takes 8 query tiles and reloads K and V by span in each
//      pass. Streaming V by key tiles instead would make the 8 warps walk the
//      keys in step, with a barrier a tile; spans keep them free at N <= 512,
//      which holds the sampler's shapes. The V copy is cp.async, in flight
//      while the block quantizes K. Occupancy at N = 256: a bf16 block takes
//      66 KiB (three would fit an SM's shared memory) and, held to 128
//      registers a thread by its launch bounds, two blocks of 8 warps are
//      resident an SM, so the 256 blocks run in one wave on 132 SMs (at 156
//      registers, one a SM, the fused rule took 1.5x as long). An fp32
//      block takes 127 KiB and ~166 registers: one an SM, two waves.

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "f32_tiles.cuh"
#include "mma_bf16.cuh"

namespace latte {
namespace i8tc {

constexpr int kD = 72;            // head_dim
constexpr int kPitch = 80;        // bytes of a q8 / k8 row in shared memory: 72 values, 8 zeros
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;        // keys of a P.V step
constexpr int kMaxShortN = 32;    // the short route: a warp per sequence
constexpr int kOutTiles = kD / 8;  // n8 tiles of the output: 9
constexpr int kQBytes = 16 * kPitch;  // a warp's q8 rows
static_assert(kD == tc::kD && kD == f32::kD && kOutTiles == tc::kChunks, "one head_dim");

// keys of K / V resident in shared memory at once (8. above)
__host__ __device__ constexpr int max_span(bool pv8) { return pv8 ? 1024 : 512; }

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

// Pass 1 over the 32-key chunks of the scale block [sb0, sb1): the row
// maxima of its int32 logits, as logits (bmax[0] row g, bmax[1] row g+8).
template <typename Chunk>
__device__ __forceinline__ void block_max(const QFrags& q, const uint8_t* sk, Chunk& chunk, int sb0,
                                          int sb1, float ls, float (&bmax)[2], int lane) {
  const int t2 = 2 * (lane & 3);
  int imax[2] = {INT_MIN, INT_MIN};
  for (int c = sb0 / kChunk; c < (sb1 + kChunk - 1) / kChunk; ++c) {
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
#pragma unroll
  for (int r = 0; r < 2; ++r) bmax[r] = logit(quad_max(imax[r]), ls);
}

// Pass 1b (the fused arithmetic): l = sum(exp(s - m)) over the scale block,
// so P can be normalised before it is rounded.
template <typename Chunk>
__device__ __forceinline__ void block_sum(const QFrags& q, const uint8_t* sk, Chunk& chunk, int sb0,
                                          int sb1, float ls, const float (&m)[2], float (&l)[2],
                                          int lane) {
  const int t2 = 2 * (lane & 3);
  float lsum[2] = {0.f, 0.f};
  for (int c = sb0 / kChunk; c < (sb1 + kChunk - 1) / kChunk; ++c) {
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
          if (key >= sb0 && key < sb1) lsum[i >> 1] += expf(logit(s[jj][i], ls) - m[i >> 1]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(lsum[r]);
}

// P.V in int8: the warp's 16 query rows (fragments q) against keys 0 ..
// N-1: res[n][i] is the output of row g (i < 2) or g+8 at head_dim 8n + 2t
// + (i & 1). chunk(c) makes the 32-key chunk c resident and returns its key
// offset in sk / vt.
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
    float bmax[2], m_new[2], p_max[2], q127[2];
    block_max(q, sk, chunk, sb0, sb1, ls, bmax, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = FUSED ? bmax[r] : fmaxf(m[r], bmax[r]);
      p_max[r] = fmaxf(expf(bmax[r] - m_new[r]), 1e-30f);
    }
    if constexpr (FUSED) {
      // the row's largest P is exp(0) / l = 1 / l
      block_sum(q, sk, chunk, sb0, sb1, ls, m_new, l, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) p_max[r] = __fdiv_rn(1.f, l[r]);
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

// The "qk" mode's P.V accumulators, one a warp over its 16 query rows. p of
// a 32-key chunk comes in the layout of scores(): p[h][jj][i] is row g + 8
// (i >> 1), key 16h + 8jj + 2t + (i & 1). Per-row factors f come as the
// fragment rows hold them: f[0] row g, f[1] row g + 8.

// bf16 on the tensor cores (6. above): the C fragments of the 16 x 72
// output, rows as in `attend`'s res.
struct FragPV {
  static constexpr int kRowBytes = tc::kD * 2;  // a V row in shared memory
  static constexpr int kScratch = 0;            // shared bytes a warp
  float c[kOutTiles][4];

  __device__ __forceinline__ FragPV(uint8_t*) {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  }
  // += bf16(p) . V over one chunk (sv: its first V row)
  __device__ __forceinline__ void add(const float (&p)[2][2][4], const uint8_t* sv, int lane) {
    uint32_t pa[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pa[h][0] = tc::pack_bf16(p[h][0][0], p[h][0][1]);  // row g, keys 16h + 2t ..
      pa[h][1] = tc::pack_bf16(p[h][0][2], p[h][0][3]);  // row g + 8
      pa[h][2] = tc::pack_bf16(p[h][1][0], p[h][1][1]);  // row g, keys 16h + 8 + 2t ..
      pa[h][3] = tc::pack_bf16(p[h][1][2], p[h][1][3]);
    }
    tc::pv_product<2>(pa, reinterpret_cast<const tc::bf16*>(sv), c, lane);
  }
  // x = x * f + o.x, per row, each a correctly rounded operation
  __device__ __forceinline__ void scale_add(const float (&f)[2], const FragPV& o, int) {
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] = __fadd_rn(__fmul_rn(c[n][i], f[i >> 1]), o.c[n][i]);
    }
  }
  __device__ __forceinline__ void divide(const float (&f)[2], int) {
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] = __fdiv_rn(c[n][i], f[i >> 1]);
    }
  }
  template <typename T>
  __device__ __forceinline__ void store(const Args& a, int b, int h, int q0, int lane) const {
    store_rows<T>(a, b, h, q0, c, lane);
  }
};

// fp32 on the CUDA cores (7. above): f32_tiles.cuh's register tile, rows
// 8 ty + i of the warp's 16 (ty = lane / 16, tx = lane % 16). A warp's
// scratch: p of a chunk (16 rows of kPLd floats), then 16 per-row factors.
struct TilePV {
  static constexpr int kPLd = kChunk + 8;  // 40: the float2 stores of a fragment row hit distinct banks
  static constexpr int kRowBytes = f32::kLd * 4;
  static constexpr int kScratch = (16 * kPLd + 16) * 4;
  using Tile = f32::OutTile<8>;
  Tile t;
  float* sp;

  __device__ __forceinline__ TilePV(uint8_t* scratch) : sp(reinterpret_cast<float*>(scratch)) {}
  __device__ __forceinline__ void zero() { t.zero(); }
  // += p . V over one chunk (sv: its first V row), p through the warp's rows
  __device__ __forceinline__ void add(const float (&p)[2][2][4], const uint8_t* sv, int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    __syncwarp();  // every lane is done with the previous chunk's p
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<float2*>(sp + (g + 8 * r) * kPLd + 16 * h + 8 * jj + t2) =
              make_float2(p[h][jj][2 * r], p[h][jj][2 * r + 1]);
        }
      }
    }
    __syncwarp();
    t.add<kChunk>(sp, kPLd, reinterpret_cast<const float*>(sv), lane >> 4, lane & 15);
  }
  // the per-row factors f at the tile's rows: fr[i] row 8 ty + i, ft the tail's row
  __device__ __forceinline__ void tile_rows(const float (&f)[2], float (&fr)[8], float& ft,
                                            int lane) const {
    float* st = sp + 16 * kPLd;
    __syncwarp();
    if ((lane & 3) == 0) {
      st[lane >> 2] = f[0];
      st[(lane >> 2) + 8] = f[1];
    }
    __syncwarp();
    const int ty = lane >> 4, tx = lane & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) fr[i] = st[8 * ty + i];
    ft = st[8 * ty + tx / Tile::LPR];
  }
  __device__ __forceinline__ void scale_add(const float (&f)[2], const TilePV& o, int lane) {
    float fr[8], ft;
    tile_rows(f, fr, ft, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) t.acc[i][c] = __fadd_rn(__fmul_rn(t.acc[i][c], fr[i]), o.t.acc[i][c]);
    }
#pragma unroll
    for (int c = 0; c < Tile::TW; ++c) t.tail[c] = __fadd_rn(__fmul_rn(t.tail[c], ft), o.t.tail[c]);
  }
  __device__ __forceinline__ void divide(const float (&f)[2], int lane) {
    float fr[8], ft;
    tile_rows(f, fr, ft, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) t.acc[i][c] = __fdiv_rn(t.acc[i][c], fr[i]);
    }
#pragma unroll
    for (int c = 0; c < Tile::TW; ++c) t.tail[c] = __fdiv_rn(t.tail[c], ft);
  }
  template <typename T>
  __device__ __forceinline__ void store(const Args& a, int b, int h, int q0, int lane) const {
    static_assert(sizeof(T) == 4, "the register tile holds fp32 outputs");
    float* base = static_cast<float*>(a.o) + ((long long)b * a.N * a.H + h) * kD;
    t.store(base, (long long)a.H * kD, q0, a.N, 1.f, lane >> 4, lane & 15);
  }
};

template <typename T>
using QkPV = std::conditional_t<sizeof(T) == 2, FragPV, TilePV>;

// P.V in the storage type ("qk" mode): the warp's 16 query rows against
// keys 0 .. N-1, stored. QK^T, the passes and the masks are `attend`'s;
// chunk(c) makes chunk c resident and returns its key offset in sk / sv.
template <typename T, int RULE, typename Chunk>
__device__ __forceinline__ void attend_qk(const Args& a, const QFrags& q, const uint8_t* sk,
                                          const uint8_t* sv, Chunk&& chunk, float ls,
                                          uint8_t* scratch, int b, int h, int q0, int lane) {
  using PV = QkPV<T>;
  constexpr bool MULTI = RULE == kFlashBlocks, FUSED = RULE == kFused;
  const int t2 = 2 * (lane & 3);
  const int SB = a.scale_block;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  PV pv(scratch), acc(scratch);  // acc carries over scale blocks (MULTI)
  if constexpr (MULTI) acc.zero();
  for (int sb0 = 0; sb0 < a.N; sb0 += SB) {
    const int sb1 = min(sb0 + SB, a.N);
    const int c0 = sb0 / kChunk, c1 = (sb1 + kChunk - 1) / kChunk;
    float m_new[2];
    block_max(q, sk, chunk, sb0, sb1, ls, m_new, lane);
    if constexpr (FUSED) {
      block_sum(q, sk, chunk, sb0, sb1, ls, m_new, l, lane);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], m_new[r]);
    }
    // pass 2: p, rounded to T, and P.V over the scale block
    pv.zero();
    float psum[2] = {0.f, 0.f};
    for (int c = c0; c < c1; ++c) {
      const int off = chunk(c);
      float p[2][2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        int s[2][4];
        scores(q, sk + off * kPitch, hh, s, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = c * kChunk + 16 * hh + 8 * jj + t2 + (i & 1), r = i >> 1;
            const float e = key >= sb0 && key < sb1 ? expf(logit(s[jj][i], ls) - m_new[r]) : 0.f;
            psum[r] += e;
            p[hh][jj][i] = FUSED ? __fdiv_rn(e, l[r]) : e;
          }
        }
      }
      pv.add(p, sv + off * PV::kRowBytes, lane);
    }
    if constexpr (!FUSED) {
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = expf(m[r] - m_new[r]);
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), quad_sum(psum[r]));
        m[r] = m_new[r];
      }
      if constexpr (MULTI) acc.scale_add(alpha, pv, lane);
    }
  }
  // one scale block (not MULTI): acc = 0 * alpha + pv = pv
  PV& out = MULTI ? acc : pv;
  if constexpr (!FUSED) out.divide(l, lane);
  out.template store<T>(a, b, h, q0, lane);
}

template <typename T>
__device__ __forceinline__ const T* seq_base(const Args& a, const void* x, int o, int b, int h) {
  return static_cast<const T*>(x) + b * a.st[o][0] + h * a.st[o][2];
}

// V rows k0 .. k0+keys-1 of one sequence into shared rows of QkPV<T>::kRowBytes,
// 16 bytes a thread at a time by cp.async, committed and not waited for;
// rows at or past `end` are zero.
template <typename T>
__device__ __forceinline__ void copy_v_rows(uint8_t* dst, const T* src, long long stride, int k0,
                                            int keys, int end, int t, int nt) {
  constexpr int E = Vec<T>::N, CH = kD / E;
  for (int i = t; i < keys * CH; i += nt) {
    const int r = i / CH, c = i - r * CH;
    const bool valid = k0 + r < end;
    cp_async_16(dst + r * QkPV<T>::kRowBytes + c * 16, src + (valid ? k0 + r : 0) * stride + c * E,
                valid ? 16 : 0);
  }
  cp_async_commit();
}

// Shared bytes of V for `keys` keys: v8^T (72 rows of keys + 16) with P.V
// in int8, else rows of the storage type; and a warp's own: q8 rows, then
// the "qk" P.V's scratch.
template <typename T, bool PV8>
__host__ __device__ constexpr int v_bytes(int keys) {
  return PV8 ? kD * (keys + 16) : keys * QkPV<T>::kRowBytes;
}
template <typename T, bool PV8>
__host__ __device__ constexpr int warp_bytes() {
  return kQBytes + (PV8 ? 0 : QkPV<T>::kScratch);
}

// K8 and V of keys k0 .. k0+keys-1 (past `end` zero) into sk and sv, by
// threads t of nt: in "qk" mode the V copy is in flight while K is
// quantized. Not followed by a barrier.
template <typename T, bool PV8, int BATCH = kBatch>
__device__ __forceinline__ void fill_kv(uint8_t* sk, uint8_t* sv, const Args& a, const Scales& sc,
                                        const T* kb, const T* vb, int k0, int keys, int t, int nt) {
  if constexpr (!PV8) copy_v_rows<T>(sv, vb, a.st[2][1], k0, keys, a.N, t, nt);
  quantize_rows<T, BATCH>(sk, kb, a.st[1][1], k0, keys, a.N, sc.k, t, nt);
  if constexpr (PV8) {
    quantize_vt<T, BATCH>(sv, keys + 16, vb, a.st[2][1], k0, keys, a.N, sc.v, t, nt);
  } else {
    cp_async_wait<0>();
  }
}

// One query tile of the warp: quantize its 16 q rows into sw (the warp's
// shared bytes), then attend and store.
template <typename T, int RULE, bool PV8, typename Chunk>
__device__ __forceinline__ void query_tile(const Args& a, int b, int h, int q0, uint8_t* sw,
                                           const uint8_t* sk, const uint8_t* sv, int keys,
                                           Chunk&& chunk, int lane) {
  const Scales sc = head_scales(a, h);
  __syncwarp();  // every lane is done with the previous tile's q rows
  quantize_rows<T>(sw, seq_base<T>(a, a.q, 0, b, h), a.st[0][1], q0, 16, a.N, sc.q, lane, 32);
  __syncwarp();
  QFrags q;
  load_q(sw, q, lane);
  if constexpr (PV8) {
    float res[kOutTiles][4];
    attend<RULE>(a, q, sk, sv, keys + 16, chunk, sc.logit, sc.v, res, lane);
    store_rows<T>(a, b, h, q0, res, lane);
  } else {
    attend_qk<T, RULE>(a, q, sk, sv, chunk, sc.logit, sw + kQBytes, b, h, q0, lane);
  }
}

// N > 32: block = one (batch, head) sequence, or with K/V longer than one
// span (N > max_span) 8 query tiles of it ("rounds" blocks a sequence).
// Shared memory: k8 rows of the span, its V (v_bytes), each warp's own.
template <typename T, int RULE, bool PV8>
__device__ __forceinline__ void sequence_block(const Args& a, int span, int rounds, uint8_t* smem) {
  uint8_t* sk = smem;
  uint8_t* sv = sk + span * kPitch;
  const int bh = blockIdx.x / rounds, round = blockIdx.x - bh * rounds;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* sw = sv + v_bytes<T, PV8>(span) + warp * warp_bytes<T, PV8>();
  const T* kb = seq_base<T>(a, a.k, 1, b, h);
  const T* vb = seq_base<T>(a, a.v, 2, b, h);
  const Scales sc = head_scales(a, h);
  fill_kv<T, PV8>(sk, sv, a, sc, kb, vb, 0, span, tid, kThreads);
  __syncthreads();
  int loaded = 0;
  auto chunk = [&](int c) {
    const int want = c * kChunk / span;
    if (want != loaded) {  // uniform over the block: every warp runs the same chunk sequence
      __syncthreads();  // every warp is done with the span in place
      fill_kv<T, PV8, 2>(sk, sv, a, sc, kb, vb, want * span, span, tid, kThreads);
      __syncthreads();
      loaded = want;
    }
    return c * kChunk - loaded * span;
  };
  const int nqt = (a.N + 15) / 16;
  if (rounds == 1) {  // one span, loaded: no barrier follows, warps run free
    for (int qt = warp; qt < nqt; qt += kWarps) {
      query_tile<T, RULE, PV8>(a, b, h, 16 * qt, sw, sk, sv, span, chunk, lane);
    }
  } else {  // every warp takes part in each reload, a tile past N too
    query_tile<T, RULE, PV8>(a, b, h, 16 * (round * kWarps + warp), sw, sk, sv, span, chunk, lane);
  }
}

// the short route's shared bytes a warp: K (32 rows), its V, its own
template <typename T, bool PV8>
__host__ __device__ constexpr int short_bytes() {
  return kChunk * kPitch + v_bytes<T, PV8>(kChunk) + warp_bytes<T, PV8>();
}

// N <= 32: a warp per (batch, head) sequence, kWarps sequences a block.
template <typename T, int RULE, bool PV8>
__device__ __forceinline__ void short_block(const Args& a, uint8_t* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kWarps + warp;
  if (bh >= a.BH) return;  // no block-wide barrier follows
  const int b = bh / a.H, h = bh - b * a.H;
  uint8_t* sk = smem + warp * short_bytes<T, PV8>();
  uint8_t* sv = sk + kChunk * kPitch;
  uint8_t* sw = sv + v_bytes<T, PV8>(kChunk);
  const Scales sc = head_scales(a, h);
  fill_kv<T, PV8>(sk, sv, a, sc, seq_base<T>(a, a.k, 1, b, h), seq_base<T>(a, a.v, 2, b, h), 0,
                  kChunk, lane, 32);
  auto chunk = [](int c) { return c * kChunk; };
  for (int q0 = 0; q0 < a.N; q0 += 16) {
    query_tile<T, RULE, PV8>(a, b, h, q0, sw, sk, sv, kChunk, chunk, lane);
  }
}

// P.V in int8
template <typename T, int RULE>
__global__ void __launch_bounds__(kThreads, RULE == kFlash ? 2 : 1)
    flash_int8_tc_kernel(const Args a, int span, int rounds) {
  extern __shared__ __align__(16) uint8_t smem[];
  sequence_block<T, RULE, true>(a, span, rounds, smem);
}
template <typename T, int RULE>
__global__ void __launch_bounds__(kThreads, RULE == kFlash ? 2 : 1)
    flash_int8_tc_short_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  short_block<T, RULE, true>(a, smem);
}
// P.V in the storage type ("qk" mode). Two blocks an SM in bf16 with one
// scale block (the sampler's rules): at most 128 registers a thread. In
// fp32 one block's shared memory fills an SM at N = 256.
template <typename T, int RULE>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && RULE != kFlashBlocks ? 2 : 1)
    flash_int8_qk_tc_kernel(const Args a, int span, int rounds) {
  extern __shared__ __align__(16) uint8_t smem[];
  sequence_block<T, RULE, false>(a, span, rounds, smem);
}
template <typename T, int RULE>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && RULE != kFlashBlocks ? 2 : 1)
    flash_int8_qk_tc_short_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  short_block<T, RULE, false>(a, smem);
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

template <typename T, int RULE, bool PV8>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  if (a.N <= kMaxShortN) {
    auto kernel = PV8 ? flash_int8_tc_short_kernel<T, RULE> : flash_int8_qk_tc_short_kernel<T, RULE>;
    return launch_i8(kernel, (a.BH + kWarps - 1) / kWarps, (size_t)kWarps * short_bytes<T, PV8>(),
                     stream, a);
  }
  const int keys = (a.N + kChunk - 1) / kChunk * kChunk;
  const int span = min(keys, max_span(PV8));
  const int nqt = (a.N + 15) / 16;
  const int rounds = keys > span ? (nqt + kWarps - 1) / kWarps : 1;
  const size_t smem = (size_t)span * kPitch + v_bytes<T, PV8>(span) + kWarps * warp_bytes<T, PV8>();
  auto kernel = PV8 ? flash_int8_tc_kernel<T, RULE> : flash_int8_qk_tc_kernel<T, RULE>;
  return launch_i8(kernel, (long long)a.BH * rounds, smem, stream, a, span, rounds);
}

template <typename T, bool PV8>
cudaError_t launch_by_rule(const Args& a, bool fused, cudaStream_t stream) {
  if (fused) return launch_tc<T, kFused, PV8>(a, stream);
  if (a.scale_block < a.N) return launch_tc<T, kFlashBlocks, PV8>(a, stream);
  return launch_tc<T, kFlash, PV8>(a, stream);
}

template <typename T>
cudaError_t launch_by_mode(const Args& a, bool pv_int8, bool fused, cudaStream_t stream) {
  return pv_int8 ? launch_by_rule<T, true>(a, fused, stream) : launch_by_rule<T, false>(a, fused, stream);
}

}  // namespace i8tc
}  // namespace latte

// q, k, v: (B, N, H, D) with the element strides `st` (batch, token, head of
// q, then of k, then of v), base pointers and strides 16-byte aligned, a
// contiguous last axis; q_amax, k_amax, v_amax: contiguous fp32 (H,); o:
// contiguous (B, N, H, D); dscale: D^-1/2 as fp32. pv_int8: 1 for P.V in
// int8, 0 for P.V in the storage type (the "qk" mode). scale_block: 0 for
// the fused core's arithmetic, else the keys of one P scale (flash). D = 72.
extern "C" int latte_flash_attention_int8_tc(int dtype, int pv_int8, const void* q, const void* k,
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
  const bool fused = scale_block == 0, pv8 = pv_int8 != 0;
  if (dtype == latte::kBFloat16) return (int)launch_by_mode<__nv_bfloat16>(a, pv8, fused, s);
  if (dtype == latte::kFloat32) return (int)launch_by_mode<float>(a, pv8, fused, s);
  return (int)cudaErrorInvalidValue;
}
