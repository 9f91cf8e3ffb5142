// Building blocks of the tensor-core attention kernels (sm_90a, bf16,
// head_dim 72): flash_attention_tc.cu (forward) and flash_attention_bwd_tc.cu
// (dQ, dK/dV).
//
// A warp owns 16 rows of a product and works in mma.sync.m16n8k16 fragments
// (bf16 in, fp32 accumulate). With g = lane / 4 and t = lane % 4:
//   A (16 x 16, row): a0 rows g, k 2t..2t+1; a1 row g+8; a2, a3 the same at k + 8;
//   B (16 x 8, col):  b0 k 2t..2t+1, column g; b1 at k + 8;
//   C (16 x 8):       c0, c1 row g, columns 2t, 2t+1; c2, c3 row g+8.
// So the C fragments of two n8 tiles, converted to bf16 pairs, are the A
// fragment of one k16 step: a product's output feeds the next product from
// registers (P.V in the forward, dS.K, P^T.dO and dS^T.qs in the backward).
//
// Head_dim 72 = 4 k16 steps + one m16n8k8 step on columns 64-71 when it is
// the contraction axis, and 9 n8 tiles when it is the output axis. Rows of
// 72 bf16 sit in shared memory at their own 144-byte pitch: 9 16-byte
// chunks, an odd number, so the 8 rows an ldmatrix 8x8 matrix reads start 36
// words apart (4 banks mod 32) and fall on 8 distinct groups of 4 banks: no
// conflicts without padding. ldmatrix (non-transposed) gives the B fragment
// of a product against the rows (A.rows^T, contraction over the 72 columns);
// ldmatrix.trans gives the B fragment of a product with the rows (P.rows,
// contraction over the rows).
#pragma once

#include <cstdint>

#include <math_constants.h>

#include "common.cuh"

namespace latte {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kD = 72;           // head_dim, also the bf16 pitch of a shared-memory row
constexpr int kChunks = kD / 8;  // 16-byte chunks of a row: 9
constexpr int kSteps = kD / 16;  // k16 steps of a contraction over head_dim (then one k8 step)
static_assert(kChunks == 9, "the fragment loads are written for 9 chunks: 4 + 4 + 1");

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)) : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16x8, row) * b (8x8, col)
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&r);
}

// round(x * scale) of both bf16 halves, the product in fp32
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// Copy rows n0 .. n0+ROWS-1 of one (batch, head) sequence into shared
// memory, 16 bytes a thread at a time; rows past N become zeros.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int n0,
                                          int N, int t) {
#pragma unroll 2
  for (int i = t; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool valid = n0 + r < N;
    cp_async_16(dst + r * kD + c * 8, src + (valid ? n0 + r : 0) * stride + c * 8,
                valid ? 16 : 0);
  }
}

// A fragments of a warp's 16 rows of 72 columns: a[s] covers columns
// 16s..16s+15, tail columns 64-71.
struct QFrags {
  uint32_t a[kSteps][4];
  uint32_t tail[2];
};

// The A fragments of rows sq[0..15], scaled and rounded (the forward's qs).
__device__ __forceinline__ void load_q(const bf16* sq, QFrags& f, float scale, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  // matrix mi of an x4: rows (mi & 1) * 8 + r, columns (mi >> 1) * 8 of the step
  const bf16* row = sq + ((mi & 1) * 8 + r) * kD;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    ldsm_x4(f.a[s], row + s * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) f.a[s][j] = scale_pair(f.a[s][j], scale);
  }
  ldsm_x2(f.tail[0], f.tail[1], row + (kD - 8));  // lanes 0-15: rows 0-7, 8-15
  f.tail[0] = scale_pair(f.tail[0], scale);
  f.tail[1] = scale_pair(f.tail[1], scale);
}

// The A fragments of rows sa[0..15] as they are.
__device__ __forceinline__ void load_a(const bf16* sa, QFrags& f, int lane) {
  const int r = lane & 7, mi = lane >> 3;
  const bf16* row = sa + ((mi & 1) * 8 + r) * kD;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) ldsm_x4(f.a[s], row + s * 16 + (mi >> 1) * 8);
  ldsm_x2(f.tail[0], f.tail[1], row + (kD - 8));
}

// s[j] = the warp's 16 A rows against rows 8j..8j+7 of sk (a product
// A.rows^T over the 72 columns): c0, c1 of row g = lane / 4, rows 2t, 2t+1
// of sk (t = lane % 4); c2, c3 row g+8.
template <int NT8>
__device__ __forceinline__ void qk_scores(const QFrags& q, const bf16* sk, float (&s)[NT8][4],
                                          int lane) {
  const int r = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const bf16* row = sk + (j * 8 + r) * kD;
    uint32_t kb[kChunks];  // kb[c]: the B fragment of columns 8c..8c+7
#pragma unroll
    for (int c = 0; c < 8; c += 4) {
      uint32_t x[4];
      ldsm_x4(x, row + (c + mi) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[c + i] = x[i];
    }
    ldsm_x1(kb[8], row + 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) mma_k16(s[j], q.a[st], kb[2 * st], kb[2 * st + 1]);
    mma_k8(s[j], q.tail, kb[8]);
  }
}

// Entries of columns at or past N (the zero-filled rows of a ragged last
// tile, column 0 being row key0) -> -inf, so that exp gives 0.
template <int NT8>
__device__ __forceinline__ void mask_keys(float (&s)[NT8][4], int key0, int N, int lane) {
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (key0 + j * 8 + t2 + (i & 1) >= N) s[j][i] = -CUDART_INF_F;
    }
  }
}

// acc += P (16 x 16*KS) . V (rows of sv): the contraction runs over the rows
template <int KS>
__device__ __forceinline__ void pv_product(const uint32_t (&pa)[KS][4], const bf16* sv,
                                           float (&acc)[kChunks][4], int lane) {
  const int r = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    // matrix mi of an x4.trans: keys 16j + (mi & 1) * 8 + r, columns of tile n + (mi >> 1)
    const bf16* row = sv + (j * 16 + (mi & 1) * 8 + r) * kD;
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, row + (n + (mi >> 1)) * 8);
      mma_k16(acc[n], pa[j], b[0], b[1]);
      mma_k16(acc[n + 1], pa[j], b[2], b[3]);
    }
    uint32_t b0, b1;
    ldsm_x2_t(b0, b1, row + 64);  // columns 64-71; lanes 0-15: keys 16j..16j+15
    mma_k16(acc[8], pa[j], b0, b1);
  }
}

__device__ __forceinline__ const bf16* seq_base(const bf16* x, const long long (&st)[3], int bh,
                                                int H) {
  const int b = bh / H, h = bh - b * H;
  return x + b * st[0] + h * st[2];
}

}  // namespace tc
}  // namespace latte
