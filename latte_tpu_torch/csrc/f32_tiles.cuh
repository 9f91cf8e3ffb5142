// Register tiles of the fp32 attention kernels on Hopper's CUDA cores
// (sm_90a, head_dim 72): flash_attention_f32.cu (forward) and
// flash_attention_bwd_f32.cu (dQ, dK/dV).
//
// Every operand row of 72 floats sits in shared memory at a pitch of 76
// (16-byte aligned; 19 chunks, odd, so 8 consecutive rows fall on 8 distinct
// groups of 4 banks). With R rows a thread (ty = thread / 16, tx = thread %
// 16):
//   - row_products: S = A B^T over head_dim, a thread owning rows R*ty.. and
//     columns tx, tx+16, ...: per 4 head_dim values R row chunks (shared by
//     the 16 threads of a half-warp) and M column chunks, R + M LDS.128 for
//     4RM FFMA.
//   - OutTile: an output tile over the streamed rows (O += W B), rows R*ty..
//     at columns 4tx..4tx+3 of the first 64, the 8 tail columns of the
//     half-warp's rows split over its 16 threads (R/2 each).
// Tiles come by 16-byte cp.async from the (B, N, H, D) views.
#pragma once

#include "common.cuh"

namespace latte {
namespace f32 {

constexpr int kD = 72;           // head_dim
constexpr int kChunks = kD / 4;  // 16-byte chunks of a row: 18
constexpr int kLd = kD + 4;      // pitch of an operand row in shared memory, in floats
constexpr int kRows = 8;           // spatial: output rows a thread owns (dK/dV's scores: 4)
constexpr int kTile = 64;           // spatial: rows of a streamed tile
constexpr int kThreads = 256;       // spatial block
constexpr int kMaxShortN = 64;      // the temporal route takes N <= 64
static_assert(kD == 64 + 8, "a thread owns 4 of the first 64 columns and some of the last 8");

// Rows n0 .. n0+ROWS-1 of one sequence (src: its base, stride: its token
// stride) into shared rows of pitch kLd, 16 bytes a thread at a time; rows
// past N become zeros.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride, int n0,
                                          int N, int t) {
#pragma unroll 2
  for (int i = t; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool valid = n0 + r < N;
    cp_async_16(dst + r * kLd + c * 4, src + (valid ? n0 + r : 0) * stride + c * 4,
                valid ? 16 : 0);
  }
}

// qs = q * scale in place, over the chunks thread t copied with
// load_rows<ROWS, THREADS>: its own copies are visible to it once its wait
// returns, so no barrier comes between.
template <int ROWS, int THREADS>
__device__ __forceinline__ void scale_rows(float* rows, float scale, int t) {
  for (int i = t; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i - r * kChunks;
    float4* p = reinterpret_cast<float4*>(rows + r * kLd + c * 4);
    float4 x = *p;
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *p = x;
  }
}

// fp32 values n0 .. n0+ROWS-1 of one (B*H, N) row into shared memory, 4
// bytes a thread at a time; values past N become zeros.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n0, int N, int t) {
  for (int i = t; i < ROWS; i += THREADS) {
    const bool valid = n0 + i < N;
    cp_async_4(dst + i, src + (valid ? n0 + i : 0), valid ? 4 : 0);
  }
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// s[i][m] = sum_d a[RPT*ty+i][d] * b[tx+16m][d]: rows of a against rows of
// b, both at pitch kLd, contracted over head_dim.
template <int RPT, int M>
__device__ __forceinline__ void row_products(const float* sa, const float* sb,
                                             float (&s)[RPT][M], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int m = 0; m < M; ++m) s[i][m] = 0.f;
  }
  const float* a = sa + RPT * ty * kLd;
  const float* b = sb + tx * kLd;
#pragma unroll
  for (int c = 0; c < kD; c += 4) {
    float4 av[RPT], bv[M];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * kLd + c);
#pragma unroll
    for (int m = 0; m < M; ++m) bv[m] = *reinterpret_cast<const float4*>(b + 16 * m * kLd + c);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        s[i][m] = fmaf(av[i].x, bv[m].x, s[i][m]);
        s[i][m] = fmaf(av[i].y, bv[m].y, s[i][m]);
        s[i][m] = fmaf(av[i].z, bv[m].z, s[i][m]);
        s[i][m] = fmaf(av[i].w, bv[m].w, s[i][m]);
      }
    }
  }
}

// The output tile of a thread: rows RPT*ty.. at columns 4tx..4tx+3, and
// the 8 tail columns 64-71 of its RPT rows shared by the 16 threads of its
// half-warp: row RPT*ty + tx/LPR at columns 64 + TW*(tx%LPR).., TW = RPT/2
// of them (a float2 at RPT = 4, a float4 at 8).
template <int RPT>
struct OutTile {
  static constexpr int TW = RPT / 2, LPR = 8 / TW;
  float acc[RPT][4];
  float tail[TW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int c = 0; c < TW; ++c) tail[c] = 0.f;
  }

  // Row i of the tile *= f[i] (the tail's row is RPT*ty + tx/LPR).
  __device__ __forceinline__ void rescale(const float (&f)[RPT], int tx) {
    float ft = f[0];
#pragma unroll
    for (int i = 1; i < RPT; ++i) ft = tx / LPR == i ? f[i] : ft;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= f[i];
    }
#pragma unroll
    for (int c = 0; c < TW; ++c) tail[c] *= ft;
  }

  // += w b over the ROWS streamed rows: w (pitch ldw) holds this thread's
  // rows' weights per streamed row, b the streamed rows at pitch kLd.
  template <int ROWS>
  __device__ __forceinline__ void add(const float* sw, int ldw, const float* sb, int ty, int tx) {
    const float* w = sw + RPT * ty * ldw;
    const float* wt = sw + (RPT * ty + tx / LPR) * ldw;
    const float* b = sb + 4 * tx;
    const float* bt = sb + 64 + TW * (tx % LPR);
#pragma unroll 4
    for (int j = 0; j < ROWS; j += 4) {
      float4 wv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) wv[i] = *reinterpret_cast<const float4*>(w + i * ldw + j);
      const float4 wtv = *reinterpret_cast<const float4*>(wt + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 bv = *reinterpret_cast<const float4*>(b + (j + jj) * kLd);
        float btv[TW];
        if constexpr (TW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(bt + (j + jj) * kLd);
          btv[0] = t.x;
          btv[1] = t.y;
        } else {
          const float4 t = *reinterpret_cast<const float4*>(bt + (j + jj) * kLd);
          btv[0] = t.x;
          btv[1] = t.y;
          btv[2] = t.z;
          btv[3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float x = lane(wv[i], jj);
          acc[i][0] = fmaf(x, bv.x, acc[i][0]);
          acc[i][1] = fmaf(x, bv.y, acc[i][1]);
          acc[i][2] = fmaf(x, bv.z, acc[i][2]);
          acc[i][3] = fmaf(x, bv.w, acc[i][3]);
        }
        const float xt = lane(wtv, jj);
#pragma unroll
        for (int c = 0; c < TW; ++c) tail[c] = fmaf(xt, btv[c], tail[c]);
      }
    }
  }

  // Rows row0 + RPT*ty.. of one sequence (out: its base, stride: its token
  // stride) = acc * mult; rows past N are not stored.
  __device__ __forceinline__ void store(float* out, long long stride, int row0, int N, float mult,
                                        int ty, int tx) const {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + RPT * ty + i;
      if (r < N) {
        *reinterpret_cast<float4*>(out + r * stride + 4 * tx) = make_float4(
            acc[i][0] * mult, acc[i][1] * mult, acc[i][2] * mult, acc[i][3] * mult);
      }
    }
    const int r = row0 + RPT * ty + tx / LPR;
    if (r < N) {
      float* o = out + r * stride + 64 + TW * (tx % LPR);
      if constexpr (TW == 2) {
        *reinterpret_cast<float2*>(o) = make_float2(tail[0] * mult, tail[1] * mult);
      } else {
        *reinterpret_cast<float4*>(o) =
            make_float4(tail[0] * mult, tail[1] * mult, tail[2] * mult, tail[3] * mult);
      }
    }
  }
};

}  // namespace f32
}  // namespace latte
