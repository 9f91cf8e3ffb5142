// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel` of latte_tpu/kernels/attention.py
// (reached through `_flash_forward` and `flash_attention`). Computes
// softmax(q k^T / sqrt(D)) v over the layout (B, N, H, D) with an online
// softmax, so the N x N score matrix never reaches device memory, and
// optionally writes the per-row logsumexp (B*H, N) for a backward pass.
//
// Numerics follow the TPU kernel:
//   - q is scaled in fp32 and rounded back to the storage type;
//   - scores and P.V accumulate in fp32; m and l are fp32;
//   - P is rounded to v's type before P.V, while l sums the unrounded P.
//
// Bound: at Latte-XL/2 256^2 the spatial call (B*H = 256, N = 256, D = 72)
// does 4*B*H*N^2*D = 4.8 GFLOP on 37.7 MB of q, k, v, o; at the H100 SXM's
// 989 TFLOP/s (bf16) and 3.35 TB/s that is 4.9 us of tensor-core work and
// 11 us of memory traffic, so the call is bound by bytes. The temporal call
// (B*H = 4096, N = 16) moves the same bytes for 1/16 of the operations.
//
// Design (first, simple version: CUDA cores, fp32 FMAs, no tensor cores):
//   - one block per (batch*head, tile of BQ queries); 4 threads share a
//     query row. The grid's x axis is batch*head, so any batch fits.
//   - q, k, v are read in place through their strides: the model passes the
//     q/k/v column views of its fused qkv projection without a transpose.
//   - K and V stream through shared memory in tiles of BK keys, stored as
//     fp32 rows padded to D+1 floats so neither the score loop nor the P.V
//     loop has shared-memory bank conflicts.
//   - each thread keeps BK/4 scores and ceil(D/4) output columns in
//     registers (COLS is the compile-time bound), so head_dim 72 needs no
//     padding of the result: columns >= D are never written.
//   - keys past N are masked to -inf and queries past N are zero rows that
//     are not stored, so any N works (no fallback as at attention.py:493).
//   - tile sizes follow N: BQ = 64, BK = 32 for the spatial N = 256, and
//     BQ = BK = 16 for N <= 32 (the temporal N = 16), so a short sequence
//     does not leave most of a block idle.

#include <math_constants.h>

#include "common.cuh"

namespace latte {

constexpr int kThreadsPerRow = 4;
constexpr int kMaxHeadDim = 128;

template <typename T, int BQ, int BK, int COLS>
__global__ void __launch_bounds__(BQ * kThreadsPerRow)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int N, int H, int D,
                 long long sqb, long long sqn, long long sqh, long long skb, long long skn,
                 long long skh, long long svb, long long svn, long long svh, float scale) {
  constexpr int TPR = kThreadsPerRow;
  constexpr int SPT = BK / TPR;  // scores per thread per K tile
  constexpr int NT = BQ * TPR;   // threads per block
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sq = smem;            // BQ x ld
  float* sk = sq + BQ * ld;    // BK x ld
  float* sv = sk + BK * ld;    // BK x ld
  float* sp = sv + BK * ld;    // BQ x (BK + 1)
  constexpr int ldp = BK + 1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, t4 = tid % TPR;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D, d = idx - i * D;
    const int n = q0 + i;
    sq[i * ld + d] = n < N ? round_to<T>(to_float(qb[n * sqn + d]) * scale) : 0.f;
  }

  float m = -1e30f, l = 0.f;  // the row's running max and sum, kept by all 4 threads
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with sk, sv
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx - j * D;
      const int n = k0 + j;
      sk[j * ld + d] = n < N ? to_float(kb[n * skn + d]) : 0.f;
      sv[j * ld + d] = n < N ? to_float(vb[n * svn + d]) : 0.f;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int c = 0; c < SPT; ++c) s[c] = 0.f;
    const float* qrow = sq + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int c = 0; c < SPT; ++c) s[c] = fmaf(qd, sk[(t4 + c * TPR) * ld + d], s[c]);
    }
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      if (k0 + t4 + c * TPR >= N) s[c] = -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      const float p = expf(s[c] - m_new);
      psum += p;
      sp[r * ldp + t4 + c * TPR] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's P is written by its 4 threads, all in this warp

    float pv[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) pv[c] = 0.f;
    const float* prow = sp + r * ldp;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float pj = prow[j];
      const float* vrow = sv + j * ld;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = t4 + c * TPR;
        if (d < D) pv[c] = fmaf(pj, vrow[d], pv[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = acc[c] * alpha + pv[c];
  }

  const int n = q0 + r;
  if (n < N) {
    T* orow = o + (((long long)b * N + n) * H + h) * D;
    const float inv_l = 1.f / l;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = t4 + c * TPR;
      if (d < D) orow[d] = from_float<T>(acc[c] * inv_l);
    }
    if (lse != nullptr && t4 == 0) lse[(long long)bh * N + n] = m + logf(l);
  }
}

template <typename T, int BQ, int BK, int COLS>
void launch_flash(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int N, int H, int D, const long long* st, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, BQ, BK, COLS>;
  const int ld = D + 1;
  const size_t smem = sizeof(float) * ((size_t)BQ * ld + 2 * (size_t)BK * ld + (size_t)BQ * (BK + 1));
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((N + BQ - 1) / BQ));
  kernel<<<grid, BQ * kThreadsPerRow, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, N, H, D, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
}

template <typename T, int BQ, int BK>
void launch_by_dim(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int N, int H, int D, const long long* st, float scale, cudaStream_t stream) {
  if (D <= 64) {
    launch_flash<T, BQ, BK, 16>(q, k, v, o, lse, B, N, H, D, st, scale, stream);
  } else if (D <= 96) {
    launch_flash<T, BQ, BK, 24>(q, k, v, o, lse, B, N, H, D, st, scale, stream);
  } else {
    launch_flash<T, BQ, BK, 32>(q, k, v, o, lse, B, N, H, D, st, scale, stream);
  }
}

template <typename T>
void launch_by_len(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int N, int H, int D, const long long* st, float scale, cudaStream_t stream) {
  if (N <= 32) {
    launch_by_dim<T, 16, 16>(q, k, v, o, lse, B, N, H, D, st, scale, stream);
  } else {
    launch_by_dim<T, 64, 32>(q, k, v, o, lse, B, N, H, D, st, scale, stream);
  }
}

}  // namespace latte

using namespace latte;

// strides: the 9 element strides (batch, token, head) of q, k and v, in that
// order; the last axis of each is contiguous. o is a contiguous (B, N, H, D)
// tensor; lse is a contiguous fp32 (B*H, N) tensor or null.
extern "C" int latte_flash_attention_fwd(int dtype, const void* q, const void* k,
                                         const void* v, void* o, void* lse, int B, int N,
                                         int H, int D, long long sqb, long long sqn,
                                         long long sqh, long long skb, long long skn,
                                         long long skh, long long svb, long long svn,
                                         long long svh, float scale, int device,
                                         void* stream) {
  if (D < 1 || D > kMaxHeadDim || N < 1) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const long long st[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBFloat16) {
    launch_by_len<__nv_bfloat16>(q, k, v, o, (float*)lse, B, N, H, D, st, scale, s);
  } else if (dtype == kFloat32) {
    launch_by_len<float>(q, k, v, o, (float*)lse, B, N, H, D, st, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
