// Flash-attention backward for Hopper (sm_90a) on the CUDA cores, any
// layout: dQ and dK/dV.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of latte_tpu/kernels/attention.py (launched by
// `_flash_backward`) for the operands that flash_attention_bwd_tc.cu (bf16)
// and flash_attention_bwd_f32.cu (fp32) do not take: head dims other than
// 72 (Latte-XL/2's), or a base pointer or (batch, token, head) stride off a
// 16-byte boundary, in either dtype. `backward_route`
// (latte_tpu_torch/kernels/attention.py) chooses before the launch. Both
// kernels recompute the probabilities block by block from
// the forward's fp32 logsumexp, so the N x N matrices never reach device
// memory:
//   p  = exp(qs k^T - lse),  qs = round(q * scale) (the forward's rounding)
//   ds = round(p * (dO v^T - delta)),  delta = rowsum(dO * O) (fp32, given)
//   dq = round(scale * ds k)
//   dk = ds^T qs            (qs carries the scale)
//   dv = round(p)^T dO
// Every product accumulates in fp32; round() is the storage type's
// round-to-nearest-even, at the points where the TPU kernels cast.
//
// Bound: at Latte-XL/2 256^2, batch 5, the spatial call (B*H = 1280, N = 256,
// D = 72) reads q, k, v, dO (4 x 23.6 MB in fp32) and writes 1 (dQ) or 2
// (dK/dV) such arrays; it does 6 (dQ) and 8 (dK/dV) * B*H*N^2*D FLOP = 36
// and 48 GFLOP. On CUDA cores (67 TFLOP/s fp32) that is 0.5-0.7 ms against
// 0.04 ms of memory traffic: this simple version is bound by operations,
// and in practice by shared-memory reads, about one per FMA (the fp32
// kernels of flash_attention_bwd_f32.cu tile registers against that).
//
// Design (first, simple version: CUDA cores, fp32 FMAs, no tensor cores;
// two kernels and no atomics, as in the TPU design):
//   - dQ: one block per (batch*head, tile of BQ queries), looping over the
//     K tiles; dK/dV: one block per (batch*head, tile of BK keys), looping
//     over the Q tiles. Each block owns its output rows, so no block adds
//     into another's.
//   - 4 threads share an output row; each owns every 4th column (COLS is
//     the compile-time bound, 24 for head_dim 72), so nothing is padded and
//     columns >= D are never written. Shared-memory rows are fp32 padded to
//     D + 1 floats, which keeps the dot-product loops free of bank conflicts.
//   - q, k, v, dO are read and dq, dk, dv written through their (batch,
//     token, head) element strides, with a contiguous last axis: the model
//     passes column views of its fused qkv projection and gets dq, dk, dv
//     back in one (B, N, 3, H, D) buffer, so no copy rebuilds the fused
//     gradient.
//   - rows past N are masked (p = 0) and not stored, so any N works.
//   - tiles follow N as in the forward: 16 x 16 for N <= 32 (temporal
//     N = 16), 64 output rows x 32 streamed rows above.

#include "common.cuh"

namespace latte {

constexpr int kBwdThreadsPerRow = 4;
constexpr int kBwdMaxHeadDim = 128;

// Pointers, sizes and the (batch, token, head) element strides of the seven
// (B, N, H, D) operands, in the order q, k, v, dO, dq, dk, dv.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, N), contiguous
  const float* delta;  // (B*H, N), contiguous
  void* dq;
  void* dk;
  void* dv;
  int N, H, D;
  long long st[7][3];
  float scale;
};

enum Operand { kQ = 0, kK, kV, kDO, kDQ, kDK, kDV };

// Element (n, d) of operand `o` for the batch and head of block row bh.
__device__ __forceinline__ long long offset(const BwdArgs& a, int o, int b, int h, int n) {
  return b * a.st[o][0] + (long long)n * a.st[o][1] + h * a.st[o][2];
}

template <typename T, int BQ, int BK, int COLS>
__global__ void __launch_bounds__(BQ * kBwdThreadsPerRow) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int TPR = kBwdThreadsPerRow;
  constexpr int SPT = BK / TPR;  // keys per thread per K tile
  constexpr int NT = BQ * TPR;
  constexpr int ldp = BK + 1;
  extern __shared__ float smem[];
  const int N = a.N, H = a.H, D = a.D, ld = D + 1;
  float* sq = smem;           // BQ x ld: qs
  float* sdo = sq + BQ * ld;  // BQ x ld: dO
  float* sk = sdo + BQ * ld;  // BK x ld
  float* sv = sk + BK * ld;   // BK x ld
  float* sds = sv + BK * ld;  // BQ x ldp: ds of the current K tile

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, t4 = tid % TPR;
  const T* q = (const T*)a.q;
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  const T* dout = (const T*)a.dout;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D, d = idx - i * D;
    const int n = q0 + i;
    const bool in = n < N;
    sq[i * ld + d] = in ? round_to<T>(to_float(q[offset(a, kQ, b, h, n) + d]) * a.scale) : 0.f;
    sdo[i * ld + d] = in ? to_float(dout[offset(a, kDO, b, h, n) + d]) : 0.f;
  }
  const int n_row = q0 + r;
  const bool row_in = n_row < N;
  const float lse = row_in ? a.lse[(long long)bh * N + n_row] : 0.f;
  const float delta = row_in ? a.delta[(long long)bh * N + n_row] : 0.f;

  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with sk, sv, sds
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx - j * D;
      const int n = k0 + j;
      const bool in = n < N;
      sk[j * ld + d] = in ? to_float(k[offset(a, kK, b, h, n) + d]) : 0.f;
      sv[j * ld + d] = in ? to_float(v[offset(a, kV, b, h, n) + d]) : 0.f;
    }
    __syncthreads();

    float s[SPT], dp[SPT];
#pragma unroll
    for (int c = 0; c < SPT; ++c) s[c] = dp[c] = 0.f;
    const float* qrow = sq + r * ld;
    const float* dorow = sdo + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d], dod = dorow[d];
#pragma unroll
      for (int c = 0; c < SPT; ++c) {
        const int j = t4 + c * TPR;
        s[c] = fmaf(qd, sk[j * ld + d], s[c]);
        dp[c] = fmaf(dod, sv[j * ld + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      const int j = t4 + c * TPR;
      const float p = (row_in && k0 + j < N) ? expf(s[c] - lse) : 0.f;
      sds[r * ldp + j] = round_to<T>(p * (dp[c] - delta));
    }
    __syncwarp();  // a row's ds is written by its 4 threads, all in this warp

    const float* dsrow = sds + r * ldp;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float dsj = dsrow[j];
      const float* krow = sk + j * ld;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = t4 + c * TPR;
        if (d < D) acc[c] = fmaf(dsj, krow[d], acc[c]);
      }
    }
  }

  if (row_in) {
    T* dq = (T*)a.dq + offset(a, kDQ, b, h, n_row);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = t4 + c * TPR;
      if (d < D) dq[d] = from_float<T>(acc[c] * a.scale);
    }
  }
}

template <typename T, int BK, int BQ, int COLS>
__global__ void __launch_bounds__(BK * kBwdThreadsPerRow) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int TPR = kBwdThreadsPerRow;
  constexpr int SPT = BQ / TPR;  // queries per thread per Q tile
  constexpr int NT = BK * TPR;
  constexpr int ldp = BQ + 1;
  extern __shared__ float smem[];
  const int N = a.N, H = a.H, D = a.D, ld = D + 1;
  float* sk = smem;            // BK x ld
  float* sv = sk + BK * ld;    // BK x ld
  float* sq = sv + BK * ld;    // BQ x ld: qs of the current Q tile
  float* sdo = sq + BQ * ld;   // BQ x ld
  float* sp = sdo + BQ * ld;   // BK x ldp: round(p), transposed
  float* sds = sp + BK * ldp;  // BK x ldp: ds, transposed
  float* slse = sds + BK * ldp;
  float* sdelta = slse + BQ;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int r = tid / TPR, t4 = tid % TPR;
  const T* q = (const T*)a.q;
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  const T* dout = (const T*)a.dout;

  for (int idx = tid; idx < BK * D; idx += NT) {
    const int j = idx / D, d = idx - j * D;
    const int n = k0 + j;
    const bool in = n < N;
    sk[j * ld + d] = in ? to_float(k[offset(a, kK, b, h, n) + d]) : 0.f;
    sv[j * ld + d] = in ? to_float(v[offset(a, kV, b, h, n) + d]) : 0.f;
  }
  const bool row_in = k0 + r < N;

  float dk[COLS], dv[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done with sq, sdo, sp, sds
    for (int idx = tid; idx < BQ * D; idx += NT) {
      const int i = idx / D, d = idx - i * D;
      const int n = q0 + i;
      const bool in = n < N;
      sq[i * ld + d] = in ? round_to<T>(to_float(q[offset(a, kQ, b, h, n) + d]) * a.scale) : 0.f;
      sdo[i * ld + d] = in ? to_float(dout[offset(a, kDO, b, h, n) + d]) : 0.f;
    }
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < N;
      slse[i] = in ? a.lse[(long long)bh * N + q0 + i] : 0.f;
      sdelta[i] = in ? a.delta[(long long)bh * N + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[SPT], dp[SPT];
#pragma unroll
    for (int c = 0; c < SPT; ++c) s[c] = dp[c] = 0.f;
    const float* krow = sk + r * ld;
    const float* vrow = sv + r * ld;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d], vd = vrow[d];
#pragma unroll
      for (int c = 0; c < SPT; ++c) {
        const int i = t4 + c * TPR;
        s[c] = fmaf(sq[i * ld + d], kd, s[c]);
        dp[c] = fmaf(sdo[i * ld + d], vd, dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < SPT; ++c) {
      const int i = t4 + c * TPR;
      const float p = (row_in && q0 + i < N) ? expf(s[c] - slse[i]) : 0.f;
      sp[r * ldp + i] = round_to<T>(p);
      sds[r * ldp + i] = round_to<T>(p * (dp[c] - sdelta[i]));
    }
    __syncwarp();  // a key row's p and ds are written by its 4 threads, all in this warp

    const float* prow = sp + r * ldp;
    const float* dsrow = sds + r * ldp;
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      const float pi = prow[i], dsi = dsrow[i];
      const float* dorow = sdo + i * ld;
      const float* qrow = sq + i * ld;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = t4 + c * TPR;
        if (d < D) {
          dv[c] = fmaf(pi, dorow[d], dv[c]);
          dk[c] = fmaf(dsi, qrow[d], dk[c]);
        }
      }
    }
  }

  if (row_in) {
    T* dkrow = (T*)a.dk + offset(a, kDK, b, h, k0 + r);
    T* dvrow = (T*)a.dv + offset(a, kDV, b, h, k0 + r);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = t4 + c * TPR;
      if (d < D) {
        dkrow[d] = from_float<T>(dk[c]);
        dvrow[d] = from_float<T>(dv[c]);
      }
    }
  }
}

template <typename Kernel>
void launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem, const BwdArgs& a,
            cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  kernel<<<grid, threads, smem, stream>>>(a);
}

// ROWS output rows per block, STREAM rows streamed per inner step.
template <typename T, int ROWS, int STREAM, int COLS>
void launch_bwd(bool dkv, int BH, const BwdArgs& a, cudaStream_t stream) {
  const size_t ld = a.D + 1;
  const dim3 grid((unsigned)BH, (unsigned)((a.N + ROWS - 1) / ROWS));
  const int threads = ROWS * kBwdThreadsPerRow;
  if (dkv) {
    const size_t smem = sizeof(float) * (2 * (size_t)ROWS * ld + 2 * (size_t)STREAM * ld +
                                         2 * (size_t)ROWS * (STREAM + 1) + 2 * (size_t)STREAM);
    launch_kernel(flash_bwd_dkv_kernel<T, ROWS, STREAM, COLS>, grid, threads, smem, a, stream);
  } else {
    const size_t smem = sizeof(float) * (2 * (size_t)ROWS * ld + 2 * (size_t)STREAM * ld +
                                         (size_t)ROWS * (STREAM + 1));
    launch_kernel(flash_bwd_dq_kernel<T, ROWS, STREAM, COLS>, grid, threads, smem, a, stream);
  }
}

template <typename T, int ROWS, int STREAM>
void bwd_by_dim(bool dkv, int BH, const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 64) {
    launch_bwd<T, ROWS, STREAM, 16>(dkv, BH, a, stream);
  } else if (a.D <= 96) {
    launch_bwd<T, ROWS, STREAM, 24>(dkv, BH, a, stream);
  } else {
    launch_bwd<T, ROWS, STREAM, 32>(dkv, BH, a, stream);
  }
}

template <typename T>
void bwd_by_len(bool dkv, int BH, const BwdArgs& a, cudaStream_t stream) {
  if (a.N <= 32) {
    bwd_by_dim<T, 16, 16>(dkv, BH, a, stream);
  } else {
    bwd_by_dim<T, 64, 32>(dkv, BH, a, stream);
  }
}

int flash_bwd(bool dkv, int dtype, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int N, int H, int D, const long long* strides, float scale,
              int device, void* stream) {
  if (D < 1 || D > kBwdMaxHeadDim || N < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.N = N;
  a.H = H;
  a.D = D;
  for (int o = 0; o < 7; ++o) {
    for (int i = 0; i < 3; ++i) a.st[o][i] = strides[3 * o + i];
  }
  a.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBFloat16) {
    bwd_by_len<__nv_bfloat16>(dkv, B * H, a, s);
  } else if (dtype == kFloat32) {
    bwd_by_len<float>(dkv, B * H, a, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace latte

// strides: 21 element strides, (batch, token, head) of q, k, v, dout, dq, dk
// and dv in that order; the last axis of each is contiguous. lse and delta
// are contiguous fp32 (B*H, N). The dq entry writes dq only (dk, dv unused);
// the dkv entry writes dk and dv only (dq unused).
extern "C" int latte_flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                            const void* v, const void* dout, const void* lse,
                                            const void* delta, void* dq, void* dk, void* dv,
                                            int B, int N, int H, int D,
                                            const long long* strides, float scale, int device,
                                            void* stream) {
  return latte::flash_bwd(false, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, N, H, D,
                          strides, scale, device, stream);
}

extern "C" int latte_flash_attention_bwd_dkv(int dtype, const void* q, const void* k,
                                             const void* v, const void* dout, const void* lse,
                                             const void* delta, void* dq, void* dk, void* dv,
                                             int B, int N, int H, int D,
                                             const long long* strides, float scale, int device,
                                             void* stream) {
  return latte::flash_bwd(true, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, N, H, D,
                          strides, scale, device, stream);
}
