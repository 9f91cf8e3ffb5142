// int8 flash-attention forward (W8A8 serving) for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_int8_kernel` of
// latte_tpu/kernels/attention.py together with what its wrapper
// `flash_attention_int8` does around it (the per-head quantize of q, k, v),
// and, with scale_block = 0, the fused int8 core `int8_attention` of
// latte_tpu/quant/int8.py, which that wrapper falls back to and the model's
// short-sequence route runs. Per (batch, head) row:
//   x8  = clip(rint(x / s), -127, 127)      s = max(amax, 1e-8) / 127 per head
//   s_j = float(q8 . k8_j) * ls             ls = qs * ks * D^-1/2 (given)
// The int32 dot is exact (|q8 . k8| <= 127^2 * 128 < 2^24), so float() is too.
// Then one of two arithmetics, each that of its TPU twin:
//   flash (scale_block > 0, `_flash_int8_kernel`): the keys fall in scale
//     blocks of scale_block keys; for each, m' = max(m, blockmax(s)),
//     p = exp(s - m'), l = l * exp(m - m') + sum(p), and with pv_int8
//     p8 = rint(p * (127 / p_max)) at p_max = max(exp(blockmax - m'), 1e-30),
//     acc = acc * exp(m - m') + float(p8 . v8) * (p_max / 127); the output
//     is (acc / l) * vs. Without pv_int8 (the "qk" mode) p is rounded to the
//     storage type and P.V sums in fp32; the output is acc / l.
//   fused (scale_block = 0, `int8_attention`): one block, the whole row; the
//     probabilities are normalised before they are rounded: P = p / l,
//     P8 = rint(P * (127 / max(P))), out = float(P8 . v8) * (max(P) / 127) * vs,
//     or in "qk" mode out = sum(round(P) * v) in fp32.
// The P scale depends on the maximum over a whole scale block, however the
// kernel tiles K in shared memory: a first pass over the block's K tiles
// finds the maximum of the int32 logits (max commutes with float() * ls for
// a positive ls), and only then does a second pass compute p, quantize it
// and run P.V (the fused arithmetic adds a pass for l in between). Every
// fp32 operation of the formulas above is a separate, correctly rounded
// one (__fmul_rn, __fdiv_rn, ...): nvcc may not contract them into FMAs,
// and x / s is a division, not a multiply by 1/s.
//
// Bound: at Latte-XL/2 256^2 the spatial call (B*H = 256, N = 256, D = 72)
// reads bf16 q, k, v and writes bf16 o, 37.7 MB, 11.3 us at 3.35 TB/s; its
// 4 * B*H * N^2 * D = 4.8 G int8 operations take 2.4 us at 1,979 TOP/s. The
// call is bound by bytes, as is the T2V 512^2 one (N = 1024: 45 us of bytes,
// 39 us of operations).
//
// Design (first, simple version: CUDA cores, dp4a, no tensor cores):
//   - one block per (batch*head, tile of BQ queries), 4 threads per query
//     row, tiles as in flash_attention.cu (16 x 16 for N <= 32, 64 x 32
//     above); q, k, v are read in place through their (batch, token, head)
//     strides, so the model hands over the column views of its fused qkv
//     projection and no quantized copy reaches device memory: each block
//     quantizes its q rows once and each K/V tile as it loads it.
//   - q8 and k8 rows sit in shared memory as 32-bit words of 4 int8 values
//     (head_dim 72 = 18 words; padded with zeros up to a multiple of 4),
//     rows padded by one word against bank conflicts, and the logits are
//     __dp4a sums over the words.
//   - with pv_int8, v8 is stored transposed (4 keys to a word) and each
//     row's p8 packed the same way, so P.V is __dp4a too; in "qk" mode v and
//     P are fp32 rows in shared memory, as in flash_attention.cu.
//   - keys and queries past N are masked (p = 0; rows not stored).

#include <climits>

#include "common.cuh"

namespace latte {

constexpr int kInt8ThreadsPerRow = 4;
constexpr int kInt8MaxHeadDim = 128;

// Element strides (batch, token, head) of q, k, v; the last axis is contiguous.
struct Int8Args {
  const void* q;
  const void* k;
  const void* v;
  const float* sc;  // (H, 4): qs, ks, vs, ls per head
  void* o;          // contiguous (B, N, H, D)
  int N, H, D, scale_block;
  long long st[3][3];
};

template <typename T, int BQ, int BK, int COLS, bool PV8>
__global__ void __launch_bounds__(BQ * kInt8ThreadsPerRow) flash_int8_kernel(Int8Args a) {
  constexpr int TPR = kInt8ThreadsPerRow;
  constexpr int SPT = BK / TPR;  // keys per thread per K tile
  constexpr int NT = BQ * TPR;
  constexpr int KW = BK / 4;     // words of a packed row of BK int8 values
  constexpr int ldp = KW + 1;    // PV8: p8 rows and v8 columns, in words
  constexpr int ldpf = BK + 1;   // "qk": fp32 P rows
  const int N = a.N, H = a.H, D = a.D;
  const int DW = (D + 3) / 4, ldw = DW + 1;  // q8/k8 rows, in words
  extern __shared__ int smem[];
  int* sq = smem;           // BQ x ldw words: q8
  int* sk = sq + BQ * ldw;  // BK x ldw words: k8
  int* sv = sk + BK * ldw;  // PV8: D x ldp words (v8 transposed); "qk": BK x (D + 1) floats
  int* sp = sv + (PV8 ? D * ldp : BK * (D + 1));  // PV8: BQ x ldp words; "qk": BQ x ldpf floats
  signed char* sq8 = reinterpret_cast<signed char*>(sq);
  signed char* sk8 = reinterpret_cast<signed char*>(sk);
  signed char* sv8 = reinterpret_cast<signed char*>(sv);
  signed char* sp8 = reinterpret_cast<signed char*>(sp);
  float* svf = reinterpret_cast<float*>(sv);
  float* spf = reinterpret_cast<float*>(sp);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, t4 = tid % TPR;
  const T* qb = static_cast<const T*>(a.q) + b * a.st[0][0] + h * a.st[0][2];
  const T* kb = static_cast<const T*>(a.k) + b * a.st[1][0] + h * a.st[1][2];
  const T* vb = static_cast<const T*>(a.v) + b * a.st[2][0] + h * a.st[2][2];
  const float qs = a.sc[4 * h], ks = a.sc[4 * h + 1], vs = a.sc[4 * h + 2], ls = a.sc[4 * h + 3];
  const bool fused = a.scale_block <= 0;
  const int SB = fused ? N : a.scale_block;

  for (int idx = tid; idx < BQ * DW * 4; idx += NT) {
    const int i = idx / (DW * 4), d = idx - i * (DW * 4);
    const int n = q0 + i;
    sq8[i * ldw * 4 + d] =
        (signed char)(n < N && d < D ? quantize_i8(to_float(qb[n * a.st[0][1] + d]), qs) : 0);
  }

  // k8 of keys [k0, k0 + BK); keys at or past `end` are zero
  auto load_k = [&](int k0, int end) {
    for (int idx = tid; idx < BK * DW * 4; idx += NT) {
      const int j = idx / (DW * 4), d = idx - j * (DW * 4);
      const int n = k0 + j;
      sk8[j * ldw * 4 + d] =
          (signed char)(n < end && d < D ? quantize_i8(to_float(kb[n * a.st[1][1] + d]), ks) : 0);
    }
  };
  auto load_v = [&](int k0, int end) {
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx - j * D;
      const int n = k0 + j;
      const float x = n < end ? to_float(vb[n * a.st[2][1] + d]) : 0.f;
      if constexpr (PV8) {
        sv8[d * ldp * 4 + j] = (signed char)quantize_i8(x, vs);
      } else {
        svf[j * (D + 1) + d] = x;
      }
    }
  };
  // this thread's int32 logits against the keys t4 + c * TPR of the tile
  auto logits = [&](int (&s32)[SPT]) {
#pragma unroll
    for (int c = 0; c < SPT; ++c) s32[c] = 0;
    const int* qrow = sq + r * ldw;
    for (int w = 0; w < DW; ++w) {
      const int qw = qrow[w];
#pragma unroll
      for (int c = 0; c < SPT; ++c) s32[c] = __dp4a(qw, sk[(t4 + c * TPR) * ldw + w], s32[c]);
    }
  };
  auto logit = [&](int s) { return __fmul_rn(__int2float_rn(s), ls); };

  float m = -1e30f, l = 0.f;  // the row's running max and sum (flash); kept by all 4 threads
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  for (int sb0 = 0; sb0 < N; sb0 += SB) {
    const int sb1 = min(sb0 + SB, N);
    // pass 1: the maximum of the scale block's int32 logits
    int imax = INT_MIN;
    for (int k0 = sb0; k0 < sb1; k0 += BK) {
      __syncthreads();  // the previous readers of sk are done
      load_k(k0, sb1);
      __syncthreads();
      int s32[SPT];
      logits(s32);
#pragma unroll
      for (int c = 0; c < SPT; ++c) {
        if (k0 + t4 + c * TPR < sb1) imax = max(imax, s32[c]);
      }
    }
    imax = max(imax, __shfl_xor_sync(0xffffffffu, imax, 1));
    imax = max(imax, __shfl_xor_sync(0xffffffffu, imax, 2));
    const float bmax = logit(imax);

    float m_new, p_max;
    if (fused) {
      // pass 2 (fused only): l over the row, so P can be normalised before
      // it is rounded; the row's largest P is exp(0) / l = 1 / l
      m_new = bmax;
      float lsum = 0.f;
      for (int k0 = sb0; k0 < sb1; k0 += BK) {
        __syncthreads();
        load_k(k0, sb1);
        __syncthreads();
        int s32[SPT];
        logits(s32);
#pragma unroll
        for (int c = 0; c < SPT; ++c) {
          if (k0 + t4 + c * TPR < sb1) lsum += expf(logit(s32[c]) - m_new);
        }
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      l = lsum;
      p_max = __fdiv_rn(1.f, l);
    } else {
      m_new = fmaxf(m, bmax);
      p_max = fmaxf(expf(bmax - m_new), 1e-30f);
    }
    const float q127 = __fdiv_rn(127.f, p_max);

    // pass 3: p, its rounding and P.V over the scale block
    int acc8[COLS];
    float accf[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      acc8[c] = 0;
      accf[c] = 0.f;
    }
    float psum = 0.f;
    for (int k0 = sb0; k0 < sb1; k0 += BK) {
      __syncthreads();  // the previous readers of sk, sv are done
      load_k(k0, sb1);
      load_v(k0, sb1);
      __syncthreads();
      int s32[SPT];
      logits(s32);
#pragma unroll
      for (int c = 0; c < SPT; ++c) {
        const int j = t4 + c * TPR;
        const float p = k0 + j < sb1 ? expf(logit(s32[c]) - m_new) : 0.f;
        psum += p;
        const float pn = fused ? __fdiv_rn(p, l) : p;
        if constexpr (PV8) {
          sp8[r * ldp * 4 + j] = (signed char)(int)rintf(__fmul_rn(pn, q127));
        } else {
          spf[r * ldpf + j] = round_to<T>(pn);
        }
      }
      __syncwarp();  // a row's P is written by its 4 threads, all in this warp
      if constexpr (PV8) {
        const int* prow = sp + r * ldp;
#pragma unroll
        for (int jw = 0; jw < KW; ++jw) {
          const int pw = prow[jw];
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int d = t4 + c * TPR;
            if (d < D) acc8[c] = __dp4a(pw, sv[d * ldp + jw], acc8[c]);
          }
        }
      } else {
        const float* prow = spf + r * ldpf;
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
          const float pj = prow[j];
          const float* vrow = svf + j * (D + 1);
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int d = t4 + c * TPR;
            if (d < D) accf[c] = fmaf(pj, vrow[d], accf[c]);
          }
        }
      }
    }

    if (fused) {  // the only block: acc is the output
      const float pscale = __fdiv_rn(p_max, 127.f);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        acc[c] = PV8 ? __fmul_rn(__fmul_rn(__int2float_rn(acc8[c]), pscale), vs) : accf[c];
      }
    } else {
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float alpha = expf(m - m_new);
      l = __fadd_rn(__fmul_rn(l, alpha), psum);
      const float pscale = __fdiv_rn(p_max, 127.f);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float pv = PV8 ? __fmul_rn(__int2float_rn(acc8[c]), pscale) : accf[c];
        acc[c] = __fadd_rn(__fmul_rn(acc[c], alpha), pv);
      }
      m = m_new;
    }
  }

  const int n = q0 + r;
  if (n < N) {
    T* orow = static_cast<T*>(a.o) + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = t4 + c * TPR;
      if (d >= D) continue;
      float out = acc[c];
      if (!fused) {
        out = __fdiv_rn(out, l);
        if (PV8) out = __fmul_rn(out, vs);
      }
      orow[d] = from_float<T>(out);
    }
  }
}

template <typename T, int BQ, int BK, int COLS, bool PV8>
void launch_int8(const Int8Args& a, int B, cudaStream_t stream) {
  auto kernel = flash_int8_kernel<T, BQ, BK, COLS, PV8>;
  const int ldw = (a.D + 3) / 4 + 1;
  const size_t words = (size_t)(BQ + BK) * ldw +
                       (PV8 ? (size_t)(a.D + BQ) * (BK / 4 + 1)
                            : (size_t)BK * (a.D + 1) + (size_t)BQ * (BK + 1));
  const size_t smem = 4 * words;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((unsigned)(B * a.H), (unsigned)((a.N + BQ - 1) / BQ));
  kernel<<<grid, BQ * kInt8ThreadsPerRow, smem, stream>>>(a);
}

template <typename T, int BQ, int BK, bool PV8>
void launch_int8_by_dim(const Int8Args& a, int B, cudaStream_t stream) {
  if (a.D <= 64) {
    launch_int8<T, BQ, BK, 16, PV8>(a, B, stream);
  } else if (a.D <= 96) {
    launch_int8<T, BQ, BK, 24, PV8>(a, B, stream);
  } else {
    launch_int8<T, BQ, BK, 32, PV8>(a, B, stream);
  }
}

template <typename T, bool PV8>
void launch_int8_by_len(const Int8Args& a, int B, cudaStream_t stream) {
  if (a.N <= 32) {
    launch_int8_by_dim<T, 16, 16, PV8>(a, B, stream);
  } else {
    launch_int8_by_dim<T, 64, 32, PV8>(a, B, stream);
  }
}

template <typename T>
void launch_int8_by_mode(const Int8Args& a, int B, int pv_int8, cudaStream_t stream) {
  if (pv_int8) {
    launch_int8_by_len<T, true>(a, B, stream);
  } else {
    launch_int8_by_len<T, false>(a, B, stream);
  }
}

}  // namespace latte

using namespace latte;

// q, k, v: (B, N, H, D) with the element strides `st` (batch, token, head of
// q, then of k, then of v) and a contiguous last axis; sc: contiguous fp32
// (H, 4) of qs, ks, vs and the logit scale; o: contiguous (B, N, H, D).
// scale_block: 0 for the fused core's arithmetic, else the keys of one P
// scale (flash).
extern "C" int latte_flash_attention_int8(int dtype, int pv_int8, const void* q, const void* k,
                                          const void* v, const void* sc, void* o, int B, int N,
                                          int H, int D, int scale_block, const long long* st,
                                          int device, void* stream) {
  if (D < 1 || D > kInt8MaxHeadDim || N < 1 || B < 1 || H < 1 || scale_block < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaSetDevice(device);
  Int8Args a{q, k, v, (const float*)sc, o, N, H, D, scale_block, {}};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) a.st[i][j] = st[3 * i + j];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBFloat16) {
    launch_int8_by_mode<__nv_bfloat16>(a, B, pv_int8, s);
  } else if (dtype == kFloat32) {
    launch_int8_by_mode<float>(a, B, pv_int8, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
