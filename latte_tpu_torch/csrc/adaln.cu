// Fused adaLN glue kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels `_ln_mod_kernel` and `_res_ln_mod_kernel` of
// latte_tpu/kernels/adaln.py:
//
//   ln_modulate:           out = LN(x) * (1 + scale) + shift
//   residual_ln_modulate:  y   = round(x + gate * delta)      (stored, returned)
//                          out = LN(y) * (1 + scale) + shift
//
// LN has no affine terms, eps 1e-6, fp32 statistics with the two-pass
// variance E[(x - mu)^2]. x, delta, y, out are (B, N, D) contiguous;
// shift, scale, gate are (B, D) rows at a row stride `vec_stride` (so the
// model can pass the column chunks of its adaLN modulation without a copy)
// and broadcast over N.
//
// Bound: pure streaming. Per call the kernel must read x (and delta) and
// write out (and y): 2 (4) * B*N*D elements, at 3.35 TB/s on the H100 SXM.
// The arithmetic (~10 flops per element) is far below the card's rate.
//
// Design: one warp per row of D, eight rows per 256-thread block. A row is
// read from device memory once; its fp32 copy stays in shared memory for
// the second (variance) pass and the output pass, so the two-pass variance
// costs no second read of device memory.

#include "common.cuh"

namespace latte {

constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_modulate_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                   const T* __restrict__ scale, T* __restrict__ out, long long rows,
                   int N, int D, long long vec_stride, float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  float* buf = smem + (size_t)warp * D;
  const T* xr = x + row * D;

  float s = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_float(xr[i]);
    buf[i] = v;
    s += v;
  }
  const float mu = warp_sum(s) / D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float c = buf[i] - mu;
    ss += c * c;
  }
  const float rstd = rsqrtf(warp_sum(ss) / D + eps);

  const long long b = row / N;
  const T* sh = shift + b * vec_stride;
  const T* sc = scale + b * vec_stride;
  T* o = out + row * D;
  for (int i = lane; i < D; i += 32) {
    const float norm = (buf[i] - mu) * rstd;
    o[i] = from_float<T>(norm * (1.f + to_float(sc[i])) + to_float(sh[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
residual_ln_modulate_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                            const T* __restrict__ gate, const T* __restrict__ shift,
                            const T* __restrict__ scale, T* __restrict__ y,
                            T* __restrict__ out, long long rows, int N, int D,
                            long long vec_stride, float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  float* buf = smem + (size_t)warp * D;
  const long long b = row / N;
  const T* xr = x + row * D;
  const T* dr = delta + row * D;
  const T* g = gate + b * vec_stride;
  T* yr = y + row * D;

  // The carry is rounded to the storage type before the LN statistics,
  // exactly as the unfused block stores it (latte_tpu/kernels/adaln.py:63-70).
  float s = 0.f;
  for (int i = lane; i < D; i += 32) {
    // __fmul_rn/__fadd_rn keep nvcc from contracting to an FMA, so the fp32
    // sum is rounded as the plain version rounds it.
    const T stored =
        from_float<T>(__fadd_rn(to_float(xr[i]), __fmul_rn(to_float(g[i]), to_float(dr[i]))));
    yr[i] = stored;
    const float v = to_float(stored);
    buf[i] = v;
    s += v;
  }
  const float mu = warp_sum(s) / D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float c = buf[i] - mu;
    ss += c * c;
  }
  const float rstd = rsqrtf(warp_sum(ss) / D + eps);

  const T* sh = shift + b * vec_stride;
  const T* sc = scale + b * vec_stride;
  T* o = out + row * D;
  for (int i = lane; i < D; i += 32) {
    const float norm = (buf[i] - mu) * rstd;
    o[i] = from_float<T>(norm * (1.f + to_float(sc[i])) + to_float(sh[i]));
  }
}

inline dim3 row_grid(long long rows) {
  return dim3((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

inline size_t row_smem(int D) { return (size_t)kRowsPerBlock * D * sizeof(float); }

}  // namespace latte

using namespace latte;

extern "C" int latte_ln_modulate(int dtype, const void* x, const void* shift,
                                 const void* scale, void* out, int B, int N, int D,
                                 long long vec_stride, float eps, int device,
                                 void* stream) {
  cudaSetDevice(device);
  const long long rows = (long long)B * N;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kBFloat16) {
    ln_modulate_kernel<__nv_bfloat16><<<row_grid(rows), kRowsPerBlock * 32, row_smem(D), st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)shift, (const __nv_bfloat16*)scale,
        (__nv_bfloat16*)out, rows, N, D, vec_stride, eps);
  } else if (dtype == kFloat32) {
    ln_modulate_kernel<float><<<row_grid(rows), kRowsPerBlock * 32, row_smem(D), st>>>(
        (const float*)x, (const float*)shift, (const float*)scale, (float*)out, rows, N, D,
        vec_stride, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int latte_residual_ln_modulate(int dtype, const void* x, const void* delta,
                                          const void* gate, const void* shift,
                                          const void* scale, void* y, void* out, int B,
                                          int N, int D, long long vec_stride, float eps,
                                          int device, void* stream) {
  cudaSetDevice(device);
  const long long rows = (long long)B * N;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    residual_ln_modulate_kernel<T><<<row_grid(rows), kRowsPerBlock * 32, row_smem(D), st>>>(
        (const T*)x, (const T*)delta, (const T*)gate, (const T*)shift, (const T*)scale,
        (T*)y, (T*)out, rows, N, D, vec_stride, eps);
  } else if (dtype == kFloat32) {
    residual_ln_modulate_kernel<float><<<row_grid(rows), kRowsPerBlock * 32, row_smem(D), st>>>(
        (const float*)x, (const float*)delta, (const float*)gate, (const float*)shift,
        (const float*)scale, (float*)y, (float*)out, rows, N, D, vec_stride, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
