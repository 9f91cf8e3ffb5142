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
// write out (and y): 2 (4) * B*N*D elements, at 3.35 TB/s on the H100 SXM
// (the sampler's bf16 call, 4096 rows of 1152: 5.6 us, 11.3 us with the
// residual). The arithmetic (~10 flops per element) is far below the
// card's rate, so the kernels live or die by the bytes they keep in flight.
//
// Two routes (kernels/adaln.py `adaln_route` picks one before the launch):
//
// * vector (`*_vec_kernel`): D in {384, 768, 1024, 1152} (the registry's
//   widths) as a template parameter, every pointer aligned to 4 elements,
//   vec_stride a multiple of 4. One warp owns a row and holds it in
//   registers: lane l holds D/128 chunks of 4 consecutive elements, chunk j
//   at columns 128 j + 4 l .. + 3, so each warp-wide access is one
//   contiguous 256 B (bf16, 8-byte loads) or 512 B (fp32, 16-byte loads)
//   segment. Every chunk of x (and delta, and gate) is issued before the
//   first reduction: at D = 1152 a warp has 2.3 KB (bf16 ln_modulate) to
//   9.2 KB (fp32 residual) in flight. In bf16 the D = 1152 kernels take 60
//   registers, so all 4096 rows of the sampler's call are resident at once
//   (132 SMs x 32 warps) and the whole activation is requested in the
//   kernel's first microseconds; no grid-stride loop. shift and scale are
//   read through L1 after the statistics, where their latency hides behind
//   the two butterfly reductions (consecutive rows share them: 256
//   spatially, 16 temporally). No shared memory. Chosen by measurement on
//   the card (PERF.md, Findings): loading shift and scale with x was no faster
//   at the sampler's shapes and costs ~90 registers; holding them in
//   registers across R rows of a warp, and persistent warps that load their
//   next row during the reductions, were slower; a 64-register cap with
//   the early loads spills. The kernels run within ~10% of a plain copy of
//   the same activation bytes.
// * generic (`ln_modulate_kernel`, `residual_ln_modulate_kernel`, the first
//   versions): any D up to MAX_DIM and any layout. One warp
//   per row, eight rows per block, scalar loads; the row's fp32 copy sits in
//   shared memory for the variance and output passes.

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


// ---- the vector route ----

constexpr int kVecWarps = 4;  // rows (warps) per 128-thread block

// Four consecutive elements of T as one vector access, unpacked to fp32.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using V = float4;
  __device__ static __forceinline__ V load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static __forceinline__ void store(float* p, V v) { *reinterpret_cast<float4*>(p) = v; }
  __device__ static __forceinline__ void unpack(V v, float (&f)[4]) {
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static __forceinline__ V pack(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using V = uint2;  // element 0 in the low half of .x, as in memory
  __device__ static __forceinline__ V load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, V v) {
    *reinterpret_cast<uint2*>(p) = v;
  }
  __device__ static __forceinline__ void unpack(V v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x << 16), f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16), f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  // round to nearest even, as from_float
  __device__ static __forceinline__ V pack(const float (&f)[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]), hi = __floats2bfloat162_rn(f[2], f[3]);
    return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
};

// A row of D elements spread over a warp: chunk j of lane l holds columns
// 128 j + 4 l .. + 3. `p` points at the lane's first column.
template <typename T, int D>
struct WarpRow {
  static constexpr int kChunks = D / 128;
  using Q = Quad<T>;
  typename Q::V v[kChunks];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) v[j] = Q::load(p + 128 * j);
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) Q::store(p + 128 * j, v[j]);
  }
  // fp32 mean and 1/std of the row, the two-pass variance, on every lane
  __device__ __forceinline__ void stats(float eps, float& mu, float& rstd) const {
    float s = 0.f, ss = 0.f, f[4];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      Q::unpack(v[j], f);
#pragma unroll
      for (int i = 0; i < 4; ++i) s += f[i];
    }
    mu = warp_sum(s) / D;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      Q::unpack(v[j], f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c = f[i] - mu;
        ss += c * c;
      }
    }
    rstd = rsqrtf(warp_sum(ss) / D + eps);
  }
  // out = (row - mu) * rstd * (1 + scale) + shift, stored chunk by chunk;
  // shift and scale are read here, through L1
  __device__ __forceinline__ void modulate_store(float mu, float rstd, const T* sh, const T* sc,
                                                 T* out) const {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      float f[4], b[4], a[4], o[4];
      Q::unpack(v[j], f);
      Q::unpack(Q::load(sh + 128 * j), b);
      Q::unpack(Q::load(sc + 128 * j), a);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = (f[i] - mu) * rstd * (1.f + a[i]) + b[i];
      Q::store(out + 128 * j, Q::pack(o));
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kVecWarps * 32)
ln_modulate_vec_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                       const T* __restrict__ scale, T* __restrict__ out, int rows, int N,
                       long long vec_stride, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kVecWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long at = (long long)row * D + 4 * lane;
  const long long vat = (long long)(row / N) * vec_stride + 4 * lane;
  WarpRow<T, D> r;
  r.load(x + at);
  float mu, rstd;
  r.stats(eps, mu, rstd);
  r.modulate_store(mu, rstd, shift + vat, scale + vat, out + at);
}

template <typename T, int D>
__global__ void __launch_bounds__(kVecWarps * 32)
residual_ln_modulate_vec_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                                const T* __restrict__ gate, const T* __restrict__ shift,
                                const T* __restrict__ scale, T* __restrict__ y,
                                T* __restrict__ out, int rows, int N, long long vec_stride,
                                float eps) {
  using Q = Quad<T>;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kVecWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long at = (long long)row * D + 4 * lane;
  const long long vat = (long long)(row / N) * vec_stride + 4 * lane;
  WarpRow<T, D> r, d, g;
  r.load(x + at);
  d.load(delta + at);
  g.load(gate + vat);
  // the carry, rounded to T before the statistics as the unfused block
  // stores it; __fmul_rn/__fadd_rn keep nvcc from contracting to an FMA, so
  // the fp32 sum is rounded as the plain version rounds it
#pragma unroll
  for (int j = 0; j < WarpRow<T, D>::kChunks; ++j) {
    float xf[4], df[4], gf[4];
    Q::unpack(r.v[j], xf);
    Q::unpack(d.v[j], df);
    Q::unpack(g.v[j], gf);
#pragma unroll
    for (int i = 0; i < 4; ++i) xf[i] = __fadd_rn(xf[i], __fmul_rn(gf[i], df[i]));
    r.v[j] = Q::pack(xf);
  }
  r.store(y + at);
  float mu, rstd;
  r.stats(eps, mu, rstd);
  r.modulate_store(mu, rstd, shift + vat, scale + vat, out + at);
}

// The vector kernels' operands; delta == nullptr selects ln_modulate.
struct VecArgs {
  const void *x, *delta, *gate, *shift, *scale;
  void *y, *out;
  int rows, N;
  long long vec_stride;
  float eps;
};

template <typename T, int D>
void launch_vec(const VecArgs& a, cudaStream_t st) {
  const dim3 grid((unsigned)((a.rows + kVecWarps - 1) / kVecWarps));
  if (a.delta == nullptr) {
    ln_modulate_vec_kernel<T, D><<<grid, kVecWarps * 32, 0, st>>>(
        (const T*)a.x, (const T*)a.shift, (const T*)a.scale, (T*)a.out, a.rows, a.N,
        a.vec_stride, a.eps);
  } else {
    residual_ln_modulate_vec_kernel<T, D><<<grid, kVecWarps * 32, 0, st>>>(
        (const T*)a.x, (const T*)a.delta, (const T*)a.gate, (const T*)a.shift,
        (const T*)a.scale, (T*)a.y, (T*)a.out, a.rows, a.N, a.vec_stride, a.eps);
  }
}

// Launch the vector kernel for (T, D): D must be one of the registry's widths.
template <typename T>
int dispatch_vec(int D, const VecArgs& a, cudaStream_t st) {
  switch (D) {
    case 384: launch_vec<T, 384>(a, st); break;
    case 768: launch_vec<T, 768>(a, st); break;
    case 1024: launch_vec<T, 1024>(a, st); break;
    case 1152: launch_vec<T, 1152>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int vec_entry(int dtype, int D, const VecArgs& a, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kBFloat16) return dispatch_vec<__nv_bfloat16>(D, a, st);
  if (dtype == kFloat32) return dispatch_vec<float>(D, a, st);
  return (int)cudaErrorInvalidValue;
}

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

// The vector route: the same arguments as the generic entry points; D must
// be 384, 768, 1024 or 1152 and the layout as `adaln_route` requires.
extern "C" int latte_ln_modulate_vec(int dtype, const void* x, const void* shift,
                                     const void* scale, void* out, int B, int N, int D,
                                     long long vec_stride, float eps, int device, void* stream) {
  const VecArgs a{x, nullptr, nullptr, shift, scale, nullptr, out, B * N, N, vec_stride, eps};
  return vec_entry(dtype, D, a, device, stream);
}

extern "C" int latte_residual_ln_modulate_vec(int dtype, const void* x, const void* delta,
                                              const void* gate, const void* shift,
                                              const void* scale, void* y, void* out, int B,
                                              int N, int D, long long vec_stride, float eps,
                                              int device, void* stream) {
  const VecArgs a{x, delta, gate, shift, scale, y, out, B * N, N, vec_stride, eps};
  return vec_entry(dtype, D, a, device, stream);
}
