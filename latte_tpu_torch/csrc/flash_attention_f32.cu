// Flash-attention forward in fp32 on Hopper's CUDA cores (sm_90a),
// register-tiled.
//
// Replaces the Pallas kernel `_flash_kernel` of latte_tpu/kernels/attention.py
// (launched by `_flash_forward`) for every fp32 call the model makes, in place
// of the fp32 instantiation of flash_attention.cu, which keeps fp32 at other
// head dims and layouts. The route is chosen in Python before the launch
// (`forward_route`, latte_tpu_torch/kernels/attention.py): fp32, head_dim 72,
// base pointers and (batch, token, head) strides of q, k, v 16-byte aligned.
//
// Arithmetic, all fp32 and on the CUDA cores (FFMA, no TF32): the TPU
// kernel's with its casts the identity,
//   qs = q * scale,  s = qs k^T,  per K/V tile: m' = max(m, rowmax(s)),
//   p = exp(s - m'), l = l exp(m - m') + rowsum(p), acc = acc exp(m - m') + p v
//   out = acc / l,  lse = m + log(l)
// with expf, m starting at -1e30. Only the order of the fp32 sums differs
// from the plain version (attention_reference, one block of N keys).
//
// Bound (H100 SXM: 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s), at the
// shipped fp32 trainer's batch 5 (head_dim 72; 4 * B*H*N^2*D FLOP; q, k, v
// read and o written once):
//   spatial  B*H = 1280,  N = 256: 24.2 GFLOP, 0.361 ms; 377 MB, 0.113 ms -> operations
//   temporal B*H = 20480, N = 16:  1.5 GFLOP, 0.023 ms; 377 MB, 0.113 ms  -> bytes
//
// flash_attention.cu, its first version, reads one shared word per FFMA (four
// threads to a query row), which caps it near a quarter of the FMA rate. Here
// a thread owns a block of rows x columns of both products (f32_tiles.cuh,
// the design of the fp32 dQ kernel, which has the same shape of work: Q
// stays, K and V stream):
//   - scores: S = qs K^T with 8 query rows x 4 keys a thread, 12 LDS.128 for
//     128 FFMA per 4 head_dim values;
//   - online softmax: a row's 64 scores of a tile lie on the 16 threads of a
//     half-warp; its maximum and sum take four shuffles each, then the row's
//     output is rescaled by exp(m - m');
//   - P.V: p goes through shared memory (the half-warp that wrote a row reads
//     it: a __syncwarp), out += P V with the 8 x 4 output tile and the split
//     tail columns 64-71.
//   spatial (N > 64): block = (batch*head, 128 queries), 256 threads; K and V
//     in 64-key tiles by 16-byte cp.async, double-buffered. 148 KB of shared
//     memory, one block an SM.
//   temporal (N <= 64): the same tile code at 4 rows a thread over all 16M
//     rows of a sequence (M = ceil(N / 16)), 64M threads a sequence, the whole
//     sequence in shared memory and several sequences a block (4 at N <= 16);
//     every load in flight at once.
// Keys past N are masked to p = 0; rows past N are zero-filled and never
// stored.

#include <math_constants.h>

#include "f32_tiles.cuh"

namespace latte {
namespace f32 {

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;     // contiguous (B, N, H, D)
  float* lse;   // contiguous (B*H, N), or null
  int BH, N, H;
  long long st[3][3];  // element strides (batch, token, head) of q, k, v
  float scale;
};

__device__ __forceinline__ const float* fwd_seq(const FwdArgs& a, const float* x, int o, int bh) {
  const int b = bh / a.H, h = bh - b * a.H;
  return x + b * a.st[o][0] + h * a.st[o][2];
}

// The 16 threads of a half-warp hold one row: all of them get its max / sum.
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One K/V tile of the online softmax for rows RPT*ty.. of sq (qs): keys
// key0 .. key0+16M-1 in sk, sv (past N masked); p through sp (pitch 16M + 4).
template <int RPT, int M>
__device__ __forceinline__ void fwd_tile(const float* sq, const float* sk, const float* sv,
                                         float* sp, int key0, int N, float (&m)[RPT],
                                         float (&l)[RPT], OutTile<RPT>& out, int ty, int tx) {
  constexpr int LDS = 16 * M + 4;
  float s[RPT][M];
  row_products<RPT, M>(sq, sk, s, ty, tx);
  float alpha[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      if (key0 + tx + 16 * c >= N) s[i][c] = -CUDART_INF_F;
      mx = fmaxf(mx, s[i][c]);
    }
    const float m_new = fmaxf(m[i], row_max16(mx));
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const float p = expf(s[i][c] - m_new);
      psum += p;
      sp[(RPT * ty + i) * LDS + tx + 16 * c] = p;
    }
    l[i] = l[i] * alpha[i] + row_sum16(psum);
  }
  out.rescale(alpha, tx);
  __syncwarp();  // a row's p is written by the 16 threads of its half-warp
  out.template add<16 * M>(sp, LDS, sv, ty, tx);
}

// out = acc / l into rows row0 + RPT*ty.. of sequence bh, and their lse.
template <int RPT>
__device__ __forceinline__ void fwd_store(const FwdArgs& a, int bh, int row0, OutTile<RPT>& out,
                                          const float (&m)[RPT], const float (&l)[RPT], int ty,
                                          int tx) {
  float inv[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) inv[i] = 1.f / l[i];
  out.rescale(inv, tx);
  const int b = bh / a.H, h = bh - b * a.H;
  out.store(a.o + ((long long)b * a.N * a.H + h) * kD, (long long)a.H * kD, row0, a.N, 1.f, ty,
            tx);
  if (a.lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + RPT * ty + i;
      if (r < a.N) a.lse[(long long)bh * a.N + r] = m[i] + logf(l[i]);
    }
  }
}

// Spatial (N > 64): block = (batch*head, 128-query tile), 8 query rows a
// thread; K/V in 64-key tiles, double-buffered. Shared memory: qs,
// [stage][K, V], p.
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_f32_kernel(const FwdArgs a) {
  constexpr int T = kTile, O = 16 * kRows, LDS = T + 4;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* skv = sq + O * kLd;
  float* sp = skv + 4 * T * kLd;

  const int nqt = (a.N + O - 1) / O;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * O;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* kb = fwd_seq(a, a.k, 1, bh);
  const float* vb = fwd_seq(a, a.v, 2, bh);

  load_rows<O, kThreads>(sq, fwd_seq(a, a.q, 0, bh), a.st[0][1], q0, a.N, tid);
  cp_async_commit();
  load_rows<T, kThreads>(skv, kb, a.st[1][1], 0, a.N, tid);
  load_rows<T, kThreads>(skv + T * kLd, vb, a.st[2][1], 0, a.N, tid);
  cp_async_commit();
  cp_async_wait<1>();  // q
  scale_rows<O, kThreads>(sq, a.scale, tid);

  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  OutTile<kRows> out;
  out.zero();
  const int nkt = (a.N + T - 1) / T;
  for (int it = 0; it < nkt; ++it) {
    if (it + 1 < nkt) {
      float* st = skv + ((it + 1) & 1) * 2 * T * kLd;
      load_rows<T, kThreads>(st, kb, a.st[1][1], (it + 1) * T, a.N, tid);
      load_rows<T, kThreads>(st + T * kLd, vb, a.st[2][1], (it + 1) * T, a.N, tid);
    }
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();     // (first pass: and every thread's qs is scaled)
    const float* sk = skv + (it & 1) * 2 * T * kLd;
    fwd_tile<kRows, T / 16>(sq, sk, sk + T * kLd, sp, it * T, a.N, m, l, out, ty, tx);
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  fwd_store<kRows>(a, bh, q0, out, m, l, ty, tx);
}

// The temporal route's geometry at M = ceil(N / 16): R rows a sequence, 4R
// threads a sequence (a thread owns 4 rows), G sequences a block; shared
// floats a sequence: q, K, V rows, then p.
template <int M>
struct FwdShort {
  static constexpr int R = 16 * M;
  static constexpr int THREADS = 4 * R;
  static constexpr int G = M == 3 ? 1 : 4 / M;
  static constexpr int FLOATS = 3 * R * kLd + R * (R + 4);
};

// Temporal (N <= 64): one thread group per (batch*head) sequence, its q, K,
// V whole in shared memory, one tile.
template <int M>
__global__ void __launch_bounds__(FwdShort<M>::G * FwdShort<M>::THREADS, 2)
    flash_fwd_f32_short_kernel(const FwdArgs a) {
  using S = FwdShort<M>;
  constexpr int R = S::R, GT = S::THREADS;
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / GT, t = threadIdx.x - g * GT, ty = t >> 4, tx = t & 15;
  const int bh = blockIdx.x * S::G + g;
  const bool live = bh < a.BH;
  float* sq = smem + g * S::FLOATS;
  float* sk = sq + R * kLd;
  float* sv = sk + R * kLd;
  float* sp = sv + R * kLd;
  if (live) {
    load_rows<R, GT>(sq, fwd_seq(a, a.q, 0, bh), a.st[0][1], 0, a.N, t);
    load_rows<R, GT>(sk, fwd_seq(a, a.k, 1, bh), a.st[1][1], 0, a.N, t);
    load_rows<R, GT>(sv, fwd_seq(a, a.v, 2, bh), a.st[2][1], 0, a.N, t);
  }
  cp_async_commit();
  cp_async_wait<0>();
  scale_rows<R, GT>(sq, a.scale, t);
  __syncthreads();
  if (!live) return;  // no block-wide barrier follows
  float m[4] = {-1e30f, -1e30f, -1e30f, -1e30f}, l[4] = {0.f, 0.f, 0.f, 0.f};
  OutTile<4> out;
  out.zero();
  fwd_tile<4, M>(sq, sk, sv, sp, 0, a.N, m, l, out, ty, tx);
  fwd_store<4>(a, bh, 0, out, m, l, ty, tx);
}

template <typename Kernel>
cudaError_t launch_fwd(Kernel kernel, long long blocks, int threads, size_t smem,
                       const FwdArgs& a, cudaStream_t stream) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_fwd_short(const FwdArgs& a, cudaStream_t stream) {
  using S = FwdShort<M>;
  return launch_fwd(flash_fwd_f32_short_kernel<M>, (a.BH + S::G - 1) / S::G, S::G * S::THREADS,
                    sizeof(float) * S::G * S::FLOATS, a, stream);
}

cudaError_t launch_fwd_f32(const FwdArgs& a, cudaStream_t stream) {
  if (a.N > kMaxShortN) {
    constexpr int T = kTile, O = 16 * kRows;
    return launch_fwd(flash_fwd_f32_kernel, (long long)a.BH * ((a.N + O - 1) / O), kThreads,
                      sizeof(float) * (O * kLd + 4 * T * kLd + O * (T + 4)), a, stream);
  }
  switch ((a.N + 15) / 16) {
    case 1: return launch_fwd_short<1>(a, stream);
    case 2: return launch_fwd_short<2>(a, stream);
    case 3: return launch_fwd_short<3>(a, stream);
    default: return launch_fwd_short<4>(a, stream);
  }
}

}  // namespace f32
}  // namespace latte

// The arguments of latte_flash_attention_fwd_tc (flash_attention_tc.cu), in
// fp32: strides are the 9 element strides (batch, token, head) of q, k and v,
// each 16-byte aligned, as are the base pointers; the last axis of each is
// contiguous. o is a contiguous (B, N, H, D) tensor; lse a contiguous fp32
// (B*H, N) tensor or null. D must be 72.
extern "C" int latte_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int B, int N, int H, int D,
                                             long long sqb, long long sqn, long long sqh,
                                             long long skb, long long skn, long long skh,
                                             long long svb, long long svn, long long svh,
                                             float scale, int device, void* stream) {
  using namespace latte::f32;
  if (N < 1 || B < 1 || H < 1 || D != kD) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const FwdArgs a{(const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse,
                  B * H, N, H, {{sqb, sqn, sqh}, {skb, skn, skh}, {svb, svn, svh}}, scale};
  return (int)launch_fwd_f32(a, (cudaStream_t)stream);
}
