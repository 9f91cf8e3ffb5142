// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the Pallas kernel `_flash_kernel` of latte_tpu/kernels/attention.py
// (launched by `_flash_forward`) for every bf16 call the model makes, in
// place of the bf16 instantiation of flash_fwd_kernel (flash_attention.cu),
// which keeps fp32 and the bf16 layouts this kernel does not take. The route
// is chosen in Python before the launch (`forward_route`,
// latte_tpu_torch/kernels/attention.py): bf16, head_dim 72 (Latte-XL/2's,
// the only one a config serves), base pointers and (batch, token, head)
// strides 16-byte aligned.
//
// Numerics are the TPU kernel's:
//   - q is scaled in fp32 and rounded to bf16;
//   - scores accumulate in fp32 (mma with fp32 accumulators); m and l are fp32;
//   - the unnormalised p = exp(s - m) is rounded to bf16 before P.V, while l
//     sums the unrounded fp32 p; exp is expf, as in flash_attention.cu;
//   - the output is acc / l rounded to bf16, and lse = m + log(l) is written
//     to a (B*H, N) fp32 tensor when asked for.
// P is rounded at each 64-key tile's running maximum, as the TPU kernel does
// at block_k = 64; the plain version rounds it at the row maximum (one block
// of N keys), which differs by at most one bf16 step of p.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16), at Latte-XL/2's
// shapes (head_dim 72; bytes = q, k, v read once and o written once):
//   spatial 256^2      B*H = 256,  N = 256:  37.7 MB, 11.3 us; 4.8 GFLOP, 4.9 us  -> bytes
//   temporal           B*H = 4096, N = 16:   37.7 MB, 11.3 us; 0.3 GFLOP, 0.3 us  -> bytes
//   T2V 512^2 spatial  B*H = 256,  N = 1024: 151 MB,  45 us;  77 GFLOP,  78 us   -> operations
//   batch 5 (mixed-precision trainer): five times the batch-1 numbers.
//
// Two routes, both one warp per 16 query rows, products on the tensor cores
// through mma.sync.m16n8k16 (bf16 in, fp32 accumulate):
//   spatial (N > 64): one block of 4 warps per (batch*head, 64-query tile);
//     K/V stream through shared memory in 64-key tiles, double-buffered, with
//     an online softmax over the tiles.
//   temporal (N <= 64): one warp per (batch*head) sequence, 4 sequences a
//     block; the whole K/V (<= 64 keys) is one tile, so there is no online
//     loop: at N = 16 one 16x16 score tile and one 16x72 output tile. B*H =
//     4096 gives 1024 blocks of 27 KB, one wave at 8 blocks per SM.
// mma.sync rather than wgmma: the main-path calls are bound by bytes, their
// operations bound 2.3x (spatial) to 38x (temporal) below it, so wgmma's
// higher rate is not what they lack; a 16-row warp tile needs no 64-row
// warpgroup tile, no descriptor-laid shared memory and no padding of the
// 72-wide rows to a swizzle atom. PERF.md records how far from the bound
// each shape runs, and why.
//
// What the design does about the CUDA-core kernel's limits:
//   1. tensor cores: QK^T over head_dim 72 = four k16 steps plus one
//      m16n8k8 step on columns 64-71 (nothing past column 72 is read or
//      written); P.V as 72 = 9 n8 tiles, a 16x72 fp32 accumulator of 36
//      registers a thread.
//   2. K, V and q stay bf16 in shared memory. Rows keep their 144-byte
//      pitch: 9 16-byte chunks, an odd number, so the 8 rows an ldmatrix 8x8
//      matrix reads start 36 words apart (4 banks mod 32) and fall on 8
//      distinct groups of 4 banks: no conflicts without padding.
//   3. every load is a 16-byte cp.async, the next K/V tile's copy in flight
//      while the current one is computed; rows past N are zero-filled
//      (src-size 0) and never read from device memory.
//   4. P never touches shared memory: the C fragments of two n8 score tiles
//      are, converted to bf16 pairs, the A fragment of one k16 step of P.V.
//      Row max and row sum take two shfl_xor among the 4 threads of a row.
//   5. tiles of 64 queries x 64 keys: 76 mma per warp per K/V tile against
//      one barrier pair and one 18 KB copy.
// Fragments come from ldmatrix (K), ldmatrix.trans (V) and ldmatrix (the Q
// tile, scaled and rounded once into registers). Keys past N are masked to
// -inf; m starts at -1e30 so a padded query row never computes
// exp(-inf - -inf); queries past N are not stored. The output tile is
// staged in the warp's own Q rows of shared memory and written with 16-byte
// stores. The fragment helpers, loads and products it shares with the
// backward (flash_attention_bwd_tc.cu) are in mma_bf16.cuh.

#include "mma_bf16.cuh"

namespace latte {
namespace tc {

constexpr int kWarps = 4;        // warps of a block, on both routes
constexpr int kTile = 64;        // spatial: queries of a block, keys of a K/V tile
constexpr int kMaxShortN = 64;   // the temporal route takes N <= 64

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;     // contiguous (B, N, H, D)
  float* lse;  // contiguous (B*H, N), or null
  int BH, N, H;
  long long sq[3], sk[3], sv[3];  // element strides (batch, token, head)
  float scale;
};

// Online-softmax update of rows g (index 0) and g+8 (index 1) over one key
// tile of NT8 n8 score tiles: rescales acc by exp(m - m'), adds the tile's
// fp32 p to l, and returns p rounded to bf16 as the A fragments of P.V.
template <int NT8>
__device__ __forceinline__ void softmax_tile(float (&s)[NT8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[kChunks][4], uint32_t (&pa)[NT8 / 2][4]) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = expf(s[j][i] - m[i >> 1]);
      psum[i >> 1] += s[j][i];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
    l[i] = l[i] * alpha[i] + psum[i];
  }
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
  // the C layout of score tiles 2j, 2j+1 is the A layout of k16 step j
#pragma unroll
  for (int j = 0; j < NT8 / 2; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// Write the warp's 16 rows acc / l (rows q0.. of sequence bh) through its
// staging rows so (free once its Q fragments are in registers), and their
// lse.
__device__ __forceinline__ void store_rows(const Args& a, int bh, int q0, bf16* so,
                                           const float (&acc)[kChunks][4], const float (&m)[2],
                                           const float (&l)[2], int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * kD + n * 8 + t2) =
        pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kD + n * 8 + t2) =
        pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  __syncwarp();
  const int b = bh / a.H, h = bh - b * a.H;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks, n = q0 + r;
    if (n < a.N) {
      *reinterpret_cast<uint4*>(a.o + (((long long)b * a.N + n) * a.H + h) * kD + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * kD + c * 8);
    }
  }
  if (a.lse != nullptr && (lane & 3) == 0) {
    float* row = a.lse + (long long)bh * a.N + q0;
    if (q0 + g < a.N) row[g] = m[0] + logf(l[0]);
    if (q0 + g + 8 < a.N) row[g + 8] = m[1] + logf(l[1]);
  }
}

// Spatial route (N > 64): block = (batch*head, 64-query tile), 4 warps of
// 16 rows; K/V in 64-key tiles, double-buffered.
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_tc_kernel(const Args a) {
  constexpr int THREADS = kWarps * 32, NT8 = kTile / 8;
  __shared__ __align__(16) bf16 sq[kTile * kD];
  __shared__ __align__(16) bf16 skv[2][2][kTile * kD];  // [stage][K, V]

  const int nqt = (a.N + kTile - 1) / kTile;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = seq_base(a.q, a.sq, bh, a.H);
  const bf16* kb = seq_base(a.k, a.sk, bh, a.H);
  const bf16* vb = seq_base(a.v, a.sv, bh, a.H);

  load_rows<kTile, THREADS>(sq, qb, a.sq[1], q0, a.N, tid);
  cp_async_commit();
  load_rows<kTile, THREADS>(skv[0][0], kb, a.sk[1], 0, a.N, tid);
  load_rows<kTile, THREADS>(skv[0][1], vb, a.sv[1], 0, a.N, tid);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile
  __syncthreads();
  bf16* sq_warp = sq + warp * 16 * kD;
  QFrags qf;
  load_q(sq_warp, qf, a.scale, lane);

  float acc[kChunks][4];
#pragma unroll
  for (int n = 0; n < kChunks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  const int nkt = (a.N + kTile - 1) / kTile;
  for (int it = 0; it < nkt; ++it) {
    if (it + 1 < nkt) {
      const int k0 = (it + 1) * kTile, st = (it + 1) & 1;
      load_rows<kTile, THREADS>(skv[st][0], kb, a.sk[1], k0, a.N, tid);
      load_rows<kTile, THREADS>(skv[st][1], vb, a.sv[1], k0, a.N, tid);
    }
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    float s[NT8][4];
    qk_scores<NT8>(qf, skv[it & 1][0], s, lane);
    if ((it + 1) * kTile > a.N) mask_keys<NT8>(s, it * kTile, a.N, lane);
    uint32_t pa[NT8 / 2][4];
    softmax_tile<NT8>(s, m, l, acc, pa);
    pv_product<NT8 / 2>(pa, skv[it & 1][1], acc, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows(a, bh, q0 + warp * 16, sq_warp, acc, m, l, lane);
}

// Temporal route (N <= 64): one warp per (batch*head) sequence, kWarps
// sequences a block; K/V of up to 64 keys (KS k16 steps) in one tile.
template <int KS>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_tc_short_kernel(const Args a) {
  constexpr int ROWS = KS * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kWarps + warp;
  if (bh >= a.BH) return;  // no block-wide barrier follows
  bf16* sq = reinterpret_cast<bf16*>(smem) + warp * 3 * ROWS * kD;
  bf16* sk = sq + ROWS * kD;
  bf16* sv = sk + ROWS * kD;
  load_rows<ROWS, 32>(sq, seq_base(a.q, a.sq, bh, a.H), a.sq[1], 0, a.N, lane);
  load_rows<ROWS, 32>(sk, seq_base(a.k, a.sk, bh, a.H), a.sk[1], 0, a.N, lane);
  load_rows<ROWS, 32>(sv, seq_base(a.v, a.sv, bh, a.H), a.sv[1], 0, a.N, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  for (int q0 = 0; q0 < a.N; q0 += 16) {
    QFrags qf;
    load_q(sq + q0 * kD, qf, a.scale, lane);
    float s[2 * KS][4];
    qk_scores<2 * KS>(qf, sk, s, lane);
    if (ROWS > a.N) mask_keys<2 * KS>(s, 0, a.N, lane);
    float acc[kChunks][4];
#pragma unroll
    for (int n = 0; n < kChunks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    uint32_t pa[KS][4];
    softmax_tile<2 * KS>(s, m, l, acc, pa);
    pv_product<KS>(pa, sv, acc, lane);
    store_rows(a, bh, q0, sq + q0 * kD, acc, m, l, lane);
  }
}

template <int KS>
cudaError_t launch_short(const Args& a, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_short_kernel<KS>;
  const size_t smem = sizeof(bf16) * kWarps * 3 * KS * 16 * kD;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(a.BH + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.N > kMaxShortN) {
    const long long blocks = (long long)a.BH * ((a.N + kTile - 1) / kTile);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    flash_fwd_tc_kernel<<<(unsigned)blocks, kWarps * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
  switch ((a.N + 15) / 16) {
    case 1: return launch_short<1>(a, stream);
    case 2: return launch_short<2>(a, stream);
    case 3: return launch_short<3>(a, stream);
    default: return launch_short<4>(a, stream);
  }
}

}  // namespace tc
}  // namespace latte

using namespace latte;

// bf16 only. strides: the 9 element strides (batch, token, head) of q, k and
// v, each 16-byte aligned, as are the base pointers; the last axis of each
// is contiguous. o is a contiguous (B, N, H, D) tensor; lse a contiguous
// fp32 (B*H, N) tensor or null. D must be 72.
extern "C" int latte_flash_attention_fwd_tc(const void* q, const void* k, const void* v,
                                            void* o, void* lse, int B, int N, int H, int D,
                                            long long sqb, long long sqn, long long sqh,
                                            long long skb, long long skn, long long skh,
                                            long long svb, long long svn, long long svh,
                                            float scale, int device, void* stream) {
  if (N < 1 || B < 1 || H < 1 || D != tc::kD) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const tc::Args a{(const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v, (tc::bf16*)o,
                   (float*)lse, B * H, N, H, {sqb, sqn, sqh}, {skb, skn, skh}, {svb, svn, svh},
                   scale};
  return (int)tc::launch(a, (cudaStream_t)stream);
}
