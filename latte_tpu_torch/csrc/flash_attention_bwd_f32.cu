// Flash-attention backward in fp32 on Hopper's CUDA cores (sm_90a): dQ and
// dK/dV, register-tiled.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of latte_tpu/kernels/attention.py (launched by
// `_flash_backward`) for every fp32 call the model makes, in place of the
// fp32 instantiations of flash_attention_bwd.cu, which keep fp32 at other
// head dims and layouts, and the bf16 layouts flash_attention_bwd_tc.cu does
// not take. The route is chosen in Python before the launch
// (`backward_route`, latte_tpu_torch/kernels/attention.py): fp32, head_dim
// 72, base pointers and (batch, token, head) strides of q, k, v, dO and the
// written gradients 16-byte aligned.
//
// Arithmetic, all fp32 and on the CUDA cores (FFMA, no TF32): the TPU
// kernels' with their casts the identity,
//   qs = q * scale,  p = exp(qs k^T - lse),  ds = p * (dO v^T - delta)
//   dq = scale * ds k,  dk = ds^T qs,  dv = p^T dO
// delta = rowsum(dO * O) comes in. Each kernel recomputes S and dP, as the
// TPU design does; two kernels and no atomics. Only the order of the fp32
// sums differs from the plain versions (attention_bwd_dq_reference,
// attention_bwd_dkv_reference).
//
// Bound (H100 SXM: 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s), at the
// shipped fp32 trainer's batch 5 (head_dim 72; 6 and 8 * B*H*N^2*D FLOP):
//   spatial  B*H = 1280,  N = 256: dQ 36.2 GFLOP, 0.541 ms; dK/dV 48.3 GFLOP,
//                                  0.721 ms -> operations (bytes: 0.03-0.04 ms)
//   temporal B*H = 20480, N = 16:  dQ 474 MB, 0.142 ms; dK/dV 569 MB,
//                                  0.170 ms -> bytes (operations: 0.03-0.05 ms)
//
// What holds an fp32 backward back on this card is shared memory, not the
// FMA units: an SM issues 128 FFMA a clock but reads 32 words a clock from
// shared memory (a warp's 16-byte load is four of those clocks unless the
// addresses its threads share are merged), and flash_attention_bwd.cu
// reads one word per FFMA, which caps it near a quarter of the FMA rate.
// Here each thread owns a block of rows x columns of every product, keeps
// it in registers, and takes its operands as 16-byte loads, each reused
// across the block:
//   - S = qs K^T and dP = dO V^T contract over head_dim, and every operand
//     sits in shared memory as it lies in device memory, one row of 72
//     floats per token at a pitch of 76 (16-byte aligned; 19 chunks, odd, so
//     8 consecutive rows fall on 8 distinct groups of 4 banks). With R rows
//     a thread (ty = thread / 16, tx = thread % 16), a thread owns rows
//     R*ty.. and columns tx, tx+16, tx+32, tx+48: per 4 head_dim values R
//     row chunks (shared by the 16 threads of a half-warp) and 4 column
//     chunks (8 threads of a quarter-warp on 8 bank groups), R + 4 LDS.128
//     for 16R FFMA.
//   - The output products (dq = ds K; dv = P^T dO, dk = dS^T qs) contract
//     over the streamed rows. ds (P^T, dS^T) goes through shared memory; a
//     thread owns R rows x 4 columns of the first 64 output columns, and
//     the tail columns 64-71 of its half-warp's rows are split over its 16
//     threads (R/2 each): 4.5R outputs a thread, nothing padded. Per
//     streamed row one chunk of the operand row and R/2 floats of its tail,
//     per 4 rows a chunk of ds for each of its R + 1 rows.
//   R = 8 where registers allow it (dQ: 246; the scores at R = 4 take 6
//   LDS.128 per 64 FFMA more), R = 4 for dK/dV's scores (two 8 x 4 score
//   tiles and two output tiles do not fit in 255 registers).
// Operand tiles come by 16-byte cp.async straight from the (B, N, H, D)
// views: q, k, v are read in place from the fused qkv projection, and dq,
// dk, dv are written with 16-byte (tail: 8-byte at R = 4) stores through
// the gradient's strides into one fused (B, N, 3, H, D) gradient. qs is
// scaled in shared memory by each thread over the chunks it copied, after
// its own cp.async wait.
//   spatial (N > 64), 256 threads a block, the streamed operand in 64-row
//     tiles, double-buffered:
//     dQ: block = (batch*head, 128 queries), R = 8; qs and dO stay, K and V
//       stream; ds is exchanged within the half-warp that owns its rows (a
//       __syncwarp).
//     dK/dV: block = (batch*head, 64 keys); K and V stay, qs, dO, lse and
//       delta stream. The scores run over keys, S^T = K qs^T and dP^T =
//       V dO^T (lse and delta per column), at R = 4; after a block barrier
//       warps 0-3 take dV += P^T dO and warps 4-7 dK += dS^T qs, each at
//       R = 8, so a thread keeps one 64 x 72 output's share in registers
//       until one store.
//   temporal (N <= 64): the same tile code at R = 4 over all 16M rows of a
//     sequence on both sides (M = ceil(N / 16)), 64M threads a sequence,
//     the whole sequence in shared memory and several sequences a block (4
//     at N <= 16); no loop over tiles, a half-warp exchange for dK/dV too.
//     This route is bound by bytes: every load is a coalesced 16-byte copy
//     of a 288-byte row, all in flight at once.
// Keys (dQ) or queries (dK/dV) past N are masked to p = 0; rows past N are
// zero-filled and never stored.

#include "f32_tiles.cuh"

namespace latte {
namespace f32 {

constexpr int kDqOut = 16 * kRows;  // spatial dQ: output rows of a block, 128
constexpr int kDkvOut = 64;         // spatial dK/dV: output rows of a block

enum Operand { kQ = 0, kK, kV, kDO, kDQ, kDK, kDV };

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // contiguous (B*H, N)
  const float* delta;  // contiguous (B*H, N)
  float* dq;
  float* dk;
  float* dv;
  int BH, N, H;
  long long st[7][3];  // element strides (batch, token, head), operands in Operand order
  float scale;
};

// Element offset of sequence bh (its batch and head) in operand o.
__device__ __forceinline__ long long seq_offset(const BwdArgs& a, int o, int bh) {
  const int b = bh / a.H, h = bh - b * a.H;
  return b * a.st[o][0] + h * a.st[o][2];
}

// dQ of rows RPT*ty.. of sq/sdo (lse, delta given) against the keys key0 ..
// key0+16M-1 in sk, sv: ds through sds (pitch 16M + 4), out += ds K.
template <int RPT, int M>
__device__ __forceinline__ void dq_tile(const float* sq, const float* sdo, const float* sk,
                                        const float* sv, float* sds, const float (&lse)[RPT],
                                        const float (&dlt)[RPT], int key0, int N,
                                        OutTile<RPT>& out, int ty, int tx) {
  constexpr int LDS = 16 * M + 4;
  float s[RPT][M], dp[RPT][M];
  row_products<RPT, M>(sq, sk, s, ty, tx);
  row_products<RPT, M>(sdo, sv, dp, ty, tx);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const bool valid = key0 + tx + 16 * m < N;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float p = valid ? expf(s[i][m] - lse[i]) : 0.f;
      sds[(RPT * ty + i) * LDS + tx + 16 * m] = p * (dp[i][m] - dlt[i]);
    }
  }
  __syncwarp();  // a row's ds is written by the 16 threads of its half-warp
  out.template add<16 * M>(sds, LDS, sk, ty, tx);
}

// P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) of key rows RPT*ty..
// of sk/sv against the queries q0 .. q0+16M-1 in sq (qs), sdo, their lse
// and delta in sl, sd, into sp and sds (pitch 16M + 4).
template <int RPT, int M>
__device__ __forceinline__ void dkv_scores(const float* sk, const float* sv, const float* sq,
                                           const float* sdo, const float* sl, const float* sd,
                                           float* sp, float* sds, int q0, int N, int ty, int tx) {
  constexpr int LDS = 16 * M + 4;
  float s[RPT][M], dp[RPT][M];
  row_products<RPT, M>(sk, sq, s, ty, tx);
  row_products<RPT, M>(sv, sdo, dp, ty, tx);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = tx + 16 * m;
    const bool valid = q0 + c < N;
    const float l = sl[c], d = sd[c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float p = valid ? expf(s[i][m] - l) : 0.f;
      sp[(RPT * ty + i) * LDS + c] = p;
      sds[(RPT * ty + i) * LDS + c] = p * (dp[i][m] - d);
    }
  }
}

// dK and dV of key rows RPT*ty.. of sk/sv against the queries q0 .. q0+16M-1
// in sq (qs), sdo, their lse and delta in sl, sd: the products run over
// keys, S^T = K qs^T and dP^T = V dO^T; P^T and dS^T through sp, sds (pitch
// 16M + 4), dv += P^T dO, dk += dS^T qs.
template <int RPT, int M>
__device__ __forceinline__ void dkv_tile(const float* sk, const float* sv, const float* sq,
                                         const float* sdo, const float* sl, const float* sd,
                                         float* sp, float* sds, int q0, int N, OutTile<RPT>& dk,
                                         OutTile<RPT>& dv, int ty, int tx) {
  dkv_scores<RPT, M>(sk, sv, sq, sdo, sl, sd, sp, sds, q0, N, ty, tx);
  __syncwarp();  // a key row's p and ds are written by the 16 threads of its half-warp
  dv.template add<16 * M>(sp, 16 * M + 4, sdo, ty, tx);
  dk.template add<16 * M>(sds, 16 * M + 4, sq, ty, tx);
}

// lse and delta of rows row0 + RPT*ty + i of sequence bh; zeros past N.
template <int RPT>
__device__ __forceinline__ void row_stats(const BwdArgs& a, int bh, int row0, int ty,
                                          float (&lse)[RPT], float (&dlt)[RPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + RPT * ty + i;
    const bool valid = r < a.N;
    const long long at = (long long)bh * a.N + (valid ? r : 0);
    lse[i] = valid ? a.lse[at] : 0.f;
    dlt[i] = valid ? a.delta[at] : 0.f;
  }
}

// Spatial dQ (N > 64): block = (batch*head, 128-query tile), 8 query rows a
// thread; K/V in 64-key tiles, double-buffered. Shared memory: qs, dO,
// [stage][K, V], ds.
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_f32_kernel(const BwdArgs a) {
  constexpr int T = kTile, O = kDqOut;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + O * kLd;
  float* skv = sdo + O * kLd;
  float* sds = skv + 4 * T * kLd;

  const int nqt = (a.N + O - 1) / O;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * O;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* kb = a.k + seq_offset(a, kK, bh);
  const float* vb = a.v + seq_offset(a, kV, bh);

  load_rows<O, kThreads>(sq, a.q + seq_offset(a, kQ, bh), a.st[kQ][1], q0, a.N, tid);
  load_rows<O, kThreads>(sdo, a.dout + seq_offset(a, kDO, bh), a.st[kDO][1], q0, a.N, tid);
  cp_async_commit();
  load_rows<T, kThreads>(skv, kb, a.st[kK][1], 0, a.N, tid);
  load_rows<T, kThreads>(skv + T * kLd, vb, a.st[kV][1], 0, a.N, tid);
  cp_async_commit();
  float lse[kRows], dlt[kRows];
  row_stats<kRows>(a, bh, q0, ty, lse, dlt);  // read while the copies fly
  cp_async_wait<1>();                          // q and dO
  scale_rows<O, kThreads>(sq, a.scale, tid);

  OutTile<kRows> out;
  out.zero();
  const int nkt = (a.N + T - 1) / T;
  for (int it = 0; it < nkt; ++it) {
    if (it + 1 < nkt) {
      float* st = skv + ((it + 1) & 1) * 2 * T * kLd;
      load_rows<T, kThreads>(st, kb, a.st[kK][1], (it + 1) * T, a.N, tid);
      load_rows<T, kThreads>(st + T * kLd, vb, a.st[kV][1], (it + 1) * T, a.N, tid);
    }
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();     // (first pass: and every thread's qs is scaled)
    const float* sk = skv + (it & 1) * 2 * T * kLd;
    dq_tile<kRows, T / 16>(sq, sdo, sk, sk + T * kLd, sds, lse, dlt, it * T, a.N, out, ty, tx);
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  out.store(a.dq + seq_offset(a, kDQ, bh), a.st[kDQ][1], q0, a.N, a.scale, ty, tx);
}

// Spatial dK/dV (N > 64): block = (batch*head, 64-key tile); qs, dO, lse
// and delta in 64-query tiles, double-buffered. The scores with 4 key rows
// a thread; then warps 0-3 take dV += P^T dO and warps 4-7 dK += dS^T qs,
// 8 key rows a thread. Shared memory: K, V, [stage][qs, dO], [stage][lse,
// delta], P^T, dS^T.
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_f32_kernel(const BwdArgs a) {
  constexpr int T = kTile, O = kDkvOut, LDS = T + 4;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + O * kLd;
  float* sqd = sv + O * kLd;
  float* sld = sqd + 4 * T * kLd;
  float* sp = sld + 4 * T;
  float* sds = sp + O * LDS;

  const int nkt = (a.N + O - 1) / O;
  const int bh = blockIdx.x / nkt, k0 = (blockIdx.x - bh * nkt) * O;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = a.q + seq_offset(a, kQ, bh);
  const float* dob = a.dout + seq_offset(a, kDO, bh);
  const float* lb = a.lse + (long long)bh * a.N;
  const float* db = a.delta + (long long)bh * a.N;
  auto load_tile = [&](int stage, int q0) {
    float* st = sqd + stage * 2 * T * kLd;
    load_rows<T, kThreads>(st, qb, a.st[kQ][1], q0, a.N, tid);
    load_rows<T, kThreads>(st + T * kLd, dob, a.st[kDO][1], q0, a.N, tid);
    load_vec<T, kThreads>(sld + stage * 2 * T, lb, q0, a.N, tid);
    load_vec<T, kThreads>(sld + stage * 2 * T + T, db, q0, a.N, tid);
  };

  load_rows<O, kThreads>(sk, a.k + seq_offset(a, kK, bh), a.st[kK][1], k0, a.N, tid);
  load_rows<O, kThreads>(sv, a.v + seq_offset(a, kV, bh), a.st[kV][1], k0, a.N, tid);
  cp_async_commit();
  load_tile(0, 0);
  cp_async_commit();

  // the products by halves: dK in warps 4-7, dV in warps 0-3 (warp-uniform)
  const int dk_half = tid >> 7, t2 = tid & 127, ty2 = t2 >> 4, tx2 = t2 & 15;
  OutTile<kRows> acc;
  acc.zero();
  const int nqt = (a.N + T - 1) / T;
  for (int it = 0; it < nqt; ++it) {
    if (it + 1 < nqt) load_tile((it + 1) & 1, (it + 1) * T);
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // K, V and tile it have landed
    float* st = sqd + (it & 1) * 2 * T * kLd;
    scale_rows<T, kThreads>(st, a.scale, tid);
    __syncthreads();
    const float* sl = sld + (it & 1) * 2 * T;
    dkv_scores<4, T / 16>(sk, sv, st, st + T * kLd, sl, sl + T, sp, sds, it * T, a.N, ty, tx);
    __syncthreads();  // the other half's rows of P^T and dS^T are written
    acc.add<T>(dk_half ? sds : sp, LDS, dk_half ? st : st + T * kLd, ty2, tx2);
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  const int o = dk_half ? kDK : kDV;
  acc.store((dk_half ? a.dk : a.dv) + seq_offset(a, o, bh), a.st[o][1], k0, a.N, 1.f, ty2, tx2);
}

// The temporal route's geometry at M = ceil(N / 16): R rows a sequence on
// both sides, 4R threads a sequence (a thread owns 4 rows), G sequences a
// block.
template <int M>
struct Short {
  static constexpr int R = 16 * M;
  static constexpr int THREADS = 4 * R;
  static constexpr int G = M == 3 ? 1 : 4 / M;
  static constexpr int LDS = R + 4;
  // floats of shared memory a sequence: q, dO, K, V rows, then ds (dQ) or
  // P^T, dS^T, lse, delta (dK/dV)
  static constexpr int DQ_FLOATS = 4 * R * kLd + R * LDS;
  static constexpr int DKV_FLOATS = 4 * R * kLd + 2 * R * LDS + 2 * R;
};

// Temporal dQ (N <= 64): one thread group per (batch*head) sequence, its
// q, dO, K, V whole in shared memory, one tile.
template <int M>
__global__ void __launch_bounds__(Short<M>::G * Short<M>::THREADS, 2)
    flash_bwd_dq_f32_short_kernel(const BwdArgs a) {
  using S = Short<M>;
  constexpr int R = S::R, GT = S::THREADS;
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / GT, t = threadIdx.x - g * GT, ty = t >> 4, tx = t & 15;
  const int bh = blockIdx.x * S::G + g;
  const bool live = bh < a.BH;
  float* sq = smem + g * S::DQ_FLOATS;
  float* sdo = sq + R * kLd;
  float* sk = sdo + R * kLd;
  float* sv = sk + R * kLd;
  float* sds = sv + R * kLd;
  if (live) {
    load_rows<R, GT>(sq, a.q + seq_offset(a, kQ, bh), a.st[kQ][1], 0, a.N, t);
    load_rows<R, GT>(sdo, a.dout + seq_offset(a, kDO, bh), a.st[kDO][1], 0, a.N, t);
    load_rows<R, GT>(sk, a.k + seq_offset(a, kK, bh), a.st[kK][1], 0, a.N, t);
    load_rows<R, GT>(sv, a.v + seq_offset(a, kV, bh), a.st[kV][1], 0, a.N, t);
  }
  cp_async_commit();
  float lse[4], dlt[4];
  row_stats<4>(a, live ? bh : 0, 0, ty, lse, dlt);
  cp_async_wait<0>();
  scale_rows<R, GT>(sq, a.scale, t);
  __syncthreads();
  if (!live) return;  // no block-wide barrier follows
  OutTile<4> out;
  out.zero();
  dq_tile<4, M>(sq, sdo, sk, sv, sds, lse, dlt, 0, a.N, out, ty, tx);
  out.store(a.dq + seq_offset(a, kDQ, bh), a.st[kDQ][1], 0, a.N, a.scale, ty, tx);
}

// Temporal dK/dV (N <= 64): one thread group per sequence, as the temporal
// dQ; its lse and delta follow its rows in shared memory.
template <int M>
__global__ void __launch_bounds__(Short<M>::G * Short<M>::THREADS, 2)
    flash_bwd_dkv_f32_short_kernel(const BwdArgs a) {
  using S = Short<M>;
  constexpr int R = S::R, GT = S::THREADS;
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / GT, t = threadIdx.x - g * GT, ty = t >> 4, tx = t & 15;
  const int bh = blockIdx.x * S::G + g;
  const bool live = bh < a.BH;
  float* sk = smem + g * S::DKV_FLOATS;
  float* sv = sk + R * kLd;
  float* sq = sv + R * kLd;
  float* sdo = sq + R * kLd;
  float* sp = sdo + R * kLd;
  float* sds = sp + R * S::LDS;
  float* sl = sds + R * S::LDS;
  float* sd = sl + R;
  if (live) {
    load_rows<R, GT>(sk, a.k + seq_offset(a, kK, bh), a.st[kK][1], 0, a.N, t);
    load_rows<R, GT>(sv, a.v + seq_offset(a, kV, bh), a.st[kV][1], 0, a.N, t);
    load_rows<R, GT>(sq, a.q + seq_offset(a, kQ, bh), a.st[kQ][1], 0, a.N, t);
    load_rows<R, GT>(sdo, a.dout + seq_offset(a, kDO, bh), a.st[kDO][1], 0, a.N, t);
    load_vec<R, GT>(sl, a.lse + (long long)bh * a.N, 0, a.N, t);
    load_vec<R, GT>(sd, a.delta + (long long)bh * a.N, 0, a.N, t);
  }
  cp_async_commit();
  cp_async_wait<0>();
  scale_rows<R, GT>(sq, a.scale, t);
  __syncthreads();
  if (!live) return;  // no block-wide barrier follows
  OutTile<4> dk, dv;
  dk.zero();
  dv.zero();
  dkv_tile<4, M>(sk, sv, sq, sdo, sl, sd, sp, sds, 0, a.N, dk, dv, ty, tx);
  dk.store(a.dk + seq_offset(a, kDK, bh), a.st[kDK][1], 0, a.N, 1.f, ty, tx);
  dv.store(a.dv + seq_offset(a, kDV, bh), a.st[kDV][1], 0, a.N, 1.f, ty, tx);
}

template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, long long blocks, int threads, size_t smem,
                       const BwdArgs& a, cudaStream_t stream) {
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
cudaError_t launch_short(bool dkv, const BwdArgs& a, cudaStream_t stream) {
  using S = Short<M>;
  const long long blocks = (a.BH + S::G - 1) / S::G;
  if (dkv) {
    return launch_bwd(flash_bwd_dkv_f32_short_kernel<M>, blocks, S::G * S::THREADS,
                      sizeof(float) * S::G * S::DKV_FLOATS, a, stream);
  }
  return launch_bwd(flash_bwd_dq_f32_short_kernel<M>, blocks, S::G * S::THREADS,
                    sizeof(float) * S::G * S::DQ_FLOATS, a, stream);
}

cudaError_t launch_f32(bool dkv, const BwdArgs& a, cudaStream_t stream) {
  if (a.N > kMaxShortN) {
    constexpr int T = kTile, O = kDqOut, OK = kDkvOut;
    if (dkv) {
      return launch_bwd(flash_bwd_dkv_f32_kernel, (long long)a.BH * ((a.N + OK - 1) / OK),
                        kThreads,
                        sizeof(float) * (2 * OK * kLd + 4 * T * kLd + 4 * T + 2 * OK * (T + 4)),
                        a, stream);
    }
    return launch_bwd(flash_bwd_dq_f32_kernel, (long long)a.BH * ((a.N + O - 1) / O), kThreads,
                      sizeof(float) * (2 * O * kLd + 4 * T * kLd + O * (T + 4)), a, stream);
  }
  switch ((a.N + 15) / 16) {
    case 1: return launch_short<1>(dkv, a, stream);
    case 2: return launch_short<2>(dkv, a, stream);
    case 3: return launch_short<3>(dkv, a, stream);
    default: return launch_short<4>(dkv, a, stream);
  }
}

int flash_bwd_f32(bool dkv, int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                  void* dv, int B, int N, int H, int D, const long long* strides, float scale,
                  int device, void* stream) {
  if (dtype != kFloat32 || D != kD || N < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  BwdArgs a;
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.dout = (const float*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.BH = B * H;
  a.N = N;
  a.H = H;
  for (int o = 0; o < 7; ++o) {
    for (int i = 0; i < 3; ++i) a.st[o][i] = strides[3 * o + i];
  }
  a.scale = scale;
  return (int)launch_f32(dkv, a, (cudaStream_t)stream);
}

}  // namespace f32
}  // namespace latte

// The arguments of latte_flash_attention_bwd_dq / _dkv (flash_attention_bwd.cu):
// dtype must be fp32 and D 72; the base pointers and the (batch, token, head)
// strides of q, k, v, dout and the written gradients 16-byte aligned, the
// last axis of each contiguous. lse and delta are contiguous fp32 (B*H, N).
// The dq entry writes dq only (dk, dv unused); the dkv entry dk and dv only.
extern "C" int latte_flash_attention_bwd_dq_f32(int dtype, const void* q, const void* k,
                                                const void* v, const void* dout, const void* lse,
                                                const void* delta, void* dq, void* dk, void* dv,
                                                int B, int N, int H, int D,
                                                const long long* strides, float scale,
                                                int device, void* stream) {
  return latte::f32::flash_bwd_f32(false, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, N, H,
                                   D, strides, scale, device, stream);
}

extern "C" int latte_flash_attention_bwd_dkv_f32(int dtype, const void* q, const void* k,
                                                 const void* v, const void* dout,
                                                 const void* lse, const void* delta, void* dq,
                                                 void* dk, void* dv, int B, int N, int H, int D,
                                                 const long long* strides, float scale,
                                                 int device, void* stream) {
  return latte::f32::flash_bwd_f32(true, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, N, H,
                                   D, strides, scale, device, stream);
}
