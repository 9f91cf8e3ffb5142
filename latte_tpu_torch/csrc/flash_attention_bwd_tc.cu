// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16: dQ and
// dK/dV.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of latte_tpu/kernels/attention.py (launched by
// `_flash_backward`) for every bf16 call the model makes, in place of the
// bf16 instantiations of flash_attention_bwd.cu, which keep fp32 and the
// bf16 layouts these kernels do not take. The route is chosen in Python
// before the launch (`backward_route`, latte_tpu_torch/kernels/attention.py):
// bf16, head_dim 72 (Latte-XL/2's, the only one a config serves), base
// pointers and (batch, token, head) strides of q, k, v, dO and the written
// gradients 16-byte aligned.
//
// Numerics are the TPU kernels', and every rounding is elementwise:
//   qs = round(q * scale)                   (the forward's rounding)
//   p  = exp(qs k^T - lse)                  fp32, expf as in the forward
//   ds = round(p * (dO v^T - delta))        delta = rowsum(dO * O), fp32, given
//   dq = round(scale * sum_keys ds k)
//   dk = round(sum_queries ds^T qs)         (qs carries the scale)
//   dv = round(sum_queries round(p)^T dO)
// All sums are fp32 (mma with fp32 accumulators). There is no running
// maximum and no rescale, so the tile schedule changes nothing but the
// order of fp32 sums: the plain versions (attention_bwd_dq_reference,
// attention_bwd_dkv_reference) mirror any tile schedule.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16), at Latte-XL/2's
// shapes (head_dim 72; bytes = q, k, v, dO, the fp32 lse and delta read once,
// dq or dk and dv written once; 6 and 8 * B*H*N^2*D FLOP):
//   spatial 256^2  B*H = 256,  N = 256:  dQ 47.7 MB, 14.2 us; 2.9 GFLOP, 2.9 us -> bytes
//                                        dK/dV 57.2 MB, 17.1 us; 9.7 GFLOP, 9.8 us -> bytes
//   temporal       B*H = 4096, N = 16:   the same bytes; 0.5-0.6 us of operations -> bytes
//   batch 5 (the mixed-precision trainer): five times the batch-1 numbers.
//
// Design: a warp owns 16 output rows and keeps their operand fragments in
// registers for the whole loop; the streamed operand comes through shared
// memory in tiles of 64 rows, 16-byte cp.async, double-buffered; each tile
// is taken 16 rows (one k16 step of the output product) at a time, so the
// scores of only 16 x 16 entries live in registers at once.
//   dQ: block = (batch*head, 64 queries), 4 warps of 16 queries; qs (scaled
//     and rounded at the fragment load) and dO are A fragments. Per 16 keys:
//     S = qs K^T and dP = dO V^T (4 k16 + 1 k8 mma each per n8 tile),
//     ds = round(exp(S - lse) * (dP - delta)) from the C fragments straight
//     into the A fragment of dQ += ds K (9 mma, K by ldmatrix.trans).
//   dK/dV: block = (batch*head, 64 keys), 4 warps of 16 keys; K and V are A
//     fragments. qs, dO, lse and delta of 64 queries stream; q is scaled and
//     rounded in shared memory, each thread over the chunks it copied once
//     its copies have landed (no extra barrier). Per 16 queries:
//     S^T = K qs^T, P^T = exp(S^T - lse) (lse and delta per column, from
//     shared memory), dV += round(P^T) dO, dP^T = V dO^T,
//     dK += round(P^T (dP^T - delta)) qs. dK and dV (16 x 72 fp32 each) stay
//     in registers until one rounded store.
//   N <= 64 (the temporal route): one warp per (batch*head) sequence, 4 a
//     block; the whole sequence is one tile in shared memory, no loop over
//     tiles: at N = 16 one 16 x 16 score tile per product.
// Each block owns its output rows: no atomics, as in the TPU design. Keys
// (dQ) or queries (dK/dV) past N are masked to p = 0; rows past N are
// zero-filled and never stored. The output is staged, rounded, in the warp's
// own rows of shared memory (free once its fragments are in registers) and
// written with 16-byte stores through the gradient's strides, so dq, dk and
// dv land in one fused (B, N, 3, H, D) gradient.
// mma.sync rather than wgmma: the main-path calls are bound by bytes, their
// operations bound 1.7x (spatial) to 28x (temporal) below it; a 16-row warp
// tile needs no 64-row warpgroup tile and no swizzled, padded layout of the
// 72-wide rows.

#include "mma_bf16.cuh"

namespace latte {
namespace tc {

constexpr int kBwdWarps = 4;       // warps of a block, on both routes
constexpr int kBwdTile = 64;       // spatial: output rows of a block, rows of a streamed tile
constexpr int kBwdMaxShortN = 64;  // the temporal route takes N <= 64

enum Operand { kQ = 0, kK, kV, kDO, kDQ, kDK, kDV };

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // contiguous (B*H, N)
  const float* delta;  // contiguous (B*H, N)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int BH, N, H;
  long long st[7][3];  // element strides (batch, token, head), operands in Operand order
  float scale;
};

// Element offset of sequence bh (its batch and head) in operand o.
__device__ __forceinline__ long long seq_offset(const BwdArgs& a, int o, int bh) {
  const int b = bh / a.H, h = bh - b * a.H;
  return b * a.st[o][0] + h * a.st[o][2];
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

// qs = round(q * scale) in place, over the 16-byte chunks that thread t
// copied with load_rows<ROWS, THREADS>: its own copies are visible to it
// once its wait returns, so no barrier comes between.
template <int ROWS, int THREADS>
__device__ __forceinline__ void scale_rows(bf16* rows, float scale, int t) {
  for (int i = t; i < ROWS * kChunks; i += THREADS) {
    uint4* p = reinterpret_cast<uint4*>(rows + i * 8);  // chunk i of row-major rows
    uint4 x = *p;
    x.x = scale_pair(x.x, scale);
    x.y = scale_pair(x.y, scale);
    x.z = scale_pair(x.z, scale);
    x.w = scale_pair(x.w, scale);
    *p = x;
  }
}

// The C fragments of two n8 tiles as the A fragment of one k16 step.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// dQ of a warp's 16 query rows (g, g+8 with lse and delta as given) over keys
// key0 .. key0+16*KS-1, rows of sk and sv: acc += ds K.
template <int KS>
__device__ __forceinline__ void dq_keys(const QFrags& qs, const QFrags& dO, const float (&lse)[2],
                                        const float (&dlt)[2], const bf16* sk, const bf16* sv,
                                        int key0, int N, float (&acc)[kChunks][4], int lane) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const bf16* kj = sk + j * 16 * kD;
    float s[2][4], dp[2][4];
    qk_scores<2>(qs, kj, s, lane);
    if (key0 + (j + 1) * 16 > N) mask_keys<2>(s, key0 + j * 16, N, lane);
    qk_scores<2>(dO, sv + j * 16 * kD, dp, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = expf(s[n][i] - lse[i >> 1]) * (dp[n][i] - dlt[i >> 1]);
    }
    uint32_t ds[1][4];
    pack_a(ds[0], s);
    pv_product<1>(ds, kj, acc, lane);
  }
}

// dK and dV of a warp's 16 key rows (A fragments kf, vf) over queries
// q0 .. q0+16*KS-1: rows of sq (qs, scaled and rounded) and sdo, their lse
// and delta in sl, sd. The products run transposed, keys along m and queries
// along n, so lse and delta are read per column.
template <int KS>
__device__ __forceinline__ void dkv_queries(const QFrags& kf, const QFrags& vf, const bf16* sq,
                                            const bf16* sdo, const float* sl, const float* sd,
                                            int q0, int N, float (&dk)[kChunks][4],
                                            float (&dv)[kChunks][4], int lane) {
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const bf16* qj = sq + j * 16 * kD;
    const bf16* doj = sdo + j * 16 * kD;
    float p[2][4];
    qk_scores<2>(kf, qj, p, lane);  // S^T
    if (q0 + (j + 1) * 16 > N) mask_keys<2>(p, q0 + j * 16, N, lane);
    float2 l[2], d[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      l[n] = *reinterpret_cast<const float2*>(sl + j * 16 + n * 8 + t2);
      d[n] = *reinterpret_cast<const float2*>(sd + j * 16 + n * 8 + t2);
      p[n][0] = expf(p[n][0] - l[n].x);
      p[n][1] = expf(p[n][1] - l[n].y);
      p[n][2] = expf(p[n][2] - l[n].x);
      p[n][3] = expf(p[n][3] - l[n].y);
    }
    uint32_t a[1][4];
    pack_a(a[0], p);  // round(P^T)
    pv_product<1>(a, doj, dv, lane);
    float dp[2][4];
    qk_scores<2>(vf, doj, dp, lane);  // dP^T
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      dp[n][0] = p[n][0] * (dp[n][0] - d[n].x);
      dp[n][1] = p[n][1] * (dp[n][1] - d[n].y);
      dp[n][2] = p[n][2] * (dp[n][2] - d[n].x);
      dp[n][3] = p[n][3] * (dp[n][3] - d[n].y);
    }
    pack_a(a[0], dp);  // round(dS^T)
    pv_product<1>(a, qj, dk, lane);
  }
}

// Write a warp's 16 rows round(acc * mult), rows n0.. of one sequence (out:
// its base, stride: its token stride), through the staging rows so.
__device__ __forceinline__ void store_tile(bf16* out, long long stride, int n0, int N, bf16* so,
                                           const float (&acc)[kChunks][4], float mult, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * kD + n * 8 + t2) =
        pack_bf16(acc[n][0] * mult, acc[n][1] * mult);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kD + n * 8 + t2) =
        pack_bf16(acc[n][2] * mult, acc[n][3] * mult);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks, n = n0 + r;
    if (n < N) {
      *reinterpret_cast<uint4*>(out + n * stride + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * kD + c * 8);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kChunks][4]) {
#pragma unroll
  for (int n = 0; n < kChunks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Spatial dQ (N > 64): block = (batch*head, 64-query tile); K/V in 64-key
// tiles, double-buffered. Shared memory: q, dO, then [stage][K, V].
__global__ void __launch_bounds__(kBwdWarps * 32) flash_bwd_dq_tc_kernel(const BwdArgs a) {
  constexpr int THREADS = kBwdWarps * 32, T = kBwdTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + T * kD;
  bf16* skv = sdo + T * kD;

  const int nqt = (a.N + T - 1) / T;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kb = a.k + seq_offset(a, kK, bh);
  const bf16* vb = a.v + seq_offset(a, kV, bh);

  load_rows<T, THREADS>(sq, a.q + seq_offset(a, kQ, bh), a.st[kQ][1], q0, a.N, tid);
  load_rows<T, THREADS>(sdo, a.dout + seq_offset(a, kDO, bh), a.st[kDO][1], q0, a.N, tid);
  cp_async_commit();
  load_rows<T, THREADS>(skv, kb, a.st[kK][1], 0, a.N, tid);
  load_rows<T, THREADS>(skv + T * kD, vb, a.st[kV][1], 0, a.N, tid);
  cp_async_commit();
  // lse and delta of rows g and g+8, read while the copies fly
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = row0 + 8 * i < a.N;
    const long long at = (long long)bh * a.N + row0 + 8 * i;
    lse[i] = valid ? a.lse[at] : 0.f;
    dlt[i] = valid ? a.delta[at] : 0.f;
  }
  cp_async_wait<1>();  // q and dO
  __syncthreads();
  bf16* sq_warp = sq + warp * 16 * kD;
  QFrags qs, dO;
  load_q(sq_warp, qs, a.scale, lane);
  load_a(sdo + warp * 16 * kD, dO, lane);

  float acc[kChunks][4];
  zero(acc);
  const int nkt = (a.N + T - 1) / T;
  for (int it = 0; it < nkt; ++it) {
    if (it + 1 < nkt) {
      bf16* st = skv + ((it + 1) & 1) * 2 * T * kD;
      load_rows<T, THREADS>(st, kb, a.st[kK][1], (it + 1) * T, a.N, tid);
      load_rows<T, THREADS>(st + T * kD, vb, a.st[kV][1], (it + 1) * T, a.N, tid);
    }
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const bf16* sk = skv + (it & 1) * 2 * T * kD;
    dq_keys<T / 16>(qs, dO, lse, dlt, sk, sk + T * kD, it * T, a.N, acc, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_tile(a.dq + seq_offset(a, kDQ, bh), a.st[kDQ][1], q0 + warp * 16, a.N, sq_warp, acc,
             a.scale, lane);
}

// Spatial dK/dV (N > 64): block = (batch*head, 64-key tile); qs, dO, lse and
// delta in 64-query tiles, double-buffered. Shared memory: K, V, then
// [stage][q, dO] rows, then [stage][lse, delta] values.
__global__ void __launch_bounds__(kBwdWarps * 32) flash_bwd_dkv_tc_kernel(const BwdArgs a) {
  constexpr int THREADS = kBwdWarps * 32, T = kBwdTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + T * kD;
  bf16* sqd = sv + T * kD;
  float* sld = reinterpret_cast<float*>(sqd + 2 * 2 * T * kD);

  const int nkt = (a.N + T - 1) / T;
  const int bh = blockIdx.x / nkt, k0 = (blockIdx.x - bh * nkt) * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = a.q + seq_offset(a, kQ, bh);
  const bf16* dob = a.dout + seq_offset(a, kDO, bh);
  const float* lb = a.lse + (long long)bh * a.N;
  const float* db = a.delta + (long long)bh * a.N;
  auto load_tile = [&](int stage, int q0) {
    bf16* st = sqd + stage * 2 * T * kD;
    load_rows<T, THREADS>(st, qb, a.st[kQ][1], q0, a.N, tid);
    load_rows<T, THREADS>(st + T * kD, dob, a.st[kDO][1], q0, a.N, tid);
    load_vec<T, THREADS>(sld + stage * 2 * T, lb, q0, a.N, tid);
    load_vec<T, THREADS>(sld + stage * 2 * T + T, db, q0, a.N, tid);
  };

  load_rows<T, THREADS>(sk, a.k + seq_offset(a, kK, bh), a.st[kK][1], k0, a.N, tid);
  load_rows<T, THREADS>(sv, a.v + seq_offset(a, kV, bh), a.st[kV][1], k0, a.N, tid);
  cp_async_commit();
  load_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V
  __syncthreads();
  bf16* sk_warp = sk + warp * 16 * kD;
  bf16* sv_warp = sv + warp * 16 * kD;
  QFrags kf, vf;
  load_a(sk_warp, kf, lane);
  load_a(sv_warp, vf, lane);

  float dk[kChunks][4], dv[kChunks][4];
  zero(dk);
  zero(dv);
  const int nqt = (a.N + T - 1) / T;
  for (int it = 0; it < nqt; ++it) {
    if (it + 1 < nqt) load_tile((it + 1) & 1, (it + 1) * T);
    cp_async_commit();   // possibly empty: keeps one group per iteration
    cp_async_wait<1>();  // tile it has landed
    bf16* st = sqd + (it & 1) * 2 * T * kD;
    scale_rows<T, THREADS>(st, a.scale, tid);
    __syncthreads();
    const float* sl = sld + (it & 1) * 2 * T;
    dkv_queries<T / 16>(kf, vf, st, st + T * kD, sl, sl + T, it * T, a.N, dk, dv, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_tile(a.dk + seq_offset(a, kDK, bh), a.st[kDK][1], k0 + warp * 16, a.N, sk_warp, dk, 1.f,
             lane);
  store_tile(a.dv + seq_offset(a, kDV, bh), a.st[kDV][1], k0 + warp * 16, a.N, sv_warp, dv, 1.f,
             lane);
}

// Temporal dQ (N <= 64): one warp per (batch*head) sequence, kBwdWarps
// sequences a block; q, dO, K, V of up to 64 rows (KS k16 steps) in one tile.
template <int KS>
__global__ void __launch_bounds__(kBwdWarps * 32) flash_bwd_dq_tc_short_kernel(const BwdArgs a) {
  constexpr int ROWS = KS * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kBwdWarps + warp;
  if (bh >= a.BH) return;  // no block-wide barrier follows
  bf16* sq = reinterpret_cast<bf16*>(smem) + warp * 4 * ROWS * kD;
  bf16* sdo = sq + ROWS * kD;
  bf16* sk = sdo + ROWS * kD;
  bf16* sv = sk + ROWS * kD;
  load_rows<ROWS, 32>(sq, a.q + seq_offset(a, kQ, bh), a.st[kQ][1], 0, a.N, lane);
  load_rows<ROWS, 32>(sdo, a.dout + seq_offset(a, kDO, bh), a.st[kDO][1], 0, a.N, lane);
  load_rows<ROWS, 32>(sk, a.k + seq_offset(a, kK, bh), a.st[kK][1], 0, a.N, lane);
  load_rows<ROWS, 32>(sv, a.v + seq_offset(a, kV, bh), a.st[kV][1], 0, a.N, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  bf16* dq = a.dq + seq_offset(a, kDQ, bh);
  for (int q0 = 0; q0 < a.N; q0 += 16) {
    QFrags qs, dO;
    load_q(sq + q0 * kD, qs, a.scale, lane);
    load_a(sdo + q0 * kD, dO, lane);
    const int row0 = q0 + (lane >> 2);
    float lse[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool valid = row0 + 8 * i < a.N;
      const long long at = (long long)bh * a.N + row0 + 8 * i;
      lse[i] = valid ? a.lse[at] : 0.f;
      dlt[i] = valid ? a.delta[at] : 0.f;
    }
    float acc[kChunks][4];
    zero(acc);
    dq_keys<KS>(qs, dO, lse, dlt, sk, sv, 0, a.N, acc, lane);
    store_tile(dq, a.st[kDQ][1], q0, a.N, sq + q0 * kD, acc, a.scale, lane);
  }
}

// Temporal dK/dV (N <= 64): one warp per sequence, as the temporal dQ; its
// lse and delta follow the blocks' rows in shared memory.
template <int KS>
__global__ void __launch_bounds__(kBwdWarps * 32) flash_bwd_dkv_tc_short_kernel(const BwdArgs a) {
  constexpr int ROWS = KS * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kBwdWarps + warp;
  if (bh >= a.BH) return;  // no block-wide barrier follows
  bf16* sk = reinterpret_cast<bf16*>(smem) + warp * 4 * ROWS * kD;
  bf16* sv = sk + ROWS * kD;
  bf16* sq = sv + ROWS * kD;
  bf16* sdo = sq + ROWS * kD;
  float* sl = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem) + kBwdWarps * 4 * ROWS * kD) +
              warp * 2 * ROWS;
  float* sd = sl + ROWS;
  load_rows<ROWS, 32>(sk, a.k + seq_offset(a, kK, bh), a.st[kK][1], 0, a.N, lane);
  load_rows<ROWS, 32>(sv, a.v + seq_offset(a, kV, bh), a.st[kV][1], 0, a.N, lane);
  load_rows<ROWS, 32>(sq, a.q + seq_offset(a, kQ, bh), a.st[kQ][1], 0, a.N, lane);
  load_rows<ROWS, 32>(sdo, a.dout + seq_offset(a, kDO, bh), a.st[kDO][1], 0, a.N, lane);
  load_vec<ROWS, 32>(sl, a.lse + (long long)bh * a.N, 0, a.N, lane);
  load_vec<ROWS, 32>(sd, a.delta + (long long)bh * a.N, 0, a.N, lane);
  cp_async_commit();
  cp_async_wait<0>();
  scale_rows<ROWS, 32>(sq, a.scale, lane);
  __syncwarp();
  bf16* dk = a.dk + seq_offset(a, kDK, bh);
  bf16* dv = a.dv + seq_offset(a, kDV, bh);
  for (int k0 = 0; k0 < a.N; k0 += 16) {
    QFrags kf, vf;
    load_a(sk + k0 * kD, kf, lane);
    load_a(sv + k0 * kD, vf, lane);
    float gk[kChunks][4], gv[kChunks][4];
    zero(gk);
    zero(gv);
    dkv_queries<KS>(kf, vf, sq, sdo, sl, sd, 0, a.N, gk, gv, lane);
    store_tile(dk, a.st[kDK][1], k0, a.N, sk + k0 * kD, gk, 1.f, lane);
    store_tile(dv, a.st[kDV][1], k0, a.N, sv + k0 * kD, gv, 1.f, lane);
  }
}

template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, long long blocks, size_t smem, const BwdArgs& a,
                       cudaStream_t stream) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kBwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Shared memory of a temporal block: 4 bf16 row arrays a warp, and for
// dK/dV the lse and delta values.
constexpr size_t short_smem(int ks, bool dkv) {
  return kBwdWarps * (4 * sizeof(bf16) * ks * 16 * kD + (dkv ? 2 * sizeof(float) * ks * 16 : 0));
}

cudaError_t launch_dq_tc(const BwdArgs& a, cudaStream_t stream) {
  if (a.N > kBwdMaxShortN) {
    return launch_bwd(flash_bwd_dq_tc_kernel, (long long)a.BH * ((a.N + kBwdTile - 1) / kBwdTile),
                      sizeof(bf16) * 6 * kBwdTile * kD, a, stream);
  }
  const long long blocks = (a.BH + kBwdWarps - 1) / kBwdWarps;
  switch ((a.N + 15) / 16) {
    case 1: return launch_bwd(flash_bwd_dq_tc_short_kernel<1>, blocks, short_smem(1, false), a, stream);
    case 2: return launch_bwd(flash_bwd_dq_tc_short_kernel<2>, blocks, short_smem(2, false), a, stream);
    case 3: return launch_bwd(flash_bwd_dq_tc_short_kernel<3>, blocks, short_smem(3, false), a, stream);
    default: return launch_bwd(flash_bwd_dq_tc_short_kernel<4>, blocks, short_smem(4, false), a, stream);
  }
}

cudaError_t launch_dkv_tc(const BwdArgs& a, cudaStream_t stream) {
  if (a.N > kBwdMaxShortN) {
    return launch_bwd(flash_bwd_dkv_tc_kernel, (long long)a.BH * ((a.N + kBwdTile - 1) / kBwdTile),
                      sizeof(bf16) * 6 * kBwdTile * kD + sizeof(float) * 4 * kBwdTile, a, stream);
  }
  const long long blocks = (a.BH + kBwdWarps - 1) / kBwdWarps;
  switch ((a.N + 15) / 16) {
    case 1: return launch_bwd(flash_bwd_dkv_tc_short_kernel<1>, blocks, short_smem(1, true), a, stream);
    case 2: return launch_bwd(flash_bwd_dkv_tc_short_kernel<2>, blocks, short_smem(2, true), a, stream);
    case 3: return launch_bwd(flash_bwd_dkv_tc_short_kernel<3>, blocks, short_smem(3, true), a, stream);
    default: return launch_bwd(flash_bwd_dkv_tc_short_kernel<4>, blocks, short_smem(4, true), a, stream);
  }
}

int flash_bwd_tc(bool dkv, int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                 void* dv, int B, int N, int H, int D, const long long* strides, float scale,
                 int device, void* stream) {
  if (dtype != kBFloat16 || D != kD || N < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  BwdArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.BH = B * H;
  a.N = N;
  a.H = H;
  for (int o = 0; o < 7; ++o) {
    for (int i = 0; i < 3; ++i) a.st[o][i] = strides[3 * o + i];
  }
  a.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dkv ? launch_dkv_tc(a, s) : launch_dq_tc(a, s));
}

}  // namespace tc
}  // namespace latte

// The arguments of latte_flash_attention_bwd_dq / _dkv (flash_attention_bwd.cu):
// dtype must be bf16 and D 72; the base pointers and the (batch, token, head)
// strides of q, k, v, dout and the written gradients 16-byte aligned, the
// last axis of each contiguous. lse and delta are contiguous fp32 (B*H, N).
// The dq entry writes dq only (dk, dv unused); the dkv entry dk and dv only.
extern "C" int latte_flash_attention_bwd_dq_tc(int dtype, const void* q, const void* k,
                                               const void* v, const void* dout, const void* lse,
                                               const void* delta, void* dq, void* dk, void* dv,
                                               int B, int N, int H, int D,
                                               const long long* strides, float scale, int device,
                                               void* stream) {
  return latte::tc::flash_bwd_tc(false, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, N, H, D,
                                 strides, scale, device, stream);
}

extern "C" int latte_flash_attention_bwd_dkv_tc(int dtype, const void* q, const void* k,
                                                const void* v, const void* dout, const void* lse,
                                                const void* delta, void* dq, void* dk, void* dv,
                                                int B, int N, int H, int D,
                                                const long long* strides, float scale, int device,
                                                void* stream) {
  return latte::tc::flash_bwd_tc(true, dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, N, H, D,
                                 strides, scale, device, stream);
}
