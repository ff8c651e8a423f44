// Flash-attention backward for Hopper (sm_90a), bf16 or f32 in, f32 sums.
//
// Replaces the backward of the reference's flash attention: the custom_vjp
// rule `_flash_bwd` in src/repro/kernels/flash_attention/ops.py, which has no
// Pallas kernel and recomputes the gradients through `attention_ref` under
// jax.vjp.  It computes what that rule computes, but with the forward's own
// masks: the top-left causal mask qpos >= kpos and keys at or past kv_lens[b]
// masked (`attention_ref` aligns its causal mask bottom-right, which differs
// from the forward when Sq != Sk).  For every valid (query i, key j) of a
// head, with the forward's log-sum-exp `lse` (natural log of the row's sum
// of exp(scale * s)):
//
//   P = exp(scale * q_i.k_j - lse_i),  delta_i = dO_i . O_i,
//   dV_j += P dO_i,  dP = dO_i . v_j,  dS = P (dP - delta_i),
//   dQ_i += scale dS k_j,  dK_j += scale dS q_i,
//
// GQA: dK and dV of a KV head sum over the G query heads that read it.
// Masked pairs contribute nothing, so a query row with no valid key gets
// dQ = 0 and a key at or past kv_lens[b] (or that no query reaches) gets
// dK = dV = 0.  Sums in f32; dq, dk, dv are written in the input dtype.
//
// What bounds it on the card.  Five products of 2 D flops per valid pair
// and head (S, dP, dV, dK, dQ) against q, k, v, o, dO, lse read once and
// dq, dk, dv written once: at the training shape (B 2, S 2048, 32 heads,
// D 128, causal, bf16) that is 172 GFLOP against 235 MB, ~730 flops a
// byte, so the tensor cores are the bound, not memory.  This design does
// seven products (S and dP in both gradient passes), 241 GFLOP there.
//
// What the design does.  Three kernels on the caller's stream, no atomics,
// so every gradient is summed in a fixed order and a launch repeats bit for
// bit (what makes training losses and resumes repeat exactly):
//   1. delta: one warp per (batch, query, head) row, delta = rowsum(dO * O).
//   2. dK/dV (bf16: bwd_dkdv_bf16): one block per (KV head, batch row, tile
//      of 128 keys), two consumer warpgroups of 64 keys and one producer
//      warpgroup (FlashAttention-3's shape).  One producer thread loads the
//      block's K and V once by TMA (the forward's 4-D tensor maps (D,
//      heads, S, B): rows past S are zero-filled and never read the next
//      batch row), then streams the Q and dO tiles of 64 queries through a
//      ring of KV_STAGES stages, walking the G query heads of the KV head and
//      the query tiles the causal mask leaves; the lanes of its warp copy
//      each tile's lse (times log2 e) and delta into the stage beside them.
//      Each stage has a full mbarrier (the copy's bytes and the 32 lanes)
//      and an empty one (one arrival per consumer warp).  A consumer
//      warpgroup computes S^T = K Q^T and dP^T = V dO^T with wgmma (m64 n64
//      k16, both operands in shared memory, K-major), P^T = exp2(S^T scale
//      log2e - lse log2e) in registers (masks only on tiles that cross the
//      diagonal, kv_len or Sq), dS^T = P^T (dP^T - delta), turns P^T and
//      dS^T into bf16 A fragments in registers (the accumulator layout is
//      the A-fragment layout, as in the forward's P V), and adds dV += P^T
//      dO and dK += dS^T Q with wgmma (A from registers, dO and Q the
//      MN-major B operands: the transpose bit, as the forward reads V).
//      dK and dV stay in registers (2 x m64 nD f32 a warpgroup) until the
//      loops end; setmaxnreg moves the producer's registers to them.  A
//      warpgroup skips the tiles where all its pairs are masked.  Key tiles
//      are issued longest first (blockIdx.z, key tile 0 first).
//   3. dQ (bwd_dq_bf16): one block per (head, batch row, tile of 128
//      queries), two consumer warpgroups of 64 queries, Q and dO resident,
//      K and V tiles of 128 keys streamed through the same kind of ring.
//      S = Q K^T and dP = dO V^T are shared-memory products (m64 n128), dQ
//      += dS K takes dS from registers and K as the MN-major operand.
//      Query tiles are issued longest first (the forward's reversed index).
//   S and dP are computed in both (2) and (3), as FlashAttention-2 does: two
//   products more than one pass with an atomic dQ, and no f32 dQ scratch.
//   Tried on the H100 and not kept (tools/k1_bwd_variants.py, PERF.md):
//   the forward's ping-pong turns between the two consumer warpgroups,
//   issuing dV's product before dP^T is waited for, and 64-key dQ tiles.
//   f32: scalar FMAs from shared memory (tensor cores would round to TF32),
//   256 threads each owning 2 x 2 pairs of the 32 x 32 score tile and 2 rows
//   x D/16 columns of the gradient tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper_sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------- delta
// delta[(b H + h) Sq + i] = sum_d dO[b, i, h, d] O[b, i, h, d]; one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, int B, int Sq, int H, int D) {
  const int64_t rows = (int64_t)B * Sq * H;
  const int lane = threadIdx.x & 31;
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(op[d]), to_f(dp[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bi = row / H;
    const int i = (int)(bi % Sq), b = (int)(bi / Sq);
    delta[((int64_t)b * H + h) * Sq + i] = s;
  }
}

__device__ __forceinline__ bool pair_valid(int qpos, int key, int Sq,
                                           int kv_len, int causal) {
  return qpos < Sq && key < kv_len && (!causal || key <= qpos);
}

// ----------------------------------------------------------- f32 kernels
constexpr int T32 = 32;         // f32: rows of every tile
constexpr int NT32 = 256;       // threads: 16 x 16

template <int D>
constexpr int smem_f32() {
  return (4 * T32 * (D + 1) + 2 * T32 * (T32 + 1) + 2 * T32) * (int)sizeof(float);
}

// Rows r0 .. r0 + T32 - 1 of a (B, S, heads, D) f32 tensor at (b, head) into
// a T32 x (D + 1) tile; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int b, int head, int heads,
                                              int r0, int S) {
  const float* base = src + ((int64_t)b * S * heads + head) * D;
  for (int i = threadIdx.x; i < T32 * D; i += blockDim.x) {
    const int r = i / D, c = i % D, pos = r0 + r;
    dst[r * (D + 1) + c] = pos < S ? base[(int64_t)pos * heads * D + c] : 0.f;
  }
}

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, Kh, D); lse, delta:
// (B, H, Sq).  grid = (ceil(Sk / T32), Kh, B).
template <int D>
__global__ void __launch_bounds__(NT32)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv,
             const int* __restrict__ kv_lens, int H, int Kh, int Sq, int Sk,
             float sm_scale, int causal) {
  constexpr int DP = D + 1, TP = T32 + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // keys x DP
  float* sV = sK + T32 * DP;
  float* sQ = sV + T32 * DP;    // queries x DP
  float* sO = sQ + T32 * DP;    // dO
  float* sP = sO + T32 * DP;    // P^T: keys x TP
  float* sS = sP + T32 * TP;    // dS^T
  float* sL = sS + T32 * TP;    // lse of the query tile
  float* sD = sL + T32;         // delta of the query tile

  const int j0 = blockIdx.x * T32, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;

  load_rows_f32<D>(sK, k, b, kh, Kh, j0, Sk);
  load_rows_f32<D>(sV, v, b, kh, Kh, j0, Sk);
  float ak[2][NC], av[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) ak[a][c] = av[a][c] = 0.f;

  // every key of the tile is masked when j0 >= kv_len; causal rows below j0
  // see none of its keys
  const int i_begin = causal ? j0 : 0;
  for (int hh = 0; hh < G && j0 < kv_len; ++hh) {
    const int h = kh * G + hh;
    const float* lrow = lse + ((int64_t)b * H + h) * Sq;
    const float* drow = delta + ((int64_t)b * H + h) * Sq;
    for (int i0 = i_begin; i0 < Sq; i0 += T32) {
      __syncthreads();          // the previous tile's sQ / sO / sP / sS are consumed
      load_rows_f32<D>(sQ, q, b, h, H, i0, Sq);
      load_rows_f32<D>(sO, dout, b, h, H, i0, Sq);
      if (tid < T32) {
        sL[tid] = i0 + tid < Sq ? lrow[i0 + tid] : 0.f;
        sD[tid] = i0 + tid < Sq ? drow[i0 + tid] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T for keys ty + 16 a, queries tx + 16 c
      float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float k0 = sK[ty * DP + d], k1 = sK[(ty + 16) * DP + d];
        const float v0 = sV[ty * DP + d], v1 = sV[(ty + 16) * DP + d];
        const float q0 = sQ[tx * DP + d], q1 = sQ[(tx + 16) * DP + d];
        const float o0 = sO[tx * DP + d], o1 = sO[(tx + 16) * DP + d];
        s[0][0] = fmaf(k0, q0, s[0][0]); s[0][1] = fmaf(k0, q1, s[0][1]);
        s[1][0] = fmaf(k1, q0, s[1][0]); s[1][1] = fmaf(k1, q1, s[1][1]);
        dp[0][0] = fmaf(v0, o0, dp[0][0]); dp[0][1] = fmaf(v0, o1, dp[0][1]);
        dp[1][0] = fmaf(v1, o0, dp[1][0]); dp[1][1] = fmaf(v1, o1, dp[1][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = ty + 16 * a, col = tx + 16 * c;
          const bool ok = pair_valid(i0 + col, j0 + r, Sq, kv_len, causal);
          const float p = ok ? expf(s[a][c] * sm_scale - sL[col]) : 0.f;
          sP[r * TP + col] = p;
          sS[r * TP + col] = p * (dp[a][c] - sD[col]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q for keys ty + 16 a, columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < T32; ++i) {
        const float p0 = sP[ty * TP + i], p1 = sP[(ty + 16) * TP + i];
        const float s0 = sS[ty * TP + i], s1 = sS[(ty + 16) * TP + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = sO[i * DP + tx + 16 * c], qv = sQ[i * DP + tx + 16 * c];
          av[0][c] = fmaf(p0, ov, av[0][c]);
          av[1][c] = fmaf(p1, ov, av[1][c]);
          ak[0][c] = fmaf(s0, qv, ak[0][c]);
          ak[1][c] = fmaf(s1, qv, ak[1][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = j0 + ty + 16 * a;
    if (key >= Sk) continue;
    const int64_t off = (((int64_t)b * Sk + key) * Kh + kh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = ak[a][c] * sm_scale;
      dv[off + tx + 16 * c] = av[a][c];
    }
  }
}

// grid = (ceil(Sq / T32), H, B).
template <int D>
__global__ void __launch_bounds__(NT32)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, const int* __restrict__ kv_lens, int H,
           int Kh, int Sq, int Sk, float sm_scale, int causal) {
  constexpr int DP = D + 1, TP = T32 + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // queries x DP
  float* sO = sQ + T32 * DP;    // dO
  float* sK = sO + T32 * DP;    // keys x DP
  float* sV = sK + T32 * DP;
  float* sS = sV + T32 * DP;    // dS: queries x TP
  float* sL = sS + 2 * T32 * TP;
  float* sD = sL + T32;

  const int i0 = blockIdx.x * T32, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  int k_end = kv_len;           // keys at or past k_end are masked for every row
  if (causal) k_end = min(k_end, min(i0 + T32, Sq));

  load_rows_f32<D>(sQ, q, b, h, H, i0, Sq);
  load_rows_f32<D>(sO, dout, b, h, H, i0, Sq);
  if (tid < T32) {
    const int64_t r = ((int64_t)b * H + h) * Sq + i0 + tid;
    sL[tid] = i0 + tid < Sq ? lse[r] : 0.f;
    sD[tid] = i0 + tid < Sq ? delta[r] : 0.f;
  }
  float aq[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) aq[a][c] = 0.f;

  for (int j0 = 0; j0 < k_end; j0 += T32) {
    __syncthreads();            // the previous tile's sK / sV / sS are consumed
    load_rows_f32<D>(sK, k, b, kh, Kh, j0, Sk);
    load_rows_f32<D>(sV, v, b, kh, Kh, j0, Sk);
    __syncthreads();
    // S and dP for queries ty + 16 a, keys tx + 16 c
    float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float q0 = sQ[ty * DP + d], q1 = sQ[(ty + 16) * DP + d];
      const float o0 = sO[ty * DP + d], o1 = sO[(ty + 16) * DP + d];
      const float k0 = sK[tx * DP + d], k1 = sK[(tx + 16) * DP + d];
      const float v0 = sV[tx * DP + d], v1 = sV[(tx + 16) * DP + d];
      s[0][0] = fmaf(q0, k0, s[0][0]); s[0][1] = fmaf(q0, k1, s[0][1]);
      s[1][0] = fmaf(q1, k0, s[1][0]); s[1][1] = fmaf(q1, k1, s[1][1]);
      dp[0][0] = fmaf(o0, v0, dp[0][0]); dp[0][1] = fmaf(o0, v1, dp[0][1]);
      dp[1][0] = fmaf(o1, v0, dp[1][0]); dp[1][1] = fmaf(o1, v1, dp[1][1]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = ty + 16 * a, col = tx + 16 * c;
        const bool ok = pair_valid(i0 + r, j0 + col, Sq, kv_len, causal);
        const float p = ok ? expf(s[a][c] * sm_scale - sL[r]) : 0.f;
        sS[r * TP + col] = p * (dp[a][c] - sD[r]);
      }
    __syncthreads();
    // dQ += dS K for queries ty + 16 a, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < T32; ++j) {
      const float s0 = sS[ty * TP + j], s1 = sS[(ty + 16) * TP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[j * DP + tx + 16 * c];
        aq[0][c] = fmaf(s0, kv, aq[0][c]);
        aq[1][c] = fmaf(s1, kv, aq[1][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int pos = i0 + ty + 16 * a;
    if (pos >= Sq) continue;
    const int64_t off = (((int64_t)b * Sq + pos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[off + tx + 16 * c] = aq[a][c] * sm_scale;
  }
}

// ---------------------------------------------------------- bf16 kernels
constexpr int NWG = 2;          // consumer warpgroups a block, 64 rows each
constexpr int THREADS = 128 * (NWG + 1);
constexpr int BKV = 64 * NWG;   // dK/dV: keys a block
constexpr int BQ = 64;          // dK/dV: queries a streamed tile
constexpr int BQD = 64 * NWG;   // dQ: queries a block
constexpr int BKD = 128;        // dQ: keys a streamed tile
constexpr int KV_STAGES = 3;    // depth of the dK/dV pass's Q/dO ring
constexpr int Q_STAGES = 2;     // depth of the dQ pass's K/V ring
// 168 registers a thread at the launch bound (one block of 384 threads an
// SM); the producer warpgroup lowers its own to 24 and the two consumer
// warpgroups raise theirs by what it gave up, so setmaxnreg never waits.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = (168 + (168 - PRODUCER_REGS) / NWG) / 8 * 8;

// Shared memory of a dK/dV block: K and V, then the ring's Q tiles, dO
// tiles, lse (times log2 e) and delta slices, then the mbarriers.
template <int D> struct DkdvSmem {
  static constexpr int KV_BYTES = BKV * D * 2;       // the block's K or V
  static constexpr int QO_BYTES = BQ * D * 2;        // one Q or dO tile
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int O_OFF = Q_OFF + KV_STAGES * QO_BYTES;
  static constexpr int L_OFF = O_OFF + KV_STAGES * QO_BYTES;
  static constexpr int DL_OFF = L_OFF + KV_STAGES * BQ * 4;
  static constexpr int BAR_OFF = DL_OFF + KV_STAGES * BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * KV_STAGES) + 1024;  // + alignment
};

// Shared memory of a dQ block: Q and dO, then the ring's K and V tiles,
// then the mbarriers.
template <int D> struct DqSmem {
  static constexpr int QO_BYTES = BQD * D * 2;       // the block's Q or dO
  static constexpr int KV_BYTES = BKD * D * 2;       // one K or V tile
  static constexpr int K_OFF = 2 * QO_BYTES;
  static constexpr int V_OFF = K_OFF + Q_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + Q_STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * Q_STAGES) + 1024;
};

// wgmma descriptor of a K-major operand: 64 or more rows of a swizzled
// tile whose atom columns lie R rows apart, head-dim columns 16 kk .. +15.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* rows, int kk) {
  using G = Geo<D>;
  return gmma_desc(rows + kk * 16 / G::SWE * R * G::SW + kk * 16 % G::SWE * 2,
                   16, 8 * G::SW, G::LAYOUT);
}

// wgmma descriptor of an R-row tile as the MN-major B operand (k = the
// tile's rows 16 kk .. +15, n = the head dim): the forward's V operand.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  using G = Geo<D>;
  return gmma_desc(tile + kk * 16 * G::SW, G::NA > 1 ? R * G::SW : 16,
                   8 * G::SW, G::LAYOUT);
}

// acc (m64 x N, f32) = A B^T over the head dim, both K-major in shared
// memory (B's N rows): issued and committed as one group, not waited for.
template <int D, int RA, int RB, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], const unsigned char* a,
                                         const unsigned char* b) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (N == 64)
      wgmma_ss_n64(acc, desc_k<D, RA>(a, kk), desc_k<D, RB>(b, kk), kk > 0);
    else
      wgmma_ss_n128(acc, desc_k<D, RA>(a, kk), desc_k<D, RB>(b, kk), kk > 0);
  }
  wg_commit();
}

// acc (m64 x D, f32) += A (m64 x kN, bf16 fragments) B (kN x D, the
// MN-major N-row tile), 16 rows of B a step; not committed.
template <int D, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[N / 16][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_pv<D>(acc, a[kk], desc_mn<D, N>(b, kk));
}

// A 64 x N f32 accumulator as bf16 A fragments of its N columns, 16 a
// step: columns 16k .. 16k + 15 are accumulator tiles 2k and 2k + 1.
template <int N>
__device__ __forceinline__ void acc_frags(const float (&p)[N / 2],
                                          uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    pa[j / 2][(j & 1) * 2] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

// A consumer warp is done with a ring stage: its lanes' reads of it have
// completed (their wgmma products waited for, their loads used), so one
// lane arrives for the warp.
__device__ __forceinline__ void warp_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Write a warpgroup's m64 x D f32 accumulator times `scale` to rows r0 (e <
// 2) and r0 + 8 of a (B, S, heads, D) bf16 tensor at (b, head); rows at or
// past S are skipped.  Accumulator layout of wgmma m64nN (warp w, g = lane
// / 4, t = lane % 4): d[4n + e] holds row 16w + g (e < 2) or 16w + g + 8,
// column 8n + 2t + (e & 1).
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, const float (&acc)[D / 2],
                                          int b, int head, int heads, int r0,
                                          int S, float scale, int t4) {
  __nv_bfloat16* base = dst + ((int64_t)b * S * heads + head) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(base + (int64_t)r0 * heads * D + col) =
          pack_bf16(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (int64_t)(r0 + 8) * heads * D + col) =
          pack_bf16(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// q, dout: (B, Sq, H, D) and k, v: (B, Sk, Kh, D), read through the tensor
// maps tq / tdo (64-row boxes) and tk / tv (128-row boxes); dk, dv: (B, Sk,
// Kh, D); lse, delta: (B, H, Sq).  grid = (Kh, B, ceil(Sk / BKV)); block =
// THREADS.  Consumer warpgroup wg owns keys j0 + 64 wg .. + 63.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              const int* __restrict__ kv_lens, int H, int Kh, int Sq, int Sk,
              float sm_scale, int causal) {
  using G = Geo<D>;
  using L = DkdvSmem<D>;
  constexpr int STAGES = KV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on a 1024-byte boundary (the 128-byte swizzle's period)
  unsigned char* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + L::KV_BYTES;
  unsigned char* sQ = sK + L::Q_OFF;
  unsigned char* sO = sK + L::O_OFF;
  float* sL = reinterpret_cast<float*>(sK + L::L_OFF);
  float* sDl = reinterpret_cast<float*>(sK + L::DL_OFF);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sK + L::BAR_OFF);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int kh = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * BKV;
  const int group = H / Kh;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  // causal rows before j0 see none of the block's keys; a block past
  // kv_len has no valid key
  const int i_begin = causal ? j0 : 0;
  const int n_q = j0 < kv_len && i_begin < Sq ? (Sq - i_begin + BQ - 1) / BQ : 0;
  const int n_tiles = group * n_q;        // (head, query tile), heads outermost

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 33);            // the copy's expect_tx and 32 lanes
      mbar_init(empty + s, 4 * NWG);      // every consumer warp releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: its first warp streams the query tiles
    regs_lower<PRODUCER_REGS>();
    if (threadIdx.x < 128 * NWG + 32 && n_tiles > 0) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
#pragma unroll
        for (int a = 0; a < G::NA; ++a) {
          tma_load_4d(sK + a * BKV * G::SW, &tk, bar_kv, a * G::SWE, kh, j0, b);
          tma_load_4d(sV + a * BKV * G::SW, &tv, bar_kv, a * G::SWE, kh, j0, b);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int h = kh * group + t / n_q, i0 = i_begin + t % n_q * BQ;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);   // round 0 passes at once
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * L::QO_BYTES);
#pragma unroll
          for (int a = 0; a < G::NA; ++a) {
            tma_load_4d(sQ + s * L::QO_BYTES + a * BQ * G::SW, &tq, full + s,
                        a * G::SWE, h, i0, b);
            tma_load_4d(sO + s * L::QO_BYTES + a * BQ * G::SW, &tdo, full + s,
                        a * G::SWE, h, i0, b);
          }
        }
        const float* lrow = lse + ((int64_t)b * H + h) * Sq;
        const float* drow = delta + ((int64_t)b * H + h) * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = i0 + r < Sq;
          sL[s * BQ + r] = in ? lrow[i0 + r] * LOG2E : 0.f;
          sDl[s * BQ + r] = in ? drow[i0 + r] : 0.f;
        }
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys j0 + 64 wg .. + 63
    regs_raise<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int t4 = tid & 3;
    const int wkey = j0 + wg * 64;                  // this warpgroup's first key
    const int key0 = wkey + (tid >> 5) * 16 + ((tid & 31) >> 2), key1 = key0 + 8;
    const unsigned char* k_wg = sK + wg * 64 * G::SW;
    const unsigned char* v_wg = sV + wg * 64 * G::SW;
    const float scale_log2 = sm_scale * LOG2E;

    float dvacc[D / 2], dkacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dvacc[i] = dkacc[i] = 0.f;
    if (n_tiles > 0) mbar_wait(bar_kv, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int i0 = i_begin + t % n_q * BQ;
      mbar_wait(full + s, (t / STAGES) & 1);
      // skipped where every pair of this warpgroup's keys is masked
      if (wkey < kv_len && !(causal && wkey > i0 + BQ - 1)) {
        const unsigned char* q_s = sQ + s * L::QO_BYTES;
        const unsigned char* o_s = sO + s * L::QO_BYTES;
        const float* ls = sL + s * BQ;
        const float* ds = sDl + s * BQ;
        float st[BQ / 2], dpt[BQ / 2];              // S^T, dP^T: keys x queries
        issue_ss<D, BKV, BQ, BQ>(st, k_wg, q_s);
        issue_ss<D, BKV, BQ, BQ>(dpt, v_wg, o_s);
        wg_wait<1>();                               // S^T is done
        fence_regs(st);
        const bool edge = wkey + 64 > kv_len || i0 + BQ > Sq ||
                          (causal && wkey + 63 > i0);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(st[4 * j + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
            if (edge && !pair_valid(i0 + 8 * j + 2 * t4 + (e & 1), e < 2 ? key0 : key1,
                                    Sq, kv_len, causal))
              p = 0.f;
            st[4 * j + e] = p;
          }
        }
        wg_wait<0>();                               // dP^T is done
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        acc_frags<BQ>(st, pa);
        acc_frags<BQ>(dpt, da);
        wg_fence();
        issue_rs<D, BQ>(dvacc, pa, o_s);            // dV += P^T dO
        issue_rs<D, BQ>(dkacc, da, q_s);            // dK += dS^T Q
        wg_commit();
        wg_wait<0>();
        fence_regs(dvacc);
        fence_regs(dkacc);
        fence_frags(pa);
        fence_frags(da);
      }
      warp_release(empty + s);                      // Q, dO, lse and delta read
    }
    store_acc<D>(dk, dkacc, b, kh, Kh, key0, Sk, sm_scale, t4);
    store_acc<D>(dv, dvacc, b, kh, Kh, key0, Sk, 1.f, t4);
  }
}

// q, dout, dq: (B, Sq, H, D) and k, v: (B, Sk, Kh, D); q / dout read through
// the tensor maps tq / tdo (128-row boxes), k / v through tk / tv (64-row
// boxes); lse, delta: (B, H, Sq).  grid = (H, B, ceil(Sq / BQD)); block =
// THREADS.  Consumer warpgroup wg owns queries i0 + 64 wg .. + 63.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, const int* __restrict__ kv_lens,
            int H, int Kh, int Sq, int Sk, float sm_scale, int causal) {
  using G = Geo<D>;
  using L = DqSmem<D>;
  constexpr int STAGES = Q_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sO = sQ + L::QO_BYTES;
  unsigned char* sK = sQ + L::K_OFF;
  unsigned char* sV = sQ + L::V_OFF;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sQ + L::BAR_OFF);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BQD;    // longest tiles first
  const int kh = h / (H / Kh);
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  int k_end = kv_len;           // keys at or past k_end are masked for every row
  if (causal) k_end = min(k_end, min(i0 + BQD, Sq));
  const int n_tiles = (k_end + BKD - 1) / BKD;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: one thread issues every copy
    regs_lower<PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * L::QO_BYTES);
#pragma unroll
      for (int a = 0; a < G::NA; ++a) {
        tma_load_4d(sQ + a * BQD * G::SW, &tq, bar_q, a * G::SWE, h, i0, b);
        tma_load_4d(sO + a * BQD * G::SW, &tdo, bar_q, a * G::SWE, h, i0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * L::KV_BYTES);
#pragma unroll
        for (int a = 0; a < G::NA; ++a) {
          tma_load_4d(sK + s * L::KV_BYTES + a * BKD * G::SW, &tk, full + s,
                      a * G::SWE, kh, t * BKD, b);
          tma_load_4d(sV + s * L::KV_BYTES + a * BKD * G::SW, &tv, full + s,
                      a * G::SWE, kh, t * BKD, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: queries i0 + 64 wg .. + 63
    regs_raise<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int t4 = tid & 3;
    const int wrow = i0 + wg * 64;                  // this warpgroup's first query
    const int row0 = wrow + (tid >> 5) * 16 + ((tid & 31) >> 2), row1 = row0 + 8;
    const unsigned char* q_wg = sQ + wg * 64 * G::SW;
    const unsigned char* o_wg = sO + wg * 64 * G::SW;
    const float scale_log2 = sm_scale * LOG2E;
    const float* lrow = lse + ((int64_t)b * H + h) * Sq;
    const float* drow = delta + ((int64_t)b * H + h) * Sq;
    const float l0 = row0 < Sq ? lrow[row0] * LOG2E : 0.f;
    const float l1 = row1 < Sq ? lrow[row1] * LOG2E : 0.f;
    const float d0 = row0 < Sq ? drow[row0] : 0.f;
    const float d1 = row1 < Sq ? drow[row1] : 0.f;

    float dqacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
    if (n_tiles > 0) mbar_wait(bar_q, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, k0 = t * BKD;
      mbar_wait(full + s, (t / STAGES) & 1);
      // skipped where every key of the tile is past this warpgroup's rows
      if (!(causal && k0 > wrow + 63)) {
        const unsigned char* k_s = sK + s * L::KV_BYTES;
        const unsigned char* v_s = sV + s * L::KV_BYTES;
        float sa[BKD / 2], dpa[BKD / 2];            // S, dP: queries x keys
        issue_ss<D, BQD, BKD, BKD>(sa, q_wg, k_s);
        issue_ss<D, BQD, BKD, BKD>(dpa, o_wg, v_s);
        wg_wait<1>();
        fence_regs(sa);
        const bool edge = k0 + BKD > kv_len || (causal && k0 + BKD - 1 > wrow);
#pragma unroll
        for (int j = 0; j < BKD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sa[4 * j + e], scale_log2, e < 2 ? -l0 : -l1));
            if (edge && !pair_valid(e < 2 ? row0 : row1, k0 + 8 * j + 2 * t4 + (e & 1),
                                    Sq, kv_len, causal))
              p = 0.f;
            sa[4 * j + e] = p;
          }
        wg_wait<0>();
        fence_regs(dpa);
#pragma unroll
        for (int j = 0; j < BKD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpa[4 * j + e] = sa[4 * j + e] * (dpa[4 * j + e] - (e < 2 ? d0 : d1));
        uint32_t da[BKD / 16][4];
        acc_frags<BKD>(dpa, da);
        wg_fence();
        issue_rs<D, BKD>(dqacc, da, k_s);           // dQ += dS K
        wg_commit();
        wg_wait<0>();
        fence_regs(dqacc);
        fence_frags(da);
      }
      warp_release(empty + s);                      // K and V read
    }
    store_acc<D>(dq, dqacc, b, h, H, row0, Sq, sm_scale, t4);
  }
}

// ---------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int* kv_lens;
  int B, H, Kh, Sq, Sk;
  float sm_scale;
  int causal;
  cudaStream_t st;
};

template <typename T>
int launch_delta(const Args& a, int D) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  const int64_t blocks = (rows + 7) / 8;          // 8 warps a block
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bwd_delta<T><<<(unsigned)blocks, 256, 0, a.st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.B,
      a.Sq, a.H, D);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a) {
  int err = launch_delta<float>(a, D);
  if (err) return err;
  constexpr int smem = smem_f32<D>();
  static std::atomic<uint64_t> ready_kv{0}, ready_q{0};
  if ((err = allow_smem(reinterpret_cast<const void*>(bwd_dkdv_f32<D>), smem, ready_kv)) ||
      (err = allow_smem(reinterpret_cast<const void*>(bwd_dq_f32<D>), smem, ready_q)))
    return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  bwd_dkdv_f32<D><<<dim3((a.Sk + T32 - 1) / T32, a.Kh, a.B), NT32, smem, a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.kv_lens, a.H, a.Kh, a.Sq, a.Sk, a.sm_scale,
      a.causal);
  if ((err = (int)cudaGetLastError())) return err;
  bwd_dq_f32<D><<<dim3((a.Sq + T32 - 1) / T32, a.H, a.B), NT32, smem, a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.kv_lens, a.H,
      a.Kh, a.Sq, a.Sk, a.sm_scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a) {
  int err = launch_delta<__nv_bfloat16>(a, D);
  if (err) return err;
  constexpr int smem_kv = DkdvSmem<D>::BYTES, smem_q = DqSmem<D>::BYTES;
  static std::atomic<uint64_t> ready_kv{0}, ready_q{0};
  if ((err = allow_smem(reinterpret_cast<const void*>(bwd_dkdv_bf16<D>), smem_kv, ready_kv)) ||
      (err = allow_smem(reinterpret_cast<const void*>(bwd_dq_bf16<D>), smem_q, ready_q)))
    return err;
  EncodeTiled encode = nullptr;
  if ((err = tensor_map_encoder(&encode))) return err;
  // the pointers change per call: encoded per launch, one map per box height
  CUtensorMap q_t, do_t, k_b, v_b, q_b, do_b, k_t, v_t;
  if ((err = make_map<D>(&q_t, encode, a.q, a.H, a.Sq, a.B, BQ)) ||
      (err = make_map<D>(&do_t, encode, a.dout, a.H, a.Sq, a.B, BQ)) ||
      (err = make_map<D>(&k_b, encode, a.k, a.Kh, a.Sk, a.B, BKV)) ||
      (err = make_map<D>(&v_b, encode, a.v, a.Kh, a.Sk, a.B, BKV)) ||
      (err = make_map<D>(&q_b, encode, a.q, a.H, a.Sq, a.B, BQD)) ||
      (err = make_map<D>(&do_b, encode, a.dout, a.H, a.Sq, a.B, BQD)) ||
      (err = make_map<D>(&k_t, encode, a.k, a.Kh, a.Sk, a.B, BKD)) ||
      (err = make_map<D>(&v_t, encode, a.v, a.Kh, a.Sk, a.B, BKD)))
    return err;
  using bf = __nv_bfloat16;
  bwd_dkdv_bf16<D><<<dim3(a.Kh, a.B, (a.Sk + BKV - 1) / BKV), THREADS, smem_kv, a.st>>>(
      q_t, k_b, v_b, do_t, a.lse, a.delta, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.kv_lens, a.H, a.Kh, a.Sq, a.Sk, a.sm_scale,
      a.causal);
  if ((err = (int)cudaGetLastError())) return err;
  bwd_dq_bf16<D><<<dim3(a.H, a.B, (a.Sq + BQD - 1) / BQD), THREADS, smem_q, a.st>>>(
      q_b, k_t, v_t, do_b, a.lse, a.delta, static_cast<bf*>(a.dq), a.kv_lens,
      a.H, a.Kh, a.Sq, a.Sk, a.sm_scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point.  q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, Kh,
// D); all contiguous, one dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned.  lse: (B, H, Sq) f32 from the forward; delta: (B, H, Sq) f32
// scratch, overwritten; kv_lens: (B,) int32 or null.  Launches three kernels
// on `stream` and returns a cudaError_t (0 on success): the launch status
// from cudaGetLastError, or cudaErrorInvalidValue for a shape, head dim or
// dtype the kernels do not take.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   const int* kv_lens, int B, int H, int Kh,
                                   int Sq, int Sk, int D, int dtype,
                                   float sm_scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, kv_lens,
               B, H, Kh, Sq, Sk, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch_d<16>(dtype, a);
    case 32: return launch_d<32>(dtype, a);
    case 64: return launch_d<64>(dtype, a);
    case 128: return launch_d<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
