// Flash-attention forward for Hopper (sm_90a), bf16 or f32 in, f32 softmax.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_attn_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: blockwise
// attention with an online softmax whose running max m, sum l and
// accumulator acc stay in f32; GQA by reading K/V at head h / (H / Kh); a
// per-batch kv_lens mask; the top-left causal mask qpos >= kpos; KV tiles
// above the diagonal are never loaded.  A row with no valid key gives 0.
// Given an lse pointer, the epilogue also writes each query row's
// log-sum-exp of its scaled scores from the running max and sum, -inf for a
// row with no valid key, for the backward (flash_attention_bwd.cu); a null
// pointer, what every served call passes, leaves the served work unchanged.
//
// What bounds it on the card.  The work is 4*B*H*D*pairs flops (pairs = the
// unmasked (query, key) pairs, about Sq*Sk/2 when causal) against
// q + k + v + o bytes.  At the serving path's causal prefill lengths
// (65..900 tokens, D = 128, bf16) that is at most ~225 flops per byte, under
// the H100's ~295 bf16 flops per byte, so moving q, k, v and o once is the
// bound, with tensor-core time close behind at the longest prompts.
//
// What the design does.
//   * bf16 (the serving path): one block per (head, query tile, batch row)
//     with one or two consumer warpgroups of 64 query rows each and one
//     producer warpgroup.  One producer thread issues TMA copies
//     (cp.async.bulk.tensor through 4-D tensor maps (D, heads, S, B), so a
//     tile that runs past S is zero-filled and never reads the next batch
//     row): Q once, and K/V tiles of KT keys into a ring of STAGES stages,
//     each K and each V tile with its own full and empty mbarriers.  The
//     consumers wait on a tile's phase, compute S = Q K^T with wgmma
//     (m64 n128 k16, Q and K read from shared memory, K-major) and release
//     K; mask only the tiles that cross the diagonal or kv_len; run the
//     online softmax in registers; convert P to bf16 A fragments in
//     registers (the accumulator layout of S is the A-fragment layout of P,
//     as in FlashAttention-2/3; P rounded to bf16 for P V); and compute
//     O += P V with wgmma (A from registers, V the MN-major shared operand,
//     transpose bit set), then release V.  Tile t's Q K^T is issued before
//     tile t-1's P V, so tile t's softmax runs while that P V is on the
//     tensor cores, and two consumer warpgroups take turns to issue their
//     products (named barriers), so one's softmax runs while the other's
//     products do (FlashAttention-3's ping-pong).  The softmax is one FFMA
//     and one ex2.approx per score.  Tiles are stored with the widest
//     swizzle a D-wide row slice allows (128 B at D 64 and 128, split into
//     two 64-column atom columns at D 128; 64 B at D 32; 32 B at D 16),
//     which is what the wgmma descriptors read.  The producer gives its
//     registers to the consumers with setmaxnreg.  Query tiles are issued
//     longest first (blockIdx.y reversed, heads fastest), so the grid's
//     tail runs the short causal tiles.
//   * f32: scalar FMAs from shared memory (tensor cores would round f32 to
//     TF32); each thread owns 4 rows x 4 keys of S and the same 4 rows x
//     D/16 output columns, with rows padded to D + 1 floats.  A correctness
//     path for float32 models: no configuration served on the card is f32,
//     and at llama2 prefill shapes it is slower than the plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper_sm90.cuh"

namespace {

constexpr int BQ = 64;          // f32: query rows per block
constexpr int BK = 64;          // f32: keys per KV tile
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------- f32 kernel
constexpr int NT32 = 256;       // threads: 16 x 16
constexpr int PP = BK + 16;     // row stride of the P tile (conflict-free)

template <int D>
constexpr int smem_bytes_f32() {
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PP) * (int)sizeof(float);
}

// q, o: (B, Sq, H, D); k, v: (B, Sk, Kh, D); all contiguous.
// kv_lens: (B,) int32 or null.  grid = (ceil(Sq / BQ), H, B).
template <int D>
__global__ void __launch_bounds__(NT32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ kv_lens, int H,
              int Kh, int Sq, int Sk, float sm_scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x DP, pre-scaled
  float* sK = sQ + BQ * DP;     // BK x DP
  float* sV = sK + BK * DP;     // BK x D
  float* sP = sV + BK * D;      // BQ x PP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x;
  const int tx = tid & 15;      // key / output-column lane
  const int ty = tid >> 4;      // query-row lane

  const int64_t q_stride = (int64_t)H * D;    // between consecutive positions
  const int64_t kv_stride = (int64_t)Kh * D;
  const float* qb = q + ((int64_t)b * Sq * H + h) * D;
  const float* kb = k + ((int64_t)b * Sk * Kh + kh) * D;
  const float* vb = v + ((int64_t)b * Sk * Kh + kh) * D;
  float* ob = o + ((int64_t)b * Sq * H + h) * D;

  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  int k_end = kv_len;           // keys at or past k_end are masked for every row
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int i = tid; i < BQ * D; i += NT32) {
    const int r = i / D, c = i % D, pos = q0 + r;
    sQ[r * DP + c] = pos < Sq ? qb[pos * q_stride + c] * sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // the previous tile's sK / sV / sP are consumed
    for (int i = tid; i < BK * D; i += NT32) {
      const int r = i / D, c = i % D, pos = k0 + r;
      const bool in = pos < Sk;
      sK[r * DP + c] = in ? kb[pos * kv_stride + c] : 0.f;
      sV[r * D + c] = in ? vb[pos * kv_stride + c] : 0.f;
    }
    __syncthreads();

    // S = (Q * sm_scale) K^T for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // masks, online softmax, P tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < kv_len && (!causal || kpos <= qpos);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + ty + 16 * i;
    if (pos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[pos * q_stride + tx + 16 * c] = acc[i][c] / denom;
    if (lse && tx == 0)
      lse[((int64_t)b * H + h) * Sq + pos] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// ------------------------------------------------------------ bf16 kernel
constexpr int KT = 128;         // keys per K/V tile: the n of S = Q K^T
constexpr int STAGES = 2;       // depth of the K/V ring
constexpr int PRODUCER_REGS = 24;

// Registers a thread starts with (the launch bound) and what a consumer
// raises them to once the producer warpgroup has lowered its own to
// PRODUCER_REGS: the two changes balance, so setmaxnreg never waits.
template <int NWG> struct Regs {
  static constexpr int ENTRY = NWG == 2 ? 168 : 128;
  static constexpr int CONSUMER = (ENTRY + (ENTRY - PRODUCER_REGS) / NWG) / 8 * 8;
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : 2;
};

template <int D, int NWG> struct Smem {
  static constexpr int BQ16 = 64 * NWG;
  static constexpr int Q_BYTES = BQ16 * D * 2;
  static constexpr int KV_BYTES = KT * D * 2;           // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;  // + alignment
};

// S = Q K^T for one K tile, over the head dim 16 columns a step: issued and
// committed as one group, not waited for.
template <int D, int BQ16>
__device__ __forceinline__ void issue_qk(float (&sacc)[KT / 2],
                                         const unsigned char* q_wg,
                                         const unsigned char* k_s) {
  using G = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk * 16 / G::SWE, off = (kk * 16 % G::SWE) * 2;
    wgmma_ss_n128(sacc, gmma_desc(q_wg + a * BQ16 * G::SW + off, 16, 8 * G::SW, G::LAYOUT),
                  gmma_desc(k_s + a * KT * G::SW + off, 16, 8 * G::SW, G::LAYOUT), kk > 0);
  }
  wg_commit();
}

// O += P V for one V tile, 16 keys a step: issued and committed as one
// group, not waited for.  P's registers and O's belong to the product until
// it is waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         const uint32_t (&pa)[KT / 16][4],
                                         const unsigned char* v_s) {
  using G = Geo<D>;
  constexpr uint32_t V_LBO = G::NA > 1 ? KT * G::SW : 16;   // next atom column
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_pv<D>(oacc, pa[kk], gmma_desc(v_s + kk * 16 * G::SW, V_LBO, 8 * G::SW, G::LAYOUT));
  wg_commit();
}

// Ping-pong between two consumer warpgroups (named barriers 1 and 2): a
// warpgroup issues its products only in its turn and then passes the turn,
// so one warpgroup's softmax runs while the other's products do.
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
template <int NWG>
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (NWG == 2)
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
template <int NWG>
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (NWG == 2) named_arrive(2 - wg);
}

// Online softmax of one tile of raw scores, in place, for the thread's rows
// row0 and row1: mask where `edge` (the tile crosses kv_len or the
// diagonal; -inf, so exp2 gives exactly 0), raise the running maxima m0/m1
// (log2 domain: scores times scale_log2) over the 4 lanes of a row, turn
// the scores into exp2(s scale_log2 - m) (one FFMA and one MUFU.EX2 each),
// and rescale the running sums l0/l1 by alpha before adding them.  Returns
// alpha (a0, a1) for the accumulator.
__device__ __forceinline__ void softmax_tile(float (&sacc)[KT / 2], int k0,
                                             bool edge, int kv_len, int causal,
                                             int row0, int row1, int t4,
                                             float scale_log2, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    if (edge) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool valid = key < kv_len && (!causal || key <= row);
        if (!valid) sacc[4 * j + e] = -INFINITY;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
  a0 = fast_exp2(m0 - mn0);
  a1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    sacc[4 * j] = fast_exp2(fmaf(sacc[4 * j], scale_log2, -mn0));
    sacc[4 * j + 1] = fast_exp2(fmaf(sacc[4 * j + 1], scale_log2, -mn0));
    sacc[4 * j + 2] = fast_exp2(fmaf(sacc[4 * j + 2], scale_log2, -mn1));
    sacc[4 * j + 3] = fast_exp2(fmaf(sacc[4 * j + 3], scale_log2, -mn1));
    r0 += sacc[4 * j] + sacc[4 * j + 1];
    r1 += sacc[4 * j + 2] + sacc[4 * j + 3];
  }
  l0 = l0 * a0 + r0;
  l1 = l1 * a1 + r1;
}

// P (bf16) as wgmma A fragments: keys 16k..16k+15 are accumulator tiles
// 2k and 2k + 1.
__device__ __forceinline__ void to_frags(const float (&p)[KT / 2],
                                         uint32_t (&pa)[KT / 16][4]) {
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    pa[j / 2][(j & 1) * 2] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

// Accumulator layout of wgmma m64nN (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4j + e] holds row 16w + g (e < 2) or 16w + g + 8 (e >= 2),
// column 8j + 2t + (e & 1).  That is mma.sync's C layout per 8-column tile,
// and keys 16k..16k+15 of S (tiles 2k, 2k+1) are P's A fragment k.
//
// q, o: (B, Sq, H, D); k, v: (B, Sk, Kh, D); all contiguous, read through
// the tensor maps tq / tk / tv.  kv_lens: (B,) int32 or null.
// grid = (H, ceil(Sq / (64 NWG)), B); block = 128 (NWG + 1) threads.
template <int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), Regs<NWG>::MIN_BLOCKS)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               const int* __restrict__ kv_lens, int H, int Kh, int Sq, int Sk,
               float scale_log2, int causal) {
  using G = Geo<D>;
  using L = Smem<D, NWG>;
  constexpr int BQ16 = L::BQ16;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on a 1024-byte boundary (the 128-byte swizzle's period)
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + L::Q_BYTES;                  // STAGES K tiles
  unsigned char* sV = sK + STAGES * L::KV_BYTES;        // STAGES V tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sQ + L::BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ16;   // longest tiles first
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);             // GQA: the KV head of head h
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  int k_end = kv_len;           // keys at or past k_end are masked for every row
  if (causal) k_end = min(k_end, min(q0 + BQ16, Sq));
  const int n_tiles = (k_end + KT - 1) / KT;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 128 * NWG);  // every consumer thread releases
      mbar_init(empty_v + s, 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer warpgroup: one thread issues every copy
    regs_lower<PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int a = 0; a < G::NA; ++a)
        tma_load_4d(sQ + a * BQ16 * G::SW, &tq, bar_q, a * G::SWE, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int free_parity = ((t / STAGES) & 1) ^ 1;   // round 0 passes at once
        mbar_wait(empty_k + s, free_parity);
        mbar_expect_tx(full_k + s, L::KV_BYTES);
#pragma unroll
        for (int a = 0; a < G::NA; ++a)
          tma_load_4d(sK + s * L::KV_BYTES + a * KT * G::SW, &tk, full_k + s,
                      a * G::SWE, kh, t * KT, b);
        mbar_wait(empty_v + s, free_parity);
        mbar_expect_tx(full_v + s, L::KV_BYTES);
#pragma unroll
        for (int a = 0; a < G::NA; ++a)
          tma_load_4d(sV + s * L::KV_BYTES + a * KT * G::SW, &tv, full_v + s,
                      a * G::SWE, kh, t * KT, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    regs_raise<Regs<NWG>::CONSUMER>();
    const int tid = threadIdx.x % 128;
    const int g = (tid & 31) >> 2, t4 = tid & 3;
    const int wrow = q0 + wg * 64;                 // this warpgroup's first row
    const int row0 = wrow + (tid >> 5) * 16 + g, row1 = row0 + 8;
    const unsigned char* q_wg = sQ + wg * 64 * G::SW;

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's part
    float sacc[KT / 2] = {};
    uint32_t pa[KT / 16][4];
    mbar_wait(bar_q, 0);

    // Tile t's S = Q K^T is issued before tile t-1's O += P V, and its
    // softmax runs while that product is on the tensor cores; with two
    // consumer warpgroups they also take turns to issue, so one's softmax
    // runs while the other's products do.  Tile 0 is peeled, so every wgmma
    // of the loop is issued on every pass.
    if (NWG == 2 && wg == 1) named_arrive(1);    // warpgroup 0 goes first
    if (n_tiles > 0) {
      turn_wait<NWG>(wg);
      mbar_wait(full_k, 0);
      issue_qk<D, BQ16>(sacc, q_wg, sK);
      turn_pass<NWG>(wg);
      wg_wait<0>();
      fence_regs(sacc);
      mbar_arrive(empty_k);
      float a0, a1;                               // oacc is 0: nothing to rescale
      softmax_tile(sacc, 0, KT > kv_len || (causal && KT - 1 > wrow), kv_len,
                   causal, row0, row1, t4, scale_log2, m0, m1, l0, l1, a0, a1);
      to_frags(sacc, pa);
    }
    for (int tile = 1; tile < n_tiles; ++tile) {
      const int s = tile % STAGES, phase = (tile / STAGES) & 1;
      const int ps = (tile - 1) % STAGES, pphase = ((tile - 1) / STAGES) & 1;
      turn_wait<NWG>(wg);
      mbar_wait(full_k + s, phase);
      issue_qk<D, BQ16>(sacc, q_wg, sK + s * L::KV_BYTES);
      mbar_wait(full_v + ps, pphase);
      issue_pv<D>(oacc, pa, sV + ps * L::KV_BYTES);
      turn_pass<NWG>(wg);
      wg_wait<1>();                               // S of this tile is done
      fence_regs(sacc);
      mbar_arrive(empty_k + s);                   // K of this tile is consumed
      const int k0 = tile * KT;
      const bool edge = k0 + KT > kv_len || (causal && k0 + KT - 1 > wrow);
      float a0, a1;
      softmax_tile(sacc, k0, edge, kv_len, causal, row0, row1, t4, scale_log2,
                   m0, m1, l0, l1, a0, a1);
      wg_wait<0>();                               // the previous P V is done
      fence_regs(oacc);
      fence_frags(pa);
      mbar_arrive(empty_v + ps);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        oacc[4 * n] *= a0;
        oacc[4 * n + 1] *= a0;
        oacc[4 * n + 2] *= a1;
        oacc[4 * n + 3] *= a1;
      }
      to_frags(sacc, pa);
    }
    if (n_tiles > 0) {
      const int ps = (n_tiles - 1) % STAGES;
      turn_wait<NWG>(wg);
      mbar_wait(full_v + ps, ((n_tiles - 1) / STAGES) & 1);
      issue_pv<D>(oacc, pa, sV + ps * L::KV_BYTES);
      turn_pass<NWG>(wg);
      wg_wait<0>();
      fence_regs(oacc);
      fence_frags(pa);
      mbar_arrive(empty_v + ps);
    }


#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int64_t q_stride = (int64_t)H * D;
    __nv_bfloat16* ob = o + ((int64_t)b * Sq * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + col) =
            pack_bf16(oacc[4 * n] * inv0, oacc[4 * n + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * q_stride + col) =
            pack_bf16(oacc[4 * n + 2] * inv1, oacc[4 * n + 3] * inv1);
    }
    if (lse && t4 == 0) {       // m is in the log2 domain: lse = m ln 2 + ln l
      float* lrow = lse + ((int64_t)b * H + h) * Sq;
      if (row0 < Sq) lrow[row0] = l0 > 0.f ? m0 * 0.6931471805599453f + logf(l0) : -INFINITY;
      if (row1 < Sq) lrow[row1] = l1 > 0.f ? m1 * 0.6931471805599453f + logf(l1) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------- launch
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* kv_lens, int B, int H, int Kh, int Sq, int Sk,
               float sm_scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes_f32<D>();
  static std::atomic<uint64_t> ready{0};
  const int err = allow_smem(reinterpret_cast<const void*>(flash_fwd_f32<D>), smem, ready);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32<D><<<grid, NT32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, kv_lens, H, Kh,
      Sq, Sk, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int NWG>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* kv_lens, int B, int H, int Kh, int Sq, int Sk,
                float sm_scale, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<D, NWG>::BYTES;
  static std::atomic<uint64_t> ready{0};
  int err = allow_smem(reinterpret_cast<const void*>(flash_fwd_bf16<D, NWG>), smem, ready);
  if (err) return err;
  EncodeTiled encode = nullptr;
  if ((err = tensor_map_encoder(&encode))) return err;
  CUtensorMap tq, tk, tv;     // the pointers change per call: encoded per launch
  if ((err = make_map<D>(&tq, encode, q, H, Sq, B, 64 * NWG)) ||
      (err = make_map<D>(&tk, encode, k, Kh, Sk, B, KT)) ||
      (err = make_map<D>(&tv, encode, v, Kh, Sk, B, KT)))
    return err;
  const dim3 grid(H, (Sq + 64 * NWG - 1) / (64 * NWG), B);
  flash_fwd_bf16<D, NWG><<<grid, 128 * (NWG + 1), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, kv_lens, H, Kh, Sq, Sk,
      sm_scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// Consumer warpgroups per block when the caller does not choose: two (128
// query rows a block, each K/V tile read once for both) unless the prompt
// fits in one such tile, where 64-row blocks give twice the blocks
// (tools/k1_tiles.py on the H100: S 77 0.0057 ms with one, 0.0065 with two;
// S 384 and 901 faster with two).
inline int default_wgs(int Sq) { return Sq <= 128 ? 1 : 2; }

template <int D>
int launch_d(int dtype, int wgs, const void* q, const void* k, const void* v,
             void* o, float* lse, const int* kv_lens, int B, int H, int Kh,
             int Sq, int Sk, float sm_scale, int causal, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (wgs == 0) wgs = default_wgs(Sq);
  if (wgs == 1)
    return launch_bf16<D, 1>(q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
  if (wgs == 2)
    return launch_bf16<D, 2>(q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point with the bf16 kernel's consumer warpgroups per block chosen
// by the caller (1: 64 query rows a block, 2: 128; 0: the default rule).
// dtype: 0 = float32, 1 = bfloat16; q, k, v, o contiguous and 16-byte
// aligned.  lse: (B, H, Sq) f32 or null; where given, each query row's
// log-sum-exp of its scaled scores (natural log) is written there, -inf
// for a row with no valid key (what the backward reads).  Returns a cudaError_t (0 on success): the launch status from
// cudaGetLastError, or cudaErrorInvalidValue for a head dim, dtype or
// warpgroup count the kernel does not take or a tensor map the driver
// refuses.
extern "C" int flash_attention_fwd_wgs(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const int* kv_lens, int B, int H,
                                       int Kh, int Sq, int Sk, int D,
                                       int dtype, float sm_scale, int causal,
                                       int wgs, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(dtype, wgs, q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
    case 32: return launch_d<32>(dtype, wgs, q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
    case 64: return launch_d<64>(dtype, wgs, q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
    case 128: return launch_d<128>(dtype, wgs, q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry point.  The same, with the default rule for the bf16 kernel.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* kv_lens,
                                   int B, int H, int Kh, int Sq, int Sk, int D,
                                   int dtype, float sm_scale, int causal,
                                   void* stream) {
  return flash_attention_fwd_wgs(q, k, v, o, lse, kv_lens, B, H, Kh, Sq, Sk, D,
                                 dtype, sm_scale, causal, 0, stream);
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
