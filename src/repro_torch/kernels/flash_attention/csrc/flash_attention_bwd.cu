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
// byte, so the tensor cores are the bound, not memory.
//
// What the design does (FlashAttention-2's split, simple first).  Three
// kernels on the caller's stream, no atomics, so every gradient is summed
// in a fixed order and a run repeats bit for bit:
//   1. delta: one warp per (batch, query, head) row, delta = rowsum(dO * O).
//   2. dK/dV: one block per (key tile, KV head, batch row).  It keeps its K
//      and V tile in shared memory and its dK/dV accumulators in registers,
//      and loops over the G query heads of its KV head and over the query
//      tiles the causal mask leaves (from the tile's first key on), loading
//      Q and dO once per query tile.  Nothing is written until the loops end.
//   3. dQ: one block per (query tile, head, batch row), looping over the key
//      tiles up to the causal and kv_lens limit, dQ in registers.
//   S and dP are recomputed in both (2), (3), as FlashAttention-2 does.
//   bf16: warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate); each warp
//   owns 16 rows of its block's tile.  P and dS are turned from the
//   accumulator layout into A fragments in registers (P and dS rounded to
//   bf16 for their products, as the forward rounds P); the operands whose
//   reduction dimension is the tile's rows (dO and Q for dV and dK, K for
//   dQ) are also stored transposed in shared memory, so every fragment is
//   one 32-bit shared load.  Rows are padded by 8 elements, so the fragment
//   loads of a warp hit 32 different banks.
//   f32: scalar FMAs from shared memory (tensor cores would round to TF32),
//   256 threads each owning 2 x 2 pairs of the 32 x 32 score tile and 2 rows
//   x D/16 columns of the gradient tile.
//   wgmma, TMA and a pipelined ring are for a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
constexpr int NW = 4;           // bf16: warps per block, 16 rows each
constexpr int BT = 16 * NW;     // the block's own rows (keys for dK/dV, queries for dQ)
constexpr int IT = 32;          // rows of the tile the block loops over
constexpr int LDT = IT + 8;     // row stride of a transposed (D x IT) tile

template <int D>
constexpr int smem_dkdv_bf16() {
  return (2 * BT + 2 * IT) * (D + 8) * 2 + 2 * D * LDT * 2 + 2 * IT * 4;
}
template <int D>
constexpr int smem_dq_bf16() {
  return (2 * BT + 2 * IT) * (D + 8) * 2 + D * LDT * 2 + 2 * BT * 4;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);    // .x (lo) in bits 0..15
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major fragment) b (16 x 8, bf16,
// column fragment).  Fragments (g = lane / 4, t = lane % 4): a[0] row g cols
// 2t, 2t+1; a[1] row g+8; a[2] row g cols 2t+8, 2t+9; a[3] row g+8 cols
// 2t+8, 2t+9.  b0 k 2t, 2t+1 of column g; b1 k 2t+8, 2t+9.  c[0], c[1] row g
// cols 2t, 2t+1; c[2], c[3] row g+8.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows r .. r + 15, columns c .. c + 15 of a row-major
// tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int ld, int r, int c, int g, int t) {
  a[0] = ld32(s + (r + g) * ld + c + 2 * t);
  a[1] = ld32(s + (r + g + 8) * ld + c + 2 * t);
  a[2] = ld32(s + (r + g) * ld + c + 2 * t + 8);
  a[3] = ld32(s + (r + g + 8) * ld + c + 2 * t + 8);
}

// Accumulator tiles n, n + 1 (16 x 16 of f32) as a bf16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows r0 .. r0 + rows - 1 of a (B, S, heads, D) bf16 tensor at (b, head)
// into a row-major tile of stride D + 8 and, where `dst_t` is given, also
// transposed into a D x LDT tile; 16-byte loads, rows at or past S zero.
template <int D>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               __nv_bfloat16* dst_t,
                                               const __nv_bfloat16* src, int b,
                                               int head, int heads, int r0,
                                               int rows, int S) {
  constexpr int V8 = D / 8;
  const __nv_bfloat16* base = src + ((int64_t)b * S * heads + head) * D;
  for (int i = threadIdx.x; i < rows * V8; i += blockDim.x) {
    const int r = i / V8, c = (i % V8) * 8, pos = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < S)
      val = *reinterpret_cast<const uint4*>(base + (int64_t)pos * heads * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
    if (dst_t) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) dst_t[(c + u) * LDT + r] = e[u];
    }
  }
}

// Write a warp's 16 x D f32 accumulator (rows r .. r + 15 of a (B, S, heads,
// D) bf16 tensor at (b, head)) times `scale`; rows at or past S are skipped.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                const float (&acc)[D / 8][4],
                                                int b, int head, int heads,
                                                int r, int S, float scale,
                                                int g, int t) {
  __nv_bfloat16* base = dst + ((int64_t)b * S * heads + head) * D;
  const int ra = r + g, rb = r + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(base + (int64_t)ra * heads * D + col) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(base + (int64_t)rb * heads * D + col) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// grid = (ceil(Sk / BT), Kh, B); block = 32 NW threads.  Warp w owns keys
// j0 + 16 w .. + 15 and their dK / dV rows.
template <int D>
__global__ void __launch_bounds__(32 * NW)
bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              const int* __restrict__ kv_lens, int H, int Kh, int Sq, int Sk,
              float sm_scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BT x LD
  __nv_bfloat16* sV = sK + BT * LD;
  __nv_bfloat16* sQ = sV + BT * LD;      // IT x LD
  __nv_bfloat16* sO = sQ + IT * LD;      // dO
  __nv_bfloat16* sQT = sO + IT * LD;     // D x LDT
  __nv_bfloat16* sOT = sQT + D * LDT;
  float* sL = reinterpret_cast<float*>(sOT + D * LDT);   // IT
  float* sD = sL + IT;

  const int j0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  const float scale_log2 = sm_scale * LOG2E;

  load_rows_bf16<D>(sK, nullptr, k, b, kh, Kh, j0, BT, Sk);
  load_rows_bf16<D>(sV, nullptr, v, b, kh, Kh, j0, BT, Sk);
  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;

  const int i_begin = causal ? j0 / IT * IT : 0;
  for (int hh = 0; hh < G && j0 < kv_len; ++hh) {
    const int h = kh * G + hh;
    const float* lrow = lse + ((int64_t)b * H + h) * Sq;
    const float* drow = delta + ((int64_t)b * H + h) * Sq;
    for (int i0 = i_begin; i0 < Sq; i0 += IT) {
      __syncthreads();          // the previous query tile is consumed
      load_rows_bf16<D>(sQ, sQT, q, b, h, H, i0, IT, Sq);
      load_rows_bf16<D>(sO, sOT, dout, b, h, H, i0, IT, Sq);
      if (threadIdx.x < IT) {
        const int i = i0 + threadIdx.x;
        sL[threadIdx.x] = i < Sq ? lrow[i] * LOG2E : 0.f;
        sD[threadIdx.x] = i < Sq ? drow[i] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x IT queries
      float st[IT / 8][4] = {}, dpt[IT / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, LD, 16 * w, 16 * kk, g, t);
        load_a(av, sV, LD, 16 * w, 16 * kk, g, t);
#pragma unroll
        for (int n = 0; n < IT / 8; ++n) {
          const __nv_bfloat16* qr = sQ + (8 * n + g) * LD + 16 * kk + 2 * t;
          const __nv_bfloat16* orow = sO + (8 * n + g) * LD + 16 * kk + 2 * t;
          mma16816(st[n], ak, ld32(qr), ld32(qr + 8));
          mma16816(dpt[n], av, ld32(orow), ld32(orow + 8));
        }
      }
      // P^T and dS^T in place
#pragma unroll
      for (int n = 0; n < IT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 16 * w + g + (e >= 2 ? 8 : 0);
          const int qi = 8 * n + 2 * t + (e & 1);
          const bool ok = pair_valid(i0 + qi, key, Sq, kv_len, causal);
          const float p = ok ? exp2f(fmaf(st[n][e], scale_log2, -sL[qi])) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sD[qi]);
        }
      // dV += P^T dO and dK += dS^T Q over the IT queries, 16 at a step
#pragma unroll
      for (int kk = 0; kk < IT / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const __nv_bfloat16* ot = sOT + (8 * n + g) * LDT + 16 * kk + 2 * t;
          const __nv_bfloat16* qt = sQT + (8 * n + g) * LDT + 16 * kk + 2 * t;
          mma16816(dvacc[n], pa, ld32(ot), ld32(ot + 8));
          mma16816(dkacc[n], da, ld32(qt), ld32(qt + 8));
        }
      }
    }
  }
  store_rows_bf16<D>(dk, dkacc, b, kh, Kh, j0 + 16 * w, Sk, sm_scale, g, t);
  store_rows_bf16<D>(dv, dvacc, b, kh, Kh, j0 + 16 * w, Sk, 1.f, g, t);
}

// grid = (ceil(Sq / BT), H, B); block = 32 NW threads.  Warp w owns queries
// i0 + 16 w .. + 15 and their dQ rows.
template <int D>
__global__ void __launch_bounds__(32 * NW)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, const int* __restrict__ kv_lens,
            int H, int Kh, int Sq, int Sk, float sm_scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BT x LD
  __nv_bfloat16* sO = sQ + BT * LD;
  __nv_bfloat16* sK = sO + BT * LD;      // IT x LD
  __nv_bfloat16* sV = sK + IT * LD;
  __nv_bfloat16* sKT = sV + IT * LD;     // D x LDT
  float* sL = reinterpret_cast<float*>(sKT + D * LDT);   // BT
  float* sD = sL + BT;

  const int i0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  int k_end = kv_len;           // keys at or past k_end are masked for every row
  if (causal) k_end = min(k_end, min(i0 + BT, Sq));
  const float scale_log2 = sm_scale * LOG2E;

  load_rows_bf16<D>(sQ, nullptr, q, b, h, H, i0, BT, Sq);
  load_rows_bf16<D>(sO, nullptr, dout, b, h, H, i0, BT, Sq);
  for (int r = threadIdx.x; r < BT; r += blockDim.x) {
    const int64_t idx = ((int64_t)b * H + h) * Sq + i0 + r;
    sL[r] = i0 + r < Sq ? lse[idx] * LOG2E : 0.f;
    sD[r] = i0 + r < Sq ? delta[idx] : 0.f;
  }
  float dqacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[n][e] = 0.f;

  for (int j0 = 0; j0 < k_end; j0 += IT) {
    __syncthreads();            // the previous key tile is consumed
    load_rows_bf16<D>(sK, sKT, k, b, kh, Kh, j0, IT, Sk);
    load_rows_bf16<D>(sV, nullptr, v, b, kh, Kh, j0, IT, Sk);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: this warp's 16 queries x IT keys
    float s[IT / 8][4] = {}, dp[IT / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, LD, 16 * w, 16 * kk, g, t);
      load_a(ao, sO, LD, 16 * w, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < IT / 8; ++n) {
        const __nv_bfloat16* kr = sK + (8 * n + g) * LD + 16 * kk + 2 * t;
        const __nv_bfloat16* vr = sV + (8 * n + g) * LD + 16 * kk + 2 * t;
        mma16816(s[n], aq, ld32(kr), ld32(kr + 8));
        mma16816(dp[n], ao, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < IT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 16 * w + g + (e >= 2 ? 8 : 0);
        const int key = j0 + 8 * n + 2 * t + (e & 1);
        const bool ok = pair_valid(i0 + qi, key, Sq, kv_len, causal);
        const float p = ok ? exp2f(fmaf(s[n][e], scale_log2, -sL[qi])) : 0.f;
        dp[n][e] = p * (dp[n][e] - sD[qi]);
      }
    // dQ += dS K over the IT keys, 16 at a step
#pragma unroll
    for (int kk = 0; kk < IT / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* kt = sKT + (8 * n + g) * LDT + 16 * kk + 2 * t;
        mma16816(dqacc[n], da, ld32(kt), ld32(kt + 8));
      }
    }
  }
  store_rows_bf16<D>(dq, dqacc, b, h, H, i0 + 16 * w, Sq, sm_scale, g, t);
}

// ---------------------------------------------------------------- launch
// Raise a kernel's dynamic shared-memory limit once per device, not on every
// launch: bit d of `ready` says it is done on device d.
inline int allow_smem(const void* fn, int smem, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return 0;
}

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
  constexpr int smem_kv = smem_dkdv_bf16<D>(), smem_q = smem_dq_bf16<D>();
  static std::atomic<uint64_t> ready_kv{0}, ready_q{0};
  if ((err = allow_smem(reinterpret_cast<const void*>(bwd_dkdv_bf16<D>), smem_kv, ready_kv)) ||
      (err = allow_smem(reinterpret_cast<const void*>(bwd_dq_bf16<D>), smem_q, ready_q)))
    return err;
  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(a.q);
  const bf* k = static_cast<const bf*>(a.k);
  const bf* v = static_cast<const bf*>(a.v);
  const bf* dout = static_cast<const bf*>(a.dout);
  bwd_dkdv_bf16<D><<<dim3((a.Sk + BT - 1) / BT, a.Kh, a.B), 32 * NW, smem_kv, a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.kv_lens, a.H, a.Kh, a.Sq, a.Sk, a.sm_scale,
      a.causal);
  if ((err = (int)cudaGetLastError())) return err;
  bwd_dq_bf16<D><<<dim3((a.Sq + BT - 1) / BT, a.H, a.B), 32 * NW, smem_q, a.st>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf*>(a.dq), a.kv_lens, a.H,
      a.Kh, a.Sq, a.Sk, a.sm_scale, a.causal);
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
