// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// The TPU reference has no kernel for it: src/repro/models/ssm.py:73
// (ssd_chunked) is differentiated by jax.grad.  This computes, from the
// forward's saved chunk states, what that gradient is: dx, ddt, dA, dB and
// dC of
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//         + exp(cs_i) S_0 C_i                         (S_0: state entering)
//   S_1   = exp(cs_last) S_0 + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// per chunk, cs the running sum of dt * A, given dy and the final state's
// cotangent.  With G = C B^T, L_ij = exp(cs_i - cs_j) for i >= j (else 0),
// M = G o L o dt_j, dM = dy x^T, D the cotangent of S_1, U_j = D B_j:
//   dx_j   = sum_i M_ij dy_i + w_j U_j,     w_j = exp(cs_last - cs_j) dt_j
//   dG     = sum_h dM o L o dt_j  ->  dC = dG B + sum_h exp(cs_i) S_0^T dy_i,
//                                     dB = dG^T C + sum_h w_j D^T x_j
//   dcs_k  = sum_j T_kj - sum_i T_ik + exp(cs_k) dy_k . (S_0 C_k) - w_k x_k.U_k
//            (+ exp(cs_last) <D, S_0> + sum_j w_j x_j.U_j at k = cl - 1),
//            T = dM o M;
//   ddt_j  = sum_i (dM o G o L)_ij + exp(cs_last - cs_j) x_j.U_j + A da_j,
//   da     = the reverse running sum of dcs in the chunk, dA = sum da dt;
//   D of chunk c-1 = exp(cs_last,c) D_c + sum_i exp(cs_i) dy_i C_i^T.
// L is a select before the exp (j <= i, i inside the chunk), so nothing
// above the diagonal reaches an exp: the reference's where(mask, exp(seg),
// 0) overflows there and its gradient is 0 * inf = NaN (ROADMAP F5).
//
// What bounds it on the card.  Per head the backward does about three
// times the forward's products: dM = dy x^T over the causal pairs, M^T dy,
// U = D B^T, V = S_0 C^T and Q; per chunk dG B and dG^T C; and the per-head
// state terms of dB and dC.  At mamba2-780m's train shape (x (2, 2048, 48,
// 64), N 128, chunk 256) that is ~20 G multiply-adds at the bf16 rate
// against ~111 MB, so it is bound by operations
// (chip_smoke.py::ssd_bwd_bound counts them), with ~8 f32 element
// operations and one exp per head and causal pair behind them.
//
// What the design does (bf16, the training path).  Five launches on one
// stream, every product on wgmma (m64, f32 sums), no atomics:
//   A. ssd_bwd_q_wg, per (chunk, head, batch row), one warpgroup: Q =
//      sum_i exp(cs_i) dy_i C_i^T (A: dy weighted by exp(cs), split hi /
//      lo in registers; B: C as the MN-major operand) into the workspace's
//      state slot, and in the same loop V = C S_0^T (S_0 split, staged
//      once) for the chunk's rows, whose dot with exp(cs_i) dy_i is dcs's
//      carried-state term (Work::vin).
//   B. ssd_bwd_dstate, per (1024 state elements, head, batch row): the
//      reverse recurrence, D of each chunk in place of its Q, and each
//      warp's part of <D, S_0> (Work::ds0p).
//   C. ssd_bwd_intra_wg, per (64-key tile jt, batch row, chunk, head
//      group), heavy key tiles first (jt = 0 has the most row tiles): a
//      consumer warpgroup and a producer warpgroup.  The producer stages
//      each head's x_j, cs and dt, its D split into hi / lo, and the dy_i
//      tiles of the row tiles i >= j through mbarrier rings (each tile
//      loaded into registers before the wait for its stage, then stored
//      and fenced to the async proxy).  The consumer walks its group's
//      heads in order; per head U = B_j D^T (wgmma, D split), dx_j = w_j U_j,
//      x_j.U_j; per row tile dM^T = x_j dy_i^T (both operands exact bf16),
//      then on the accumulator fragments L (select, then ex2), M, dM o G o
//      L (ddt's sum over rows, per thread) and T's column sums over the key
//      tile (a fixed shuffle tree, then the four warps in order); dG's
//      tiles of its key column accumulate dM o L o dt over the group's heads
//      in shared memory (each thread its own elements, in fragment order),
//      and dx_j += M^T dy_i runs on wgmma with M split into hi / lo register
//      fragments.  G = C B^T comes from the forward's saved f32 CB, read
//      once per block.  The group's dG partials go out once, G x (B, nc,
//      chunk, chunk) f32, not H x.
//   D. ssd_bwd_dbc_wg, per (chunk, 64-row tile, dC or dB, batch row): one
//      long product a block through a four-stage ring (one producer
//      warpgroup at N 128, two at N 64; no __syncthreads after set-up), a
//      head's tiles loaded into registers a head ahead: first dG summed over the
//      head groups in group order (split) against B (dC) or C (dB), then
//      one item a head, K = P: exp(cs_i) dy_i (dC) or w_j x_j (dB), the
//      row weights applied as the A tile is staged and split, against S_0
//      or D split.  The split f32 x f32 terms take three products (hi hi,
//      hi lo, lo hi).
//   E. ssd_bwd_dcs, per head: dcs from its parts, its reverse running sum
//      per chunk (a warp per chunk), ddt += A da, and dA summed over the
//      batch rows and chunks in a fixed order.
// Only f32 operands are split (M, D, S_0, dy weighted by exp(cs), x
// weighted by w, dG), once per tile, as the forward does: hi = bf16(v), lo
// = bf16(v - hi), a relative error near 2^-16; x, dy, B and C are exact in
// bf16.  Every tile is staged as bf16 in shared memory in the 128-byte
// swizzle the wgmma descriptors read (a TMA box's layout), by 16-byte
// loads through registers where the operand's base and strides allow (the
// model's column slices of its convolution output do at mamba2's and
// zamba2's widths: x, B and C rows of 6656 / 8448 bytes at offsets of
// multiples of 16), by 2-byte loads otherwise: masking a ragged chunk and
// padding P to 64 and N to 64 or 128 with zeros is a select at the load.
// dB and dC are shared by every head and dA sums over batch and sequence:
// each is reduced from partials in a fixed order, so two launches on the
// same inputs agree bit for bit.  The bf16 passes take P a multiple of 8
// up to 64, N up to 128 and chunks of up to 256 tokens.
//
// What holds it back now (tools/ssd_bwd_variants.py's ablations, PERF.md):
// not the products.  In the intra-chunk pass each key tile's block reads
// and splits every head's D (the key tiles of a chunk read it four times)
// and its dy tiles again, with one block an SM (its G^T and dG tiles take
// 128 KB of shared memory); in dB / dC each row tile's block reads and
// splits every head's S_0 or D.  Removing all the intra pass's per-step
// work leaves half its time.
//
// f32 inputs (no served or full-width model) keep the first simple passes:
// ssd_bwd_q, ssd_bwd_dstate, ssd_bwd_intra (per-head dG tiles into the
// workspace), ssd_bwd_dg_sum (dG over heads, in head order), ssd_bwd_dbc,
// ssd_bwd_dcs; every tile is staged in shared memory as f32 and every
// product is scalar f32 FMAs (the tensor cores would round f32 operands).
//
// The saved scratch is the forward's (ssd_scan_fwd.cu, Scratch), read
// only: the incoming states (B, nc, H, P, N) f32, CB (B, nc, chunk, chunk)
// f32 (written only for tiles j <= i of rows inside the chunk), cs (B, nc,
// H, chunk) f32.  The workspace (ssd_scan_bwd_workspace_floats) holds Q,
// then D, (B, nc, H, P, N), dG (bf16: per head group; f32: per head, then
// summed), and dcs's parts.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "hopper_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // threads of the f32 kernels and of E
constexpr int NMAX = 128;        // largest state size N (a multiple of 4)
constexpr int PMAX = 64;         // largest head dim P
constexpr int TT = 64;           // token tile
constexpr int LDT = TT + 4;      // f32 row stride of a 64-column tile
constexpr int LDN = NMAX + 4;    // f32 row stride of an N-column tile
constexpr int SMEM_MAX = 232448;
constexpr int WG = 128;          // threads of a warpgroup
constexpr int CHUNK_WG = 256;    // longest chunk of the bf16 passes
constexpr int Y_STAGES = 2;      // dy tiles in the intra pass's ring
constexpr int STATE_BLOCK = 4 * NT;   // state elements of a pass-B block
constexpr int DCS_NT = 512;      // threads of pass E: a warp per chunk
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

struct Strides {
  int64_t xb, xt, xh;            // x (B, S, H, P): batch, token, head; p is 1
  int64_t db, dt, dh;            // dt (B, S, H)
  int64_t bb, bt;                // Bm (B, S, N): batch, token; n is 1
  int64_t cb, ct;                // Cm (B, S, N)
};

// The forward's scratch (ssd_scan_fwd.cu, carve), in the same order, and
// the workspace's first slot.
struct Saved {
  float* ds;                     // Q, then D, here (in the workspace)
  const float* sin;
  const float* cb;
  const float* cs;
};

struct Work {
  float* dgh;                    // f32: (B, nc, H, chunk, chunk) per-head dG
  float* dg;                     // f32: (B, nc, chunk, chunk) dG over heads;
                                 // bf16: (G, B, nc, CLP, CLP) per head group
  float* rows;                   // (B, nc, H, njt, chunk) row sums of T
  float* own;                    // (B, nc, H, chunk) the rest of dcs
  float* vin;                    // bf16: (B, nc, H, chunk) carried-state term
  float* ds0p;                   // bf16: (B, nc, H, ds0_parts) of <D, S_0>
};

inline Saved carve_saved(const float* base, float* work, int B, int nc, int H,
                         int P, int N, int chunk) {
  const int64_t state = (int64_t)B * nc * H * P * N;
  Saved s;
  s.ds = work;
  s.sin = base;
  s.cb = base + state;
  s.cs = s.cb + ((int64_t)B * nc * chunk * chunk + 3) / 4 * 4;
  return s;
}

// Head groups of the bf16 intra pass: about two blocks an SM of the grid
// (B, nc, key tiles) without splitting heads unevenly, at most 8 (each
// group's dG partial is (B, nc, CLP, CLP) f32).
inline int head_groups(int B, int nc, int njt, int H) {
  const int64_t base = (int64_t)B * nc * njt;
  int g = (int)std::min<int64_t>(std::min<int64_t>(H, 8),
                                 std::max<int64_t>(1, (264 + base - 1) / base));
  const int hg = (H + g - 1) / g;
  return (H + hg - 1) / hg;
}

__host__ __device__ inline int state_blocks(int P, int N) {
  return (P * N + STATE_BLOCK - 1) / STATE_BLOCK;
}

// Parts of <D, S_0> pass B writes per (batch row, chunk, head): one a warp.
__host__ __device__ inline int ds0_parts(int P, int N) {
  return state_blocks(P, N) * (NT / 32);
}

// Floats of the workspace's slots (4-float aligned): Q / D (B, nc, H, P,
// N), then the Work slots in order; 0 for a slot the path does not use.
struct WorkSizes {
  int64_t qd, dgh, dg, rows, own, vin, ds0p;
  int64_t total() const { return qd + dgh + dg + rows + own + vin + ds0p; }
};

inline WorkSizes work_sizes(int B, int nc, int H, int P, int N, int chunk,
                            bool wg) {
  const int njt = (chunk + TT - 1) / TT, CLP = round_up(chunk, TT);
  const int64_t bnc = (int64_t)B * nc;
  const auto a4 = [](int64_t n) { return (n + 3) / 4 * 4; };
  WorkSizes z;
  z.qd = a4(bnc * H * P * N);
  z.dgh = wg ? 0 : a4(bnc * H * chunk * chunk);
  z.dg = wg ? a4(head_groups(B, nc, njt, H) * bnc * CLP * CLP) : a4(bnc * chunk * chunk);
  z.rows = a4(bnc * H * njt * chunk);
  z.own = a4(bnc * H * chunk);
  z.vin = wg ? a4(bnc * H * chunk) : 0;
  z.ds0p = wg ? a4(bnc * H * ds0_parts(P, N)) : 0;
  return z;
}

inline Work carve_work(float* base, int B, int nc, int H, int P, int N,
                       int chunk, bool wg) {
  const WorkSizes z = work_sizes(B, nc, H, P, N, chunk, wg);
  Work w;
  float* p = base + z.qd;
  w.dgh = z.dgh ? p : nullptr;
  p += z.dgh;
  w.dg = p;
  p += z.dg;
  w.rows = p;
  p += z.rows;
  w.own = p;
  p += z.own;
  w.vin = z.vin ? p : nullptr;
  p += z.vin;
  w.ds0p = z.ds0p ? p : nullptr;
  return w;
}

// Two f32 values as bf16 pairs hi = bf16(v) and lo = bf16(v - hi).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h),
                                                 v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Sum of one value per thread, in a fixed tree; every thread gets it.
// blockDim.x == NT.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// ====================================================== f32: simple passes

// rows x cols of a strided f32 matrix (row r at src + r * stride) into
// dst[r * ld + c], or dst[c * ld + r] when `transpose`, times scale[r] when
// given; zeros at rows >= valid_rows or columns >= valid_cols.  A thread
// issues TILE_BATCH loads before it stores any, so a tile costs a few
// memory latencies, not one per element it copies.
constexpr int TILE_BATCH = 8;

__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t stride, int rows,
                                          int valid_rows, int cols,
                                          int valid_cols, bool transpose,
                                          const float* scale = nullptr) {
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += TILE_BATCH * NT) {
    float v[TILE_BATCH];
#pragma unroll
    for (int u = 0; u < TILE_BATCH; ++u) {
      const int e = base + u * NT, r = e / cols, c = e % cols;
      v[u] = e < total && r < valid_rows && c < valid_cols ? src[r * stride + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < TILE_BATCH; ++u) {
      const int e = base + u * NT, r = e / cols, c = e % cols;
      if (e < total)
        dst[transpose ? c * ld + r : r * ld + c] = scale && r < valid_rows
                                                       ? v[u] * scale[r] : v[u];
    }
  }
}

// A TT x TT tile of the (chunk x chunk) f32 matrix m at rows i0, columns j0,
// into dst[(i - i0) * LDT + j - j0] (or transposed), 0 where !keep(i, j),
// loads batched as in load_tile.
template <bool transpose, typename Keep>
__device__ __forceinline__ void load_sq(float* __restrict__ dst,
                                        const float* __restrict__ m, int chunk,
                                        int i0, int j0, Keep keep) {
  for (int base = threadIdx.x; base < TT * TT; base += TILE_BATCH * NT) {
    float v[TILE_BATCH];
#pragma unroll
    for (int u = 0; u < TILE_BATCH; ++u) {
      const int e = base + u * NT, i = i0 + e / TT, j = j0 + e % TT;
      v[u] = keep(i, j) ? m[(int64_t)i * chunk + j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < TILE_BATCH; ++u) {
      const int e = base + u * NT, a = e / TT, b = e % TT;
      dst[transpose ? b * LDT + a : a * LDT + b] = v[u];
    }
  }
}

// The 16 elements (q, e) of a 64 x 64 tile that a thread holds: rows
// ty + 16 q, columns tx + 16 e.
__device__ __forceinline__ int lay_row(int q) { return (threadIdx.x >> 4) + 16 * q; }
__device__ __forceinline__ int lay_col(int e) { return (threadIdx.x & 15) + 16 * e; }

// acc(q, e) += sum_{k < K} A[row * ar + k * ak] * Bm[k * bk + col * bc] for
// the thread's 16 elements of a 64 x 64 tile, f32 FMAs.
__device__ __forceinline__ void prod(float (&acc)[4][4], const float* A,
                                     int ar, int ak, const float* Bm, int bk,
                                     int bc, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = A[(ty + 16 * q) * ar + k * ak];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = Bm[k * bk + (tx + 16 * e) * bc];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = fmaf(a[q], b[e], acc[q][e]);
  }
}

// A 64 x 64 product held by the threads (``prod``) into dst[row * ld + col].
__device__ __forceinline__ void store_tile(float* dst, int ld,
                                           const float (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[lay_row(q) * ld + lay_col(e)] = acc[q][e];
}

// out[r] = sum_{c < 64} a[r * ld + c] * b[r * ld + c] for the tile's 64
// rows: four threads a row, each over 16 columns, then a fixed shuffle tree.
__device__ __forceinline__ float row_dot(const float* a, const float* b,
                                         int ld) {
  const int r = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) s = fmaf(a[r * ld + c0 + c], b[r * ld + c0 + c], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;                          // every thread of the row's four has it
}

// ---------------------------------------------------------------- pass A
// Q = sum_i exp(cs_i) dy_i C_i^T, rows p, columns n in two 64-column halves.
// grid (nc, H, B).
__global__ void __launch_bounds__(NT)
ssd_bwd_q(const float* __restrict__ dy, const float* __restrict__ Cm, Saved sv,
          int S, int H, int P, int N, int chunk, Strides sd) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                  // TT (i) x LDT: dy_i exp(cs_i), columns p
  float* sC = sA + TT * LDT;         // TT (i) x LDN: C_i
  float* sE = sC + TT * LDN;         // TT: exp(cs_i)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const int64_t bch = ((int64_t)b * nc + c) * H + h;
  const float* cs = sv.cs + bch * chunk;
  float acc[2][4][4] = {};
  for (int i0 = 0; i0 < cl; i0 += TT) {
    __syncthreads();
    for (int t = threadIdx.x; t < TT; t += NT) sE[t] = i0 + t < cl ? expf(cs[i0 + t]) : 0.f;
    __syncthreads();
    load_tile(sA, LDT, dy + (((int64_t)b * S + c0 + i0) * H + h) * P, (int64_t)H * P,
              TT, cl - i0, TT, P, false, sE);
    load_tile(sC, LDN, Cm + b * sd.cb + (int64_t)(c0 + i0) * sd.ct, sd.ct, TT,
              cl - i0, NMAX, N, false);
    __syncthreads();
    prod(acc[0], sA, 1, LDT, sC, LDN, 1, TT);
    if (N > TT) prod(acc[1], sA, 1, LDT, sC + TT, LDN, 1, TT);
  }
  float* q = sv.ds + bch * P * N;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = lay_row(r), n = half * TT + lay_col(k);
        if (p < P && n < N) q[(int64_t)p * N + n] = acc[half][r][k];
      }
}

// ---------------------------------------------------------------- pass B
// D of each chunk, last to first: D_{nc-1} = the final state's cotangent
// (0 when none), D_{c-1} = exp(cs_last,c) D_c + Q_c, written over Q_c.
// With ds0p (bf16 passes), also each warp's part of <D_c, S_0,c> (a
// fixed shuffle tree), at ds0p[bch * ds0_parts + blockIdx.x * 8 + warp].
// grid (ceil(P N / STATE_BLOCK), H, B), four elements a thread.
__global__ void __launch_bounds__(NT)
ssd_bwd_dstate(float* __restrict__ q, const float* __restrict__ cs,
               const float* __restrict__ dfinal, const float* __restrict__ sin,
               float* __restrict__ ds0p, int H, int P, int N, int chunk,
               int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int PN = P * N, e = blockIdx.x * STATE_BLOCK + threadIdx.x * 4;
  const bool in = e < PN;
  if (!in && !ds0p) return;
  float4 d = in && dfinal
      ? *reinterpret_cast<const float4*>(dfinal + ((int64_t)b * H + h) * PN + e)
      : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int CB = 4;              // chunks whose loads are issued together
  for (int c1 = nc - 1; c1 >= 0; c1 -= CB) {
    float4 qv[CB], s0v[CB];
    float lastv[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c1 - k;
      const int64_t bch = ((int64_t)b * nc + c) * H + h;
      qv[k] = c >= 0 && in ? *reinterpret_cast<const float4*>(q + bch * PN + e) : zero;
      s0v[k] = c >= 0 && in && ds0p
                   ? *reinterpret_cast<const float4*>(sin + bch * PN + e) : zero;
      lastv[k] = c >= 0 ? cs[bch * chunk + chunk - 1] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const int c = c1 - k;
      if (c < 0) break;
      const int64_t bch = ((int64_t)b * nc + c) * H + h;
      if (in) *reinterpret_cast<float4*>(q + bch * PN + e) = d;
      if (ds0p) {
        const float4 s0 = s0v[k];
        float part = fmaf(d.x, s0.x, fmaf(d.y, s0.y, fmaf(d.z, s0.z, d.w * s0.w)));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if ((threadIdx.x & 31) == 0)
          ds0p[bch * ds0_parts(P, N) + blockIdx.x * (NT / 32) + (threadIdx.x >> 5)] = part;
      }
      const float g = expf(lastv[k]);
      const float4 qc = qv[k];
      d = make_float4(fmaf(d.x, g, qc.x), fmaf(d.y, g, qc.y), fmaf(d.z, g, qc.z),
                      fmaf(d.w, g, qc.w));
    }
  }
}

// ---------------------------------------------------------------- pass C
// Block (chunk c and key tile jt; head h; batch row b), keys j0..j0+63.
// grid (nc * njt, H, B).  The M / dM and G tiles of the loop over row
// tiles take the shared memory of the N-wide tiles (B_j, D, C, S_0), dead
// by then, so two blocks fit an SM.
__global__ void __launch_bounds__(NT, 2)
ssd_bwd_intra(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              const float* __restrict__ dy, Saved sv, Work wk,
              float* __restrict__ dx, float* __restrict__ ddt, int S, int H,
              int P, int N, int chunk, Strides sd) {
  extern __shared__ __align__(16) float smem[];
  const int njt = (chunk + TT - 1) / TT, CLP = round_up(chunk, TT);
  const int c = blockIdx.x / njt, jt = blockIdx.x % njt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + chunk - 1) / chunk;
  const int c0 = c * chunk, cl = min(chunk, S - c0), j0 = jt * TT;
  if (j0 >= cl) return;
  const int tid = threadIdx.x;
  float* sCs = smem;                 // CLP: cs of the chunk
  float* sDt = sCs + CLP;            // CLP: dt (0 past cl)
  float* sX = sDt + CLP;             // TT (j) x LDT: x_j
  float* sDy = sX + TT * LDT;        // TT (i) x LDT: dy_i
  float* sR = sDy + TT * LDT;        // TT x LDN: B_j, then C of the tile
  float* sP = sR + TT * LDN;         // TT (p) x LDN: D, then S_0
  float* sM = sR;                    // TT x LDT: U, V, dM, then M
  float* sQ = sP;                    // TT (i) x LDT: G, then dM o G o L
  float* sXU = sP + TT * LDN;        // TT: x_j . U_j
  float* sIn = sXU + TT;             // TT: exp(cs_i) dy_i . (S_0 C_i)
  float* sRed = sIn + TT;            // NT / 32 + 1
  const int64_t bch = ((int64_t)b * nc + c) * H + h;
  const int64_t PN = (int64_t)P * N;
  const float* csg = sv.cs + bch * chunk;
  const float* dtb = dt + b * sd.db + h * sd.dh + (int64_t)c0 * sd.dt;
  for (int t = tid; t < CLP; t += NT) {
    sCs[t] = csg[min(t, chunk - 1)];
    sDt[t] = t < cl ? dtb[(int64_t)t * sd.dt] : 0.f;
  }
  const float* xj = x + b * sd.xb + h * sd.xh + (int64_t)(c0 + j0) * sd.xt;
  load_tile(sX, LDT, xj, sd.xt, TT, cl - j0, TT, P, false);
  load_tile(sR, LDN, Bm + b * sd.bb + (int64_t)(c0 + j0) * sd.bt, sd.bt, TT,
            cl - j0, NMAX, N, false);
  load_tile(sP, LDN, sv.ds + bch * PN, N, TT, P, NMAX, N, false);
  __syncthreads();
  const float cs_last = sCs[cl - 1];

  // U_j = D B_j: dx starts at w_j U_j; x_j . U_j per key
  float u[4][4] = {};
  prod(u, sR, LDN, 1, sP, 1, LDN, N);
  // <D, S_0> for the last token's cs (one key tile per chunk takes it)
  float ds0 = 0.f;
  if (jt == 0) {
    float part = 0.f;
    const float* s0 = sv.sin + bch * PN;
    for (int e = tid; e < PN; e += NT) part = fmaf(sP[(e / N) * LDN + e % N], s0[e], part);
    ds0 = block_sum(part, sRed);
  }
  __syncthreads();                   // every read of B_j is done
  store_tile(sM, LDT, u);
  __syncthreads();
  float dxa[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = lay_row(q), j = j0 + jl;
      const float w = j < cl ? expf(cs_last - sCs[j]) * sDt[j] : 0.f;
      dxa[q][e] = w * sM[jl * LDT + lay_col(e)];
    }
  {
    const float xu = row_dot(sX, sM, LDT);
    if ((tid & 3) == 0) sXU[tid >> 2] = xu;
  }
  __syncthreads();                   // every read of U is done

  // V_i = S_0 C_i for the tile's rows i: the carried state's term of dcs
  load_tile(sR, LDN, Cm + b * sd.cb + (int64_t)(c0 + j0) * sd.ct, sd.ct, TT,
            cl - j0, NMAX, N, false);
  load_tile(sP, LDN, sv.sin + bch * PN, N, TT, P, NMAX, N, false);
  load_tile(sDy, LDT, dy + (((int64_t)b * S + c0 + j0) * H + h) * P,
            (int64_t)H * P, TT, cl - j0, TT, P, false);
  __syncthreads();                   // the loads are in
  {
    float v[4][4] = {};
    prod(v, sR, LDN, 1, sP, 1, LDN, N);
    __syncthreads();                 // every read of C is done
    store_tile(sM, LDT, v);
  }
  __syncthreads();
  {
    const float s_ = row_dot(sDy, sM, LDT);
    const int il = tid >> 2, i = j0 + il;
    if ((tid & 3) == 0) sIn[il] = i < cl ? expf(sCs[i]) * s_ : 0.f;
  }
  __syncthreads();
  // what the last token's cs gets from S_1 besides its own key: the tile's
  // sum_j w_j x_j . U_j, and exp(cs_last) <D, S_0> once per chunk
  if (tid == 0) {
    float e = 0.f;
    for (int jl = 0; jl < TT; ++jl) {
      const int j = j0 + jl;
      if (j < cl) e += expf(cs_last - sCs[j]) * sDt[j] * sXU[jl];
    }
    if (jt == 0) e += expf(cs_last) * ds0;
    sRed[NT / 32] = e;
  }

  float colq = 0.f;                  // thread jl < TT: sum_i (dM o G o L)_{i,jl}
  const int nit = (cl + TT - 1) / TT;
  for (int it = jt; it < nit; ++it) {
    const int i0 = it * TT;
    __syncthreads();                 // sDy, sM and sQ are free
    if (it != jt)
      load_tile(sDy, LDT, dy + (((int64_t)b * S + c0 + i0) * H + h) * P,
                (int64_t)H * P, TT, cl - i0, TT, P, false);
    load_sq<false>(sQ, sv.cb + ((int64_t)b * nc + c) * chunk * chunk, chunk,
                   i0, j0, [cl](int i, int j) { return i < cl && j <= i; });
    __syncthreads();
    {
      float dm[4][4] = {};
      prod(dm, sDy, LDT, 1, sX, 1, LDT, P);
      store_tile(sM, LDT, dm);
    }
    __syncthreads();
    float* dgh = wk.dgh + bch * chunk * chunk;
    for (int e = tid; e < TT * TT; e += NT) {
      const int il = e / TT, jl = e % TT, i = i0 + il, j = j0 + jl;
      const bool valid = i < cl && j <= i;
      const float L = valid ? expf(sCs[i] - sCs[j]) : 0.f;
      const float dm = sM[il * LDT + jl], g = sQ[il * LDT + jl];
      sM[il * LDT + jl] = g * L * sDt[j];
      sQ[il * LDT + jl] = dm * g * L;
      if (i < chunk && j < chunk) dgh[(int64_t)i * chunk + j] = dm * L * sDt[j];
    }
    __syncthreads();
    prod(dxa, sM, 1, LDT, sDy, LDT, 1, TT);  // dx_j += sum_i M_ij dy_i
    if (tid < TT) {
      for (int il = 0; il < TT; ++il) colq += sQ[il * LDT + tid];
    } else if (tid < 2 * TT) {
      const int il = tid - TT, i = i0 + il;
      if (i < chunk) {
        float s_ = 0.f;
        for (int jl = 0; jl < TT; ++jl) s_ = fmaf(sQ[il * LDT + jl], sDt[j0 + jl], s_);
        if (i == cl - 1) s_ += sRed[NT / 32];
        wk.rows[(bch * njt + jt) * chunk + i] = s_;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + lay_row(q), p = lay_col(e);
      if (j < cl && p < P) dx[(((int64_t)b * S + c0 + j) * H + h) * P + p] = dxa[q][e];
    }
  if (tid < TT) {
    const int j = j0 + tid;
    if (j < cl) {
      const float dec = expf(cs_last - sCs[j]);
      const float xu = sXU[tid];
      ddt[((int64_t)b * S + c0 + j) * H + h] = colq + dec * xu;
      wk.own[bch * chunk + j] = -sDt[j] * colq - dec * sDt[j] * xu + sIn[tid];
    }
  }
}

// --------------------------------------------------------------- pass D1
// dG = sum_h dG_h in head order, 0 outside j <= i < cl.  grid
// (ceil(chunk^2 / NT), nc, B).
__global__ void __launch_bounds__(NT)
ssd_bwd_dg_sum(Work wk, int S, int H, int chunk) {
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int64_t sq = (int64_t)chunk * chunk;
  const int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (e >= sq) return;
  const int i = (int)(e / chunk), j = (int)(e % chunk);
  const int cl = min(chunk, S - c * chunk);
  float s = 0.f;
  if (i < cl && j <= i) {
    const float* src = wk.dgh + ((int64_t)b * nc + c) * H * sq + e;
    for (int h = 0; h < H; ++h) s += src[h * sq];
  }
  wk.dg[((int64_t)b * nc + c) * sq + e] = s;
}

// --------------------------------------------------------------- pass D2
// Block (chunk c and 64-row tile rt; dC or dB and 64 columns; batch row).
// dC rows i: sum_{j} dG_ij B_j + sum_h exp(cs_i) S_0,h^T dy_i,h;
// dB rows j: sum_{i} dG_ij C_i + sum_h w_j,h D_h^T x_j,h; each head's term
// is a product of its own, scaled by its row weights as it is added.
// grid (nc * nit, 2 * ceil(N / 64), B).
__global__ void __launch_bounds__(NT)
ssd_bwd_dbc(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const float* __restrict__ dy, Saved sv, Work wk,
            float* __restrict__ dB, float* __restrict__ dC, int S, int H,
            int P, int N, int chunk, Strides sd) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                  // TT (k) x LDT: rows of the output along columns
  float* sK = sA + TT * LDT;         // TT (k) x LDT: the output's columns n
  float* sW = sK + TT * LDT;         // TT: per-row weights of one head
  const int nit = (chunk + TT - 1) / TT, nnt = (N + TT - 1) / TT;
  const int c = blockIdx.x / nit, rt = blockIdx.x % nit;
  const bool do_c = blockIdx.y < nnt;
  const int n0 = (blockIdx.y % nnt) * TT, b = blockIdx.z;
  const int nc = (S + chunk - 1) / chunk;
  const int c0 = c * chunk, cl = min(chunk, S - c0), r0 = rt * TT;
  if (r0 >= cl) return;
  const int tid = threadIdx.x;
  const int64_t sq = (int64_t)chunk * chunk, PN = (int64_t)P * N;
  const float* dg = wk.dg + ((int64_t)b * nc + c) * sq;
  const int ntile = (cl + TT - 1) / TT;
  float acc[4][4] = {};
  // dG times B (for dC) or C (for dB), over the 64-token tiles on the
  // right side of the diagonal
  for (int kt = do_c ? 0 : rt; kt < (do_c ? rt + 1 : ntile); ++kt) {
    const int k0 = kt * TT;
    __syncthreads();
    // sA[k][output row]: dG^T's rows for dC, dG's for dB
    const auto inside = [chunk](int i, int j) { return i < chunk && j < chunk; };
    if (do_c)
      load_sq<true>(sA, dg, chunk, r0, k0, inside);
    else
      load_sq<false>(sA, dg, chunk, k0, r0, inside);
    if (do_c)
      load_tile(sK, LDT, Bm + b * sd.bb + (int64_t)(c0 + k0) * sd.bt + n0, sd.bt,
                TT, cl - k0, TT, N - n0, false);
    else
      load_tile(sK, LDT, Cm + b * sd.cb + (int64_t)(c0 + k0) * sd.ct + n0, sd.ct,
                TT, cl - k0, TT, N - n0, false);
    __syncthreads();
    prod(acc, sA, 1, LDT, sK, LDT, 1, TT);
  }
  // the per-head terms: exp(cs_i) dy_i against S_0 (dC), w_j x_j against D
  // (dB), heads in order
  for (int h = 0; h < H; ++h) {
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    const float* cs = sv.cs + bch * chunk;
    __syncthreads();
    if (tid < TT) {
      const int t = r0 + tid;
      float w = 0.f;
      if (t < cl) {
        if (do_c) {
          w = expf(cs[t]);
        } else {
          const float* dtb = dt + b * sd.db + h * sd.dh + (int64_t)c0 * sd.dt;
          w = expf(cs[cl - 1] - cs[t]) * dtb[(int64_t)t * sd.dt];
        }
      }
      sW[tid] = w;
    }
    __syncthreads();
    if (do_c)
      load_tile(sA, LDT, dy + (((int64_t)b * S + c0 + r0) * H + h) * P, (int64_t)H * P,
                TT, cl - r0, TT, P, true);
    else
      load_tile(sA, LDT, x + b * sd.xb + h * sd.xh + (int64_t)(c0 + r0) * sd.xt, sd.xt,
                TT, cl - r0, TT, P, true);
    load_tile(sK, LDT, (do_c ? sv.sin : sv.ds) + bch * PN + n0, N, TT, P, TT, N - n0,
              false);
    __syncthreads();
    float ah[4][4] = {};
    prod(ah, sA, 1, LDT, sK, LDT, 1, P);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = fmaf(sW[lay_row(q)], ah[q][e], acc[q][e]);
  }
  float* out = do_c ? dC : dB;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = r0 + lay_row(q), n = n0 + lay_col(e);
      if (t < cl && n < N) out[((int64_t)b * S + c0 + t) * N + n] = acc[q][e];
    }
}

// ---------------------------------------------------------------- pass E
// Per head: dcs_t = own_t (+ vin_t) + the key tiles' row sums at t; da =
// its reverse running sum in each chunk (a warp a chunk, lanes on
// contiguous token segments); ddt += A da; dA = sum da dt over batch rows
// and chunks, in a fixed order.  grid (H).
__global__ void __launch_bounds__(DCS_NT)
ssd_bwd_dcs(const float* __restrict__ dt, const float* __restrict__ A, Work wk,
            float* __restrict__ ddt, float* __restrict__ dA, int B, int S,
            int H, int chunk, Strides sd) {
  __shared__ float red[DCS_NT / 32];
  const int h = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (S + chunk - 1) / chunk, njt = (chunk + TT - 1) / TT;
  const float a = A[h];
  float dap = 0.f;                   // lane 0: this warp's chunks, in order
  for (int pr = warp; pr < B * nc; pr += DCS_NT / 32) {
    const int b = pr / nc, c = pr % nc;
    const int c0 = c * chunk, cl = min(chunk, S - c0);
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    const float* own = wk.own + bch * chunk;
    const float* vin = wk.vin ? wk.vin + bch * chunk : nullptr;
    const float* rows = wk.rows + bch * njt * chunk;
    const int seg = (cl + 31) / 32;
    const int beg = min(lane * seg, cl), end = min(beg + seg, cl);
    const auto part = [&](int t) {
      float v = own[t];
      if (vin) v += vin[t];
      for (int jt = 0; jt <= t / TT; ++jt) v += rows[jt * chunk + t];
      return v;
    };
    float tot = 0.f;
    for (int t = beg; t < end; ++t) tot += part(t);
    float suf = tot;                 // inclusive suffix sum over lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o;
    }
    float run = suf - tot;           // what the later lanes' tokens add
    float dsum = 0.f;
    const float* dtb = dt + b * sd.db + h * sd.dh + (int64_t)c0 * sd.dt;
    for (int t = end - 1; t >= beg; --t) {
      run += part(t);
      ddt[((int64_t)b * S + c0 + t) * H + h] += a * run;
      dsum = fmaf(run, dtb[(int64_t)t * sd.dt], dsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    dap += dsum;
  }
  if (lane == 0) red[warp] = dap;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < DCS_NT / 32; ++w) s += red[w];
    dA[h] = s;
  }
}

// ================================================= bf16: wgmma passes

// Byte offset of element (r, col) of a bf16 tile of R rows and 64 or 128
// columns in the 128-byte swizzle: rows of 128 bytes (64 columns), the
// 16-byte chunks of row r XOR-ed with r % 8 (CU_TENSOR_MAP_SWIZZLE_128B's
// layout), the second 64 columns R rows further on.  Tiles start on a
// 1024-byte boundary.
__device__ __forceinline__ int swz(int R, int r, int col) {
  return (col >> 6) * R * 128 + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4) +
         (col & 7) * 2;
}

// wgmma descriptor of a K-major operand: rows of a swizzled tile of R rows
// and COLS (= K) columns, k = 16 kk .. +15.
template <int COLS, int R>
__device__ __forceinline__ uint64_t kdesc(const unsigned char* t, int kk) {
  return gmma_desc(t + kk * 16 / 64 * R * 128 + kk * 16 % 64 * 2, 16, 1024, 1);
}

// wgmma descriptor of a swizzled tile (R rows = k, COLS columns = n) as the
// MN-major B operand, k = 16 kk .. +15 (the transpose bit).
template <int COLS, int R>
__device__ __forceinline__ uint64_t mndesc(const unsigned char* t, int kk) {
  return gmma_desc(t + kk * 16 * 128, COLS > 64 ? R * 128 : 16, 1024, 1);
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroup's own barrier (warps 0-3).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// A consumer warp is done with a ring stage: its lanes' reads of it have
// completed, so one lane arrives for the warp.
__device__ __forceinline__ void warp_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t ld_u16(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// R x COLS (64 or 128) of a strided bf16 matrix (row r at src + r *
// stride), zeros at rows >= vr or columns >= vc, loaded into registers
// (`load`; `vec`: 16-byte loads, src and stride 16-byte aligned and vc a
// multiple of 8; else 2-byte loads) and stored into a swizzled tile
// (`store`).  NTH threads, this one `t`.  A producer loads the next tile
// before it waits for a free stage, so the loads' latency hides behind
// the wait.
template <int R, int COLS, int NTH>
struct TileRegs {
  static constexpr int CH = COLS / 8, IT = R * CH / NTH;
  static_assert(R * CH % NTH == 0, "tile not a multiple of the threads");
  uint4 v[IT];

  __device__ __forceinline__ void load(const bf16* src, int64_t stride, int vr,
                                       int vc, bool vec, int t) {
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int q = t + u * NTH, r = q / CH, c = q % CH * 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < vr && c < vc) {
        const bf16* p = src + r * stride + c;
        if (vec) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = (c + 2 * k < vc ? ld_u16(p + 2 * k) : 0u) |
                   (c + 2 * k + 1 < vc ? ld_u16(p + 2 * k + 1) << 16 : 0u);
          v[u] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* tile, int t) const {
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int q = t + u * NTH, r = q / CH, c = q % CH * 8;
      *reinterpret_cast<uint4*>(tile + swz(R, r, c)) = v[u];
    }
  }
};

template <int R, int COLS, int NTH>
__device__ __forceinline__ void stage_tile(unsigned char* tile, const bf16* src,
                                           int64_t stride, int vr, int vc,
                                           bool vec, int t) {
  TileRegs<R, COLS, NTH> regs;
  regs.load(src, stride, vr, vc, vec, t);
  regs.store(tile, t);
}

// R x COLS of a row-major f32 matrix (row r at src + r * ld; src 16-byte
// aligned, ld and vc multiples of 4), zeros at rows >= vr or columns >= vc,
// loaded into registers (`load`) and split into hi = bf16(v) and lo =
// bf16(v - hi) into two swizzled tiles (`store`).
template <int R, int COLS, int NTH>
struct SplitRegs {
  static constexpr int CH = COLS / 8, IT = R * CH / NTH;
  static_assert(R * CH % NTH == 0, "tile not a multiple of the threads");
  float4 a[IT][2];

  __device__ __forceinline__ void load(const float* src, int ld, int vr, int vc,
                                       int t) {
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int q = t + u * NTH, r = q / CH, c = q % CH * 8;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        a[u][k] = r < vr && c + 4 * k < vc
                      ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)r * ld + c + 4 * k))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(unsigned char* hi, unsigned char* lo,
                                        int t) const {
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int q = t + u * NTH, r = q / CH, c = q % CH * 8;
      uint4 h, l;
      split(a[u][0].x, a[u][0].y, h.x, l.x);
      split(a[u][0].z, a[u][0].w, h.y, l.y);
      split(a[u][1].x, a[u][1].y, h.z, l.z);
      split(a[u][1].z, a[u][1].w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + swz(R, r, c)) = h;
      *reinterpret_cast<uint4*>(lo + swz(R, r, c)) = l;
    }
  }
};

template <int R, int COLS, int NTH>
__device__ __forceinline__ void stage_split(unsigned char* hi, unsigned char* lo,
                                            const float* src, int ld, int vr,
                                            int vc, int t) {
  SplitRegs<R, COLS, NTH> regs;
  regs.load(src, ld, vr, vc, t);
  regs.store(hi, lo, t);
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* tile, int R,
                                          int r, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + swz(R, r, col)));
}

__device__ __forceinline__ float ld_one(const unsigned char* tile, int R, int r,
                                        int col) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + swz(R, r, col)));
}

// Which loads of an operand may be 16 bytes wide (see stage_tile).
struct Vec {
  int x, y, b, c;
};

// ------------------------------------------------------------ pass A (wg)
// Block (chunk c, head h, batch row b), one warpgroup.  Per 64-token tile
// i: V = C_i S_0^T (m64 n64, both K-major over n, S_0 split), then vin_i =
// exp(cs_i) dy_i . V_i; Q += (exp(cs) dy)^T C_i (A: p x i from registers,
// split; B: C_i MN-major).  grid (nc, H, B).
template <int NP>
__global__ void __launch_bounds__(WG)
ssd_bwd_q_wg(const bf16* __restrict__ dy, const bf16* __restrict__ Cm,
             Saved sv, Work wk, int S, int H, int P, int N, int chunk,
             Strides sd, Vec vec) {
  extern __shared__ unsigned char smem_wg[];
  unsigned char* sS0h = align1024(smem_wg);  // 64 (p) x NP: S_0 hi
  unsigned char* sS0l = sS0h + 64 * NP * 2;  // S_0 lo
  unsigned char* sC = sS0l + 64 * NP * 2;    // 64 (i) x NP: C_i
  unsigned char* sY = sC + 64 * NP * 2;      // 64 (i) x 64 (p): dy_i
  float* sE = reinterpret_cast<float*>(sY + 64 * 64 * 2);   // 64: exp(cs_i)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * chunk, cl = min(chunk, S - c0), tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  const int64_t bch = ((int64_t)b * nc + c) * H + h;
  const float* cs = sv.cs + bch * chunk;
  // the next token tile's C, dy and cs are loaded into registers while the
  // products of this one run
  TileRegs<64, NP, WG> cr;
  TileRegs<64, 64, WG> yr;
  float csn = 0.f;
  const auto fetch = [&](int i0) {
    cr.load(Cm + b * sd.cb + (int64_t)(c0 + i0) * sd.ct, sd.ct, cl - i0, N, vec.c, tid);
    yr.load(dy + (((int64_t)b * S + c0 + i0) * H + h) * P, (int64_t)H * P, cl - i0, P,
            vec.y, tid);
    if (tid < TT && i0 + tid < cl) csn = cs[i0 + tid];
  };
  fetch(0);
  stage_split<64, NP, WG>(sS0h, sS0l, sv.sin + bch * P * N, N, P, N, tid);
  float q[NP / 2];
#pragma unroll
  for (int k = 0; k < NP / 2; ++k) q[k] = 0.f;
  const int r0 = 16 * warp + g;      // this thread's rows (i of V, p of Q)
  for (int i0 = 0; i0 < cl; i0 += TT) {
    __syncthreads();                 // the last tile's products are done
    cr.store(sC, tid);
    yr.store(sY, tid);
    if (tid < TT) sE[tid] = i0 + tid < cl ? expf(csn) : 0.f;
    fence_async();
    __syncthreads();
    if (i0 + TT < cl) fetch(i0 + TT);
    float v[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_ss_n64(v, kdesc<NP, 64>(sC, kk), kdesc<NP, 64>(sS0h, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_ss_n64(v, kdesc<NP, 64>(sC, kk), kdesc<NP, 64>(sS0l, kk), 1);
    wg_commit();
    // A (m = p, k = i) = exp(cs_i) dy_i,p, hi and lo
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int p = r0 + 8 * (f & 1), i = 16 * kk + 2 * t4 + 8 * (f >> 1);
        const float2 e = *reinterpret_cast<const float2*>(sE + i);
        split(ld_one(sY, 64, i, p) * e.x, ld_one(sY, 64, i + 1, p) * e.y, ah[kk][f],
              al[kk][f]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<NP>(q, ah[kk], mndesc<NP, 64>(sC, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<NP>(q, al[kk], mndesc<NP, 64>(sC, kk));
    wg_commit();
    wg_wait<1>();                    // V is done
    fence_regs(v);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 y = ld_pair(sY, 64, r0 + 8 * r, 8 * nb + 2 * t4);
        s[r] = fmaf(y.x, v[4 * nb + 2 * r], fmaf(y.y, v[4 * nb + 2 * r + 1], s[r]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
      const int i = r0 + 8 * r;
      if (t4 == 0 && i0 + i < cl) wk.vin[bch * chunk + i0 + i] = sE[i] * s[r];
    }
    wg_wait<0>();
    fence_regs(q);
    fence_frags(ah);
    fence_frags(al);
  }
  float* out = sv.ds + bch * P * N;
#pragma unroll
  for (int nb = 0; nb < NP / 8; ++nb) {
    const int n = 8 * nb + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = r0 + 8 * r;
      if (n < N && p < P)
        *reinterpret_cast<float2*>(out + (int64_t)p * N + n) =
            make_float2(q[4 * nb + 2 * r], q[4 * nb + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ pass C (wg)
// Shared memory of the intra pass from a 1024-byte boundary: G^T and dG
// tiles (f32, fragment order: element e of thread t at e * 128 + t) for up
// to NIT row tiles, B_j, two head stages (x_j, cs, dt, <D, S_0>), D hi and
// lo, Y_STAGES dy tiles, the row-sum partials, barriers.
template <int NP> struct IntraSmem {
  int nit, clp;
  __host__ __device__ IntraSmem(int nit_, int clp_) : nit(nit_), clp(clp_) {}
  __host__ __device__ int g() const { return 0; }
  __host__ __device__ int dg() const { return nit * 16384; }
  __host__ __device__ int bj() const { return 2 * nit * 16384; }
  __host__ __device__ int x(int s) const { return bj() + 64 * NP * 2 + s * 8192; }
  __host__ __device__ int dh() const { return x(2); }
  __host__ __device__ int dl() const { return dh() + 64 * NP * 2; }
  __host__ __device__ int y(int s) const { return dl() + 64 * NP * 2 + s * 8192; }
  __host__ __device__ int cs(int s) const { return y(Y_STAGES) + s * 2 * clp * 4; }
  __host__ __device__ int dt(int s) const { return cs(s) + clp * 4; }
  __host__ __device__ int misc() const { return cs(2); }      // ds0[2], ext[4]
  __host__ __device__ int rw() const { return misc() + 64; }  // [2][4][64] f32
  __host__ __device__ int bar() const { return rw() + 2 * 4 * 64 * 4; }
  __host__ __device__ int bytes() const { return bar() + 16 * 8 + 1024; }
};

// Block (key tile jt, batch row b, chunk c, head group hg): x = ((jt * B +
// b) * nc + c) * G + group, so the heaviest key tiles start first.  Threads
// 0-127 consume, 128-255 produce.  grid (njt * B * nc * G).
template <int NP>
__global__ void __launch_bounds__(2 * WG, 1)
ssd_bwd_intra_wg(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const bf16* __restrict__ Bm, const bf16* __restrict__ dy,
                 Saved sv, Work wk, bf16* __restrict__ dx,
                 float* __restrict__ ddt, int B, int S, int H, int P, int N,
                 int chunk, int G, Strides sd, Vec vec) {
  extern __shared__ unsigned char smem_wg[];
  unsigned char* base = align1024(smem_wg);
  const int nc = (S + chunk - 1) / chunk, CLP = round_up(chunk, TT);
  const int njt = CLP / TT;
  const IntraSmem<NP> L(njt, CLP);
  const int group = blockIdx.x % G, c = blockIdx.x / G % nc;
  const int b = blockIdx.x / (G * nc) % B, jt = blockIdx.x / (G * nc * B);
  const int c0 = c * chunk, cl = min(chunk, S - c0), j0 = jt * TT;
  if (j0 >= cl) return;
  const int nit = (cl + TT - 1) / TT, nt = nit - jt;
  const int hg = (H + G - 1) / G, h0 = group * hg, nh = min(H, h0 + hg) - h0;
  float* sG = reinterpret_cast<float*>(base + L.g());
  float* sDG = reinterpret_cast<float*>(base + L.dg());
  unsigned char* sB = base + L.bj();
  float* misc = reinterpret_cast<float*>(base + L.misc());   // ds0[2], ext[4]
  float* sRw = reinterpret_cast<float*>(base + L.rw());
  uint64_t* hfull = reinterpret_cast<uint64_t*>(base + L.bar());
  uint64_t* hempty = hfull + 2;
  uint64_t* yfull = hempty + 2;
  uint64_t* yempty = yfull + Y_STAGES;
  uint64_t* dfull = yempty + Y_STAGES;
  uint64_t* dempty = dfull + 1;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(hfull + s, WG);
      mbar_init(hempty + s, 4);
    }
    for (int s = 0; s < Y_STAGES; ++s) {
      mbar_init(yfull + s, WG);
      mbar_init(yempty + s, 4);
    }
    mbar_init(dfull, WG);
    mbar_init(dempty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // G^T tiles (keys j x rows i) of the row tiles it >= jt, 0 outside
  // j <= i < cl, in fragment order; dG tiles zeroed; B_j
  const float* cb = sv.cb + ((int64_t)b * nc + c) * chunk * chunk;
  for (int e = tid; e < nt * 4096; e += 2 * WG) {
    const int k = e >> 12, il = (e >> 6) & 63, jl = e & 63;
    const int i = (jt + k) * TT + il, j = j0 + jl;
    const int r = 4 * (il >> 3) + 2 * ((jl >> 3) & 1) + (il & 1);
    const int t = 32 * (jl >> 4) + 4 * (jl & 7) + ((il >> 1) & 3);
    sG[k * 4096 + r * 128 + t] = i < cl && j <= i ? cb[(int64_t)i * chunk + j] : 0.f;
    sDG[k * 4096 + r * 128 + t] = 0.f;
  }
  stage_tile<64, NP, 2 * WG>(sB, Bm + b * sd.bb + (int64_t)(c0 + j0) * sd.bt, sd.bt,
                             cl - j0, N, vec.b, tid);
  fence_async();
  __syncthreads();

  if (tid >= WG) {
    // ---- producer warpgroup: every tile is loaded into registers before
    // the wait for its stage, the next head's while this head's dy tiles
    // are consumed (one dy tile ahead: loading them all at once costs the
    // consumer registers, 17 us at mamba2's shape, PERF.md)
    const int p = tid - WG;
    const float* dtg = dt + b * sd.db + (int64_t)c0 * sd.dt;
    const int nparts = ds0_parts(P, N);
    TileRegs<64, 64, WG> xr, yr;
    SplitRegs<64, NP, WG> dr;
    float csr[2], dtr[2], s0r[2];
    const auto load_head = [&](int h) {
      const int64_t bch = ((int64_t)b * nc + c) * H + h;
      xr.load(x + b * sd.xb + h * sd.xh + (int64_t)(c0 + j0) * sd.xt, sd.xt, cl - j0, P,
              vec.x, p);
      dr.load(sv.ds + bch * P * N, N, P, N, p);
      const float* csg = sv.cs + bch * chunk;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = p + k * WG;
        csr[k] = t < CLP ? csg[min(t, chunk - 1)] : 0.f;
        dtr[k] = t < cl ? dtg[h * sd.dh + (int64_t)t * sd.dt] : 0.f;
        // <D, S_0> from pass B's parts (jt == 0 only), lanes of warp 0
        s0r[k] = jt == 0 && p < 32 && p + 32 * k < nparts
                     ? wk.ds0p[bch * nparts + p + 32 * k] : 0.f;
      }
    };
    load_head(h0);
    int ny = 0;
    for (int hi = 0; hi < nh; ++hi) {
      const int h = h0 + hi, hs = hi & 1;
      float s0 = s0r[0] + s0r[1];
      if (p < 32) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      }
      mbar_wait(hempty + hs, ((hi >> 1) & 1) ^ 1);
      xr.store(base + L.x(hs), p);
      float* scs = reinterpret_cast<float*>(base + L.cs(hs));
      float* sdt = reinterpret_cast<float*>(base + L.dt(hs));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = p + k * WG;
        if (t < CLP) {
          scs[t] = csr[k];
          sdt[t] = dtr[k];
        }
      }
      if (p == 0) misc[hs] = s0;
      fence_async();
      mbar_arrive(hfull + hs);
      mbar_wait(dempty, (hi & 1) ^ 1);
      dr.store(base + L.dh(), base + L.dl(), p);
      fence_async();
      mbar_arrive(dfull);
      const auto load_dy = [&](int it) {
        yr.load(dy + (((int64_t)b * S + c0 + it * TT) * H + h) * P, (int64_t)H * P,
                cl - it * TT, P, vec.y, p);
      };
      load_dy(jt);
      for (int it = jt; it < nit; ++it, ++ny) {
        const int s = ny % Y_STAGES;
        mbar_wait(yempty + s, ((ny / Y_STAGES) & 1) ^ 1);
        yr.store(base + L.y(s), p);
        fence_async();
        mbar_arrive(yfull + s);
        if (it + 1 < nit) load_dy(it + 1);
      }
      if (hi + 1 < nh) load_head(h + 1);
    }
    return;
  }

  // ---- consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int jr[2] = {16 * warp + g, 16 * warp + g + 8};   // this thread's keys
  int ny = 0;
  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi, hs = hi & 1;
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    const unsigned char* sX = base + L.x(hs);
    const float* scs = reinterpret_cast<const float*>(base + L.cs(hs));
    const float* sdt = reinterpret_cast<const float*>(base + L.dt(hs));
    mbar_wait(hfull + hs, (hi >> 1) & 1);
    mbar_wait(dfull, hi & 1);
    // U = B_j D^T (keys x p), D split
    float u[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_ss_n64(u, kdesc<NP, 64>(sB, kk), kdesc<NP, 64>(base + L.dh(), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_ss_n64(u, kdesc<NP, 64>(sB, kk), kdesc<NP, 64>(base + L.dl(), kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(u);
    warp_release(dempty);
    const float cs_last = scs[cl - 1];
    float csj[2], dtj[2], dec[2], w[2], xu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + jr[r];
      csj[r] = scs[j];
      dtj[r] = sdt[j];
      dec[r] = j < cl ? expf(cs_last - csj[r]) : 0.f;
      w[r] = dec[r] * dtj[r];
      xu[r] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 xv = ld_pair(sX, 64, jr[r], 8 * nb + 2 * t4);
        xu[r] = fmaf(xv.x, u[4 * nb + 2 * r], fmaf(xv.y, u[4 * nb + 2 * r + 1], xu[r]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xu[r] += __shfl_xor_sync(0xffffffffu, xu[r], 1);
      xu[r] += __shfl_xor_sync(0xffffffffu, xu[r], 2);
    }
    float dxa[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) dxa[k] = w[(k >> 1) & 1] * u[k];
    // the last token's extra dcs: sum_j w_j x_j . U_j over the tile's keys,
    // and exp(cs_last) <D, S_0> once per chunk (jt == 0)
    float ex = t4 == 0 ? w[0] * xu[0] + w[1] * xu[1] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ex += __shfl_xor_sync(0xffffffffu, ex, off);
    if (lane == 0) misc[2 + warp] = ex;
    consumer_sync();
    float ext = misc[2] + misc[3] + misc[4] + misc[5];
    if (jt == 0) ext += expf(cs_last) * misc[hs];
    float colq[2] = {0.f, 0.f};
    for (int it = jt; it < nit; ++it, ++ny) {
      const int s = ny % Y_STAGES, i0 = it * TT;
      const unsigned char* yt = base + L.y(s);
      mbar_wait(yfull + s, (ny / Y_STAGES) & 1);
      float dm[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(dm, kdesc<64, 64>(sX, kk), kdesc<64, 64>(yt, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(dm);
      float* gk = sG + (it - jt) * 4096;
      float* dgk = sDG + (it - jt) * 4096;
      float rp[16];                  // T summed over this thread's two keys, per column
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 ci = *reinterpret_cast<const float2*>(scs + i0 + 8 * nb + 2 * t4);
        rp[2 * nb] = rp[2 * nb + 1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, k = 4 * nb + e;
          const int i = i0 + 8 * nb + 2 * t4 + (e & 1), j = j0 + jr[r];
          const bool keep = i < cl && j <= i;
          const float Lv =
              fast_exp2(keep ? (((e & 1) ? ci.y : ci.x) - csj[r]) * LOG2E : -INFINITY);
          const float gl = gk[k * WG + tid] * Lv;
          const float qv = dm[k] * gl;             // dM o G o L
          colq[r] += qv;
          rp[2 * nb + (e & 1)] = fmaf(qv, dtj[r], rp[2 * nb + (e & 1)]);
          dgk[k * WG + tid] = fmaf(dm[k] * Lv, dtj[r], dgk[k * WG + tid]);
          dm[k] = gl * dtj[r];                     // M
        }
      }
      // dx_j += M^T dy_i, M split into hi / lo A fragments
      uint32_t mh[4][4], ml[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split(dm[8 * kk], dm[8 * kk + 1], mh[kk][0], ml[kk][0]);
        split(dm[8 * kk + 2], dm[8 * kk + 3], mh[kk][1], ml[kk][1]);
        split(dm[8 * kk + 4], dm[8 * kk + 5], mh[kk][2], ml[kk][2]);
        split(dm[8 * kk + 6], dm[8 * kk + 7], mh[kk][3], ml[kk][3]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dxa, mh[kk], mndesc<64, 64>(yt, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dxa, ml[kk], mndesc<64, 64>(yt, kk));
      wg_commit();
      // T's column sums over the warp's keys: a fixed tree over the lanes
      // of one column (lane bits 4, 3, 2), halving the columns each step;
      // lane (g, t4) ends with columns 8 g + 2 t4 and + 1
      float a8[8], a4[4], a2[2];
      const bool h1 = lane & 16, h2 = lane & 8, h3 = lane & 4;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        a8[k] = (h1 ? rp[8 + k] : rp[k]) +
                __shfl_xor_sync(0xffffffffu, h1 ? rp[k] : rp[8 + k], 16);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        a4[k] = (h2 ? a8[4 + k] : a8[k]) +
                __shfl_xor_sync(0xffffffffu, h2 ? a8[k] : a8[4 + k], 8);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        a2[k] = (h3 ? a4[2 + k] : a4[k]) +
                __shfl_xor_sync(0xffffffffu, h3 ? a4[k] : a4[2 + k], 4);
      float* rw = sRw + (ny & 1) * 256;
      *reinterpret_cast<float2*>(rw + warp * 64 + 8 * g + 2 * t4) = make_float2(a2[0], a2[1]);
      consumer_sync();
      if (tid < TT && i0 + tid < cl) {
        float v = rw[tid] + rw[64 + tid] + rw[128 + tid] + rw[192 + tid];
        if (i0 + tid == cl - 1) v += ext;
        wk.rows[(bch * njt + jt) * chunk + i0 + tid] = v;
      }
      wg_wait<0>();
      fence_regs(dxa);
      fence_frags(mh);
      fence_frags(ml);
      warp_release(yempty + s);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      colq[r] += __shfl_xor_sync(0xffffffffu, colq[r], 1);
      colq[r] += __shfl_xor_sync(0xffffffffu, colq[r], 2);
      const int j = j0 + jr[r];
      if (j < cl) {
        bf16* out = dx + (((int64_t)b * S + c0 + j) * H + h) * P;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int pc = 8 * nb + 2 * t4;
          if (pc < P)
            *reinterpret_cast<uint32_t*>(out + pc) =
                pack_bf16(dxa[4 * nb + 2 * r], dxa[4 * nb + 2 * r + 1]);
        }
        if (t4 == 0) {
          ddt[((int64_t)b * S + c0 + j) * H + h] = colq[r] + dec[r] * xu[r];
          wk.own[bch * chunk + j] = -dtj[r] * colq[r] - dec[r] * dtj[r] * xu[r];
        }
      }
    }
    warp_release(hempty + hs);
  }
  // the group's dG tiles (it, jt), rows i, columns j, at (G, B, nc, CLP, CLP)
  float* dgp = wk.dg + (((int64_t)group * B + b) * nc + c) * CLP * CLP;
  for (int k = 0; k < nt; ++k)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (jt + k) * TT + 8 * (e >> 2) + 2 * t4 + (e & 1);
      const int j = j0 + jr[(e >> 1) & 1];
      dgp[(int64_t)i * CLP + j] = sDG[k * 4096 + e * WG + tid];
    }
}

// ------------------------------------------------------------ pass D (wg)
// A ring stage: B hi and lo (64 k rows x NP, swizzled, the MN-major
// operand), A hi and lo (64 rows x 64 k, row stride LDA bf16).
constexpr int DBC_STAGES = 4;
// Producer warpgroups of the dB / dC pass: two at N 64, one at N 128, where
// a third warpgroup's register cap (168) makes the producers spill and
// two measured slower than one (PERF.md).
__host__ __device__ constexpr int dbc_producers(int NP) { return NP > 64 ? 1 : 2; }
constexpr int LDA = 72;
template <int NP> struct DbcSmem {
  static constexpr int B_BYTES = 64 * NP * 2;
  static constexpr int A_BYTES = 64 * LDA * 2;
  static constexpr int STAGE = (2 * B_BYTES + 2 * A_BYTES + 1023) / 1024 * 1024;
  static constexpr int BAR = DBC_STAGES * STAGE;
  static constexpr int BYTES = BAR + 2 * DBC_STAGES * 8 + 1024;
};

// Block (chunk c, 64-row tile rt, dC or dB, batch row b): x = (c * njt +
// rt) * 2 + (dB), grid (nc * njt * 2, B).  Threads 0-127 consume (one
// m64 x NP accumulator); dbc_producers(NP) warpgroups after them produce the
// ring's items: first the dG term's 64-token tiles k (dC: k <= rt, A =
// dG[rt rows][k], B = B_k; dB: k >= rt, A = dG[k][rt]^T, B = C_k), dG
// summed over the head groups in order and split, by the first producer;
// then one item a head (A = the weighted dy (dC) or x (dB) rows, split; B
// = S_0 or D, split), the heads dealt to the producers in turn.
template <int NP>
__global__ void __launch_bounds__((1 + dbc_producers(NP)) * WG, 1)
ssd_bwd_dbc_wg(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
               const bf16* __restrict__ dy, Saved sv, Work wk,
               bf16* __restrict__ dB, bf16* __restrict__ dC, int B, int S,
               int H, int P, int N, int chunk, int G, Strides sd, Vec vec) {
  using L = DbcSmem<NP>;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* base = align1024(smem_wg);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + DBC_STAGES;
  const int nc = (S + chunk - 1) / chunk, CLP = round_up(chunk, TT);
  const int njt = CLP / TT;
  const bool do_c = (blockIdx.x & 1) == 0;
  const int rt = blockIdx.x / 2 % njt, c = blockIdx.x / 2 / njt, b = blockIdx.y;
  const int c0 = c * chunk, cl = min(chunk, S - c0), r0 = rt * TT;
  if (r0 >= cl) return;
  const int nit = (cl + TT - 1) / TT;
  const int n1 = do_c ? rt + 1 : nit - rt, items = n1 + H;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < DBC_STAGES; ++s) {
      mbar_init(full + s, WG);
      mbar_init(empty + s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {
    // ---- producer warpgroups: a head's item is loaded into registers
    // before the wait for its stage
    const int p = tid % WG, pw = tid / WG - 1;
    const int64_t sq = (int64_t)CLP * CLP, gstride = (int64_t)B * nc * sq;
    const float* dg = wk.dg + ((int64_t)b * nc + c) * sq;
    // A row m = p / 2, columns (p & 1) * 32 .. +31: the weighted dy (dC) or
    // x (dB) of token r0 + m
    const int m = p >> 1, col = (p & 1) * 32, t = r0 + m;
    const bool vv = do_c ? vec.y : vec.x;
    uint4 raw[4];
    float cst = 0.f, csl = 0.f, dtt = 0.f;
    SplitRegs<64, NP, WG> br;
    const auto load_head = [&](int h) {
      const int64_t bch = ((int64_t)b * nc + c) * H + h;
      const float* cs = sv.cs + bch * chunk;
      if (t < cl) {
        cst = cs[t];
        csl = cs[cl - 1];
        dtt = dt[b * sd.db + h * sd.dh + (int64_t)(c0 + t) * sd.dt];
      }
      const bf16* src = do_c ? dy + (((int64_t)b * S + c0 + t) * H + h) * P
                             : x + b * sd.xb + h * sd.xh + (int64_t)(c0 + t) * sd.xt;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cc = col + 8 * k;
        raw[k] = make_uint4(0u, 0u, 0u, 0u);
        if (t < cl && cc < P) {
          if (vv) {
            raw[k] = __ldg(reinterpret_cast<const uint4*>(src + cc));
          } else {
            uint32_t wv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              wv[e] = (cc + 2 * e < P ? ld_u16(src + cc + 2 * e) : 0u) |
                      (cc + 2 * e + 1 < P ? ld_u16(src + cc + 2 * e + 1) << 16 : 0u);
            raw[k] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
          }
        }
      }
      br.load((do_c ? sv.sin : sv.ds) + bch * P * N, N, P, N, p);
    };
    if (pw < H) load_head(pw);
    for (int n = 0; n < items; ++n) {
      if (n < n1 ? pw != 0 : (n - n1) % dbc_producers(NP) != pw) continue;
      const int s = n % DBC_STAGES;
      unsigned char* st = base + s * L::STAGE;
      unsigned char* bh = st;
      unsigned char* bl = st + L::B_BYTES;
      bf16* ah = reinterpret_cast<bf16*>(st + 2 * L::B_BYTES);
      bf16* al = ah + 64 * LDA;
      mbar_wait(empty + s, ((n / DBC_STAGES) & 1) ^ 1);
      if (n < n1) {
        const int kt = do_c ? n : rt + n, k0 = kt * TT;
        // dC: A[m][k] = dG[r0 + m][k0 + k]; dB: A[m][k] = dG[k0 + k][r0 + m]:
        // this thread reads 32 contiguous floats of dG row m, from col
        const float* src = dg + (int64_t)((do_c ? r0 : k0) + m) * CLP + (do_c ? k0 : r0) + col;
        float4 acc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int gi = 0; gi < G; ++gi) {
          float4 v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = __ldg(reinterpret_cast<const float4*>(src + gi * gstride) + k);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            acc[k].x += v[k].x;
            acc[k].y += v[k].y;
            acc[k].z += v[k].z;
            acc[k].w += v[k].w;
          }
        }
        const float* a = reinterpret_cast<const float*>(acc);
        if (do_c) {
#pragma unroll
          for (int k = 0; k < 32; k += 2) {
            uint32_t h2, l2;
            split(a[k], a[k + 1], h2, l2);
            *reinterpret_cast<uint32_t*>(ah + m * LDA + col + k) = h2;
            *reinterpret_cast<uint32_t*>(al + m * LDA + col + k) = l2;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const bf16 hv = __float2bfloat16_rn(a[k]);
            ah[(col + k) * LDA + m] = hv;
            al[(col + k) * LDA + m] = __float2bfloat16_rn(a[k] - __bfloat162float(hv));
          }
        }
        if (do_c)
          stage_tile<64, NP, WG>(bh, Bm + b * sd.bb + (int64_t)(c0 + k0) * sd.bt, sd.bt,
                                 cl - k0, N, vec.b, p);
        else
          stage_tile<64, NP, WG>(bh, Cm + b * sd.cb + (int64_t)(c0 + k0) * sd.ct, sd.ct,
                                 cl - k0, N, vec.c, p);
        // B and C are exact in bf16: their lo half is zero
        for (int q = p; q < L::B_BYTES / 16; q += WG)
          reinterpret_cast<uint4*>(bl)[q] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const int h = n - n1;
        float wt = 0.f;
        if (t < cl) {
          if (do_c)
            wt = expf(cst);
          else
            wt = expf(csl - cst) * dtt;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t wv[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
          uint4 hv, lv;
          uint32_t* hp = reinterpret_cast<uint32_t*>(&hv);
          uint32_t* lp = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
          for (int e = 0; e < 4; ++e)     // a bf16 is the top half of its f32
            split(__uint_as_float(wv[e] << 16) * wt,
                  __uint_as_float(wv[e] & 0xffff0000u) * wt, hp[e], lp[e]);
          *reinterpret_cast<uint4*>(ah + m * LDA + col + 8 * k) = hv;
          *reinterpret_cast<uint4*>(al + m * LDA + col + 8 * k) = lv;
        }
        br.store(bh, bl, p);
        if (h + dbc_producers(NP) < H) load_head(h + dbc_producers(NP));
      }
      fence_async();
      mbar_arrive(full + s);
    }
    return;
  }

  // ---- consumer warpgroup: rows r0 + 16 warp + g (+ 8), columns NP
  const int warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  float acc[NP / 2];
#pragma unroll
  for (int k = 0; k < NP / 2; ++k) acc[k] = 0.f;
  for (int n = 0; n < items; ++n) {
    const int s = n % DBC_STAGES;
    const unsigned char* st = base + s * L::STAGE;
    const bf16* ah = reinterpret_cast<const bf16*>(st + 2 * L::B_BYTES);
    const bf16* al = ah + 64 * LDA;
    mbar_wait(full + s, (n / DBC_STAGES) & 1);
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int off = (16 * warp + g + 8 * (f & 1)) * LDA + 16 * kk + 2 * t4 + 8 * (f >> 1);
        fh[kk][f] = *reinterpret_cast<const uint32_t*>(ah + off);
        fl[kk][f] = *reinterpret_cast<const uint32_t*>(al + off);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<NP>(acc, fh[kk], mndesc<NP, 64>(st, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<NP>(acc, fh[kk], mndesc<NP, 64>(st + L::B_BYTES, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<NP>(acc, fl[kk], mndesc<NP, 64>(st, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_frags(fh);
    fence_frags(fl);
    warp_release(empty + s);
  }
  bf16* out = do_c ? dC : dB;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + 16 * warp + g + 8 * r;
    if (t >= cl) continue;
#pragma unroll
    for (int nb = 0; nb < NP / 8; ++nb) {
      const int n = 8 * nb + 2 * t4;
      if (n < N)
        *reinterpret_cast<uint32_t*>(out + ((int64_t)b * S + c0 + t) * N + n) =
            pack_bf16(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch
int launch_f32(const float* x, const float* dt, const float* A, const float* Bm,
               const float* Cm, const float* dy, const float* dfinal,
               const float* saved, float* work, float* dx, float* ddt,
               float* dA, float* dB, float* dC, int B, int S, int H, int P,
               int N, int chunk, const Strides& sd, cudaStream_t stream) {
  const int nc = (S + chunk - 1) / chunk, njt = (chunk + TT - 1) / TT;
  const int CLP = round_up(chunk, TT);
  const Saved sv = carve_saved(saved, work, B, nc, H, P, N, chunk);
  const Work wk = carve_work(work, B, nc, H, P, N, chunk, false);
  const int smem_q = (TT * LDT + TT * LDN + TT) * 4;
  const int smem_c = (2 * CLP + 2 * TT * LDT + 2 * TT * LDN + 2 * TT + NT / 32 + 1) * 4;
  const int smem_d = (2 * TT * LDT + TT) * 4;
  if (smem_c > SMEM_MAX || (int64_t)nc * njt > 2147483647 ||
      2 * ((N + TT - 1) / TT) > 65535)
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> ready_q{0}, ready_c{0};
  int err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_q), SMEM_MAX, ready_q);
  if (err) return err;
  if ((err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_intra), SMEM_MAX, ready_c)))
    return err;
  ssd_bwd_q<<<dim3(nc, H, B), NT, smem_q, stream>>>(dy, Cm, sv, S, H, P, N, chunk, sd);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dstate<<<dim3(state_blocks(P, N), H, B), NT, 0, stream>>>(
      sv.ds, sv.cs, dfinal, sv.sin, nullptr, H, P, N, chunk, nc);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_intra<<<dim3(nc * njt, H, B), NT, smem_c, stream>>>(
      x, dt, Bm, Cm, dy, sv, wk, dx, ddt, S, H, P, N, chunk, sd);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t sq = (int64_t)chunk * chunk;
  ssd_bwd_dg_sum<<<dim3((unsigned)((sq + NT - 1) / NT), nc, B), NT, 0, stream>>>(
      wk, S, H, chunk);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc<<<dim3(nc * njt, 2 * ((N + TT - 1) / TT), B), NT, smem_d, stream>>>(
      x, dt, Bm, Cm, dy, sv, wk, dB, dC, S, H, P, N, chunk, sd);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dcs<<<dim3(H), DCS_NT, 0, stream>>>(dt, A, wk, ddt, dA, B, S, H, chunk, sd);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int NP>
int launch_wg(const bf16* x, const float* dt, const float* A, const bf16* Bm,
              const bf16* Cm, const bf16* dy, const float* dfinal,
              const float* saved, float* work, bf16* dx, float* ddt, float* dA,
              bf16* dB, bf16* dC, int B, int S, int H, int P, int N, int chunk,
              const Strides& sd, cudaStream_t stream) {
  const int nc = (S + chunk - 1) / chunk, CLP = round_up(chunk, TT);
  const int njt = CLP / TT, G = head_groups(B, nc, njt, H);
  const Saved sv = carve_saved(saved, work, B, nc, H, P, N, chunk);
  const Work wk = carve_work(work, B, nc, H, P, N, chunk, true);
  const Vec vec{aligned16(x) && sd.xb % 8 == 0 && sd.xt % 8 == 0 && sd.xh % 8 == 0 &&
                    P % 8 == 0,
                aligned16(dy) && P % 8 == 0 && (H * P) % 8 == 0,
                aligned16(Bm) && sd.bb % 8 == 0 && sd.bt % 8 == 0 && N % 8 == 0,
                aligned16(Cm) && sd.cb % 8 == 0 && sd.ct % 8 == 0 && N % 8 == 0};
  const int smem_q = 1024 + 3 * 64 * NP * 2 + 64 * 64 * 2 + 64 * 4;
  const int smem_c = IntraSmem<NP>(njt, CLP).bytes();
  const int smem_d = DbcSmem<NP>::BYTES;
  const int64_t blocks_c = (int64_t)njt * B * nc * G;
  if (smem_c > SMEM_MAX || smem_d > SMEM_MAX || blocks_c > 2147483647 ||
      (int64_t)nc * njt * 2 > 2147483647)
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> ready_q{0}, ready_c{0}, ready_d{0};
  int err;
  // raised once a device to the most any shape needs, not to this call's
  if ((err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_q_wg<NP>), SMEM_MAX, ready_q)) ||
      (err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_intra_wg<NP>), SMEM_MAX, ready_c)) ||
      (err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_dbc_wg<NP>), SMEM_MAX, ready_d)))
    return err;
  ssd_bwd_q_wg<NP><<<dim3(nc, H, B), WG, smem_q, stream>>>(dy, Cm, sv, wk, S, H, P, N,
                                                           chunk, sd, vec);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dstate<<<dim3(state_blocks(P, N), H, B), NT, 0, stream>>>(
      sv.ds, sv.cs, dfinal, sv.sin, wk.ds0p, H, P, N, chunk, nc);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_intra_wg<NP><<<dim3((unsigned)blocks_c), 2 * WG, smem_c, stream>>>(
      x, dt, Bm, dy, sv, wk, dx, ddt, B, S, H, P, N, chunk, G, sd, vec);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_wg<NP><<<dim3(nc * njt * 2, B), (1 + dbc_producers(NP)) * WG, smem_d,
                       stream>>>(
      x, dt, Bm, Cm, dy, sv, wk, dB, dC, B, S, H, P, N, chunk, G, sd, vec);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dcs<<<dim3(H), DCS_NT, 0, stream>>>(dt, A, wk, ddt, dA, B, S, H, chunk, sd);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of device workspace ssd_scan_bwd needs for these shapes and dtype
// (0 = float32, 1 = bfloat16).
extern "C" long long ssd_scan_bwd_workspace_floats(int B, int S, int H, int P,
                                                   int N, int chunk, int dtype) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0) return 0;
  return work_sizes(B, (S + chunk - 1) / chunk, H, P, N, chunk, dtype == 1).total();
}

// C entry point.  dtype (of x, Bm, Cm, dy, dx, dB and dC): 0 = float32, 1 =
// bfloat16; dt, A, dfinal, ddt and dA are float32.  x, dt, Bm and Cm are
// read through their strides (in elements, unit stride in the last dim);
// dy, dx (B, S, H, P), ddt (B, S, H), dB and dC (B, S, N) and dfinal
// (B, H, P, N) are contiguous, dfinal 16-byte aligned or null (a zero
// cotangent).  saved: the forward's scratch (ssd_scan_scratch_floats of the
// bf16 layout), read only; work: at least ssd_scan_bwd_workspace_floats(...)
// floats, 16-byte aligned.  bf16 takes P a multiple of 8 and chunk up to
// CHUNK_WG.  Returns a cudaError_t.
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm, const void* dy,
                            const float* dfinal, const float* saved, float* work,
                            void* dx, float* ddt, float* dA, void* dB, void* dC,
                            int B, int S, int H, int P, int N, int chunk,
                            long long sxb, long long sxt, long long sxh,
                            long long sdb, long long sdt, long long sdh,
                            long long sbb, long long sbt, long long scb,
                            long long sct, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PMAX || N <= 0 || N > NMAX ||
      N % 4 != 0 || chunk <= 0 || B > 65535 || H > 65535 || !saved || !work)
    return (int)cudaErrorInvalidValue;
  const Strides sd{sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, scb, sct};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), dt, A,
                      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                      static_cast<const float*>(dy), dfinal, saved, work,
                      static_cast<float*>(dx), ddt, dA, static_cast<float*>(dB),
                      static_cast<float*>(dC), B, S, H, P, N, chunk, sd, st);
  if (dtype != 1 || P % 8 != 0 || std::min(chunk, S) > CHUNK_WG)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(Bm);
  const auto* cb = static_cast<const bf16*>(Cm);
  const auto* yb = static_cast<const bf16*>(dy);
  auto* dxb = static_cast<bf16*>(dx);
  auto* dbb = static_cast<bf16*>(dB);
  auto* dcb = static_cast<bf16*>(dC);
  if (N <= 64)
    return launch_wg<64>(xb, dt, A, bb, cb, yb, dfinal, saved, work, dxb, ddt, dA, dbb,
                         dcb, B, S, H, P, N, chunk, sd, st);
  return launch_wg<128>(xb, dt, A, bb, cb, yb, dfinal, saved, work, dxb, ddt, dA, dbb,
                        dcb, B, S, H, P, N, chunk, sd, st);
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
