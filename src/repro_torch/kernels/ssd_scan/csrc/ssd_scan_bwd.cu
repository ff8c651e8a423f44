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
// Passes, one stream, each parallel over chunks where the math allows:
//   A. ssd_bwd_q, per (chunk, head, batch row): Q = sum_i exp(cs_i) dy_i
//      C_i^T into the workspace's state slot.
//   B. ssd_bwd_dstate, per (1024 state elements, head, batch row): the
//      reverse recurrence, D of each chunk in place of its Q.
//   C. ssd_bwd_intra, per (chunk and 64-key tile, head, batch row): dx of
//      the tile's keys, the direct part of their ddt, per-head dG tiles into
//      the workspace, and the parts of dcs (row sums per key tile).
//   D1. ssd_bwd_dg_sum: dG summed over heads, in head order.
//   D2. ssd_bwd_dbc, per (chunk and 64-row tile, dC or dB and 64 columns,
//      batch row): dC and dB rows, the sums over heads inside the block.
//   E. ssd_bwd_dcs, per head: dcs from its parts, its reverse running sum
//      per chunk (a warp per chunk), ddt += A da, and dA summed over the
//      batch rows and chunks in a fixed order.
// dB and dC are shared by every head and dA sums over batch and sequence:
// each is reduced from per-head or per-chunk partials in a fixed order,
// with no atomics, so two launches on the same inputs agree bit for bit.
//
// What bounds it on the card.  The backward does about three times the
// forward's products (dM, M^T dy, and G's gradient times B and C, per
// head; U, V and the state terms per head), so like the forward it is
// bound by operations (chip_smoke.py::ssd_bwd_bound counts them).  The
// design is simple: every tile is staged in shared memory as f32 and every
// product is a 64 x 64 tile (``prod``).  With bf16 inputs the products run
// on the tensor cores, mma.sync m16n8k16 over 8 warps, and an f32 operand
// (M, dG, D, the incoming state, dy weighted by exp(cs)) is split into
// hi = bf16(v) and lo = bf16(v - hi), multiplied twice, as the forward
// does: a relative error near 2^-16, where x, dy, B and C are exact in
// bf16.  With f32 inputs (no served or full-width model) the same tiles are
// scalar f32 FMAs.  The elementwise work (the masked exps, M, dM o G o L,
// the row and column sums) is scalar on the tiles in shared memory.
//
// The saved scratch is the forward's (ssd_scan_fwd.cu, Scratch), read
// only: the incoming states (B, nc, H, P, N) f32, CB (B, nc, chunk, chunk)
// f32 (written only for tiles j <= i of rows inside the chunk), cs (B, nc,
// H, chunk) f32.  The workspace (ssd_scan_bwd_workspace_floats) holds Q,
// then D, (B, nc, H, P, N), the per-head dG tiles, dG, and dcs's parts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // threads of every kernel but the scan
constexpr int NMAX = 128;        // largest state size N (a multiple of 4)
constexpr int PMAX = 64;         // largest head dim P
constexpr int TT = 64;           // token tile
constexpr int LDT = TT + 4;      // f32 row stride of a 64-column tile
constexpr int LDN = NMAX + 4;    // f32 row stride of an N-column tile
constexpr int SMEM_MAX = 232448;

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
  float* dgh;                    // (B, nc, H, chunk, chunk) per-head dG
  float* dg;                     // (B, nc, chunk, chunk) dG over heads
  float* rows;                   // (B, nc, H, njt, chunk) row sums of T
  float* own;                    // (B, nc, H, chunk) the rest of dcs
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

// The workspace: Q / D (B, nc, H, P, N), then the Work slots.
inline int64_t workspace_floats(int B, int nc, int H, int P, int N, int chunk) {
  const int njt = (chunk + TT - 1) / TT;
  const int64_t sq = (int64_t)chunk * chunk;
  return (int64_t)B * nc * H * P * N + (int64_t)B * nc * H * sq +
         (int64_t)B * nc * sq + (int64_t)B * nc * H * njt * chunk +
         (int64_t)B * nc * H * chunk;
}

inline Work carve_work(float* base, int B, int nc, int H, int P, int N,
                       int chunk) {
  const int njt = (chunk + TT - 1) / TT;
  const int64_t sq = (int64_t)chunk * chunk;
  Work w;
  w.dgh = base + (int64_t)B * nc * H * P * N;
  w.dg = w.dgh + (int64_t)B * nc * H * sq;
  w.rows = w.dg + (int64_t)B * nc * sq;
  w.own = w.rows + (int64_t)B * nc * H * njt * chunk;
  return w;
}

inline int allow_smem(const void* fn, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return 0;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// rows x cols of a strided matrix (row r at src + r * stride), as f32 into
// dst[r * ld + c], or dst[c * ld + r] when `transpose`, times scale[r] when
// given; zeros at rows >= valid_rows or columns >= valid_cols.  A thread
// issues TILE_BATCH loads before it stores any, so a tile costs a few
// memory latencies, not one per element it copies.
constexpr int TILE_BATCH = 8;

template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
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
      v[u] = e < total && r < valid_rows && c < valid_cols
                 ? to_f(src[r * stride + c]) : 0.f;
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The 16 elements (q, e) of a 64 x 64 tile that a thread holds.  Scalar
// (TC false): rows ty + 16 q, columns tx + 16 e.  Tensor cores (TC true):
// mma.sync's accumulator over 8 warps of 16 x 32 (warp w: rows 16 (w & 3),
// columns 32 (w >> 2)), n-tile q and element e: row g + 8 (e >> 1),
// column 8 q + 2 t + (e & 1), g = lane / 4, t = lane % 4.
template <bool TC>
__device__ __forceinline__ int lay_row(int q, int e) {
  if (TC) {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    return (warp & 3) * 16 + g + 8 * (e >> 1);
  }
  return (threadIdx.x >> 4) + 16 * q;
}

template <bool TC>
__device__ __forceinline__ int lay_col(int q, int e) {
  if (TC) {
    const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
    return (warp >> 2) * 32 + 8 * q + 2 * t + (e & 1);
  }
  return (threadIdx.x & 15) + 16 * e;
}

// acc(q, e) += sum_{k < K} A[row * ar + k * ak] * Bm[k * bk + col * bc] for
// the thread's 16 elements of a 64 x 64 tile (lay_row / lay_col).  TC: K a
// multiple of 16; an operand flagged f32 (fa, fb) is split into hi + lo and
// multiplied twice, an exact one once.  Scalar: f32 FMAs, flags unused.
template <bool TC, bool fa, bool fb>
__device__ __forceinline__ void prod(float (&acc)[4][4], const float* A,
                                     int ar, int ak, const float* Bm, int bk,
                                     int bc, int K) {
  if (TC) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (warp & 3) * 16 + g, c0 = (warp >> 2) * 32 + g;
    for (int k = 0; k < K; k += 16) {
      const int ka = k + 2 * t;
      const float* a0 = A + r0 * ar + ka * ak;
      const float* a1 = a0 + 8 * ar;
      uint32_t ah[4], al[4];
      split(a0[0], a0[ak], ah[0], al[0]);
      split(a1[0], a1[ak], ah[1], al[1]);
      split(a0[8 * ak], a0[9 * ak], ah[2], al[2]);
      split(a1[8 * ak], a1[9 * ak], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* b = Bm + ka * bk + (c0 + 8 * q) * bc;
        uint32_t bh0, bl0, bh1, bl1;
        split(b[0], b[bk], bh0, bl0);
        split(b[8 * bk], b[9 * bk], bh1, bl1);
        mma_bf16(acc[q], ah, bh0, bh1);
        if (fa) mma_bf16(acc[q], al, bh0, bh1);
        if (fb) mma_bf16(acc[q], ah, bl0, bl1);
      }
    }
  } else {
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
}

// A 64 x 64 product held by the threads (``prod``) into dst[row * ld + col].
template <bool TC>
__device__ __forceinline__ void store_tile(float* dst, int ld,
                                           const float (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[lay_row<TC>(q, e) * ld + lay_col<TC>(q, e)] = acc[q][e];
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

// Sum of one value per thread, in a fixed tree; every thread gets it.
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

// ---------------------------------------------------------------- pass A
// Q = sum_i exp(cs_i) dy_i C_i^T, rows p, columns n in two 64-column halves.
// grid (nc, H, B).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_q(const T* __restrict__ dy, const T* __restrict__ Cm, Saved sv, int S,
          int H, int P, int N, int chunk, Strides sd) {
  constexpr bool TC = sizeof(T) == 2;
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
    prod<TC, true, false>(acc[0], sA, 1, LDT, sC, LDN, 1, TT);
    if (N > TT) prod<TC, true, false>(acc[1], sA, 1, LDT, sC + TT, LDN, 1, TT);
  }
  float* q = sv.ds + bch * P * N;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = lay_row<TC>(r, k), n = half * TT + lay_col<TC>(r, k);
        if (p < P && n < N) q[(int64_t)p * N + n] = acc[half][r][k];
      }
}

// ---------------------------------------------------------------- pass B
// D of each chunk, last to first: D_{nc-1} = the final state's cotangent
// (0 when none), D_{c-1} = exp(cs_last,c) D_c + Q_c, written over Q_c.
// grid (ceil(P N / (4 NT)), H, B), four elements a thread.
__global__ void __launch_bounds__(NT)
ssd_bwd_dstate(float* __restrict__ q, const float* __restrict__ cs,
               const float* __restrict__ dfinal, int H, int P, int N,
               int chunk, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int PN = P * N, e = (blockIdx.x * NT + threadIdx.x) * 4;
  if (e >= PN) return;
  float4 d = dfinal ? *reinterpret_cast<const float4*>(dfinal + ((int64_t)b * H + h) * PN + e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    float4* slot = reinterpret_cast<float4*>(q + bch * PN + e);
    const float4 qc = *slot;
    *slot = d;
    const float g = expf(cs[bch * chunk + chunk - 1]);
    d = make_float4(fmaf(d.x, g, qc.x), fmaf(d.y, g, qc.y), fmaf(d.z, g, qc.z),
                    fmaf(d.w, g, qc.w));
  }
}

// ---------------------------------------------------------------- pass C
// Block (chunk c, key tile jt; head h; batch row b), keys j0..j0+63.
// grid (nc * njt, H, B).  The M / dM and G tiles of the loop over row
// tiles take the shared memory of the N-wide tiles (B_j, D, C, S_0), dead
// by then, so two blocks fit an SM.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_bwd_intra(const T* __restrict__ x, const float* __restrict__ dt,
              const T* __restrict__ Bm, const T* __restrict__ Cm,
              const T* __restrict__ dy, Saved sv, Work wk, T* __restrict__ dx,
              float* __restrict__ ddt, int S, int H, int P, int N, int chunk,
              Strides sd) {
  constexpr bool TC = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int njt = (chunk + TT - 1) / TT, CLP = round_up(chunk, TT);
  const int c = blockIdx.x / njt, jt = blockIdx.x % njt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + chunk - 1) / chunk;
  const int c0 = c * chunk, cl = min(chunk, S - c0), j0 = jt * TT;
  if (j0 >= cl) return;
  const int tid = threadIdx.x;
  const int KN = round_up(N, 16), KP = round_up(P, 16);
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
  const T* xj = x + b * sd.xb + h * sd.xh + (int64_t)(c0 + j0) * sd.xt;
  load_tile(sX, LDT, xj, sd.xt, TT, cl - j0, TT, P, false);
  load_tile(sR, LDN, Bm + b * sd.bb + (int64_t)(c0 + j0) * sd.bt, sd.bt, TT,
            cl - j0, NMAX, N, false);
  load_tile(sP, LDN, sv.ds + bch * PN, N, TT, P, NMAX, N, false);
  __syncthreads();
  const float cs_last = sCs[cl - 1];

  // U_j = D B_j: dx starts at w_j U_j; x_j . U_j per key
  float u[4][4] = {};
  prod<TC, false, true>(u, sR, LDN, 1, sP, 1, LDN, KN);
  // <D, S_0> for the last token's cs (one key tile per chunk takes it)
  float ds0 = 0.f;
  if (jt == 0) {
    float part = 0.f;
    const float* s0 = sv.sin + bch * PN;
    for (int e = tid; e < PN; e += NT) part = fmaf(sP[(e / N) * LDN + e % N], s0[e], part);
    ds0 = block_sum(part, sRed);
  }
  __syncthreads();                   // every read of B_j is done
  store_tile<TC>(sM, LDT, u);
  __syncthreads();
  float dxa[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = lay_row<TC>(q, e), j = j0 + jl;
      const float w = j < cl ? expf(cs_last - sCs[j]) * sDt[j] : 0.f;
      dxa[q][e] = w * sM[jl * LDT + lay_col<TC>(q, e)];
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
    prod<TC, false, true>(v, sR, LDN, 1, sP, 1, LDN, KN);
    __syncthreads();                 // every read of C is done
    store_tile<TC>(sM, LDT, v);
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
      prod<TC, false, false>(dm, sDy, LDT, 1, sX, 1, LDT, KP);
      store_tile<TC>(sM, LDT, dm);
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
    prod<TC, true, false>(dxa, sM, 1, LDT, sDy, LDT, 1, TT);  // dx_j += sum_i M_ij dy_i
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
      const int j = j0 + lay_row<TC>(q, e), p = lay_col<TC>(q, e);
      if (j < cl && p < P)
        dx[(((int64_t)b * S + c0 + j) * H + h) * P + p] = from_f<T>(dxa[q][e]);
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
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_dbc(const T* __restrict__ x, const float* __restrict__ dt,
            const T* __restrict__ Bm, const T* __restrict__ Cm,
            const T* __restrict__ dy, Saved sv, Work wk, T* __restrict__ dB,
            T* __restrict__ dC, int S, int H, int P, int N, int chunk,
            Strides sd) {
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
  constexpr bool TC = sizeof(T) == 2;
  const int tid = threadIdx.x, KP = round_up(P, 16);
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
    prod<TC, true, false>(acc, sA, 1, LDT, sK, LDT, 1, TT);
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
    prod<TC, false, true>(ah, sA, 1, LDT, sK, LDT, 1, KP);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = fmaf(sW[lay_row<TC>(q, e)], ah[q][e], acc[q][e]);
  }
  T* out = do_c ? dC : dB;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = r0 + lay_row<TC>(q, e), n = n0 + lay_col<TC>(q, e);
      if (t < cl && n < N) out[((int64_t)b * S + c0 + t) * N + n] = from_f<T>(acc[q][e]);
    }
}

// ---------------------------------------------------------------- pass E
// Per head: dcs_t = own_t + the key tiles' row sums at t; da = its reverse
// running sum in each chunk (a warp a chunk, lanes on contiguous token
// segments); ddt += A da; dA = sum da dt over batch rows and chunks, in a
// fixed order.  grid (H).
__global__ void __launch_bounds__(NT)
ssd_bwd_dcs(const float* __restrict__ dt, const float* __restrict__ A, Work wk,
            float* __restrict__ ddt, float* __restrict__ dA, int B, int S,
            int H, int chunk, Strides sd) {
  __shared__ float red[NT / 32];
  const int h = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (S + chunk - 1) / chunk, njt = (chunk + TT - 1) / TT;
  const float a = A[h];
  float dap = 0.f;                   // lane 0: this warp's chunks, in order
  for (int pr = warp; pr < B * nc; pr += NT / 32) {
    const int b = pr / nc, c = pr % nc;
    const int c0 = c * chunk, cl = min(chunk, S - c0);
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    const float* own = wk.own + bch * chunk;
    const float* rows = wk.rows + bch * njt * chunk;
    const int seg = (cl + 31) / 32;
    const int beg = min(lane * seg, cl), end = min(beg + seg, cl);
    float tot = 0.f;
    for (int t = beg; t < end; ++t) {
      float v = own[t];
      for (int jt = 0; jt <= t / TT; ++jt) v += rows[jt * chunk + t];
      tot += v;
    }
    float suf = tot;                 // inclusive suffix sum over lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o;
    }
    float run = suf - tot;           // what the later lanes' tokens add
    float part = 0.f;
    const float* dtb = dt + b * sd.db + h * sd.dh + (int64_t)c0 * sd.dt;
    for (int t = end - 1; t >= beg; --t) {
      float v = own[t];
      for (int jt = 0; jt <= t / TT; ++jt) v += rows[jt * chunk + t];
      run += v;
      ddt[((int64_t)b * S + c0 + t) * H + h] += a * run;
      part = fmaf(run, dtb[(int64_t)t * sd.dt], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    dap += part;
  }
  if (lane == 0) red[warp] = dap;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w];
    dA[h] = s;
  }
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const T* dy, const float* dfinal, const float* saved,
           float* work, T* dx, float* ddt, float* dA, T* dB, T* dC, int B,
           int S, int H, int P, int N, int chunk, const Strides& sd,
           cudaStream_t stream) {
  const int nc = (S + chunk - 1) / chunk, njt = (chunk + TT - 1) / TT;
  const int CLP = round_up(chunk, TT);
  const Saved sv = carve_saved(saved, work, B, nc, H, P, N, chunk);
  const Work wk = carve_work(work, B, nc, H, P, N, chunk);
  const int smem_q = (TT * LDT + TT * LDN + TT) * 4;
  const int smem_c = (2 * CLP + 2 * TT * LDT + 2 * TT * LDN + 2 * TT + NT / 32 + 1) * 4;
  const int smem_d = (2 * TT * LDT + TT) * 4;
  if (smem_c > SMEM_MAX || (int64_t)nc * njt > 2147483647 ||
      2 * ((N + TT - 1) / TT) > 65535)
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> ready_q{0}, ready_c{0};
  int err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_q<T>), ready_q);
  if (err) return err;
  if ((err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_intra<T>), ready_c)))
    return err;
  ssd_bwd_q<T><<<dim3(nc, H, B), NT, smem_q, stream>>>(dy, Cm, sv, S, H, P, N,
                                                       chunk, sd);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dstate<<<dim3((P * N + 4 * NT - 1) / (4 * NT), H, B), NT, 0, stream>>>(
      sv.ds, sv.cs, dfinal, H, P, N, chunk, nc);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_intra<T><<<dim3(nc * njt, H, B), NT, smem_c, stream>>>(
      x, dt, Bm, Cm, dy, sv, wk, dx, ddt, S, H, P, N, chunk, sd);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t sq = (int64_t)chunk * chunk;
  ssd_bwd_dg_sum<<<dim3((unsigned)((sq + NT - 1) / NT), nc, B), NT, 0, stream>>>(
      wk, S, H, chunk);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc<T><<<dim3(nc * njt, 2 * ((N + TT - 1) / TT), B), NT, smem_d, stream>>>(
      x, dt, Bm, Cm, dy, sv, wk, dB, dC, S, H, P, N, chunk, sd);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dcs<<<dim3(H), NT, 0, stream>>>(dt, A, wk, ddt, dA, B, S, H, chunk, sd);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of device workspace ssd_scan_bwd needs for these shapes.
extern "C" long long ssd_scan_bwd_workspace_floats(int B, int S, int H, int P,
                                                   int N, int chunk) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0) return 0;
  return workspace_floats(B, (S + chunk - 1) / chunk, H, P, N, chunk);
}

// C entry point.  dtype (of x, Bm, Cm, dy, dx, dB and dC): 0 = float32, 1 =
// bfloat16; dt, A, dfinal, ddt and dA are float32.  x, dt, Bm and Cm are
// read through their strides (in elements, unit stride in the last dim);
// dy, dx (B, S, H, P), ddt (B, S, H), dB and dC (B, S, N) and dfinal
// (B, H, P, N) are contiguous, dfinal 16-byte aligned or null (a zero
// cotangent).  saved: the forward's scratch (ssd_scan_scratch_floats of the
// bf16 layout), read only; work: at least ssd_scan_bwd_workspace_floats(...)
// floats, 16-byte aligned.  Returns a cudaError_t.
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
    return launch<float>(static_cast<const float*>(x), dt, A,
                         static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                         static_cast<const float*>(dy), dfinal, saved, work,
                         static_cast<float*>(dx), ddt, dA, static_cast<float*>(dB),
                         static_cast<float*>(dC), B, S, H, P, N, chunk, sd, st);
  if (dtype == 1)
    return launch<bf16>(static_cast<const bf16*>(x), dt, A,
                        static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
                        static_cast<const bf16*>(dy), dfinal, saved, work,
                        static_cast<bf16*>(dx), ddt, dA, static_cast<bf16*>(dB),
                        static_cast<bf16*>(dC), B, S, H, P, N, chunk, sd, st);
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
