// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan_fwd` / `_ssd_kernel` in
// src/repro/kernels/ssd_scan/kernel.py (and computes what
// src/repro/models/ssm.py::ssd_chunked computes).  Per chunk of `chunk`
// tokens, with cs the running sum of dt * A inside the chunk:
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra)
//         + exp(cs_i) C_i . S                                     (inter)
//   S     = exp(cs_last) S + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// with the P x N state S carried from chunk to chunk in f32, y stored in
// x's dtype and the final S returned in f32.
//
// What bounds it on the card.  Per (batch, head, chunk of length c) the
// work is about c^2 N / 2 (C B^T, causal half, shared by every head) +
// c^2 P / 2 (M x) + 2 c P N (inter and state) multiply-adds, against
// 2 c P bytes of x and y (bf16) and 4 c N of B and C shared by all heads.
// On the tensor cores, with every f32 operand split in two (below), those
// products take about as long at the dense bf16 rate as moving x, B, C and
// y once at mamba2-780m's widths (P 64, N 128, chunk 256, 48 heads): ~4 us
// each at S 901 (chip_smoke.py::ssd_bound says which is larger), with the
// exps on the f32 units behind them.
//
// What the design does (bf16, the serving path).  The reference's
// sequential chunk axis (the TPU grid's) is split into passes that are
// parallel over chunks, as the reference's docstring says a CUDA version
// would be: only a P x N state recurrence stays sequential.
//   1. ssd_scan_chunk, per (chunk, head, 64-column P tile, batch row):
//      cs = cumsum(dt * A) over the chunk, in sequence as torch.cumsum sums
//      it (written to scratch; see chunk_state for why the order), and the
//      chunk's own state contribution dS = sum_j w_j x_j B_j^T with
//      w_j = exp(cs_last - cs_j) dt_j.  In the same launch, extra blocks per
//      (chunk, 64-row strip) compute CB = C B^T once for every head, lower
//      triangle in 64 x 64 tiles, f32 into scratch (1 MiB at S 901: it
//      stays in L2).
//   2. ssd_scan_state, per (1024 state elements, head, batch row):
//      S_c = exp(cs_last,c) S_{c-1} + dS_c over the chunks, writing the
//      state that enters each chunk and the final state.  It carries only
//      P x N states.
//   3. ssd_scan_output, per (chunk, 64-row tile, head, P tile, batch row):
//      y = (CB o L o dt) x + exp(cs) (C . S_{c-1}), stored in x's dtype.
// Every product runs on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate).  In each product one operand is exact in bf16 (x, B or
// C); the other is f32 (the weighted x of dS, M = CB o L o dt, the incoming
// state S) and is split into hi = bf16(v) and lo = bf16(v - hi), multiplied
// twice: a relative error near 2^-16 where one bf16 rounding (2^-9) would
// break the state limit.  mma.sync rather than wgmma: the split operands
// are made in registers from f32 values, and each block's products are a
// few million multiply-adds, so latency, not the tensor-core rate, sets the
// time.  B and x fragments come from row-major shared tiles through
// ldmatrix.trans.  x, dt, B and C are read in the model's layout through
// their strides (B and C are column slices of the convolution output, x a
// head split of it), so nothing is transposed or padded in device memory:
// a ragged last chunk is masked by index, with dt and x taken as 0 past the
// end, so the final state is the state after token S - 1.  The caller
// allocates the scratch (incoming states, CB, cs: what a backward reads)
// and, apart from it, the dS buffer, which is dead once the call returns.
//
// f32 inputs run the one-block-per-(P half, head, batch row) kernel
// ssd_scan_f32: the chunk axis a loop inside the block, the state in
// shared memory, every product a scalar f32 FMA (tensor cores would round
// f32 operands), 64-row query tiles against key tiles j <= i.  Nothing
// served runs f32.  Given scratch (a forward whose backward follows), it
// also writes the incoming states, CB and cs in the bf16 passes' layout
// which is what the backward (ssd_scan_bwd.cu) reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NT = 256;        // threads of every kernel: 8 warps
constexpr int NMAX = 128;      // largest state size N (a multiple of 4)
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

struct Strides {
  int64_t xb, xt, xh;          // x (B, S, H, P): batch, token, head; p is 1
  int64_t db, dt, dh;          // dt (B, S, H)
  int64_t bb, bt;              // Bm (B, S, N): batch, token; n is 1
  int64_t cb, ct;              // Cm (B, S, N)
};

// Raise a kernel's dynamic shared-memory limit once per device, not on every
// launch: bit d of `ready` says it is done on device d.
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

// ---------------------------------------------------------- f32: one pass
constexpr int TI = 64;         // rows of a query tile and of a key tile
constexpr int PB = 32;         // head-dim columns per block

// shared floats: C and B tiles, x tile (transposed), M tile, state, and cs,
// dt, w per row.  Rows of C, B and the state are N + 4 floats and rows of
// x^T and M are TI + 4, so every row starts 16-byte aligned for float4 reads
// and neighbouring rows start 4 banks apart.
__host__ __device__ inline int smem_floats(int N, int chunk) {
  const int NP = N + 4, LDM = TI + 4;
  return 2 * TI * NP + PB * LDM + TI * LDM + PB * NP + 3 * round_up(chunk, TI);
}


__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// TI rows of `cols` elements (row r at src + r * stride) into dst[r * ld + c]
// (or dst[c * ld + r] when `transpose`), as f32; rows at or past `valid`
// are zeros.  Every load of the tile is issued before the first store, so
// a tile costs about one memory latency, not one per element a thread
// copies.  Needs TI * cols <= NT * MAXE.
template <int MAXE, bool transpose, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int valid,
                                          int cols) {
  const int dr = NT / cols, dc = NT % cols;   // (row, col) step of NT elements
  float v[MAXE];
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    v[k] = r < TI && r < valid ? load_f(src + r * stride + c) : 0.f;
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  }
  r = threadIdx.x / cols;
  c = threadIdx.x % cols;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    if (r < TI) dst[transpose ? c * ld + r : r * ld + c] = v[k];
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  }
}


// y: (B, S, H, P) contiguous; state: (B, H, P, N) contiguous f32; N a
// multiple of 4.  grid = (ceil(P / PB), H, B).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan_f32(const T* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const T* __restrict__ Bm,
         const T* __restrict__ Cm, T* __restrict__ y,
         float* __restrict__ state, float* __restrict__ sv_sin,
         float* __restrict__ sv_cb, float* __restrict__ sv_cs, int S, int H,
         int P, int N, int chunk, Strides sd) {
  constexpr int LDM = TI + 4;
  const int NP = N + 4;
  const int CLP = round_up(chunk, TI);
  extern __shared__ __align__(16) float smem[];
  float* sC = smem;                  // TI x NP: C rows of the query tile
  float* sB = sC + TI * NP;          // TI x NP: B rows of the key tile
  float* sXt = sB + TI * NP;         // PB x LDM: x^T of the key tile
  float* sM = sXt + PB * LDM;        // TI x LDM: masked, decayed C B^T
  float* sS = sM + TI * LDM;         // PB x NP: the carried state
  float* sCs = sS + PB * NP;         // CLP: cumulative dt * A in the chunk
  float* sDt = sCs + CLP;            // CLP: dt
  float* sW = sDt + CLP;             // CLP: dt_j exp(cs_last - cs_j)

  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // tile rows ty + 16 r, cols tx + 16 c
  const int n0 = 4 * (tid & 31);            // state update: columns n0..n0+3,
  const int pg = tid >> 5;                  // rows pg + 8 a
  const float a = A[h];

  const T* xb = x + b * sd.xb + h * sd.xh + p0;
  const float* dtb = dt + b * sd.db + h * sd.dh;
  const T* Bb = Bm + b * sd.bb;
  const T* Cb = Cm + b * sd.cb;
  const int64_t y_row = (int64_t)H * P;
  T* yb = y + ((int64_t)b * S * H + h) * P + p0;

  for (int i = tid; i < PB * NP; i += NT) sS[i] = 0.f;
  for (int i = tid; i < PB * LDM; i += NT) sXt[i] = 0.f;   // columns past P stay 0

  const int nc = (S + chunk - 1) / chunk;
  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int cl = min(chunk, S - c0);      // valid rows of this chunk
    const int64_t bc = (int64_t)b * nc + c0 / chunk;
    __syncthreads();                        // the last chunk is done with sCs, sDt, sW
    for (int t = tid; t < CLP; t += NT) sDt[t] = t < cl ? dtb[(c0 + t) * sd.dt] : 0.f;
    __syncthreads();
    if (tid < 32) {                         // inclusive scan of dt * a by one warp
      const int seg = (CLP + 31) / 32;
      const int beg = min(tid * seg, CLP), end = min(beg + seg, CLP);
      float run = 0.f;
      for (int t = beg; t < end; ++t) run += sDt[t] * a;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) acc = 0.f;
      for (int t = beg; t < end; ++t) {
        acc += sDt[t] * a;
        sCs[t] = acc;                       // past cl: dt = 0, so cs stays at cs_last
      }
    }
    __syncthreads();
    const float cs_last = sCs[cl - 1];
    for (int t = tid; t < CLP; t += NT) sW[t] = sDt[t] * expf(cs_last - sCs[t]);
    if (sv_cs) {                            // saved for the backward
      if (blockIdx.x == 0)
        for (int t = tid; t < chunk; t += NT) sv_cs[(bc * H + h) * chunk + t] = sCs[t];
      for (int e = tid; e < PB * N; e += NT) {
        const int p = e / N, n = e % N;
        if (p0 + p < P) sv_sin[((bc * H + h) * P + p0 + p) * N + n] = sS[p * NP + n];
      }
    }

    const int nt = (cl + TI - 1) / TI;
    float supd[4][4];                       // rows pg + 8 a, columns n0 + k
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) supd[r][k] = 0.f;

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TI;
      __syncthreads();                      // sC is free, sW is written
      load_tile<TI * NMAX / NT, false>(sC, NP, Cb + (c0 + i0) * sd.ct, sd.ct,
                                       cl - i0, N);
      __syncthreads();

      // inter-chunk term: exp(cs_i) C_i . S, rows ty + 16 r, columns tx + 16 c
      float yacc[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) yacc[r][c] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(sC + (ty + 16 * r) * NP + n);
#pragma unroll
        for (int c = 0; c < 2; ++c) sv[c] = ld4(sS + (tx + 16 * c) * NP + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) yacc[r][c] = dot4(cv[r], sv[c], yacc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(sCs[i0 + ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < 2; ++c) yacc[r][c] *= e;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TI;
        __syncthreads();                    // sB, sXt and sM are free
        load_tile<TI * NMAX / NT, false>(sB, NP, Bb + (c0 + j0) * sd.bt,
                                         sd.bt, cl - j0, N);
        load_tile<TI * PB / NT, true>(sXt, LDM, xb + (c0 + j0) * sd.xt,
                                      sd.xt, cl - j0, min(PB, P - p0));
        __syncthreads();

        // M = (C_i B_j^T) exp(cs_i - cs_j) dt_j for j <= i, else 0
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = ld4(sC + (ty + 16 * r) * NP + n);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = ld4(sB + (tx + 16 * c) * NP + n);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = dot4(cv[r], bv[c], s[r][c]);
        }
        if (sv_cb && blockIdx.x == 0 && h == 0) {
          float* g = sv_cb + bc * chunk * chunk;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
              if (i < chunk && j < chunk) g[(int64_t)i * chunk + j] = s[r][c];
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            const float arg = j <= i ? sCs[i] - sCs[j] : -INFINITY;
            sM[(ty + 16 * r) * LDM + tx + 16 * c] = s[r][c] * expf(arg) * sDt[j];
          }
        }

        if (it == nt - 1 && n0 < N) {       // state update from this key tile
          for (int jj = 0; jj < TI; jj += 4) {
            const float4 w = ld4(sW + j0 + jj);
            float4 xw[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              xw[r] = ld4(sXt + (pg + 8 * r) * LDM + jj);
              xw[r].x *= w.x;
              xw[r].y *= w.y;
              xw[r].z *= w.z;
              xw[r].w *= w.w;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) bv[u] = ld4(sB + (jj + u) * NP + n0);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float f = comp(xw[r], u);
                supd[r][0] = fmaf(f, bv[u].x, supd[r][0]);
                supd[r][1] = fmaf(f, bv[u].y, supd[r][1]);
                supd[r][2] = fmaf(f, bv[u].z, supd[r][2]);
                supd[r][3] = fmaf(f, bv[u].w, supd[r][3]);
              }
          }
        }
        __syncthreads();                    // sM is complete

        for (int jj = 0; jj < TI; jj += 4) {
          float4 mv[4], xv[2];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = ld4(sM + (ty + 16 * r) * LDM + jj);
#pragma unroll
          for (int c = 0; c < 2; ++c) xv[c] = ld4(sXt + (tx + 16 * c) * LDM + jj);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) yacc[r][c] = dot4(mv[r], xv[c], yacc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= cl) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (p0 + tx + 16 * c < P)
            store_f(yb + (int64_t)(c0 + i) * y_row + tx + 16 * c, yacc[r][c]);
      }
    }

    __syncthreads();                        // every reader of the old state is done
    const float dec = expf(cs_last);
    if (n0 < N) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float* st = sS + (pg + 8 * r) * NP + n0 + k;
          *st = fmaf(*st, dec, supd[r][k]);
        }
    }
  }

  __syncthreads();
  if (n0 < N) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = pg + 8 * r;
      if (p0 + p >= P) continue;
      float* out = state + (((int64_t)b * H + h) * P + p0 + p) * N + n0;
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = sS[p * NP + n0 + k];
    }
  }
}

int launch_f32(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, float* state, float* sv_sin,
               float* sv_cb, float* sv_cs, int B, int S, int H, int P, int N,
               int chunk, const Strides& sd, cudaStream_t stream) {
  const int smem = smem_floats(N, chunk) * (int)sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> ready{0};
  const int err = allow_smem(reinterpret_cast<const void*>(ssd_scan_f32<float>), ready);
  if (err) return err;
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_scan_f32<float><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), state, sv_sin,
      sv_cb, sv_cs, S, H, P, N, chunk, sd);
  return (int)cudaGetLastError();
}

// ------------------------------------------- bf16: passes parallel over chunks
using bf16 = __nv_bfloat16;
constexpr int T64 = 64;        // token tile, row tile, and head-dim columns a block
constexpr int LDB = NMAX + 8;  // bf16 row stride of B and C tiles (272 bytes)
constexpr int LDX = T64 + 8;   // bf16 row stride of x tiles (144 bytes)
constexpr int LDW = T64 + 1;   // f32 row stride of the transposed weighted x
constexpr int LDF = T64 + 4;   // f32 row stride of a CB tile
constexpr int LDS = NMAX + 4;  // f32 row stride of a state tile

// The caller's scratch, carved in this order (every part but the last a
// multiple of 4 floats): the incoming states, (B, nc, H, P, N); CB,
// (B, nc, chunk, chunk); cs, (B, nc, H, chunk).  dS, (B, nc, H, P, N), is
// a buffer of its own (ds_floats), so a backward keeps the scratch alone.
struct Scratch {
  float* ds;
  float* sin;
  float* cb;
  float* cs;
};

__host__ __device__ inline int64_t scratch_floats(int B, int nc, int H, int P,
                                                  int N, int chunk) {
  const int64_t state = (int64_t)B * nc * H * P * N;
  const int64_t cb = ((int64_t)B * nc * chunk * chunk + 3) / 4 * 4;
  return state + cb + (int64_t)B * nc * H * chunk;
}

inline Scratch carve(float* base, float* ds, int B, int nc, int H, int P, int N,
                     int chunk) {
  Scratch s;
  const int64_t state = (int64_t)B * nc * H * P * N;
  s.ds = ds;
  s.sin = base;
  s.cb = s.sin + state;
  s.cs = s.cb + ((int64_t)B * nc * chunk * chunk + 3) / 4 * 4;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// d0, d1 (g, 2t..2t+1), d2, d3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The b fragment of rows k..k+15, columns n..n+7 of a row-major (k, n) bf16
// tile: lane l (< 16) gives the address of row k + l.
__device__ __forceinline__ void ldsm_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(smem_u32(row)));
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

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16_rn(0.f);
}

// A rows x cols tile of a strided matrix (row r at src + r * stride), zero
// past valid_rows / valid_cols, staged through registers: fetch() issues a
// thread's loads, put() stores them into shared memory (row stride ld, a
// multiple of 16 bytes), so one tile's loads are in flight while the
// previous tile is used.  Rows that start 16-byte aligned, with valid_cols
// a multiple of the 16-byte vector, move 16 bytes at a time; other tiles
// are copied element by element in put().
template <typename T, int rows, int cols>
struct Tile {
  static constexpr int W = 16 / sizeof(T);            // elements a vector
  static constexpr int V = cols / W, IT = (rows * V + NT - 1) / NT;
  uint4 v[IT];
  const T* src;
  int64_t stride;
  int vr, vc;
  bool vec;

  __device__ __forceinline__ void fetch(const T* s, int64_t st, int valid_rows,
                                        int valid_cols) {
    src = s;
    stride = st;
    vr = valid_rows;
    vc = valid_cols;
    vec = reinterpret_cast<uintptr_t>(s) % 16 == 0 && st % W == 0 &&
          valid_cols % W == 0;
    if (!vec) return;
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const int i = threadIdx.x + k * NT, r = i / V, c = (i % V) * W;
      v[k] = i < rows * V && r < vr && c < vc
          ? *reinterpret_cast<const uint4*>(s + r * st + c)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void put(T* dst, int ld) const {
    if (vec) {
#pragma unroll
      for (int k = 0; k < IT; ++k) {
        const int i = threadIdx.x + k * NT, r = i / V, c = (i % V) * W;
        if (i < rows * V) *reinterpret_cast<uint4*>(dst + r * ld + c) = v[k];
      }
    } else {
      for (int i = threadIdx.x; i < rows * cols; i += NT) {
        const int r = i / cols, c = i % cols;
        dst[r * ld + c] = r < vr && c < vc ? src[r * stride + c] : zero_of<T>();
      }
    }
  }
};

// Pass 1, CB part: block (chunk, H * npt + strip, batch row) computes rows
// i0..i0+63 of the chunk's CB = C B^T against key tiles j0 <= i0, f32.
__device__ __forceinline__ void chunk_cb(unsigned char* smem, const bf16* Cm,
                                         const bf16* Bm, Scratch sc, int strip,
                                         int S, int N, int chunk,
                                         const Strides& sd) {
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * chunk, cl = min(chunk, S - c0), i0 = strip * T64;
  if (i0 >= cl) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // warp's 16 x 32 tile
  bf16* sC = reinterpret_cast<bf16*>(smem);                // T64 x LDB
  bf16* sB = sC + T64 * LDB;                               // T64 x LDB
  const bf16* Cb = Cm + b * sd.cb + (int64_t)(c0 + i0) * sd.ct;
  const bf16* Bb = Bm + b * sd.bb + (int64_t)c0 * sd.bt;
  float* cb = sc.cb + ((int64_t)b * nc + c) * chunk * chunk;
  Tile<bf16, T64, NMAX> bt;
  {
    Tile<bf16, T64, NMAX> ct;
    ct.fetch(Cb, sd.ct, cl - i0, N);
    bt.fetch(Bb, sd.bt, cl, N);
    ct.put(sC, LDB);
  }
  for (int j0 = 0; j0 <= i0; j0 += T64) {
    __syncthreads();                        // sB is free (and sC written)
    bt.put(sB, LDB);
    __syncthreads();
    if (j0 + T64 <= i0)                     // the next key tile, in flight
      bt.fetch(Bb + (int64_t)(j0 + T64) * sd.bt, sd.bt, cl - j0 - T64, N);
    float acc[4][4] = {};
    for (int k = 0; k < N; k += 16) {
      const bf16* pa = sC + (wr + g) * LDB + k + 2 * t4;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LDB), ld32(pa + 8),
                             ld32(pa + 8 * LDB + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* pb = sB + (wc + nt * 8 + g) * LDB + k + 2 * t4;
        mma_bf16(acc[nt], a, ld32(pb), ld32(pb + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = j0 + wc + nt * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wr + g + (e >> 1) * 8, j = col + (e & 1);
        if (i < chunk && j < chunk) cb[(int64_t)i * chunk + j] = acc[nt][e];
      }
    }
  }
}

// Pass 1, state part: block (chunk, h * npt + P tile, batch row) computes
// cs for the chunk and dS = sum_j w_j x_j B_j^T for 64 rows p of the state.
__device__ __forceinline__ void chunk_state(unsigned char* smem, const bf16* x,
                                            const float* dt, const float* A,
                                            const bf16* Bm, Scratch sc, int S,
                                            int H, int P, int N, int chunk,
                                            int npt, const Strides& sd) {
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int h = blockIdx.y / npt, p0 = (blockIdx.y % npt) * T64;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  const int CLP = round_up(chunk, T64);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* sDt = reinterpret_cast<float*>(smem);   // CLP: dt
  float* sCs = sDt + CLP;                        // CLP: cumulative dt * A
  float* sW = sCs + CLP;                         // CLP: dt_j exp(cs_last - cs_j)
  float* sXw = sW + CLP;                         // T64 (p) x LDW (tokens)
  bf16* sB = reinterpret_cast<bf16*>(sXw + T64 * LDW);   // T64 (tokens) x LDB
  const float a = A[h];
  const float* dtb = dt + b * sd.db + h * sd.dh + (int64_t)c0 * sd.dt;

  for (int t = tid; t < CLP; t += NT) sDt[t] = t < cl ? dtb[t * sd.dt] : 0.f;
  __syncthreads();
  if (tid == 0) {
    // cs in sequence, dt * a rounded and then added, as torch.cumsum of
    // dt * A (the plain version) sums: exp(cs_last - cs_j) cancels about 11
    // bits at |cs| ~ 6e3, so another order of the sum moves the state by
    // ~1e-4 relative, SSD_STATE_TOL.  Past cl, dt = 0 and cs stays at cs_last.
    float run = 0.f;
    for (int t0 = 0; t0 < CLP; t0 += 8) {  // CLP is a multiple of 64
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = sDt[t0 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = run = __fadd_rn(run, __fmul_rn(v[u], a));
#pragma unroll
      for (int u = 0; u < 8; ++u) sCs[t0 + u] = v[u];
    }
  }
  __syncthreads();
  const float cs_last = sCs[CLP - 1];
  if (p0 == 0) {
    float* cs = sc.cs + (((int64_t)b * nc + c) * H + h) * chunk;
    for (int t = tid; t < chunk; t += NT) cs[t] = sCs[t];
  }
  for (int t = tid; t < CLP; t += NT) sW[t] = sDt[t] * expf(cs_last - sCs[t]);

  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 64;   // warp's 16 x 64 tile
  const bf16* xb = x + b * sd.xb + h * sd.xh + p0 + (int64_t)c0 * sd.xt;
  const bf16* Bb = Bm + b * sd.bb + (int64_t)c0 * sd.bt;
  float acc[8][4] = {};
  Tile<bf16, T64, T64> xt;                // tokens x p
  Tile<bf16, T64, NMAX> bt;               // tokens x n
  xt.fetch(xb, sd.xt, cl, P - p0);
  bt.fetch(Bb, sd.bt, cl, N);
  for (int j0 = 0; j0 < cl; j0 += T64) {
    __syncthreads();                      // sW is written, sXw and sB are free
    if (xt.vec) {                         // x^T times w into sXw
#pragma unroll
      for (int k = 0; k < xt.IT; ++k) {
        const int i = tid + k * NT, j = i / xt.V, p = (i % xt.V) * 8;
        const float w = sW[j0 + j];
        const uint32_t words[4] = {xt.v[k].x, xt.v[k].y, xt.v[k].z, xt.v[k].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {     // a bf16 is the top half of its f32
          sXw[(p + 2 * u) * LDW + j] = __uint_as_float(words[u] << 16) * w;
          sXw[(p + 2 * u + 1) * LDW + j] = __uint_as_float(words[u] & 0xffff0000u) * w;
        }
      }
    } else {
      for (int i = tid; i < T64 * T64; i += NT) {
        const int j = i / T64, p = i % T64;
        sXw[p * LDW + j] = j < xt.vr && p < xt.vc
            ? __bfloat162float(xt.src[(int64_t)j * sd.xt + p]) * sW[j0 + j] : 0.f;
      }
    }
    bt.put(sB, LDB);
    __syncthreads();
    if (j0 + T64 < cl) {                  // the next token tile, in flight
      xt.fetch(xb + (int64_t)(j0 + T64) * sd.xt, sd.xt, cl - j0 - T64, P - p0);
      bt.fetch(Bb + (int64_t)(j0 + T64) * sd.bt, sd.bt, cl - j0 - T64, N);
    }
#pragma unroll
    for (int k = 0; k < T64; k += 16) {
      // A = the weighted x^T (p x tokens), f32, as bf16 hi + lo
      const float* w0 = sXw + (wr + g) * LDW + k + 2 * t4;
      const float* w1 = w0 + 8 * LDW;
      uint32_t xw_hi[4], xw_lo[4];
      split(w0[0], w0[1], xw_hi[0], xw_lo[0]);
      split(w1[0], w1[1], xw_hi[1], xw_lo[1]);
      split(w0[8], w0[9], xw_hi[2], xw_lo[2]);
      split(w1[8], w1[9], xw_hi[3], xw_lo[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        ldsm_b(b0, b1, sB + (k + (lane & 15)) * LDB + wc + nt * 8);
        mma_bf16(acc[nt], xw_hi, b0, b1);
        mma_bf16(acc[nt], xw_lo, b0, b1);
      }
    }
  }
  float* ds = sc.ds + (((int64_t)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = wc + nt * 8 + 2 * t4;
    if (n >= N) continue;                 // N is a multiple of 4: n + 1 < N too
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wr + g + 8 * half;
      if (p < P)
        *reinterpret_cast<float2*>(ds + (int64_t)p * N + n) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// Pass 1: grid (nc, H * npt + ceil(chunk / 64), B).  Capped at 128
// registers, so two blocks fit an SM (one at the 140 it takes uncapped):
// the pass waits on loads more than it computes.
__global__ void __launch_bounds__(NT, 2)
ssd_scan_chunk(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, Scratch sc, int S, int H, int P,
               int N, int chunk, int npt, Strides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.y >= H * npt)
    chunk_cb(smem_raw, Cm, Bm, sc, blockIdx.y - H * npt, S, N, chunk, sd);
  else
    chunk_state(smem_raw, x, dt, A, Bm, sc, S, H, P, N, chunk, npt, sd);
}

// Pass 2: grid (ceil(P N / (4 NT)), H, B), four state elements a thread.
// The state entering chunk c is S_{c-1}; S_c = exp(cs_last,c) S_{c-1} +
// dS_c; the last is the final state.
__global__ void __launch_bounds__(NT)
ssd_scan_state(const float* __restrict__ ds, const float* __restrict__ cs,
               float* __restrict__ sin, float* __restrict__ state, int H,
               int P, int N, int chunk, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int PN = P * N, e = (blockIdx.x * NT + threadIdx.x) * 4;
  if (e >= PN) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    *reinterpret_cast<float4*>(sin + bch * PN + e) = s;
    const float decay = expf(cs[bch * chunk + chunk - 1]);
    const float4 d = *reinterpret_cast<const float4*>(ds + bch * PN + e);
    s = make_float4(fmaf(s.x, decay, d.x), fmaf(s.y, decay, d.y),
                    fmaf(s.z, decay, d.z), fmaf(s.w, decay, d.w));
  }
  *reinterpret_cast<float4*>(state + ((int64_t)b * H + h) * PN + e) = s;
}

// Pass 3: grid (nc * ceil(chunk / 64), H * npt, B); block (chunk c, row tile
// i0, head h, P tile p0) writes y for rows i0..i0+63 and columns p0..p0+63.
__global__ void __launch_bounds__(NT)
ssd_scan_output(const bf16* __restrict__ x, const float* __restrict__ dt,
                const bf16* __restrict__ Cm, Scratch sc, bf16* __restrict__ y,
                int S, int H, int P, int N, int chunk, int npt, Strides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nit = (chunk + T64 - 1) / T64, nc = (S + chunk - 1) / chunk;
  const int c = blockIdx.x / nit, i0 = (nit - 1 - blockIdx.x % nit) * T64;  // longest first
  const int h = blockIdx.y / npt, p0 = (blockIdx.y % npt) * T64;
  const int b = blockIdx.z;
  const int c0 = c * chunk, cl = min(chunk, S - c0);
  if (i0 >= cl) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;   // warp's 16 x 32 tile
  float* sCsI = reinterpret_cast<float*>(smem_raw);   // T64: cs of the rows
  float* sCsJ = sCsI + T64;                       // T64: cs of the keys
  float* sDtJ = sCsJ + T64;                       // T64: dt of the keys
  float* sF = sDtJ + T64;                         // state (T64 x LDS) or CB (T64 x LDF)
  bf16* sC = reinterpret_cast<bf16*>(sF + T64 * LDS);   // T64 x LDB
  bf16* sX = sC + T64 * LDB;                            // T64 x LDX
  const int64_t bch = ((int64_t)b * nc + c) * H + h;
  const float* csb = sc.cs + bch * chunk;
  const float* dtb = dt + b * sd.db + h * sd.dh + (int64_t)c0 * sd.dt;
  const bf16* xb = x + b * sd.xb + h * sd.xh + p0 + (int64_t)c0 * sd.xt;
  for (int t = tid; t < T64; t += NT) sCsI[t] = i0 + t < chunk ? csb[i0 + t] : 0.f;

  const float* cb = sc.cb + ((int64_t)b * nc + c) * chunk * chunk;
  Tile<float, T64, T64> cbt;              // CB rows i, key tile j
  Tile<bf16, T64, T64> xt;                // x rows j, columns p
  float acc[4][4] = {};
  if (c > 0) {                            // the state carried into this chunk
    {
      Tile<bf16, T64, NMAX> ct;
      Tile<float, T64, NMAX> st;
      ct.fetch(Cm + b * sd.cb + (int64_t)(c0 + i0) * sd.ct, sd.ct, cl - i0, N);
      st.fetch(sc.sin + (bch * P + p0) * N, N, P - p0, N);
      ct.put(sC, LDB);
      st.put(sF, LDS);
    }
    cbt.fetch(cb + (int64_t)i0 * chunk, chunk, chunk - i0, chunk);
    xt.fetch(xb, sd.xt, cl, P - p0);
    __syncthreads();
    for (int k = 0; k < N; k += 16) {
      const bf16* pa = sC + (wr + g) * LDB + k + 2 * t4;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LDB), ld32(pa + 8),
                             ld32(pa + 8 * LDB + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // B = S^T (n x p): row p of S holds its column, f32 as bf16 hi + lo
        const float* sp = sF + (wc + nt * 8 + g) * LDS + k + 2 * t4;
        uint32_t s_hi0, s_lo0, s_hi1, s_lo1;
        split(sp[0], sp[1], s_hi0, s_lo0);
        split(sp[8], sp[9], s_hi1, s_lo1);
        mma_bf16(acc[nt], a, s_hi0, s_hi1);
        mma_bf16(acc[nt], a, s_lo0, s_lo1);
      }
    }
    const float e0 = expf(sCsI[wr + g]), e1 = expf(sCsI[wr + g + 8]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  } else {
    cbt.fetch(cb + (int64_t)i0 * chunk, chunk, chunk - i0, chunk);
    xt.fetch(xb, sd.xt, cl, P - p0);
  }

  for (int j0 = 0; j0 <= i0; j0 += T64) {
    __syncthreads();                      // sF, sX and the key arrays are free
    cbt.put(sF, LDF);
    xt.put(sX, LDX);
    for (int t = tid; t < T64; t += NT) {
      sCsJ[t] = j0 + t < chunk ? csb[j0 + t] : 0.f;
      sDtJ[t] = j0 + t < cl ? dtb[(int64_t)(j0 + t) * sd.dt] : 0.f;
    }
    __syncthreads();
    if (j0 + T64 <= i0) {                 // the next key tile, in flight
      cbt.fetch(cb + (int64_t)i0 * chunk + j0 + T64, chunk, chunk - i0,
                chunk - j0 - T64);
      xt.fetch(xb + (int64_t)(j0 + T64) * sd.xt, sd.xt, cl - j0 - T64, P - p0);
    }
#pragma unroll
    for (int k = 0; k < T64; k += 16) {
      // A = M = CB exp(cs_i - cs_j) dt_j for j <= i (a select before the
      // exp, which overflows above the diagonal), f32 as bf16 hi + lo
      uint32_t m_hi[4], m_lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wr + g + (q & 1) * 8, col = k + 2 * t4 + (q >> 1) * 8;
        const int i = i0 + r;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + col + u;
          const float arg = j <= i ? sCsI[r] - sCsJ[col + u] : -INFINITY;
          v[u] = sF[r * LDF + col + u] * __expf(arg) * sDtJ[col + u];
        }
        split(v[0], v[1], m_hi[q], m_lo[q]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        ldsm_b(b0, b1, sX + (k + (lane & 15)) * LDX + wc + nt * 8);
        mma_bf16(acc[nt], m_hi, b0, b1);
        mma_bf16(acc[nt], m_lo, b0, b1);
      }
    }
  }

  const int64_t y_row = (int64_t)H * P;
  bf16* yb = y + ((int64_t)b * S + c0) * y_row + (int64_t)h * P;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int p = p0 + wc + nt * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wr + g + (e >> 1) * 8, pe = p + (e & 1);
      if (i < cl && pe < P) yb[(int64_t)i * y_row + pe] = __float2bfloat16_rn(acc[nt][e]);
    }
  }
}

int launch_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                const void* Cm, void* y, float* state, float* scratch, float* ds,
                int B, int S, int H, int P, int N, int chunk, const Strides& sd,
                cudaStream_t stream) {
  const int nc = (S + chunk - 1) / chunk, npt = (P + T64 - 1) / T64;
  const int nit = (chunk + T64 - 1) / T64;
  if (H * npt + nit > 65535) return (int)cudaErrorInvalidValue;
  const int smem_chunk = max(3 * round_up(chunk, T64) * 4 + T64 * LDW * 4 + T64 * LDB * 2,
                             2 * T64 * LDB * 2);
  const int smem_out = 3 * T64 * 4 + T64 * LDS * 4 + T64 * LDB * 2 + T64 * LDX * 2;
  if (smem_chunk > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> ready_chunk{0}, ready_out{0};
  int err = allow_smem(reinterpret_cast<const void*>(ssd_scan_chunk), ready_chunk);
  if (err) return err;
  if ((err = allow_smem(reinterpret_cast<const void*>(ssd_scan_output), ready_out)))
    return err;
  const Scratch sc = carve(scratch, ds, B, nc, H, P, N, chunk);
  const bf16* xh = static_cast<const bf16*>(x);
  const bf16* Bh = static_cast<const bf16*>(Bm);
  const bf16* Ch = static_cast<const bf16*>(Cm);
  ssd_scan_chunk<<<dim3(nc, H * npt + nit, B), NT, smem_chunk, stream>>>(
      xh, dt, A, Bh, Ch, sc, S, H, P, N, chunk, npt, sd);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_scan_state<<<dim3((P * N + 4 * NT - 1) / (4 * NT), H, B), NT, 0, stream>>>(
      sc.ds, sc.cs, sc.sin, state, H, P, N, chunk, nc);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_scan_output<<<dim3(nc * nit, H * npt, B), NT, smem_out, stream>>>(
      xh, dt, Ch, sc, static_cast<bf16*>(y), S, H, P, N, chunk, npt, sd);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the C entry point needs for these shapes and dtype
// (0 = float32, 1 = bfloat16): 0 for float32, which takes the bf16 layout's
// size only to save what its backward reads.  The dS buffer of a bf16 call
// is B * ceil(S / chunk) * H * P * N floats more.
extern "C" long long ssd_scan_scratch_floats(int B, int S, int H, int P, int N,
                                             int chunk, int dtype) {
  if (dtype != 1 || B <= 0 || S <= 0 || chunk <= 0) return 0;
  return scratch_floats(B, (S + chunk - 1) / chunk, H, P, N, chunk);
}

// C entry point.  dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16;
// dt and A are float32.  Strides are in elements.  scratch: at least
// ssd_scan_scratch_floats(...) floats on the device, 16-byte aligned (may
// be null for float32); ds: the dS buffer of a bf16 call, 16-byte aligned
// (unused by float32).  Returns a cudaError_t (0 on success): the launch
// status from cudaGetLastError, or cudaErrorInvalidValue for a shape or
// dtype it does not take.  float32 with scratch also writes the incoming
// states, CB and cs there.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm, void* y,
                            float* state, float* scratch, float* ds, int B,
                            int S, int H, int P, int N, int chunk,
                            long long sxb, long long sxt, long long sxh,
                            long long sdb, long long sdt, long long sdh,
                            long long sbb, long long sbt, long long scb,
                            long long sct, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      N % 4 != 0 || chunk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sd{sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, scb, sct};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Scratch sv{nullptr, nullptr, nullptr, nullptr};
    if (scratch) sv = carve(scratch, nullptr, B, (S + chunk - 1) / chunk, H, P, N, chunk);
    return launch_f32(x, dt, A, Bm, Cm, y, state, sv.sin, sv.cb, sv.cs, B, S, H,
                      P, N, chunk, sd, cs);
  }
  if (dtype == 1) {
    if (!scratch || !ds) return (int)cudaErrorInvalidValue;
    return launch_bf16(x, dt, A, Bm, Cm, y, state, scratch, ds, B, S, H, P, N,
                       chunk, sd, cs);
  }
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
