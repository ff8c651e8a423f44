// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan_fwd` / `_ssd_kernel` in
// src/repro/kernels/ssd_scan/kernel.py (and computes what
// src/repro/models/ssm.py::ssd_chunked computes).  Per chunk of `chunk`
// tokens, with cs the running sum of dt * A inside the chunk:
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra)
//         + exp(cs_i) C_i . S                                     (inter)
//   S     = exp(cs_last) S + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// with the P x N state S carried from chunk to chunk in f32, all arithmetic
// in f32, y stored in x's dtype and the final S returned in f32.
//
// What bounds it on the card.  Per (batch, head, chunk of length c) the
// work is about c^2 N / 2 (C B^T, causal half) + c^2 P / 2 (M x) + 2 c P N
// (inter and state) multiply-adds, against 2 c P bytes of x and y (bf16)
// and 4 c N of B and C shared by all heads.  At mamba2-780m's widths (P 64,
// N 128, chunk 256, 48 heads) that is ~100 f32 flops per byte, far above
// the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flops per byte): the f32
// operations are the bound.  This version computes everything with f32 FMAs
// from shared memory (no tensor cores): each thread holds a 4 x 4 (or 4 x 2)
// register tile and reads its operands as float4 along the contraction
// dimension, about one 16-byte read per 8 FMAs.
//
// What the design does.  The TPU grid's sequential chunk axis becomes a
// loop inside one block, which keeps S in shared memory across chunks, as
// the reference keeps it in VMEM scratch.  One block of 256 threads per
// (32 head-dim columns, head, batch row): the y columns p and the state
// rows p are independent, so splitting P doubles the blocks of a
// single-request prefill (96 for 48 heads) at the cost of computing
// C B^T twice.  A chunk's cl x cl matrix does not fit in shared memory at
// cl = 256 (256 KiB in f32), so the chunk is tiled in 64-row query tiles i
// and, for each, the key tiles j <= i: S_ij = C_i B_j^T (64 x 64), masked
// and decayed into M_ij, then y_i += M_ij x_j.  The mask is applied as a
// select before the exp (exp(cs_i - cs_j) overflows for j > i; multiplying
// by a 0/1 mask would give inf * 0 = NaN).  The state update is folded into
// the last query tile's pass over all key tiles.  x, dt, B and C are read
// in the model's layout through their strides (B and C are column slices
// of the convolution output, x a head split of it), so nothing is
// transposed or padded: a ragged last chunk is masked by index, with dt and
// x taken as 0 past the end, so the final state is the state after token
// S - 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NT = 256;        // threads: 16 x 16
constexpr int TI = 64;         // rows of a query tile and of a key tile
constexpr int PB = 32;         // head-dim columns per block
constexpr int NMAX = 128;      // largest state size N (a multiple of 4)
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// shared floats: C and B tiles, x tile (transposed), M tile, state, and cs,
// dt, w per row.  Rows of C, B and the state are N + 4 floats and rows of
// x^T and M are TI + 4, so every row starts 16-byte aligned for float4 reads
// and neighbouring rows start 4 banks apart.
__host__ __device__ inline int smem_floats(int N, int chunk) {
  const int NP = N + 4, LDM = TI + 4;
  return 2 * TI * NP + PB * LDM + TI * LDM + PB * NP + 3 * round_up(chunk, TI);
}

struct Strides {
  int64_t xb, xt, xh;          // x (B, S, H, P): batch, token, head; p is 1
  int64_t db, dt, dh;          // dt (B, S, H)
  int64_t bb, bt;              // Bm (B, S, N): batch, token; n is 1
  int64_t cb, ct;              // Cm (B, S, N)
};

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
ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const T* __restrict__ Bm,
         const T* __restrict__ Cm, T* __restrict__ y,
         float* __restrict__ state, int S, int H, int P, int N, int chunk,
         Strides sd) {
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

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int cl = min(chunk, S - c0);      // valid rows of this chunk
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

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int B, int S, int H, int P,
           int N, int chunk, const Strides& sd, cudaStream_t stream) {
  const int smem = smem_floats(N, chunk) * (int)sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // The shared-memory limit is raised once per device for this
  // instantiation, not on every launch: bit d of `ready` says it is done on
  // device d.
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(ssd_scan<T>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_scan<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, S, H, P, N, chunk,
      sd);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point.  dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16;
// dt and A are float32.  Strides are in elements.  Returns a cudaError_t
// (0 on success): the launch status from cudaGetLastError, or
// cudaErrorInvalidValue for a shape or dtype it does not take.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm, void* y,
                            float* state, int B, int S, int H, int P, int N,
                            int chunk, long long sxb, long long sxt,
                            long long sxh, long long sdb, long long sdt,
                            long long sdh, long long sbb, long long sbt,
                            long long scb, long long sct, int dtype,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      N % 4 != 0 || chunk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sd{sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, scb, sct};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, chunk, sd, cs);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, chunk, sd, cs);
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
