// Row-wise symmetric int8 quantize (K2a) and dequantize (K2b) for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels `quantize_fwd` / `_quant_kernel` and
// `dequantize_fwd` / `_dequant_kernel` in
// src/repro/kernels/quant_offload/kernel.py.  Same function, row by row of
// F features:
//   quantize:   scale = max(max|x|, 1e-12) / 127      (f32, IEEE division)
//               q     = clip(round_half_even(x / scale), -127, 127)  (int8)
//   dequantize: out   = (float(q) * scale) cast to the output type
// with x and out in f32 or bf16.  The library is built without
// --use_fast_math, so `/` is the IEEE division and rintf rounds half to
// even, as jnp.round and torch.round do: the kernels agree bit for bit
// with the plain PyTorch versions in ops.py.
//
// What bounds it on the card.  A few operations per element against 3 bytes
// moved per bf16 element (x read, q written) plus 4 bytes of scale per row:
// far under the card's ~20 f32 operations per byte, so moving the bytes once
// is the bound.  At the KV spill's shape (R = 1,048,576 rows of F = 128 bf16)
// that is 388 MiB per call, 0.12 ms at 3.35 TB/s.
//
// What the design does.  K2a has two kernels; the C entry point picks one
// by layout.  `quant_vec_rows` takes every row of F * sizeof(T) bytes, a
// multiple of 16 and at most 512, whose F * sizeof(T) / 16 lanes are a power
// of two, with x and the outer stride 16-byte aligned (the KV spill's slot
// rows: F 128 in bf16 or f32).  That many lanes share a row (16 at F 128
// bf16, so a warp covers two rows per load), each lane loads 16-byte vectors
// (8 bf16 or 4 f32), and every warp issues the loads of VEC_ITERS row groups
// before any reduction, so each warp has 2 KB in flight.  The values stay in
// registers: |x|'s max is reduced with xor shuffles inside a row's lanes, and
// each lane packs its 8 (or 4) int8 into one 8- (or 4-) byte store, so a
// row's payload is written contiguously; the block's scales go through
// shared memory and out as one coalesced run.  With an IEEE quotient x /
// scale per element (a reciprocal, Newton steps, a slow-path check and a
// call) this kernel was bound by its instructions, not its bytes (PERF.md
// §6), so it multiplies by the row's IEEE reciprocal instead and takes
// the IEEE quotient only where the product lies within 2^-14 of a
// half-integer, which rounds every element as the quotient does.  The rows of a block lie in one
// run (blockIdx.y), so no row needs a 64-bit division.  Every other layout
// (F 33, F 96 in bf16, ...) takes `quant_rows`: one warp per row, 8 rows per
// block, each lane reading features lane, lane + 32, ... and the second pass
// over the row hitting L1.  K2b (`dequant_rows`) is that one-warp-per-row
// design.  No shared memory beyond the scales, no atomics, nothing
// allocated; ragged R and F are masked by index (the reference pads R to
// whole blocks and slices the pad off).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // rows per block
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int64_t row_offset(int64_t row, int64_t rows_per_outer,
                                              int64_t outer_stride, int F) {
  return (row / rows_per_outer) * outer_stride + (row % rows_per_outer) * F;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_rows(const T* __restrict__ x, int64_t rows, int64_t rows_per_outer,
           int64_t outer_stride, int F, int8_t* __restrict__ q,
           float* __restrict__ scales) {
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;               // the whole warp leaves together
  const T* xr = x + row_offset(row, rows_per_outer, outer_stride, F);
  float amax = 0.f;
  for (int c = lane; c < F; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-12f) / 127.0f;
  int8_t* qr = q + row * F;
  for (int c = lane; c < F; c += 32) {
    const float r = fminf(fmaxf(rintf(to_f32(xr[c]) / scale), -127.f), 127.f);
    qr[c] = static_cast<int8_t>(static_cast<int>(r));
  }
  if (lane == 0) scales[row] = scale;
}

// ------------------------------------------------ K2a, 16-byte vector rows
constexpr int VEC_WARPS = 8;
constexpr int VEC_ITERS = 4;             // row groups per warp, loaded at once
constexpr int VEC_THREADS = VEC_WARPS * 32;

// 16 bytes of x, as loaded: 8 bf16 or 4 f32
template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&f)[N]) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);            // low half: element 2i
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void zero() { r = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float (&f)[N]) const {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};

// N int8 (as ints in [-127, 127]) packed little-endian into one store
__device__ __forceinline__ void store_q(int8_t* p, const int (&v)[8]) {
  uint2 w;
  w.x = (v[0] & 0xff) | (v[1] & 0xff) << 8 | (v[2] & 0xff) << 16 | (uint32_t)v[3] << 24;
  w.y = (v[4] & 0xff) | (v[5] & 0xff) << 8 | (v[6] & 0xff) << 16 | (uint32_t)v[7] << 24;
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ void store_q(int8_t* p, const int (&v)[4]) {
  *reinterpret_cast<uint32_t*>(p) =
      (v[0] & 0xff) | (v[1] & 0xff) << 8 | (v[2] & 0xff) << 16 | (uint32_t)v[3] << 24;
}

// Rows of F = (1 << lpr_log2) * Vec16<T>::N features; n_outer runs of
// rows_per_outer rows.  grid = (ceil(rows_per_outer / rows per block),
// min(n_outer, 65535)); a block takes the same rows of every run
// blockIdx.y, blockIdx.y + gridDim.y, ...
template <typename T>
__global__ void __launch_bounds__(VEC_THREADS)
quant_vec_rows(const T* __restrict__ x, int64_t rows_per_outer,
               int64_t outer_stride, int64_t n_outer, int F, int lpr_log2,
               int8_t* __restrict__ q, float* __restrict__ scales) {
  constexpr int N = Vec16<T>::N;
  __shared__ float s_scale[VEC_WARPS * VEC_ITERS * 32];
  const int lpr = 1 << lpr_log2;                 // lanes per row
  const int rpw = 32 >> lpr_log2;                // rows per warp-wide load
  const int rpb = VEC_WARPS * VEC_ITERS * rpw;   // rows per block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & (lpr - 1);              // this lane's 16 bytes of a row
  const int64_t r0 = (int64_t)blockIdx.x * rpb;  // the block's first row in a run
  const int nrows = (int)min((int64_t)rpb, rows_per_outer - r0);
  for (int64_t run = blockIdx.y; run < n_outer; run += gridDim.y) {
    const T* xr = x + run * outer_stride + r0 * F + sub * N;
    const int64_t qrow0 = run * rows_per_outer + r0;
    int local[VEC_ITERS];
    Vec16<T> v[VEC_ITERS];
#pragma unroll
    for (int it = 0; it < VEC_ITERS; ++it) {
      local[it] = (warp * VEC_ITERS + it) * rpw + (lane >> lpr_log2);
      if (local[it] < nrows) v[it].load(xr + (int64_t)local[it] * F);
      else v[it].zero();
    }
#pragma unroll
    for (int it = 0; it < VEC_ITERS; ++it) {
      float f[N];
      v[it].get(f);
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) amax = fmaxf(amax, fabsf(f[e]));
      for (int off = lpr >> 1; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float scale = fmaxf(amax, 1e-12f) / 127.0f;
      const float rcp = 1.0f / scale;            // IEEE, once per row
      if (local[it] < nrows) {
        int qi[N];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          // t = x * rn(1 / scale) is within 3 * 2^-24 * 127 (< 2^-15.4) of
          // the IEEE quotient x / scale, so the two round to the same integer
          // unless t lies within 2^-14 of a half-integer; there the IEEE
          // quotient decides (tests/test_torch_quant_rcp.py proves it for
          // every bf16 x).  __fmul_rn keeps t rounded (no FMA contraction).
          const float t = __fmul_rn(f[e], rcp);
          float r = rintf(t);
          if (fabsf(fabsf(t - r) - 0.5f) <= 6.103515625e-5f) r = rintf(f[e] / scale);
          qi[e] = (int)fminf(fmaxf(r, -127.f), 127.f);
        }
        store_q(q + (qrow0 + local[it]) * F + sub * N, qi);
        if (sub == 0) s_scale[local[it]] = scale;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrows; i += VEC_THREADS) scales[qrow0 + i] = s_scale[i];
    __syncthreads();                             // s_scale is reused by the next run
  }
}

// log2 of the lanes per row when x's layout takes quant_vec_rows, else -1.
int vec_lanes_log2(const void* x, int esize, long long outer_stride, int F) {
  const long long bytes = (long long)F * esize;
  if (bytes % 16 != 0 || bytes > 512) return -1;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || (outer_stride * esize) % 16 != 0)
    return -1;
  const int lanes = (int)(bytes / 16);
  if (lanes & (lanes - 1)) return -1;           // xor shuffles need a power of two
  int lg = 0;
  while ((1 << lg) < lanes) ++lg;
  return lg;
}

template <typename T>
void launch_vec(const void* x, long long rows, long long rows_per_outer,
                long long outer_stride, int F, int lg, int8_t* q, float* s,
                cudaStream_t st) {
  const long long rpb = (long long)VEC_WARPS * VEC_ITERS * (32 >> lg);
  const long long n_outer = rows / rows_per_outer;
  const dim3 grid((unsigned)((rows_per_outer + rpb - 1) / rpb),
                  (unsigned)(n_outer < 65535 ? n_outer : 65535));
  quant_vec_rows<T><<<grid, VEC_THREADS, 0, st>>>(
      static_cast<const T*>(x), rows_per_outer, outer_stride, n_outer, F, lg, q, s);
}

// ------------------------------------------------------------------- K2b
template <typename T>
__global__ void __launch_bounds__(THREADS)
dequant_rows(const int8_t* __restrict__ q, const float* __restrict__ scales,
             int64_t rows, int64_t rows_per_outer, int64_t outer_stride, int F,
             T* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float s = scales[row];
  const int8_t* qr = q + row * F;
  T* orow = out + row_offset(row, rows_per_outer, outer_stride, F);
  for (int c = lane; c < F; c += 32) store(orow + c, static_cast<float>(qr[c]) * s);
}

bool bad_layout(long long rows, long long rows_per_outer, long long outer_stride, int F) {
  return rows <= 0 || rows_per_outer <= 0 || F <= 0 || rows % rows_per_outer != 0 ||
         outer_stride < rows_per_outer * (long long)F;
}

dim3 grid_for(long long rows) { return dim3((unsigned)((rows + WARPS - 1) / WARPS)); }

}  // namespace

// C entry points.  dtype: 0 = float32, 1 = bfloat16 (of x, or of out).
// Each launches on `stream` and returns a cudaError_t (0 on success): the
// launch status from cudaGetLastError, or cudaErrorInvalidValue for a
// layout or dtype the kernels do not take.
extern "C" int quantize_rows(const void* x, int dtype, long long rows,
                             long long rows_per_outer, long long outer_stride,
                             int F, void* q, void* scales, void* stream) {
  if (bad_layout(rows, rows_per_outer, outer_stride, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int lg = vec_lanes_log2(x, dtype == 0 ? 4 : 2, outer_stride, F);
  if (lg >= 0 && dtype == 0)
    launch_vec<float>(x, rows, rows_per_outer, outer_stride, F, lg, qo, so, st);
  else if (lg >= 0)
    launch_vec<__nv_bfloat16>(x, rows, rows_per_outer, outer_stride, F, lg, qo, so, st);
  else if (dtype == 0)
    quant_rows<float><<<grid_for(rows), THREADS, 0, st>>>(
        static_cast<const float*>(x), rows, rows_per_outer, outer_stride, F, qo, so);
  else
    quant_rows<__nv_bfloat16><<<grid_for(rows), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), rows, rows_per_outer, outer_stride, F, qo, so);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_rows(const void* q, const void* scales, int dtype,
                               long long rows, long long rows_per_outer,
                               long long outer_stride, int F, void* out,
                               void* stream) {
  if (bad_layout(rows, rows_per_outer, outer_stride, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* si = static_cast<const float*>(scales);
  if (dtype == 0)
    dequant_rows<float><<<grid_for(rows), THREADS, 0, st>>>(
        qi, si, rows, rows_per_outer, outer_stride, F, static_cast<float*>(out));
  else if (dtype == 1)
    dequant_rows<__nv_bfloat16><<<grid_for(rows), THREADS, 0, st>>>(
        qi, si, rows, rows_per_outer, outer_stride, F, static_cast<__nv_bfloat16*>(out));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
