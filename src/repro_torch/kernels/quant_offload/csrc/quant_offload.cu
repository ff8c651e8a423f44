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
// What the design does.  One warp per row, 8 rows per block.  A row of the
// spill's K or V slot row has 128 features: each lane reads features lane,
// lane+32, ... (each warp-wide load is one coalesced 64- or 128-byte
// segment), takes |x|'s max over its features, and a shuffle-xor reduction
// gives every lane the row's max; the second pass over the row hits L1.  No
// shared memory, no atomics, nothing allocated; ragged R and F are masked
// by index (the reference pads R to whole blocks and slices the pad off).
//
// Layout.  A row's F features are contiguous; rows are grouped in `n_outer`
// runs of `rows_per_outer` contiguous rows, with `outer_stride` elements
// between runs.  A contiguous tensor is one run.  A KV slot row attn_k[:, b]
// of the (L, B, Smax, Kh, D) cache is L runs of Smax*Kh rows with an outer
// stride of B*Smax*Kh*D, so the spill quantizes it, and the restore writes
// it, in place: no contiguous copy of the 256 MiB row.  The int8 payload and
// the scales are always contiguous, (R, F) and (R,).

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
  if (dtype == 0)
    quant_rows<float><<<grid_for(rows), THREADS, 0, st>>>(
        static_cast<const float*>(x), rows, rows_per_outer, outer_stride, F, qo, so);
  else if (dtype == 1)
    quant_rows<__nv_bfloat16><<<grid_for(rows), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), rows, rows_per_outer, outer_stride, F, qo, so);
  else
    return (int)cudaErrorInvalidValue;
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
