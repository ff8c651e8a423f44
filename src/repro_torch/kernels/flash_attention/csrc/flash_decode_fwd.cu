// Flash-decode for Hopper (sm_90a): one query token against a KV cache.
//
// Replaces the Pallas TPU kernel `flash_decode_fwd` / `_decode_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: GQA attention
// of q (B, 1, H, D) over the first lens[b] rows of k / v, with a running
// (m, l, acc) merge in f32 and the output in q's dtype.  Query head h reads
// KV head h / (H / Kh).  Rows at or past lens[b] are never read.  A batch
// row with lens[b] <= 0 gives zeros (the reference kernel gives the mean of
// its zero-padded V blocks there, which depends on its padding; decode
// always passes pos + 1 >= 1).
//
// What bounds it on the card.  It reads each valid K and V row once: 4 * D
// bytes per row and KV head in bf16, against 4 * D flops per row and query
// head, so at most 2 * (H / Kh) flops per byte: far below the H100's ~295
// bf16 flops per byte.  Moving the valid rows of K and V is the bound.
//
// What the design does.  One block of 256 threads per (KV head, batch row,
// group of up to GB query heads of that KV head), so K and V are read from
// device memory once for the whole group.  D / 8 neighbouring threads share
// a key: each holds 8 of its D elements, loaded as one 16-byte vector (bf16)
// or two (f32), and the partial q.k products are summed with shuffles inside
// those lanes.  The 256 / (D / 8) key groups walk the valid rows U keys at a
// time with their loads issued before any use, so about 32 KB per block are
// in flight.  Each key group keeps its own running max m, sum l and
// accumulator for its GB heads; at the end the groups are merged through
// shared memory (rescaled to the block's max) and the block writes the
// GB output rows.  The lens are read on the device: no host sync per layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int U = 4;             // keys per key group per iteration
constexpr float NEG_INF = -1e30f;

// 8 consecutive elements of a row, as loaded
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);            // low half: element 2i
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// q, o: (B, 1, H, D); k, v: (B, Sk, Kh, D); all contiguous.  lens: (B,)
// int32.  grid = (Kh, B, ceil(G / GB)) with G = H / Kh.
template <typename T, int D, int GB>
__global__ void __launch_bounds__(NT)
flash_decode(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int* __restrict__ lens, int H, int Kh, int Sk,
             float sm_scale) {
  constexpr int TPK = D / 8;     // threads per key
  constexpr int NG = NT / TPK;   // key groups per block
  __shared__ float s_m[NG][GB];
  __shared__ float s_l[NG][GB];
  __shared__ float s_acc[NG][GB][D];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Kh;
  const int g0 = blockIdx.z * GB;            // first head of the group, in G
  const int nh = min(GB, G - g0);            // heads of this block
  const int h0 = kh * G + g0;
  const int grp = threadIdx.x / TPK;
  const int c0 = (threadIdx.x % TPK) * 8;    // this thread's 8 columns
  const int n = min(max(lens[b], 0), Sk);

  float qf[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    Row8<T> r;
    if (g < nh) r.load(q + ((int64_t)b * H + h0 + g) * D + c0);
    else r.zero();
    r.get(qf[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] *= sm_scale;
  }

  float m[GB], l[GB], acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const int64_t row = (int64_t)Kh * D;
  const T* kb = k + ((int64_t)b * Sk * Kh + kh) * D + c0;
  const T* vb = v + ((int64_t)b * Sk * Kh + kh) * D + c0;

  // Every thread runs the same number of iterations (n is the block's), so
  // the shuffles below always have the whole warp.
  for (int base = 0; base < n; base += NG * U) {
    Row8<T> kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = base + u * NG + grp;
      if (key < n) {
        kr[u].load(kb + key * row);
        vr[u].load(vb + key * row);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        kr[u].get(kf);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qf[g][e], kf[e], part);
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[u] = base + u * NG + grp < n ? part : -INFINITY;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u]);
      const float alpha = expf(m[g] - mx);
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - mx);     // masked keys: exp(-inf) = 0
        float vf[8];
        vr[u].get(vf);
        ps += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
      l[g] = l[g] * alpha + ps;
      m[g] = mx;
    }
  }

  // merge the key groups: rescale each to the block's max, then sum
  if (threadIdx.x % TPK == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) s_m[grp][g] = m[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float mb = NEG_INF;
    for (int i = 0; i < NG; ++i) mb = fmaxf(mb, s_m[i][g]);
    const float f = expf(m[g] - mb);
#pragma unroll
    for (int e = 0; e < 8; ++e) s_acc[grp][g][c0 + e] = acc[g][e] * f;
    if (threadIdx.x % TPK == 0) s_l[grp][g] = l[g] * f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += NT) {
    const int g = i / D, d = i % D;
    float num = 0.f, den = 0.f;
    for (int j = 0; j < NG; ++j) {
      num += s_acc[j][g][d];
      den += s_l[j][g];
    }
    store(o + ((int64_t)b * H + h0 + g) * D + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const int* lens, int B, int H, int Kh, int Sk, float sm_scale,
             cudaStream_t stream) {
  const int G = H / Kh;
  const int gb = G == 1 ? 1 : G == 2 ? 2 : 4;
  const dim3 grid(Kh, B, (G + gb - 1) / gb);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (gb == 1)
    flash_decode<T, D, 1><<<grid, NT, 0, stream>>>(qp, kp, vp, op, lens, H, Kh, Sk, sm_scale);
  else if (gb == 2)
    flash_decode<T, D, 2><<<grid, NT, 0, stream>>>(qp, kp, vp, op, lens, H, Kh, Sk, sm_scale);
  else
    flash_decode<T, D, 4><<<grid, NT, 0, stream>>>(qp, kp, vp, op, lens, H, Kh, Sk, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               const int* lens, int B, int H, int Kh, int Sk, float sm_scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, lens, B, H, Kh, Sk, sm_scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, lens, B, H, Kh, Sk, sm_scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, lens, B, H, Kh, Sk, sm_scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, lens, B, H, Kh, Sk, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point.  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 on success): the launch status from cudaGetLastError, or
// cudaErrorInvalidValue for a shape, head dim or dtype it does not take.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* o, const int* lens, int B, int H, int Kh,
                                int Sk, int D, int dtype, float sm_scale,
                                void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sk <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lens, B, H, Kh, Sk, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lens, B, H, Kh, Sk, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
