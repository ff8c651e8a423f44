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
// bf16 flops per byte.  Moving the valid rows of K and V is the bound.  No
// tensor cores: with one query token a block's product is GB x D by D x
// keys (GB <= 4 query heads of one KV head), and nothing fills the 64 rows
// of a `wgmma` tile or even the 16 of an `mma.sync`; the FMAs are far from
// the limit.
//
// What the design does about it.  The keys are split: a first kernel
// (`flash_decode_split`) has one block per (KV head and group of up to GB of
// its query heads, batch row, split of Tk keys), so the grid is sized from
// Smax on the host (never from lens: no host sync, and the launch can be
// captured in a CUDA graph) and every SM gets several blocks however the
// lens are spread.  A block whose first key is at or past lens[b] returns at
// once.  (The host picks Tk from 64, 128, 256 by shape, kernel.py::
// split_keys; 256 at the serve decode shape, where 352 of 512 blocks hold
// keys at the first tick's lens and tools/k3_splits.py timed it fastest.)
// Inside a block, D / 8 neighbouring threads share a key: each holds 8 of
// its D elements, and the partial q.k products are summed with shuffles
// inside those lanes; the 128 / (D / 8) key groups each keep a running max
// m, sum l and f32 accumulator for the GB heads, merged through shared
// memory at the end.  The split's K and V rows stream through a two-stage
// ring in shared memory filled with 16-byte `cp.async.cg` copies (no
// registers held, L1 bypassed): every thread copies exactly the 16-byte
// pieces it will read, so a thread only waits for its own copy groups
// (`cp.async.wait_group`) and no block barrier is needed in the key loop.
// Stage s + 1 (32 keys of K and V, 16 KB in bf16 at D 128) is in flight
// while stage s is consumed.  Rows past the split's valid keys are neither
// copied nor read (zeros in registers, score -inf).  Each working block
// writes its heads' unnormalised (m, l, acc[D]) in f32 to a workspace the
// wrapper allocates; a second kernel (`flash_decode_combine`, same stream)
// gives one block to each (batch row, query head), rescales the splits
// below ceil(lens[b] / Tk) to their common max, sums them and writes o in
// q's dtype (zeros where lens[b] <= 0) and, when asked, each row's f32
// log-sum-exp max + log(sum) (-inf where lens[b] <= 0), by which a caller
// that splits the cache's positions over ranks merges the ranks' rows.
// TMA was not used: a tensor-map box copies whole boxes, so the last box of
// a split would read rows past lens[b].
//
// Scores use expf (not exp2f with the scale folded into q), as the plain
// version does; the library is built without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NT = 128;          // threads per split block
constexpr float NEG_INF = -1e30f;

// Valid keys of batch row b: lens[b] clamped to [0, Sk].
__device__ __forceinline__ int valid_keys(const int* lens, int b, int Sk) {
  return min(max(lens[b], 0), Sk);
}

// 8 consecutive elements of a row, read from shared memory
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

// 8 elements (16 bytes of bf16, 32 of f32) from global to shared memory
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                 "l"(src + i * 16 / sizeof(T)) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Compile-time shape of the split kernel for element type T and head dim D.
template <typename T, int D>
struct Cfg {
  static constexpr int TPK = D / 8;                   // threads per key
  static constexpr int NG = NT / TPK;                 // key groups per block
  static constexpr int U = NG >= 32 ? 1 : 32 / NG;    // keys per group per stage
  static constexpr int SK = NG * U;                   // keys per stage
  static constexpr int NSTAGE = 2;                    // ring stages
  // one stage: SK rows of K, then SK rows of V
  static constexpr int RING_BYTES = NSTAGE * 2 * SK * D * (int)sizeof(T);
};

template <typename T, int D, int GB>
constexpr int smem_bytes() {
  constexpr int ring = Cfg<T, D>::RING_BYTES;
  constexpr int merge = Cfg<T, D>::NG * GB * (D + 2) * 4;
  return ring > merge ? ring : merge;
}

// q (B, 1, H, D); k, v (B, Sk, Kh, D); all contiguous.  lens: (B,) int32.
// grid = (Kh * ceil(G / GB), B, nsplit) with G = H / Kh and nsplit =
// ceil(Sk / Tk); Tk a multiple of the stage's SK keys.  Writes, for each of
// its heads h and split s with keys, ws_acc[((b * H + h) * nsplit + s) * D
// + d] (unnormalised) and ws_ml[2 * (...)] = (m, l).
template <typename T, int D, int GB>
__global__ void __launch_bounds__(NT)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ ws_acc,
                   float* __restrict__ ws_ml, const int* __restrict__ lens,
                   int H, int Kh, int Sk, int Tk, float sm_scale) {
  using C = Cfg<T, D>;
  constexpr int TPK = C::TPK, NG = C::NG, U = C::U, SK = C::SK;
  constexpr int NSTAGE = C::NSTAGE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);                  // [NSTAGE][2][SK][D]

  const int G = H / Kh;
  const int ngroups = (G + GB - 1) / GB;
  const int kh = blockIdx.x / ngroups;
  const int g0 = (blockIdx.x % ngroups) * GB;    // first head of the group, in G
  const int nh = min(GB, G - g0);                // heads of this block
  const int h0 = kh * G + g0;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int n = valid_keys(lens, b, Sk);
  const int k0 = split * Tk;                     // this split's first key
  if (k0 >= n) return;                           // the whole block, at once
  const int k1 = min(k0 + Tk, n);                // one past its last key
  const int nst = (k1 - k0 + SK - 1) / SK;       // stages with keys

  const int grp = threadIdx.x / TPK;
  const int c0 = (threadIdx.x % TPK) * 8;        // this thread's 8 columns
  const int64_t row = (int64_t)Kh * D;
  const T* kb = k + ((int64_t)b * Sk * Kh + kh) * D + c0;
  const T* vb = v + ((int64_t)b * Sk * Kh + kh) * D + c0;

  // Stage st of the split into ring slot st % NSTAGE: this thread's 8
  // columns of its U keys of K and of V.  Always commits a group (empty
  // past the last stage), so the group count stays uniform.
  auto issue = [&](int st) {
    if (st < nst) {
      T* sk = ring + (size_t)(st % NSTAGE) * 2 * SK * D;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = k0 + st * SK + u * NG + grp;
        if (key < k1) {
          copy8(sk + (u * NG + grp) * D + c0, kb + key * row);
          copy8(sk + (SK + u * NG + grp) * D + c0, vb + key * row);
        }
      }
    }
    commit();
  };
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) issue(st);

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

  // Every thread runs the same stages (nst is the block's), so the
  // shuffles below always have the whole warp.
  for (int st = 0; st < nst; ++st) {
    issue(st + NSTAGE - 1);          // into the slot consumed one stage ago
    wait_pending<NSTAGE - 1>();      // this thread's copies of stage st landed
    const T* sk = ring + (size_t)(st % NSTAGE) * 2 * SK * D;
    const int base = k0 + st * SK;
    Row8<T> kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * NG + grp < k1) {
        kr[u].load(sk + (u * NG + grp) * D + c0);
        vr[u].load(sk + (SK + u * NG + grp) * D + c0);
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
        s[u] = base + u * NG + grp < k1 ? part : -INFINITY;
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
  wait_pending<0>();                 // no copy may land in the merge buffers
  __syncthreads();                   // every thread is done with the ring

  // merge the key groups: rescale each to the block's max, then sum
  float* s_m = reinterpret_cast<float*>(smem);           // [NG][GB]
  float* s_l = s_m + NG * GB;                            // [NG][GB]
  float* s_acc = s_l + NG * GB;                          // [NG][GB][D]
  if (threadIdx.x % TPK == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) s_m[grp * GB + g] = m[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float mb = NEG_INF;
    for (int i = 0; i < NG; ++i) mb = fmaxf(mb, s_m[i * GB + g]);
    const float f = expf(m[g] - mb);
#pragma unroll
    for (int e = 0; e < 8; ++e) s_acc[(grp * GB + g) * D + c0 + e] = acc[g][e] * f;
    if (threadIdx.x % TPK == 0) s_l[grp * GB + g] = l[g] * f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += NT) {
    const int g = i / D, d = i % D;
    float num = 0.f;
    for (int j = 0; j < NG; ++j) num += s_acc[(j * GB + g) * D + d];
    const int64_t slot = ((int64_t)b * H + h0 + g) * nsplit + split;
    ws_acc[slot * D + d] = num;
    if (d == 0) {
      float den = 0.f, mb = NEG_INF;
      for (int j = 0; j < NG; ++j) {
        den += s_l[j * GB + g];
        mb = fmaxf(mb, s_m[j * GB + g]);
      }
      ws_ml[2 * slot] = mb;
      ws_ml[2 * slot + 1] = den;
    }
  }
}

// One block of D threads per (query head, batch row): merge the splits
// that hold keys, each rescaled to their common max, and write the row's
// log-sum-exp to lse[b * H + h] when lse is not null.  grid = (H, B).  The
// splits are read CH at a time with every load issued before any use, so a
// call costs two round trips to L2 for up to CH splits, not two per split.
constexpr int CH = 8;

template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_ml, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ lens,
                     int H, int Sk, int Tk,
                     int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int n = valid_keys(lens, b, Sk);
  const int ns = (n + Tk - 1) / Tk;              // splits with keys
  const int64_t base = ((int64_t)b * H + h) * nsplit;
  float mx = NEG_INF;
  for (int s0 = 0; s0 < ns; s0 += CH) {
    float mv[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) mv[j] = s0 + j < ns ? ws_ml[2 * (base + s0 + j)] : NEG_INF;
#pragma unroll
    for (int j = 0; j < CH; ++j) mx = fmaxf(mx, mv[j]);
  }
  float num = 0.f, den = 0.f;
  for (int s0 = 0; s0 < ns; s0 += CH) {
    float mv[CH], lv[CH], av[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const bool in = s0 + j < ns;
      const int64_t s = base + s0 + j;
      mv[j] = in ? ws_ml[2 * s] : NEG_INF;
      lv[j] = in ? ws_ml[2 * s + 1] : 0.f;
      av[j] = in ? ws_acc[s * D + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float f = expf(mv[j] - mx);
      num = fmaf(av[j], f, num);
      den = fmaf(lv[j], f, den);
    }
  }
  store(o + ((int64_t)b * H + h) * D + d, ns > 0 ? num / fmaxf(den, 1e-30f) : 0.f);
  if (lse != nullptr && d == 0)
    lse[(int64_t)b * H + h] = ns > 0 ? mx + logf(den) : -INFINITY;
}

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

template <typename T, int D, int GB>
int launch_split(const T* q, const T* k, const T* v, float* ws_acc,
                 float* ws_ml, const int* lens, int B, int H, int Kh, int Sk,
                 int Tk, int nsplit, float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, D, GB>();
  static std::atomic<uint64_t> ready{0};
  const void* fn = (const void*)flash_decode_split<T, D, GB>;
  if (int err = allow_smem(fn, smem, ready)) return err;
  const int G = H / Kh;
  const dim3 grid(Kh * ((G + GB - 1) / GB), B, nsplit);
  flash_decode_split<T, D, GB><<<grid, NT, smem, stream>>>(
      q, k, v, ws_acc, ws_ml, lens, H, Kh, Sk, Tk, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* ws, float* lse, const int* lens, int B, int H, int Kh, int Sk, int Tk,
             float sm_scale, cudaStream_t stream) {
  if (Tk <= 0 || Tk % Cfg<T, D>::SK != 0) return (int)cudaErrorInvalidValue;
  const int nsplit = (Sk + Tk - 1) / Tk;
  if (nsplit > 65535) return (int)cudaErrorInvalidValue;
  const int G = H / Kh;
  const int gb = G == 1 ? 1 : G == 2 ? 2 : 4;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  float* ws_acc = ws;
  float* ws_ml = ws + (int64_t)B * H * nsplit * D;
  int err;
  if (gb == 1)
    err = launch_split<T, D, 1>(qp, kp, vp, ws_acc, ws_ml, lens, B, H, Kh, Sk, Tk, nsplit, sm_scale, stream);
  else if (gb == 2)
    err = launch_split<T, D, 2>(qp, kp, vp, ws_acc, ws_ml, lens, B, H, Kh, Sk, Tk, nsplit, sm_scale, stream);
  else
    err = launch_split<T, D, 4>(qp, kp, vp, ws_acc, ws_ml, lens, B, H, Kh, Sk, Tk, nsplit, sm_scale, stream);
  if (err) return err;
  flash_decode_combine<T, D><<<dim3(H, B), D, 0, stream>>>(
      ws_acc, ws_ml, static_cast<T*>(o), lse, lens, H, Sk, Tk, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* ws, float* lse, const int* lens, int B, int H, int Kh, int Sk,
               int Tk, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, ws, lse, lens, B, H, Kh, Sk, Tk, sm_scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, ws, lse, lens, B, H, Kh, Sk, Tk, sm_scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, ws, lse, lens, B, H, Kh, Sk, Tk, sm_scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, ws, lse, lens, B, H, Kh, Sk, Tk, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point.  dtype: 0 = float32, 1 = bfloat16.  ws: f32 device memory
// of B * H * ceil(Sk / Tk) * (D + 2) floats (each split's acc, then the
// (m, l) pairs); lse: null, or B * H floats for each row's log-sum-exp;
// Tk: keys per split, a multiple of the kernel's keys per stage (32, or 64
// at D 16).
// Launches the split kernel and the combine kernel on `stream`.  Returns a
// cudaError_t (0 on success): the launch status from cudaGetLastError, or
// cudaErrorInvalidValue for a shape, head dim, split or dtype it does not
// take.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* o, void* ws, void* lse,
                                const int* lens, int B,
                                int H, int Kh, int Sk, int D, int dtype,
                                float sm_scale, int Tk, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sk <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, w, l, lens, B, H, Kh, Sk, Tk, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, w, l, lens, B, H, Kh, Sk, Tk, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
