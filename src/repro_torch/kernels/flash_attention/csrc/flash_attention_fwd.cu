// Flash-attention forward for Hopper (sm_90a), bf16 or f32 in, f32 softmax.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` / `_attn_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  Same function: blockwise
// attention with an online softmax whose running max m, sum l and
// accumulator acc stay in f32; GQA by reading K/V at head h / (H / Kh); a
// per-batch kv_lens mask; the top-left causal mask qpos >= kpos; KV tiles
// above the diagonal are never loaded.  A row with no valid key gives 0.
//
// What bounds it on the card.  The work is 4*B*H*D*pairs flops (pairs = the
// unmasked (query, key) pairs, about Sq*Sk/2 when causal) against
// q + k + v + o bytes.  At the serving path's causal prefill lengths
// (65..900 tokens, D = 128, bf16) that is at most ~225 flops per byte, under
// the H100's ~295 bf16 flops per byte, so moving q, k, v and o once is the
// bound, with tensor-core time close behind at the longest prompts.
//
// What the design does.  Both kernels run one thread block per (query tile
// of 64 rows, head, batch): the reference's sequential KV grid axis becomes
// a loop inside the block, and each K/V tile is read from device memory
// once per block and staged in shared memory.  Ragged Sq / Sk edges are
// masked from indices (no padded copies).
//   * bf16 (the serving path): 4 warps, 16 query rows each, products on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).  Q stays
//     in registers as A fragments for the whole loop; S = Q K^T comes out in
//     the accumulator layout, which is also the A-fragment layout of P for
//     P V, so the probabilities never touch shared memory (P is rounded to
//     bf16 for that product, as in FlashAttention-2).  Rows are padded by 8
//     elements so fragment loads hit 32 distinct banks.  Tiles are loaded
//     with 16-byte vector loads, synchronously: no cp.async / TMA double
//     buffering and no wgmma yet, which is where the rest of the gap to the
//     bound lies.
//   * f32: scalar FMAs from shared memory (tensor cores would round f32 to
//     TF32); each thread owns 4 rows x 4 keys of S and the same 4 rows x
//     D/16 output columns, with rows padded to D + 1 floats.  A correctness
//     path for float32 models: no configuration served on the card is f32,
//     and at llama2 prefill shapes it is slower than the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
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
              const int* __restrict__ kv_lens, int H, int Kh, int Sq, int Sk,
              float sm_scale, int causal) {
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
  }
}

// ------------------------------------------------------------ bf16 kernel
constexpr int NT16 = 128;       // 4 warps x 16 query rows

template <int D>
constexpr int smem_bytes_bf16() {
  return 3 * BQ * (D + 8) * (int)sizeof(__nv_bfloat16);   // Q, K, V tiles
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);    // .x (lo) in bits 0..15
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + 64) of a (rows, D) matrix with `stride` elements between
// rows, into a shared tile with row stride LD; rows >= n_rows are zeroed.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows, int64_t stride) {
  constexpr int V = D / 8;      // 16-byte vectors per row
  for (int i = threadIdx.x; i < BQ * V; i += NT16) {
    const int r = i / V, c = (i % V) * 8, pos = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < n_rows) val = *reinterpret_cast<const uint4*>(src + pos * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Fragment layout of mma m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16x8):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(NT16)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               const int* __restrict__ kv_lens, int H, int Kh, int Sq, int Sk,
               float sm_scale, int causal) {
  constexpr int LD = D + 8;     // shared row stride: fragment loads conflict-free
  constexpr int KS = D / 16;    // k-steps over the head dim for S = Q K^T
  constexpr int ND = D / 8;     // n-tiles over the head dim for O
  constexpr int NK = BK / 8;    // n-tiles over the keys of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Kh * D;
  const __nv_bfloat16* qb = q + ((int64_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * Sk * Kh + kh) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * Sk * Kh + kh) * D;
  __nv_bfloat16* ob = o + ((int64_t)b * Sq * H + h) * D;

  const int kv_len = kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<D, LD>(sQ, qb, q0, Sq, q_stride);
  __syncthreads();
  const int wr = warp * 16;     // this warp's first row in the tile
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* p = sQ + (wr + g) * LD + ks * 16 + 2 * t;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * LD);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * LD + 8);
  }
  const int row0 = q0 + wr + g, row1 = row0 + 8;   // this thread's two rows

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's part
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();            // every warp is done with the previous K / V
    load_tile<D, LD>(sK, kb, k0, Sk, kv_stride);
    load_tile<D, LD>(sV, vb, k0, Sk, kv_stride);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* p = sK + (n * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[n], qf[ks], ld32(p), ld32(p + 8));
      }
    }

    // scale, mask (-inf: exp gives exactly 0), row max over the 4 lanes of a row
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool valid = key < kv_len && (!causal || key <= row);
        s[n][e] = valid ? s[n][e] * sm_scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P V: the C fragments of key n-tiles 2j, 2j+1 are P's A fragment j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vr = sV + (j * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* p = vr + n * 8;
        mma_bf16(oacc[n], pa, pack_raw(p[0], p[LD]),
                 pack_raw(p[8 * LD], p[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + col) =
          pack_bf16(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * q_stride + col) =
          pack_bf16(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

// ---------------------------------------------------------------- launch
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_lens, int B, int H, int Kh, int Sq, int Sk,
           float sm_scale, int causal, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int smem = kBf16 ? smem_bytes_bf16<D>() : smem_bytes_f32<D>();
  const int threads = kBf16 ? NT16 : NT32;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  // The shared-memory limit is raised once per device for this instantiation,
  // not on every launch: bit d of `ready` says it is done on device d.
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    const void* fn = kBf16 ? reinterpret_cast<const void*>(flash_fwd_bf16<D>)
                           : reinterpret_cast<const void*>(flash_fwd_f32<D>);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  if constexpr (kBf16) {
    flash_fwd_bf16<D><<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        kv_lens, H, Kh, Sq, Sk, sm_scale, causal);
  } else {
    flash_fwd_f32<D><<<grid, threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), kv_lens, H, Kh,
        Sq, Sk, sm_scale, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               const int* kv_lens, int B, int H, int Kh, int Sq, int Sk,
               float sm_scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point.  dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 on success): the launch status from cudaGetLastError, or
// cudaErrorInvalidValue for a head dim or dtype the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const int* kv_lens, int B, int H,
                                   int Kh, int Sq, int Sk, int D, int dtype,
                                   float sm_scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, kv_lens, B, H, Kh, Sq, Sk, sm_scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned above, for the Python wrapper's message.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
