// Forward GQA flash attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py ::
// flash_attention_pallas (body _attn_kernel). For q (B, Sq, H, D) and k, v
// (B, Skv, K, D), query head h reading kv head h / (H / K):
//
//   s   = (q . k^T) * scale           scale = 1 / sqrt(D), in f32
//   s   = NEG_INF where causal and kpos > qpos + (Skv - Sq), or kpos >= Skv
//   online softmax over kv tiles: m, l and acc (f32) as the Pallas kernel
//   keeps them in VMEM; p = exp(s - m) is rounded to v's type before p . v
//   out = acc / max(l, 1e-30), rounded to q's type
//
// Both kernels can also write each row's log-sum-exp, lse = m + log(l), as
// f32 into a (B, H, Sq) array (null: not written). The gradient's kernels
// (flash_attn_bwd.cu) recompute p = exp(s - lse) from it; the serving path
// passes null and runs as before.
//
// NEG_INF is -1e30, not -inf, as in the Pallas kernel, so the masked
// arithmetic is the same: a masked score gives exp(-1e30 - m) = 0. Every
// row sees key 0 (the wrapper requires Skv >= Sq when causal), and tiles
// are walked from kv tile 0, so no row's running max stays at NEG_INF past
// its first tile.
//
// Two kernels, chosen by dtype in the wrapper (kernels/flash_attn/kernel.py):
//
// bf16: flash_attn_mma_kernel, on the tensor cores. What bounds it on an
// H100: operations. At hymba-1.5b's prefill (B 4, S 4096, H 25, K 5, D 64)
// the exact causal work is ~2.15e11 FLOP per layer against ~126 MB of q, k,
// v and out: 0.217 ms at the 989 TFLOP/s bf16 tensor-core rate, 0.04 ms at
// 3.35 TB/s. Both products run as mma.sync m16n8k16 (bf16 in, f32
// accumulate). A block of 4 warps owns a (b, h, q tile) and walks the
// 64-key kv tiles from tile 0 to the last one the causal diagonal reaches
// (q tiles issued in reverse, longest rows first). A warp owns 16 query rows
// per m-tile: two m-tiles (a 128-row q tile) at D <= 64, so each K and V
// fragment read from shared memory feeds two products -- the ldmatrix
// traffic, not the tensor cores, is what one m-tile runs out of -- and one
// at D = 128 and 160, where two would spill registers. At D = 160
// (stablelm-12b) the output fragment is 20 n-tiles (80 f32 registers a
// thread) and the shared tiles (64 + 4 x 64 rows of 168 bf16) 107 520
// bytes; the CUDA-core kernel's tiles at D = 160 take 142 336 bytes. Q, K
// and V stay bf16 in shared memory, rows padded by 16 bytes (at D = 160 a
// row is 336 bytes, 84 words: 8 rows still start in 8 different bank
// quads) so that every ldmatrix (x4 for Q
// and K, x4.trans for V) reads 8 rows in 8 different bank quads; K and V
// tiles are double-buffered with 16-byte cp.async, so tile j + 1 loads while
// tile j is computed. Q's fragments stay in registers for the whole kv loop.
// The online softmax runs on the score fragments in registers: scaled in
// f32, masked only on tiles that cross the diagonal or the kv tail, row max
// and row sum by quad shuffles, l summing the unrounded f32 p; p is then
// rounded to bf16 and fed straight from the accumulator registers as the A
// operand of p . v -- P never goes through shared memory. A warp whose rows
// lie wholly below a tile's keys skips the tile (its scores would all be
// NEG_INF: p = 0, correction 1). exp(x) is 2^(x log2 e): one FMA and one
// MUFU ex2 with results below 2^-126 flushed to zero, which moves no row
// sum (>= 1) and no bf16 product.
//
// f32: flash_attn_kernel, on the CUDA cores with f32 products and sums (TF32
// tensor cores would not meet the 2e-5 tolerance), bound by the same
// operations at the 67 TFLOP/s f32 rate. One block of 256 threads owns a
// (b, h, 64-row q tile); Q, K and V tiles are staged in shared memory as
// f32 with 16-byte loads; thread (ty, tx) of a 16 x 16 grid holds rows
// ty + 16a and key columns tx + 16c of the score tile (a, c < 4) and output
// columns tx + 16e, so a row's max and sum are shuffles within a half warp.
// Q and K rows are padded to D + 4 floats and read as float4 along D; P
// rows to 68 floats. At D = 160 it is launched as flash_attn_kernel_wide,
// the same body compiled for one block an SM, so that its 40 accumulators
// a thread fit in registers. It also takes bf16 (widened to f32 in shared
// memory): the wrapper runs it so only when asked by name, as the
// yardstick the tensor-core kernel is timed against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kLdP = kBK + 4;    // padded row of the P tile (floats)
constexpr float kNegInf = -1e30f;

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float to_f32(float v) { return v; }
  __device__ static float from_f32(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Rows [row0, row0 + 64) of a (rows, D) slab whose rows are `stride`
// elements apart, into shared memory as f32 with `ld` floats per row; rows
// at or past `n_rows` are zeros. 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int row0,
                                          int n_rows, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = tid; idx < 64 * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    float* out = dst + r * ld + c;
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (row0 + r) * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = Num<T>::to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = 0.0f;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * kLdP;
}

// One (b, h, 64-row q tile) of the CUDA-core kernel, the body of both of
// its entry points below.
template <typename T, int D>
__device__ __forceinline__ void flash_attn_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int sq, int skv, int h, int kh, int causal, float scale) {
  constexpr int kLdQ = D + 4;
  constexpr int kLdK = D + 4;
  constexpr int kCols = D / 16;              // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * kLdQ;
  float* sV = sK + kBK * kLdK;
  float* sP = sV + kBK * D;

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int khi = hi / (h / kh);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int offset = skv - sq;
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kh) * D;
  const T* qb = q + (static_cast<int64_t>(bi) * sq * h + hi) * D;
  const T* kb = k + (static_cast<int64_t>(bi) * skv * kh + khi) * D;
  const T* vb = v + (static_cast<int64_t>(bi) * skv * kh + khi) * D;

  load_tile<T, D>(sQ, kLdQ, qb, q_stride, q0, sq, tid);

  int last = (skv + kBK - 1) / kBK - 1;
  if (causal) last = min(last, (q0 + kBQ - 1 + offset) / kBK);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.0f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[a][e] = 0.0f;
  }

  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kBK;
    __syncthreads();            // the previous tile's K, V and P are read
    load_tile<T, D>(sK, kLdK, kb, kv_stride, k0, skv, tid);
    load_tile<T, D>(sV, D, vb, kv_stride, k0, skv, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * a) * kLdQ
                                                 + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * kLdK
                                                 + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qv[a].x, kv[c].x, s[a][c]);
          s[a][c] = fmaf(qv[a].y, kv[c].y, s[a][c]);
          s[a][c] = fmaf(qv[a].z, kv[c].z, s[a][c]);
          s[a][c] = fmaf(qv[a].w, kv[c].w, s[a][c]);
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a + offset;
      float row_max = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = s[a][c] * scale;
        if ((causal && kpos > qpos) || kpos >= skv) x = kNegInf;
        s[a][c] = x;
        row_max = fmaxf(row_max, x);
      }
      const float m_new = fmaxf(m[a], half_warp_max(row_max));
      const float corr = expf(m[a] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        row_sum += p;
        sP[(ty + 16 * a) * kLdP + tx + 16 * c] = Num<T>::round(p);
      }
      l[a] = l[a] * corr + half_warp_sum(row_sum);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[a][e] *= corr;
    }
    __syncthreads();            // P complete

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pv[a] = *reinterpret_cast<const float4*>(sP + (ty + 16 * a) * kLdP
                                                 + c);
      float vv[4][kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          vv[i][e] = sV[(c + i) * D + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          acc[a][e] = fmaf(pv[a].x, vv[0][e], acc[a][e]);
          acc[a][e] = fmaf(pv[a].y, vv[1][e], acc[a][e]);
          acc[a][e] = fmaf(pv[a].z, vv[2][e], acc[a][e]);
          acc[a][e] = fmaf(pv[a].w, vv[3][e], acc[a][e]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sq) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(bi) * h + hi) * sq + row] =
          m[a] + logf(denom);
    T* o = out + (static_cast<int64_t>(bi) * sq + row) * q_stride
           + static_cast<int64_t>(hi) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      o[tx + 16 * e] = Num<T>::from_f32(acc[a][e] / denom);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, int sq, int skv, int h, int kh,
                  int causal, float scale) {
  flash_attn_block<T, D>(q, k, v, out, lse, sq, skv, h, kh, causal, scale);
}

// D = 160: the tiles take 142 336 bytes, so one block fits an SM, and it is
// compiled for one (the bound's second argument) and may use 255 registers
// a thread; left to choose, ptxas kept the narrower widths' 128 and spilled.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int sq, int skv, int h, int kh,
                       int causal, float scale) {
  flash_attn_block<T, D>(q, k, v, out, lse, sq, skv, h, kh, causal, scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int b, int sq, int skv, int h, int kh, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kSmem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = [] {
    if constexpr (D > 128) return flash_attn_kernel_wide<T, D>;
    else return flash_attn_kernel<T, D>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, skv, h, kh,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int d, const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int sq, int skv, int h, int kh, int causal,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                            scale, stream);
    case 160:
      return launch<T, 160>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaBK = 64;             // keys per kv tile
constexpr int kWarps = 4;              // warps per block
// 16-row m-tiles per warp: two share each K and V fragment, halving the
// shared-memory reads per product; at D >= 128 two would spill registers.
template <int D>
constexpr int kMTiles = D <= 64 ? 2 : 1;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// c += a . b for one 16 x 8 x 16 tile: bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + ROWS) of a (rows, D) bf16 slab whose rows are `stride`
// elements apart, into shared memory rows of D + 8 elements; rows at or past
// n_rows are zeros. 16-byte cp.async, not waited for.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t stride, int row0,
                                                int n_rows, int tid) {
  constexpr int kPerRow = D / 8;
  constexpr int kPieces = ROWS * kPerRow;
#pragma unroll
  for (int it = 0; it < (kPieces + NT - 1) / NT; ++it) {
    const int idx = tid + it * NT;
    if (kPieces % NT != 0 && idx >= kPieces) break;
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async_16(dst + r * (D + 8) + c,
                ok ? src + (row0 + r) * stride + c : src, ok);
  }
}

// 2^x for x <= 0, flushing results below 2^-126 to zero: a p that small
// adds nothing to a row sum of at least 1 or to p . v in bf16.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
constexpr int mma_smem_bytes() {
  return (16 * kMTiles<D> * kWarps + 4 * kMmaBK) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int sq, int skv, int h, int kh,
                      int causal, float scale) {
  constexpr int kM = kMTiles<D>;
  constexpr int kRows = 16 * kM;         // q rows per warp
  constexpr int kBQ = kRows * kWarps;
  constexpr int kNT = 32 * kWarps;
  constexpr int kLd = D + 8;             // shared row, bf16 elements
  constexpr int kKSteps = D / 16;        // k-steps of q . k^T
  constexpr int kDTiles = D / 8;         // n-tiles of the output
  constexpr int kSTiles = kMmaBK / 8;    // n-tiles of the scores
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* sK = sQ + kBQ * kLd;          // two stages
  __nv_bfloat16* sV = sK + 2 * kMmaBK * kLd;   // two stages

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int khi = hi / (h / kh);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                // fragment row (and row + 8)
  const int t = lane % 4;                // fragment column pair
  const int offset = skv - sq;
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kh) * D;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(bi) * sq * h + hi) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<int64_t>(bi) * skv * kh + khi) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<int64_t>(bi) * skv * kh + khi) * D;
  const int wq0 = q0 + warp * kRows;     // the warp's first row

  int last = (skv + kMmaBK - 1) / kMmaBK - 1;
  if (causal) last = min(last, (q0 + kBQ - 1 + offset) / kMmaBK);

  load_tile_async<D, kBQ, kNT>(sQ, qb, q_stride, q0, sq, tid);
  load_tile_async<D, kMmaBK, kNT>(sK, kb, kv_stride, 0, skv, tid);
  load_tile_async<D, kMmaBK, kNT>(sV, vb, kv_stride, 0, skv, tid);
  cp_async_commit();

  // per m-tile i: rows wq0 + 16 i + g (r = 0) and + 8 (r = 1)
  uint32_t qf[kM][kKSteps][4];
  float o[kM][kDTiles][4];
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.0f;
    }
  }

  for (int j = 0; j <= last; ++j) {
    const int st = j & 1;
    if (j < last) {
      const int k1 = (j + 1) * kMmaBK;
      load_tile_async<D, kMmaBK, kNT>(sK + (st ^ 1) * kMmaBK * kLd, kb,
                                      kv_stride, k1, skv, tid);
      load_tile_async<D, kMmaBK, kNT>(sV + (st ^ 1) * kMmaBK * kLd, vb,
                                      kv_stride, k1, skv, tid);
      cp_async_commit();
      cp_async_wait<1>();                // tile j (and Q) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
          ldsm_x4(qf[i][kk], sQ + (warp * kRows + 16 * i + lane % 16) * kLd
                                 + kk * 16 + (lane / 16) * 8);
    }
    const int k0 = j * kMmaBK;
    const __nv_bfloat16* tK = sK + st * kMmaBK * kLd;
    const __nv_bfloat16* tV = sV + st * kMmaBK * kLd;
    if (!causal || k0 <= wq0 + kRows - 1 + offset) {
      // s = q . k^T, each K fragment shared by the warp's m-tiles
      float s[kM][kSTiles][4];
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kSTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, tK + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd
                         + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
          for (int i = 0; i < kM; ++i) {
            mma_bf16(s[i][2 * np], qf[i][kk], b[0], b[1]);
            mma_bf16(s[i][2 * np + 1], qf[i][kk], b[2], b[3]);
          }
        }
      // scale, in f32; mask only where the tile crosses the diagonal or
      // the kv tail
      const bool edge = k0 + kMmaBK > skv
                        || (causal && k0 + kMmaBK - 1 > wq0 + offset);
      uint32_t pa[kM][kSTiles / 2][4];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        float mx[2] = {m[i][0], m[i][1]};
#pragma unroll
        for (int n = 0; n < kSTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[i][n][e] * scale;
            if (edge) {
              const int kpos = k0 + n * 8 + 2 * t + (e & 1);
              const int qpos = wq0 + 16 * i + g + (e >> 1) * 8 + offset;
              if ((causal && kpos > qpos) || kpos >= skv) x = kNegInf;
            }
            s[i][n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2], mb[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2_ftz((m[i][r] - mx[r]) * kLog2e);
          mb[r] = mx[r] * kLog2e;
          m[i][r] = mx[r];
        }
        // p = exp(s - m) in f32 for l; rounded to bf16 as p . v's A operand
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2_ftz(fmaf(s[i][n][e], kLog2e, -mb[e >> 1]));
            rs[e >> 1] += p[e];
          }
          pa[i][n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
          pa[i][n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          l[i][r] = l[i][r] * corr[r] + rs[r];
        }
#pragma unroll
        for (int n = 0; n < kDTiles; ++n) {
          o[i][n][0] *= corr[0];
          o[i][n][1] *= corr[0];
          o[i][n][2] *= corr[1];
          o[i][n][3] *= corr[1];
        }
      }
      // acc += p . v, each V fragment shared by the warp's m-tiles
#pragma unroll
      for (int kk = 0; kk < kSTiles / 2; ++kk)
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, tV + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                    * kLd + dp * 16 + (lane / 16) * 8);
#pragma unroll
          for (int i = 0; i < kM; ++i) {
            mma_bf16(o[i][2 * dp], pa[i][kk], b[0], b[1]);
            mma_bf16(o[i][2 * dp + 1], pa[i][kk], b[2], b[3]);
          }
        }
    }
    __syncthreads();            // stage st is read before it is refilled
  }

#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + 16 * i + g + 8 * r;
      if (row >= sq) continue;
      const float denom = fmaxf(l[i][r], 1e-30f);
      if (lse != nullptr && t == 0)
        lse[(static_cast<int64_t>(bi) * h + hi) * sq + row] =
            m[i][r] + logf(denom);
      __nv_bfloat16* orow = out + (static_cast<int64_t>(bi) * sq + row)
                            * q_stride + static_cast<int64_t>(hi) * D;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_bf16(o[i][n][2 * r] / denom, o[i][n][2 * r + 1] / denom);
    }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int sq, int skv, int h, int kh, int causal,
               float scale, cudaStream_t stream) {
  constexpr int kSmem = mma_smem_bytes<D>();
  auto kernel = flash_attn_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBQ = 16 * kMTiles<D> * kWarps;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, 32 * kWarps, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, sq, skv, h, kh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_dim(int d, const void* q, const void* k, const void* v,
                   void* out, float* lse, int b, int sq, int skv, int h,
                   int kh, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_mma<16>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                            scale, stream);
    case 32:
      return launch_mma<32>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                            scale, stream);
    case 64:
      return launch_mma<64>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                            scale, stream);
    case 128:
      return launch_mma<128>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                             scale, stream);
    case 160:
      return launch_mma<160>(q, k, v, out, lse, b, sq, skv, h, kh, causal,
                             scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_args(const void* q, const void* k, const void* v, const void* out,
                int b, int sq, int skv, int h, int kh, int causal) {
  return !(b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kh <= 0
           || h % kh != 0 || b > 65535 || h > 65535 || (causal && skv < sq)
           || !aligned16(q) || !aligned16(k) || !aligned16(v)
           || !aligned16(out));
}

}  // namespace

// Launches forward attention on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take). q and out
// are (b, sq, h, d), k and v (b, skv, kh, d), all contiguous, 16-byte
// aligned device memory of one type: dtype 0 is f32, 1 is bf16. d is 16, 32,
// 64, 128 or 160; h is a multiple of kh; causal needs skv >= sq.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int b, int sq, int skv, int h,
                                 int kh, int d, int causal, float scale,
                                 int dtype, void* stream) {
  if (!valid_args(q, k, v, out, b, sq, skv, h, kh, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, out, nullptr, b, sq, skv, h, kh,
                             causal, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, out, nullptr, b, sq, skv, h,
                                     kh, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same, also writing each row's log-sum-exp into lse, (b, h, sq) f32
// device memory: the forward of a call that autograd will differentiate.
extern "C" int flash_attn_lse_launch(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int b, int sq, int skv, int h, int kh,
                                     int d, int causal, float scale,
                                     int dtype, void* stream) {
  if (!valid_args(q, k, v, out, b, sq, skv, h, kh, causal) || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, out, l, b, sq, skv, h, kh, causal,
                             scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, out, l, b, sq, skv, h, kh,
                                     causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: the same arguments and checks, bf16 only.
extern "C" int flash_attn_mma_launch(const void* q, const void* k,
                                     const void* v, void* out, int b, int sq,
                                     int skv, int h, int kh, int d,
                                     int causal, float scale, void* stream) {
  if (!valid_args(q, k, v, out, b, sq, skv, h, kh, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma_dim(d, q, k, v, out, nullptr, b, sq, skv, h, kh, causal,
                        scale, static_cast<cudaStream_t>(stream));
}

// The tensor-core kernel writing lse too.
extern "C" int flash_attn_mma_lse_launch(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int b, int sq, int skv, int h,
                                         int kh, int d, int causal,
                                         float scale, void* stream) {
  if (!valid_args(q, k, v, out, b, sq, skv, h, kh, causal) || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma_dim(d, q, k, v, out, static_cast<float*>(lse), b, sq,
                        skv, h, kh, causal, scale,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
