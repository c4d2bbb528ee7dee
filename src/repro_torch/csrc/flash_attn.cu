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
// NEG_INF is -1e30, not -inf, as in the Pallas kernel, so the masked
// arithmetic is the same: a masked score gives exp(-1e30 - m) = 0. Every
// row sees key 0 (the wrapper requires Skv >= Sq when causal), and tiles
// are walked from kv tile 0, so no row's running max stays at NEG_INF past
// its first tile.
//
// Design: the TPU grid walks the kv axis in order and carries m, l and acc
// in VMEM scratch between grid steps. Here one block of 256 threads owns a
// (b, h, 64-row q tile) and loops over the 64-key kv tiles itself, from
// tile 0 to the last one the causal diagonal reaches (the tile holding key
// q0 + 63 + Skv - Sq), so tiles above the diagonal are never visited. The
// q tiles are issued in reverse order, so the longest rows start first.
// Q, K and V tiles are staged in shared memory as f32 with 16-byte loads
// (coalesced: a tile row is D contiguous elements); thread (ty, tx) of a
// 16 x 16 grid holds rows ty + 16a and key columns tx + 16c of the score
// tile (a, c < 4) and output columns tx + 16e, so a row's max and sum are
// shuffles within a half warp. Q and K rows are padded to D + 4 floats and
// read as float4 along D; P rows to 68 floats. f32 and bf16 both run on the
// CUDA cores with f32 products and sums: f32 through TF32 tensor cores
// would not meet the 2e-5 tolerance, and a bf16 mma.sync / wgmma path is
// later work.
//
// What bounds it on an H100: operations. At hymba-1.5b's prefill (B 4,
// S 4096, H 25, K 5, D 64, bf16) the exact causal work is ~2.1e11 FLOP per
// layer against ~126 MB of q, k, v and out: 0.22 ms at the 989 TFLOP/s
// bf16 tensor-core rate, 0.04 ms at 3.35 TB/s. This kernel does the
// products at the f32 CUDA-core rate (67 TFLOP/s peak) and is held back
// further by shared-memory traffic, so it sits well above that bound; the
// tensor-core path is what closes the gap.

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int sq,
                  int skv, int h, int kh, int causal, float scale) {
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
    T* o = out + (static_cast<int64_t>(bi) * sq + row) * q_stride
           + static_cast<int64_t>(hi) * D;
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      o[tx + 16 * e] = Num<T>::from_f32(acc[a][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int kh, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kSmem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, h, kh, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int d, const void* q, const void* k, const void* v, void* out,
               int b, int sq, int skv, int h, int kh, int causal, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, b, sq, skv, h, kh, causal, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, b, sq, skv, h, kh, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, sq, skv, h, kh, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, sq, skv, h, kh, causal, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches forward attention on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take). q and out
// are (b, sq, h, d), k and v (b, skv, kh, d), all contiguous, 16-byte
// aligned device memory of one type: dtype 0 is f32, 1 is bf16. d is 16, 32,
// 64 or 128; h is a multiple of kh; causal needs skv >= sq.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int b, int sq, int skv, int h,
                                 int kh, int d, int causal, float scale,
                                 int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kh <= 0 || h % kh != 0 ||
      b > 65535 || h > 65535 || (causal && skv < sq) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, out, b, sq, skv, h, kh, causal,
                             scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, out, b, sq, skv, h, kh,
                                     causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
