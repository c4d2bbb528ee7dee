// Backward of the GQA flash attention of flash_attn.cu, for Hopper (sm_90a).
//
// Replaces what the JAX package differentiates with XLA's autodiff: the
// reference trains through src/repro/models/attention.py ::
// _blockwise_attention (and _full_attention), plain jnp that jax.grad
// differentiates; its Pallas kernel (src/repro/kernels/flash_attn/kernel.py
// :: flash_attention_pallas) has no custom_vjp. This is the gradient of
// exactly the function flash_attn.cu computes. For q (B, Sq, H, D), k, v
// (B, Skv, K, D), query head h reading kv head h / (H / K), scale
// 1 / sqrt(D) in f32, the right-aligned causal mask (kpos > qpos + Skv - Sq)
// or none, and the kv tail masked at kpos >= Skv, given the forward's output
// o, its row log-sum-exp lse (B, H, Sq) f32 and the output's gradient dO:
//
//   Dv  = rowsum(dO * o)                          (prep kernel, f32)
//   P   = exp(s * scale - lse), 0 where masked    (recomputed, never stored)
//   dV  = sum over the group's heads of P~^T . dO  (P~: p rounded to v's
//         type, as the forward rounds p before p . v)
//   dP  = dO . V^T
//   dS  = P * (dP - Dv)
//   dK  = scale * sum over the group's heads of dS^T . Q
//   dQ  = scale * dS . K
//
// all sums in f32; results rounded to the inputs' type. Two kernels after
// the prep: flash_attn_bwd_dkdv_kernel, one block per (b, kv head, 64-key
// tile), walks the H / K query heads of its group and their 64-row q tiles
// (from the first the causal diagonal reaches) and keeps dK and dV of its
// keys in registers; flash_attn_bwd_dq_kernel, one block per (b, h, 64-row
// q tile), walks the kv tiles up to the diagonal and keeps dQ in registers.
// No atomics: every output element is written once, by one thread, after
// sums taken in a fixed order, so the gradient is the same from run to run.
//
// What bounds it on an H100: operations. The five products are 2 D FLOP
// each per unmasked (q, k) pair, 10 D in all: at qwen3-0.6b's training shape
// (B 4, S 4 096, H 16, K 8, D 128, causal) ~6.9e11 FLOP a layer, 0.69 ms at
// the 989 TFLOP/s bf16 tensor-core rate. This first kernel runs on the CUDA
// cores, in f32 for both dtypes (bf16 is widened to f32 in shared memory),
// so its own ceiling is the 67 TFLOP/s f32 rate: the tensor cores are the
// next step. Each block holds four (64, D + 4) f32 tiles (Q, dO, K, V; rows
// padded by 4 floats and read as float4 along D) and two (64, 68) tiles (P~
// and dS) in shared memory, 203 264 bytes at D = 160; 256 threads as a 16 x
// 16 grid, thread (ty, tx) holding score rows ty + 16a and columns tx + 16c
// (a, c < 4) and output rows ty + 16a, columns tx + 16e (e < D / 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;         // q rows and keys per tile
constexpr int kThreads = 256;     // 16 x 16 thread grid
constexpr int kLdP = kTile + 4;   // padded row of the P~ and dS tiles

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
// elements apart, into shared memory as f32 with D + 4 floats per row; rows
// at or past n_rows are zeros. 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0,
                                          int n_rows, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = tid; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    float* out = dst + r * (D + 4) + c;
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

// acc[a][c] = sum_d A[ty + 16a][d] * B[tx + 16c][d] over two (64, D + 4)
// shared tiles: the score-shaped products s = Q K^T and dP = dO V^T.
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[4][4],
                                              const float* A, const float* B,
                                              int ty, int tx) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * kLd + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * kLd + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] = fmaf(av[a].x, bv[c].x, acc[a][c]);
        acc[a][c] = fmaf(av[a].y, bv[c].y, acc[a][c]);
        acc[a][c] = fmaf(av[a].z, bv[c].z, acc[a][c]);
        acc[a][c] = fmaf(av[a].w, bv[c].w, acc[a][c]);
      }
  }
}

// P and dS of one (64-row q tile at q0, 64-key tile at k0) pair, from the
// staged Q, dO, K, V tiles and the rows' lse / Dv (sL, sD): score row
// ty + 16a, key column tx + 16c. Writes P~ (p rounded to T) to sP when it
// is not null, and dS to sdS.
template <typename T, int D>
__device__ __forceinline__ void p_and_ds(const float* sQ, const float* sdO,
                                         const float* sK, const float* sV,
                                         const float* sL, const float* sD,
                                         float* sP, float* sdS, int q0,
                                         int k0, int sq, int skv, int offset,
                                         int causal, float scale, int ty,
                                         int tx) {
  float s[4][4], dp[4][4];
  rows_dot_rows<D>(s, sQ, sK, ty, tx);
  rows_dot_rows<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int qrow = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kcol = tx + 16 * c;
      const int kpos = k0 + kcol;
      const bool ok = qrow < sq && kpos < skv
                      && !(causal && kpos > qrow + offset);
      const float p = ok ? expf(s[a][c] * scale - sL[r]) : 0.0f;
      if (sP != nullptr) sP[r * kLdP + kcol] = Num<T>::round(p);
      sdS[r * kLdP + kcol] = p * (dp[a][c] - sD[r]);
    }
  }
}

// lse and Dv of rows [q0, q0 + 64) of one (b, h) into shared memory; rows
// past sq get 0 (their p is forced to 0).
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* lse_bh,
                                          const float* dvec_bh, int q0,
                                          int sq, int tid) {
  if (tid < kTile) {
    const bool ok = q0 + tid < sq;
    sL[tid] = ok ? lse_bh[q0 + tid] : 0.0f;
    sD[tid] = ok ? dvec_bh[q0 + tid] : 0.0f;
  }
}

template <int D>
constexpr int bwd_smem_floats() {
  return 4 * kTile * (D + 4) + 2 * kTile * kLdP + 2 * kTile;
}

// Blocks an SM holds: two at D <= 64 (the tiles take 105 KB), else one,
// which lets ptxas give a thread up to 255 registers.
template <int D>
constexpr int kMinBlocks = D <= 64 ? 2 : 1;

// Dv = rowsum(dO * o) in f32, one warp per (b, row, h): dvec (b, h, sq).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ dvec, int64_t rows, int sq,
                           int h) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32)
                      + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(Num<T>::to_f32(o[row * D + d]),
               Num<T>::to_f32(dout[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (bi * sq + i) * h + hi
    const int hi = static_cast<int>(row % h);
    const int64_t bs = row / h;
    const int i = static_cast<int>(bs % sq);
    const int64_t bi = bs / sq;
    dvec[(bi * h + hi) * sq + i] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           T* __restrict__ dk, T* __restrict__ dv, int sq,
                           int skv, int h, int kh, int causal, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * kLd;
  float* sQ = sV + kTile * kLd;
  float* sdO = sQ + kTile * kLd;
  float* sP = sdO + kTile * kLd;
  float* sdS = sP + kTile * kLdP;
  float* sL = sdS + kTile * kLdP;
  float* sD = sL + kTile;

  const int k0 = static_cast<int>(blockIdx.x) * kTile;
  const int khi = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = h / kh;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int offset = skv - sq;
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kh) * D;
  const int64_t kv_base = (static_cast<int64_t>(bi) * skv * kh + khi) * D;

  load_tile<T, D>(sK, k + kv_base, kv_stride, k0, skv, tid);
  load_tile<T, D>(sV, v + kv_base, kv_stride, k0, skv, tid);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      acc_k[a][e] = 0.0f;
      acc_v[a][e] = 0.0f;
    }

  const int nq = (sq + kTile - 1) / kTile;
  // the first q tile holding a row that sees key k0
  const int first = causal ? max(0, k0 - offset) / kTile : 0;
  for (int hi = khi * group; hi < (khi + 1) * group; ++hi) {
    const int64_t q_base = (static_cast<int64_t>(bi) * sq * h + hi) * D;
    const int64_t row_base = (static_cast<int64_t>(bi) * h + hi) * sq;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();          // the previous tile's Q, dO, P~, dS are read
      load_tile<T, D>(sQ, q + q_base, q_stride, q0, sq, tid);
      load_tile<T, D>(sdO, dout + q_base, q_stride, q0, sq, tid);
      load_rows(sL, sD, lse + row_base, dvec + row_base, q0, sq, tid);
      __syncthreads();
      p_and_ds<T, D>(sQ, sdO, sK, sV, sL, sD, sP, sdS, q0, k0, sq, skv,
                     offset, causal, scale, ty, tx);
      __syncthreads();          // P~ and dS complete
      // dV[key][:] += P~[:, key]^T dO, dK[key][:] += dS[:, key]^T Q
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float pa[4], da[4], ov[kCols], qv[kCols];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sP[i * kLdP + ty + 16 * a];
          da[a] = sdS[i * kLdP + ty + 16 * a];
        }
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          ov[e] = sdO[i * kLd + tx + 16 * e];
          qv[e] = sQ[i * kLd + tx + 16 * e];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            acc_v[a][e] = fmaf(pa[a], ov[e], acc_v[a][e]);
            acc_k[a][e] = fmaf(da[a], qv[e], acc_k[a][e]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= skv) continue;
    const int64_t at = kv_base + static_cast<int64_t>(key) * kv_stride;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      dk[at + tx + 16 * e] = Num<T>::from_f32(acc_k[a][e] * scale);
      dv[at + tx + 16 * e] = Num<T>::from_f32(acc_v[a][e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dq,
                         int sq, int skv, int h, int kh, int causal,
                         float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kTile * kLd;
  float* sK = sdO + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sdS = sV + kTile * kLd;
  float* sL = sdS + kTile * kLdP;
  float* sD = sL + kTile;

  const int nq = (sq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int khi = hi / (h / kh);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int offset = skv - sq;
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kh) * D;
  const int64_t q_base = (static_cast<int64_t>(bi) * sq * h + hi) * D;
  const int64_t kv_base = (static_cast<int64_t>(bi) * skv * kh + khi) * D;
  const int64_t row_base = (static_cast<int64_t>(bi) * h + hi) * sq;

  load_tile<T, D>(sQ, q + q_base, q_stride, q0, sq, tid);
  load_tile<T, D>(sdO, dout + q_base, q_stride, q0, sq, tid);
  load_rows(sL, sD, lse + row_base, dvec + row_base, q0, sq, tid);

  int last = (skv + kTile - 1) / kTile - 1;
  if (causal) last = min(last, (q0 + kTile - 1 + offset) / kTile);

  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[a][e] = 0.0f;

  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kTile;
    __syncthreads();            // the previous tile's K, V and dS are read
    load_tile<T, D>(sK, k + kv_base, kv_stride, k0, skv, tid);
    load_tile<T, D>(sV, v + kv_base, kv_stride, k0, skv, tid);
    __syncthreads();
    p_and_ds<T, D>(sQ, sdO, sK, sV, sL, sD, nullptr, sdS, q0, k0, sq, skv,
                   offset, causal, scale, ty, tx);
    __syncthreads();            // dS complete
    // dQ[row][:] += dS[row, :] K
#pragma unroll 2
    for (int j2 = 0; j2 < kTile; ++j2) {
      float da[4], kv[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sdS[(ty + 16 * a) * kLdP + j2];
#pragma unroll
      for (int e = 0; e < kCols; ++e) kv[e] = sK[j2 * kLd + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[a][e] = fmaf(da[a], kv[e], acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sq) continue;
    const int64_t at = q_base + static_cast<int64_t>(row) * q_stride;
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      dq[at + tx + 16 * e] = Num<T>::from_f32(acc[a][e] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* dvec, int b, int sq, int skv, int h, int kh, int causal,
           float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(b) * sq * h;
  const int warps = kThreads / 32;
  flash_attn_bwd_prep_kernel<T, D>
      <<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0,
         stream>>>(static_cast<const T*>(o), tdo, dvec, rows, sq, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kSmem = bwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  if (dk != nullptr) {
    auto kernel = flash_attn_bwd_dkdv_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((skv + kTile - 1) / kTile, kh, b);
    kernel<<<grid, kThreads, kSmem, stream>>>(
        tq, tk, tv, tdo, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, skv, h, kh, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dq != nullptr) {
    auto kernel = flash_attn_bwd_dq_kernel<T, D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + kTile - 1) / kTile, h, b);
    kernel<<<grid, kThreads, kSmem, stream>>>(
        tq, tk, tv, tdo, lse, dvec, static_cast<T*>(dq), sq, skv, h, kh,
        causal, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T>
int launch_dim(int d, const void* q, const void* k, const void* v,
               const void* o, const float* lse, const void* dout, void* dq,
               void* dk, void* dv, float* dvec, int b, int sq, int skv, int h,
               int kh, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                           skv, h, kh, causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                           skv, h, kh, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                           skv, h, kh, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                            skv, h, kh, causal, scale, stream);
    case 160:
      return launch<T, 160>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                            skv, h, kh, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches the backward on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take). q, o, dout and dq
// are (b, sq, h, d); k, v, dk and dv (b, skv, kh, d); all contiguous,
// 16-byte aligned device memory of one type (dtype 0 f32, 1 bf16). lse is
// the forward's (b, h, sq) f32; dvec is (b, h, sq) f32 scratch the launch
// fills. dq null skips the dQ kernel; dk and dv null (both) skip the dK / dV
// kernel. d is 16, 32, 64, 128 or 160; h is a multiple of kh; causal needs
// skv >= sq.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* dout,
                                     void* dq, void* dk, void* dv,
                                     void* dvec, int b, int sq, int skv,
                                     int h, int kh, int d, int causal,
                                     float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kh <= 0 || h % kh != 0
      || b > 65535 || h > 65535 || (causal && skv < sq)
      || (dk == nullptr) != (dv == nullptr) || lse == nullptr
      || dvec == nullptr || !aligned16(q) || !aligned16(k) || !aligned16(v)
      || !aligned16(o) || !aligned16(dout)
      || (dq != nullptr && !aligned16(dq))
      || (dk != nullptr && (!aligned16(dk) || !aligned16(dv))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dvc = static_cast<float*>(dvec);
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, o, l, dout, dq, dk, dv, dvc, b, sq,
                             skv, h, kh, causal, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, o, l, dout, dq, dk, dv, dvc,
                                     b, sq, skv, h, kh, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
