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
// all sums in f32; results rounded to the inputs' type. No atomics: every
// output element is written once, by one thread, after sums taken in a
// fixed order, so the gradient is the same from run to run.
//
// What bounds it on an H100: operations. The five products are 2 D FLOP
// each per unmasked (q, k) pair, 10 D in all: at qwen3-0.6b's training shape
// (B 4, S 4 096, H 16, K 8, D 128, causal) ~6.9e11 FLOP a layer, 0.69 ms at
// the 989 TFLOP/s bf16 tensor-core rate. Two pairs of kernels after the
// prep kernel, chosen by dtype in the wrapper (kernels/flash_attn/kernel.py).
//
// bf16: flash_attn_bwd_dkdv_mma_kernel and flash_attn_bwd_dq_mma_kernel, on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), 4 warps
// each, a warp owning 16 rows of every product.
// - dK / dV: one block per (b, kv head, 64-key tile), the early key tiles
//   (which see the most q tiles under the causal mask) issued first. K and V
//   stay in shared memory as bf16; the block walks the group's H / K query
//   heads and their 64-row q tiles from the first the diagonal reaches, Q,
//   dO and the rows' lse and Dv double-buffered with cp.async. Warp w owns
//   keys k0 + 16w .. + 15 and computes transposed, so P and dS never leave
//   its registers: S^T = K Q^T; P^T = exp2(S^T scale log2e - lse log2e)
//   (masked only on tiles that cross the diagonal or a tail); dV += P~^T dO
//   with P~^T packed from the accumulators as the A operand; dP^T = V dO^T;
//   dS^T = P^T (dP^T - Dv), packed to bf16; dK += dS~^T Q. dK and dV are f32
//   register accumulators (D a thread), written once at the end; beside
//   them a tile is taken 32 rows at a time, which keeps D = 128 free of
//   spills. At D = 160 the accumulators would be 160 registers, so there
//   the block has 8 warps, the two warps of a pair sharing 16 keys and
//   splitting D's columns: each recomputes S^T and dP^T.
// - dQ: one block per (b, h, 64-row q tile), longest rows first. Q's
//   fragments stay in registers, and dO's up to D = 64 (above, they are
//   read from shared memory: registers run out); K and V tiles are
//   double-buffered with cp.async up to the diagonal's tile and taken 32
//   keys at a time; S = Q K^T, dP = dO V^T, dS~ = bf16(P (dP - Dv)),
//   dQ += dS~ K.
// Rounding points: P~ is p rounded to bf16, as the forward rounds it before
// p . v; dS is rounded to bf16 before dK and dQ, as it is the A operand of
// both products (the CUDA-core kernels keep dS in f32). exp(x) is
// ex2.approx.ftz: results below 2^-126 flush to 0. The split recomputes S
// and dP in the dQ kernel: 14 D FLOP executed per unmasked pair against
// the 10 D of the work, so at best 71% of the bound -- the price of a
// deterministic dQ without atomics. Shared memory: K, V and two stages of
// Q and dO, (6 x 64) rows of D + 8 bf16 (16-byte padding: 8 rows of an
// ldmatrix fall in 8 bank quads), 105 472 bytes at D = 128, 130 048 at 160.
//
// f32 (and bf16 on request, the yardstick): flash_attn_bwd_dkdv_kernel and
// flash_attn_bwd_dq_kernel, on the CUDA cores in f32 for both dtypes (bf16
// is widened to f32 in shared memory), so their ceiling is the 67 TFLOP/s
// f32 rate. The same blocks and walks as above; each block holds four
// (64, D + 4) f32 tiles (Q, dO, K, V; rows padded by 4 floats and read as
// float4 along D) and two (64, 68) tiles (P~ and dS) in shared memory,
// 203 264 bytes at D = 160; 256 threads as a 16 x 16 grid, thread (ty, tx)
// holding score rows ty + 16a and columns tx + 16c (a, c < 4) and output
// rows ty + 16a, columns tx + 16e (e < D / 16).

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

// Dv = rowsum(dO * o) into dvec: the launch both routes start with.
template <typename T, int D>
cudaError_t launch_prep(const void* o, const void* dout, float* dvec, int b,
                        int sq, int h, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(b) * sq * h;
  const int warps = kThreads / 32;
  flash_attn_bwd_prep_kernel<T, D>
      <<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                   dvec, rows, sq, h);
  return cudaGetLastError();
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
  cudaError_t err = launch_prep<T, D>(o, dout, dvec, b, sq, h, stream);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;      // warps per 64-row tile, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

// The dK / dV warps split D's columns in pairs at D = 160, where one warp's
// f32 accumulators over all of D (160 registers) would not fit beside the
// score fragments.
template <int D>
constexpr int kColSplit = D > 128 ? 2 : 1;

// The dQ kernel keeps dO's fragments in registers up to D = 64 and reads
// them from shared memory above, where they would spill.
template <int D>
constexpr bool kDoInRegs = D <= 64;

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

// 4 bytes from global to shared memory, or 4 zero bytes where !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
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

// lse and Dv of rows [q0, q0 + 64) of one (b, h) into shared memory, rows
// at or past sq zeros; 4-byte cp.async (a row's offset need not be a
// multiple of 4 floats), not waited for. NT >= 128.
template <int NT>
__device__ __forceinline__ void load_rows_async(float* sL, float* sD,
                                                const float* lse_bh,
                                                const float* dvec_bh, int q0,
                                                int sq, int tid) {
  if (tid < 2 * kTile) {
    const int r = tid % kTile;
    const bool ok = q0 + r < sq;
    const float* src = tid < kTile ? lse_bh : dvec_bh;
    float* dst = tid < kTile ? sL : sD;
    cp_async_4(dst + r, ok ? src + q0 + r : src, ok);
  }
}

// 2^x, flushing results below 2^-126 to zero: a p that small moves no f32
// sum of bf16 products.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Both kernels stage six (64, D + 8) bf16 tiles: K, V and two stages of Q
// and dO, or Q, dO and two stages of K and V. The dK / dV kernel adds two
// stages of the rows' lse and Dv.
template <int D>
constexpr int mma_tiles_bytes() {
  return 6 * kTile * (D + 8) * 2;
}

template <int D>
constexpr int mma_dkdv_smem_bytes() {
  return mma_tiles_bytes<D>() + 4 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps * kColSplit<D>)
flash_attn_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dvec,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int sq,
                               int skv, int h, int kh, int causal,
                               float scale) {
  constexpr int kNT = 32 * kMmaWarps * kColSplit<D>;
  constexpr int kLd = D + 8;                 // shared row, bf16 elements
  constexpr int kKSteps = D / 16;            // k-steps of S^T and dP^T
  constexpr int kCols = D / kColSplit<D>;    // dK / dV columns of a warp
  constexpr int kCTiles = kCols / 8;         // their n-tiles
  constexpr int kQTiles = kTile / 8;         // n-tiles of S^T (q rows)
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* sV = sK + kTile * kLd;
  __nv_bfloat16* sQ = sV + kTile * kLd;          // two stages
  __nv_bfloat16* sdO = sQ + 2 * kTile * kLd;     // two stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * kTile * kLd);  // two stages
  float* sD = sL + 2 * kTile;                                    // two stages

  const int k0 = static_cast<int>(blockIdx.z) * kTile;
  const int khi = blockIdx.x;
  const int bi = blockIdx.y;
  const int group = h / kh;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                  // fragment row (and row + 8)
  const int t = lane % 4;                  // fragment column pair
  const int kw = warp % kMmaWarps;         // the warp's 16 keys
  const int c0 = (warp / kMmaWarps) * kCols;   // and its first column
  const int kw0 = k0 + 16 * kw;
  const int offset = skv - sq;
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kh) * D;
  const int64_t kv_base = (static_cast<int64_t>(bi) * skv * kh + khi) * D;

  // the walk: the group's heads, each from the first q tile holding a row
  // that sees key k0
  const int nq = (sq + kTile - 1) / kTile;
  const int first = causal ? max(0, k0 - offset) / kTile : 0;
  const int n_qt = nq - first;
  const int n_iter = group * n_qt;
  auto stage_in = [&](int it, int st) {
    const int hi = khi * group + it / n_qt;
    const int q0 = (first + it % n_qt) * kTile;
    const int64_t q_base = (static_cast<int64_t>(bi) * sq * h + hi) * D;
    const int64_t row_base = (static_cast<int64_t>(bi) * h + hi) * sq;
    load_tile_async<D, kTile, kNT>(sQ + st * kTile * kLd, q + q_base,
                                   q_stride, q0, sq, tid);
    load_tile_async<D, kTile, kNT>(sdO + st * kTile * kLd, dout + q_base,
                                   q_stride, q0, sq, tid);
    load_rows_async<kNT>(sL + st * kTile, sD + st * kTile, lse + row_base,
                         dvec + row_base, q0, sq, tid);
  };

  load_tile_async<D, kTile, kNT>(sK, k + kv_base, kv_stride, k0, skv, tid);
  load_tile_async<D, kTile, kNT>(sV, v + kv_base, kv_stride, k0, skv, tid);
  stage_in(0, 0);
  cp_async_commit();

  float acc_k[kCTiles][4], acc_v[kCTiles][4];
#pragma unroll
  for (int n = 0; n < kCTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.0f;
      acc_v[n][e] = 0.0f;
    }

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    if (it + 1 < n_iter) {
      stage_in(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                // tile it (and K, V) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (first + it % n_qt) * kTile;
    const __nv_bfloat16* tQ = sQ + st * kTile * kLd;
    const __nv_bfloat16* tdO = sdO + st * kTile * kLd;
    const float* tL = sL + st * kTile;
    const float* tD = sD + st * kTile;
    // skip a tile whose rows all lie before the warp's keys
    if (kw0 < skv && (!causal || kw0 <= q0 + kTile - 1 + offset)) {
      const bool edge = kw0 + 16 > skv || q0 + kTile > sq
                        || (causal && kw0 + 15 > q0 + offset);
      // 32 of the tile's rows at a time, the loop kept rolled: the score
      // fragments of a whole tile (or of two halves interleaved by the
      // scheduler) beside the dK and dV accumulators would spill
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat16* hQ = tQ + half * 32 * kLd;
        const __nv_bfloat16* hdO = tdO + half * 32 * kLd;
        const float* hL = tL + half * 32;
        const float* hD = tD + half * 32;
        // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 rows
        float s[kQTiles / 2][4], dpt[kQTiles / 2][4];
#pragma unroll
        for (int n = 0; n < kQTiles / 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = 0.0f;
            dpt[n][e] = 0.0f;
          }
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, sK + (16 * kw + lane % 16) * kLd + kk * 16
                         + (lane / 16) * 8);
#pragma unroll
          for (int np = 0; np < kQTiles / 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, hQ + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd
                           + kk * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(s[2 * np], a, b[0], b[1]);
            mma_bf16(s[2 * np + 1], a, b[2], b[3]);
          }
        }
        // P^T = exp(S^T scale - lse) in f32, masked only where the tile
        // crosses the diagonal or a tail; P~^T packed as dV's A operand
        uint32_t pa[kTile / 32][4];
#pragma unroll
        for (int n = 0; n < kQTiles / 2; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(hL + n * 8
                                                             + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lr = (e & 1) ? l2.y : l2.x;
            float p = exp2_ftz(fmaf(s[n][e] * scale, kLog2e,
                                    -lr * kLog2e));
            if (edge) {
              const int kpos = kw0 + g + (e >> 1) * 8;
              const int qpos = q0 + half * 32 + n * 8 + 2 * t + (e & 1);
              if (kpos >= skv || qpos >= sq
                  || (causal && kpos > qpos + offset))
                p = 0.0f;
            }
            s[n][e] = p;
          }
          pa[n / 2][(n % 2) * 2] = pack_bf16(s[n][0], s[n][1]);
          pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
        }
        // dV += P~^T dO over the half's rows, the warp's columns
#pragma unroll
        for (int kk = 0; kk < kTile / 32; ++kk)
#pragma unroll
          for (int dp = 0; dp < kCols / 16; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(b, hdO + (kk * 16 + lane % 8
                                    + ((lane / 8) % 2) * 8) * kLd
                                 + c0 + dp * 16 + (lane / 16) * 8);
            mma_bf16(acc_v[2 * dp], pa[kk], b[0], b[1]);
            mma_bf16(acc_v[2 * dp + 1], pa[kk], b[2], b[3]);
          }
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, sV + (16 * kw + lane % 16) * kLd + kk * 16
                         + (lane / 16) * 8);
#pragma unroll
          for (int np = 0; np < kQTiles / 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, hdO + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd
                            + kk * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(dpt[2 * np], a, b[0], b[1]);
            mma_bf16(dpt[2 * np + 1], a, b[2], b[3]);
          }
        }
        // dS^T = P^T (dP^T - Dv), rounded to bf16 as dK's A operand
        uint32_t da[kTile / 32][4];
#pragma unroll
        for (int n = 0; n < kQTiles / 2; ++n) {
          const float2 d2 = *reinterpret_cast<const float2*>(hD + n * 8
                                                             + 2 * t);
          da[n / 2][(n % 2) * 2] =
              pack_bf16(s[n][0] * (dpt[n][0] - d2.x),
                        s[n][1] * (dpt[n][1] - d2.y));
          da[n / 2][(n % 2) * 2 + 1] =
              pack_bf16(s[n][2] * (dpt[n][2] - d2.x),
                        s[n][3] * (dpt[n][3] - d2.y));
        }
        // dK += dS~^T Q over the half's rows, the warp's columns
#pragma unroll
        for (int kk = 0; kk < kTile / 32; ++kk)
#pragma unroll
          for (int dp = 0; dp < kCols / 16; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(b, hQ + (kk * 16 + lane % 8
                                   + ((lane / 8) % 2) * 8) * kLd
                                + c0 + dp * 16 + (lane / 16) * 8);
            mma_bf16(acc_k[2 * dp], da[kk], b[0], b[1]);
            mma_bf16(acc_k[2 * dp + 1], da[kk], b[2], b[3]);
          }
      }
    }
    __syncthreads();            // stage st is read before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= skv) continue;
    const int64_t at = kv_base + static_cast<int64_t>(key) * kv_stride + c0;
#pragma unroll
    for (int n = 0; n < kCTiles; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + n * 8 + 2 * t) =
          pack_bf16(acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + n * 8 + 2 * t) =
          pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps)
flash_attn_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             __nv_bfloat16* __restrict__ dq, int sq, int skv,
                             int h, int kh, int causal, float scale) {
  constexpr int kNT = 32 * kMmaWarps;
  constexpr int kLd = D + 8;               // shared row, bf16 elements
  constexpr int kKSteps = D / 16;          // k-steps of S and dP
  constexpr int kDTiles = D / 8;           // n-tiles of dQ
  constexpr int kSTiles = kTile / 8;       // n-tiles of S (keys)
  constexpr bool kDoRegs = kDoInRegs<D>;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* sdO = sQ + kTile * kLd;
  __nv_bfloat16* sK = sdO + kTile * kLd;       // two stages
  __nv_bfloat16* sV = sK + 2 * kTile * kLd;    // two stages

  const int nq = (sq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * kTile;
  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int khi = hi / (h / kh);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int offset = skv - sq;
  const int wq0 = q0 + 16 * warp;          // the warp's first row
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(kh) * D;
  const int64_t q_base = (static_cast<int64_t>(bi) * sq * h + hi) * D;
  const int64_t kv_base = (static_cast<int64_t>(bi) * skv * kh + khi) * D;
  const int64_t row_base = (static_cast<int64_t>(bi) * h + hi) * sq;

  int last = (skv + kTile - 1) / kTile - 1;
  if (causal) last = min(last, (q0 + kTile - 1 + offset) / kTile);

  load_tile_async<D, kTile, kNT>(sQ, q + q_base, q_stride, q0, sq, tid);
  load_tile_async<D, kTile, kNT>(sdO, dout + q_base, q_stride, q0, sq, tid);
  load_tile_async<D, kTile, kNT>(sK, k + kv_base, kv_stride, 0, skv, tid);
  load_tile_async<D, kTile, kNT>(sV, v + kv_base, kv_stride, 0, skv, tid);
  cp_async_commit();

  // the rows g and g + 8 of the warp: lse in log2 units, Dv
  float lse2[2], dvr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    const bool ok = row < sq;
    lse2[r] = ok ? lse[row_base + row] * kLog2e : 0.0f;
    dvr[r] = ok ? dvec[row_base + row] : 0.0f;
  }

  uint32_t qf[kKSteps][4];
  uint32_t df[kDoRegs ? kKSteps : 1][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j = 0; j <= last; ++j) {
    const int st = j & 1;
    if (j < last) {
      const int k1 = (j + 1) * kTile;
      load_tile_async<D, kTile, kNT>(sK + (st ^ 1) * kTile * kLd,
                                     k + kv_base, kv_stride, k1, skv, tid);
      load_tile_async<D, kTile, kNT>(sV + (st ^ 1) * kTile * kLd,
                                     v + kv_base, kv_stride, k1, skv, tid);
      cp_async_commit();
      cp_async_wait<1>();                // tile j (and Q, dO) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        ldsm_x4(qf[kk], sQ + (16 * warp + lane % 16) * kLd + kk * 16
                            + (lane / 16) * 8);
        if constexpr (kDoRegs)
          ldsm_x4(df[kk], sdO + (16 * warp + lane % 16) * kLd + kk * 16
                              + (lane / 16) * 8);
      }
    }
    const int k0 = j * kTile;
    const __nv_bfloat16* tK = sK + st * kTile * kLd;
    const __nv_bfloat16* tV = sV + st * kTile * kLd;
    // skip a tile whose keys all lie past the warp's rows
    if (!causal || k0 <= wq0 + 15 + offset) {
      const bool edge = k0 + kTile > skv
                        || (causal && k0 + kTile - 1 > wq0 + offset);
      // 32 of the tile's keys at a time, the loop kept rolled: S and dP of
      // a whole tile beside the Q and dQ fragments would spill
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat16* hK = tK + half * 32 * kLd;
        const __nv_bfloat16* hV = tV + half * 32 * kLd;
        // S = Q K^T and dP = dO V^T: the warp's 16 rows x 32 keys
        float s[kSTiles / 2][4], dpv[kSTiles / 2][4];
#pragma unroll
        for (int n = 0; n < kSTiles / 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = 0.0f;
            dpv[n][e] = 0.0f;
          }
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
          for (int np = 0; np < kSTiles / 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, hK + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd
                           + kk * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
            mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          }
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t a[4];
          if constexpr (kDoRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = df[kk][e];
          } else {
            ldsm_x4(a, sdO + (16 * warp + lane % 16) * kLd + kk * 16
                           + (lane / 16) * 8);
          }
#pragma unroll
          for (int np = 0; np < kSTiles / 4; ++np) {
            uint32_t b[4];
            ldsm_x4(b, hV + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd
                           + kk * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(dpv[2 * np], a, b[0], b[1]);
            mma_bf16(dpv[2 * np + 1], a, b[2], b[3]);
          }
        }
        // P = exp(S scale - lse), masked only where the tile crosses the
        // diagonal or the kv tail; dS~ = bf16(P (dP - Dv)) as dQ's A
        // operand
        uint32_t da[kSTiles / 4][4];
#pragma unroll
        for (int n = 0; n < kSTiles / 2; ++n) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_ftz(fmaf(s[n][e] * scale, kLog2e,
                                    -lse2[e >> 1]));
            if (edge) {
              const int kpos = k0 + half * 32 + n * 8 + 2 * t + (e & 1);
              const int qpos = wq0 + g + (e >> 1) * 8 + offset;
              if ((causal && kpos > qpos) || kpos >= skv) p = 0.0f;
            }
            ds[e] = p * (dpv[n][e] - dvr[e >> 1]);
          }
          da[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
          da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dQ += dS~ K over the half's keys
#pragma unroll
        for (int kk = 0; kk < kSTiles / 4; ++kk)
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(b, hK + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                      * kLd + dp * 16 + (lane / 16) * 8);
            mma_bf16(acc[2 * dp], da[kk], b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], da[kk], b[2], b[3]);
          }
      }
    }
    __syncthreads();            // stage st is read before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* drow = dq + q_base + static_cast<int64_t>(row) * q_stride;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* dvec, int b, int sq, int skv, int h, int kh,
               int causal, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  cudaError_t err = launch_prep<T, D>(o, dout, dvec, b, sq, h, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk != nullptr) {
    constexpr int kSmem = mma_dkdv_smem_bytes<D>();
    auto kernel = flash_attn_bwd_dkdv_mma_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // key tiles in the slowest grid dimension: the early, heavy ones first
    const dim3 grid(kh, b, (skv + kTile - 1) / kTile);
    kernel<<<grid, 32 * kMmaWarps * kColSplit<D>, kSmem, stream>>>(
        tq, tk, tv, tdo, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv),
        sq, skv, h, kh, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dq != nullptr) {
    constexpr int kSmem = mma_tiles_bytes<D>();
    auto kernel = flash_attn_bwd_dq_mma_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // q tiles in the slowest grid dimension, the last (longest) first
    const dim3 grid(h, b, (sq + kTile - 1) / kTile);
    kernel<<<grid, 32 * kMmaWarps, kSmem, stream>>>(
        tq, tk, tv, tdo, lse, dvec, static_cast<T*>(dq), sq, skv, h, kh,
        causal, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

int launch_mma_dim(int d, const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* dvec, int b, int sq,
                   int skv, int h, int kh, int causal, float scale,
                   cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_mma<16>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                            skv, h, kh, causal, scale, stream);
    case 32:
      return launch_mma<32>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                            skv, h, kh, causal, scale, stream);
    case 64:
      return launch_mma<64>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                            skv, h, kh, causal, scale, stream);
    case 128:
      return launch_mma<128>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                             skv, h, kh, causal, scale, stream);
    case 160:
      return launch_mma<160>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq,
                             skv, h, kh, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool valid_args(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, const void* dq,
                const void* dk, const void* dv, const void* dvec, int b,
                int sq, int skv, int h, int kh, int causal) {
  return !(b <= 0 || sq <= 0 || skv <= 0 || h <= 0 || kh <= 0
           || h % kh != 0 || b > 65535 || h > 65535 || (causal && skv < sq)
           || (dk == nullptr) != (dv == nullptr) || lse == nullptr
           || dvec == nullptr || !aligned16(q) || !aligned16(k)
           || !aligned16(v) || !aligned16(o) || !aligned16(dout)
           || (dq != nullptr && !aligned16(dq))
           || (dk != nullptr && (!aligned16(dk) || !aligned16(dv))));
}

}  // namespace

// Launches the backward on the CUDA cores on `stream` and returns
// cudaGetLastError() after each launch that fails, else after the last (or
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
  if (!valid_args(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq, skv, h,
                  kh, causal))
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

// The tensor-core kernels: the same arguments and checks less dtype, bf16
// only; q and k tiles are a grid dimension, so sq and skv are at most
// 65 535 x 64.
extern "C" int flash_attn_bwd_mma_launch(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         void* dvec, int b, int sq, int skv,
                                         int h, int kh, int d, int causal,
                                         float scale, void* stream) {
  if (!valid_args(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, sq, skv, h,
                  kh, causal)
      || (sq + kTile - 1) / kTile > 65535 || (skv + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma_dim(d, q, k, v, o, static_cast<const float*>(lse), dout,
                        dq, dk, dv, static_cast<float*>(dvec), b, sq, skv, h,
                        kh, causal, scale,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
