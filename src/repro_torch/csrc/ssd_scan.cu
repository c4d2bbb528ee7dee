// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py ::
// ssd_scan_pallas (body _ssd_kernel). For x (b, l, h, p), dt (b, l, h) f32,
// A (h,) f32, B and C (b, l, n), and per head a (p, n) state carried across
// chunks of Q positions:
//
//   dt     = 0 at padded tail positions (pos >= l)
//   seg    = cumsum(dt * A) within the chunk
//   y_i    = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//            + exp(seg_i) (C_i . state^T)
//   state <- exp(seg_last) state
//            + sum_j (x_j dt_j exp(seg_last - seg_j))^T B_j
//
// y is returned in x's type, the final state (b, h, p, n) too. An optional
// initial state (f32) takes the place of zeros, as in ssd_chunked, so a scan
// can continue another. exp(seg_i - seg_j) overflows to inf above the
// diagonal (A reaches -50 at hymba-1.5b, seg about -1000 within a chunk), so
// the causal mask is a select, never a multiply (inf * 0 is NaN). expf, not
// __expf; no fast-math.
//
// What bounds it on an H100: bytes. At hymba-1.5b (b 4, l 4096, h 50, p 64,
// n 16, chunk 256, bf16) a layer's scan must read x (105 MB), dt, B and C
// and write y (105 MB) and the state: ~215 MB, 0.064 ms at 3.35 TB/s,
// against ~2e10 FLOP of chunked products (0.02 ms at the bf16 tensor-core
// rate) and ~1.3e8 expf on the causal halves. Two kernels, chosen by dtype
// in the wrapper (kernels/ssd_scan/kernel.py):
//
// bf16: three chunk-parallel passes on the tensor cores, launched one after
// the other on the stream by ssd_scan_mma_launch, with workspaces the
// wrapper allocates (the kernels allocate nothing). Every product is
// mma.sync m16n8k16 (bf16 in, f32 accumulate) from 16-byte-padded shared
// rows read by ldmatrix; n is padded with zeros to NK = 16, 32, 64 or 128.
//  (a) ssd_scan_state_kernel, one block per (chunk, h, b) -- 3 200 at
//      hymba: dt (zeroed past l), seg by a block-wide scan, w = dt *
//      exp(seg_last - seg) rounded to bf16, x * w rounded to bf16 in shared
//      memory, then S_c = (x w)^T B in 64-position tiles. Writes seg and dt
//      (padded to a multiple of 64 positions with seg_last and 0),
//      exp(seg_last) and S_c (f32) to the workspace.
//  (b) ssd_scan_pass_kernel, threads over (b h, p, NK): the only serial
//      part, a walk over the chunks, prior_c = state (rounded to bf16, the
//      B operand of C . prior^T), state = exp(seg_last_c) state + S_c; the
//      final state in x's type. Its loads do not depend on the state, so
//      they are in flight together.
//  (c) ssd_scan_out_kernel, one block of 4 warps per (64-row tile, chunk,
//      h, b) -- 12 800 at hymba, longest rows first: each warp owns 16 rows
//      i. C_i's fragments stay in registers; the inter-chunk term is
//      (C_i exp(seg_i))_bf16 . prior_c^T; then for each 64-key tile j up to
//      the diagonal (B_j, x_j, seg_j, dt_j double-buffered by cp.async),
//      G = C_i . B_j^T 16 keys at a time, att = G exp(seg_i - seg_j) dt_j
//      (select-masked on the diagonal tile, whose key steps past the warp's
//      rows are skipped) rounded to bf16 in registers as the A operand of
//      att . x_j -- att never goes through shared memory. y is written once.
// The rounding points are those of the plain version (models/ssm.py ::
// ssd_chunked): att, x * w and the prior state to bf16, C exp(seg) too;
// every sum is f32. x is read twice (passes a and c), so this design's own
// byte floor is ~0.11 ms at hymba; the seg / dt / S / prior workspaces add
// ~30 MB more. Rows of y are stored as 4-byte pairs from the accumulators.
// What bounds it now: pass (c), about three quarters of the call, and there
// its memory traffic rather than the products or the expf: each row tile
// reads again the key tiles below it (x about 2.5 times over at chunk 256,
// from L2), and a block holds too few tiles to hide the latency. Fewer expf
// (the decay factored below the diagonal), a 256-row group per block with
// two m-tiles a warp, and higher occupancy were each tried on the card and
// were not faster.
//
// Each kernel also has an entry point that writes the state entering each
// chunk (ssd_scan_priors_launch, ssd_scan_mma_priors_launch): the backward
// (csrc/ssd_scan_bwd.cu) reads it instead of walking the chunks again. The
// serving path passes no buffer and runs as before.
//
// f32: ssd_scan_kernel, on the CUDA cores with f32 products (TF32 would miss
// the 1e-5 tolerance). One block of 256 threads owns a (b, h) pair -- 200
// blocks at hymba-1.5b -- and loops over the chunks itself with the state in
// shared memory; y is built in 64-row tiles of G = C B^T formed from C_i and
// B_j staged in shared memory as f32, masked, decayed and scaled by dt into
// `att`, and att . x_j accumulated in registers (thread (ty, tx) holds rows
// ty + 16a, columns tx + 16e), on top of exp(seg_i) C_i . state^T; the state
// update walks the column tiles once more. seg is a sequential cumsum by one
// thread. It also takes bf16 (widened to f32 in shared memory): the wrapper
// runs it so only when asked by name, as the yardstick the tensor-core
// passes are timed against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 64;        // rows (and columns) of a G tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kLdAtt = kTile + 4;
constexpr int kMaxN = 128;       // the state update keeps p * n / 256 sums
                                 // per thread in registers

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float to_f32(float v) { return v; }
  __device__ static float from_f32(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
};

// Rows [r0, r0 + 64) of the chunk starting at position c0 of a (l, width)
// slab whose positions are `stride` elements apart, as f32 with `ld` floats
// per row; rows at or past `rows` (the chunk's length) or past l are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t stride, int width, int c0,
                                          int r0, int rows, int l, int tid) {
  for (int idx = tid; idx < kTile * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx % width;
    const int i = r0 + r;
    const int pos = c0 + i;
    dst[r * ld + c] = (i < rows && pos < l)
                          ? Num<T>::to_f32(src[pos * stride + c])
                          : 0.0f;
  }
}

// The three per-position arrays are padded to a multiple of 4 floats, so the
// att tile after them stays 16-byte aligned for float4 reads.
__host__ __device__ inline int chunk_pad(int chunk) {
  return (chunk + 3) / 4 * 4;
}

template <int P>
int smem_floats(int n, int chunk) {
  return 3 * chunk_pad(chunk) + P * (n + 1) + 2 * kTile * (n + 1) + kTile * P
         + kTile * kLdAtt;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const float* __restrict__ init,
                T* __restrict__ y, T* __restrict__ state_out,
                T* __restrict__ prior_out, int l, int h, int n, int chunk) {
  constexpr int kCols = P / 16;
  constexpr int kStateSums = P * kMaxN / kThreads;
  extern __shared__ float4 smem4[];
  const int ldn = n + 1;
  float* sDt = reinterpret_cast<float*>(smem4);
  float* sSeg = sDt + chunk_pad(chunk);
  float* sW = sSeg + chunk_pad(chunk);
  float* sState = sW + chunk_pad(chunk);      // (P, n + 1)
  float* sC = sState + P * ldn;               // (64, n + 1)
  float* sB = sC + kTile * ldn;               // (64, n + 1)
  float* sX = sB + kTile * ldn;               // (64, P)
  float* sAtt = sX + kTile * P;               // (64, 68), 16-byte aligned

  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float a_h = A[hi];
  const int64_t x_stride = static_cast<int64_t>(h) * P;
  const T* xb = x + static_cast<int64_t>(bi) * l * x_stride
                + static_cast<int64_t>(hi) * P;
  T* yb = y + static_cast<int64_t>(bi) * l * x_stride
          + static_cast<int64_t>(hi) * P;
  const float* dtb = dt + static_cast<int64_t>(bi) * l * h + hi;
  const T* Bb = B + static_cast<int64_t>(bi) * l * n;
  const T* Cb = C + static_cast<int64_t>(bi) * l * n;
  const int64_t state_off = (static_cast<int64_t>(bi) * h + hi) * P * n;

  for (int idx = tid; idx < P * n; idx += kThreads)
    sState[(idx / n) * ldn + idx % n] =
        init != nullptr ? init[state_off + idx] : 0.0f;

  const int n_chunks = (l + chunk - 1) / chunk;
  const int n_tiles = (chunk + kTile - 1) / kTile;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * chunk;
    __syncthreads();            // the previous chunk's state update is done
    if (prior_out != nullptr) {  // the state entering the chunk, (b, h, nc,
      T* pr = prior_out + state_off * n_chunks                  // p, n)
              + static_cast<int64_t>(ci) * P * n;
      for (int idx = tid; idx < P * n; idx += kThreads)
        pr[idx] = Num<T>::from_f32(sState[(idx / n) * ldn + idx % n]);
    }
    for (int t = tid; t < chunk; t += kThreads)
      sDt[t] = c0 + t < l ? dtb[static_cast<int64_t>(c0 + t) * h] : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int t = 0; t < chunk; ++t) {
        run = __fadd_rn(run, __fmul_rn(sDt[t], a_h));
        sSeg[t] = run;
      }
    }
    __syncthreads();
    const float seg_last = sSeg[chunk - 1];
    for (int t = tid; t < chunk; t += kThreads)
      sW[t] = sDt[t] * expf(seg_last - sSeg[t]);

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      __syncthreads();          // sC, sB, sX, sAtt free; sW written
      load_rows<T>(sC, ldn, Cb, n, n, c0, i0, chunk, l, tid);
      __syncthreads();

      // inter-chunk term: (C_i * exp(seg_i)) . state^T
      float acc[4][kCols];
      float e_seg[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        e_seg[a] = i < chunk ? expf(sSeg[i]) : 0.0f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[a][e] = 0.0f;
      }
      for (int k = 0; k < n; ++k) {
        float cv[4], sv[kCols];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cv[a] = __fmul_rn(sC[(ty + 16 * a) * ldn + k], e_seg[a]);
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          sv[e] = sState[(tx + 16 * e) * ldn + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < kCols; ++e)
            acc[a][e] = fmaf(cv[a], sv[e], acc[a][e]);
      }

      // intra-chunk term over the column tiles up to the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();        // the previous tile's sB, sX, sAtt are read
        load_rows<T>(sB, ldn, Bb, n, n, c0, j0, chunk, l, tid);
        load_rows<T>(sX, P, xb, x_stride, P, c0, j0, chunk, l, tid);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[a][c] = 0.0f;
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * ldn + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * ldn + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[a][c] = fmaf(cv[a], bv[c], g[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            float att = 0.0f;
            if (i < chunk && j <= i) {   // a select, not a product
              const float decay = expf(sSeg[i] - sSeg[j]);
              att = __fmul_rn(__fmul_rn(g[a][c], decay), sDt[j]);
            }
            sAtt[(ty + 16 * a) * kLdAtt + tx + 16 * c] = att;
          }
        }
        __syncthreads();
#pragma unroll 2
        for (int c = 0; c < kTile; c += 4) {
          float4 av[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            av[a] = *reinterpret_cast<const float4*>(
                sAtt + (ty + 16 * a) * kLdAtt + c);
          float xv[4][kCols];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < kCols; ++e)
              xv[r][e] = sX[(c + r) * P + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
              acc[a][e] = fmaf(av[a].x, xv[0][e], acc[a][e]);
              acc[a][e] = fmaf(av[a].y, xv[1][e], acc[a][e]);
              acc[a][e] = fmaf(av[a].z, xv[2][e], acc[a][e]);
              acc[a][e] = fmaf(av[a].w, xv[3][e], acc[a][e]);
            }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= chunk || c0 + i >= l) continue;
        T* out = yb + static_cast<int64_t>(c0 + i) * x_stride;
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          out[tx + 16 * e] = Num<T>::from_f32(acc[a][e]);
      }
    }

    // chunk summary: S[p][k] = sum_j (x_j[p] * w_j) * B_j[k]
    float sums[kStateSums];
#pragma unroll
    for (int s = 0; s < kStateSums; ++s) sums[s] = 0.0f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      load_rows<T>(sB, ldn, Bb, n, n, c0, j0, chunk, l, tid);
      load_rows<T>(sX, P, xb, x_stride, P, c0, j0, chunk, l, tid);
      __syncthreads();
      const int rows = min(kTile, chunk - j0);
#pragma unroll
      for (int s = 0; s < kStateSums; ++s) {
        const int idx = tid + s * kThreads;
        if (idx < P * n) {
          const int p = idx / n;
          const int k = idx % n;
          float sum = sums[s];
          for (int r = 0; r < rows; ++r)
            sum = fmaf(__fmul_rn(sX[r * P + p], sW[j0 + r]), sB[r * ldn + k],
                       sum);
          sums[s] = sum;
        }
      }
    }
    const float decay_last = expf(seg_last);
#pragma unroll
    for (int s = 0; s < kStateSums; ++s) {
      const int idx = tid + s * kThreads;
      if (idx < P * n) {
        float* st = sState + (idx / n) * ldn + idx % n;
        *st = fmaf(decay_last, *st, sums[s]);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * n; idx += kThreads)
    state_out[state_off + idx] =
        Num<T>::from_f32(sState[(idx / n) * ldn + idx % n]);
}

template <typename T, int P>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* init, void* y, void* state,
           void* prior, int b, int l, int h, int n, int chunk,
           cudaStream_t stream) {
  const int smem = smem_floats<P>(n, chunk) * static_cast<int>(sizeof(float));
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_scan_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), init, static_cast<T*>(y),
      static_cast<T*>(state), static_cast<T*>(prior), l, h, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(int p, const void* x, const float* dt, const float* A,
             const void* B, const void* C, const float* init, void* y,
             void* state, void* prior, int b, int l, int h, int n, int chunk,
             cudaStream_t stream) {
  switch (p) {
    case 16:
      return launch<T, 16>(x, dt, A, B, C, init, y, state, prior, b, l, h, n,
                           chunk, stream);
    case 32:
      return launch<T, 32>(x, dt, A, B, C, init, y, state, prior, b, l, h, n,
                           chunk, stream);
    case 64:
      return launch<T, 64>(x, dt, A, B, C, init, y, state, prior, b, l, h, n,
                           chunk, stream);
    case 128:
      return launch<T, 128>(x, dt, A, B, C, init, y, state, prior, b, l, h,
                            n, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: three chunk-parallel passes
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                // positions per row tile / key tile
constexpr int kWarps = 4;                // warps per block of passes a and c
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kPassThreads = 256;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// n padded with zeros to the depth of whole k-steps
__host__ __device__ inline int nk_for(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

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

// A pair of bf16 times an f32, rounded back to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
}

// Rows [row0, row0 + 64) of a chunk starting at position c0 of a (l, n)
// bf16 slab, into shared rows of NK + 8 elements; rows past the chunk or
// past l are zeros. With n % 8 == 0, 16-byte cp.async of the n columns (the
// caller zeroes columns [n, NK) once); else element by element, columns
// [n, NK) zeros.
template <int NK>
__device__ __forceinline__ void load_bc(bf16* dst, const bf16* src, int n,
                                        int c0, int row0, int chunk, int l,
                                        bool vec, int tid) {
  constexpr int kLd = NK + 8;
  if (vec) {
    const int per_row = n / 8;
    for (int idx = tid; idx < kRows * per_row; idx += kMmaThreads) {
      const int r = idx / per_row;
      const int c = (idx % per_row) * 8;
      const int t = row0 + r;
      const bool ok = t < chunk && c0 + t < l;
      cp_async_16(dst + r * kLd + c,
                  ok ? src + static_cast<int64_t>(c0 + t) * n + c : src, ok);
    }
  } else {
    for (int idx = tid; idx < kRows * NK; idx += kMmaThreads) {
      const int r = idx / NK;
      const int c = idx % NK;
      const int t = row0 + r;
      dst[r * kLd + c] = (c < n && t < chunk && c0 + t < l)
                             ? src[static_cast<int64_t>(c0 + t) * n + c]
                             : __float2bfloat16_rn(0.0f);
    }
  }
}

// Columns [n, NK) of `rows` shared rows of NK + 8 elements set to zero.
template <int NK>
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int rows, int n,
                                              int tid) {
  const int w = NK - n;
  for (int idx = tid; idx < rows * w; idx += kMmaThreads)
    dst[(idx / w) * (NK + 8) + n + idx % w] = __float2bfloat16_rn(0.0f);
}

// Rows [row0, row0 + 64) of x's chunk (positions `xs` elements apart) into
// shared rows of P + 8 elements by cp.async; rows past the chunk or l zero.
template <int P>
__device__ __forceinline__ void load_x(bf16* dst, const bf16* xb, int64_t xs,
                                       int c0, int row0, int chunk, int l,
                                       int tid) {
  constexpr int kPerRow = P / 8;
  for (int idx = tid; idx < kRows * kPerRow; idx += kMmaThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 8;
    const int t = row0 + r;
    const bool ok = t < chunk && c0 + t < l;
    cp_async_16(dst + r * (P + 8) + c,
                ok ? xb + static_cast<int64_t>(c0 + t) * xs + c : xb, ok);
  }
}

// 64 floats by cp.async (16 threads).
__device__ __forceinline__ void load_f32_64(float* dst, const float* src,
                                            int tid) {
  if (tid < 16) cp_async_16(dst + 4 * tid, src + 4 * tid, true);
}

// The workspace of one call, carved from one allocation: seg and dt
// (bh, nc, qt) f32 with qt = chunk rounded up to 64, exp(seg_last) (bh, nc)
// f32, the chunk summaries S (bh, nc, p, nk) f32 and the prior states
// (bh, nc, p, nk) bf16. Returns its size in bytes; fills `ws` when given.
struct Workspace {
  float* seg;
  float* dt;
  float* decay;
  float* S;
  bf16* prior;
};

inline int64_t workspace_layout(int b, int l, int h, int p, int n, int chunk,
                                void* base, Workspace* ws) {
  const int64_t bhc = static_cast<int64_t>(b) * h * ((l + chunk - 1) / chunk);
  const int64_t qt = round_up(chunk, kRows);
  const int64_t pn = static_cast<int64_t>(p) * nk_for(n);
  const int64_t sizes[5] = {bhc * qt * 4, bhc * qt * 4, bhc * 4, bhc * pn * 4,
                            bhc * pn * 2};
  int64_t offs[5];
  int64_t off = 0;
  for (int i = 0; i < 5; ++i) {
    offs[i] = off;
    off += (sizes[i] + 255) / 256 * 256;
  }
  if (ws != nullptr) {
    char* c = static_cast<char*>(base);
    ws->seg = reinterpret_cast<float*>(c + offs[0]);
    ws->dt = reinterpret_cast<float*>(c + offs[1]);
    ws->decay = reinterpret_cast<float*>(c + offs[2]);
    ws->S = reinterpret_cast<float*>(c + offs[3]);
    ws->prior = reinterpret_cast<bf16*>(c + offs[4]);
  }
  return off;
}

template <int P, int NK>
int state_smem_bytes(int chunk) {
  return kRows * (P + 8 + NK + 8) * 2 + 3 * round_up(chunk, kRows) * 4;
}

template <int P, int NK>
constexpr int out_smem_bytes() {
  return (3 * kRows * (NK + 8) + P * (NK + 8) + 2 * kRows * (P + 8)) * 2
         + 5 * kRows * 4;
}

// Pass (a): per (chunk, h, b), seg, dt, exp(seg_last) and
// S_c = (x * w)^T B with w = dt exp(seg_last - seg).
template <int P, int NK>
__global__ void __launch_bounds__(kMmaThreads)
ssd_scan_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ B,
                      Workspace ws, int l, int h, int n, int chunk) {
  constexpr int kLdX = P + 8;
  constexpr int kLdB = NK + 8;
  constexpr int kNPairs = NK / 16;             // 16-column pairs of n-tiles
  constexpr int kUnits = (P / 16) * kNPairs;   // 16 x 16 blocks of S
  constexpr int kUnitsPerWarp = (kUnits + kWarps - 1) / kWarps;
  extern __shared__ uint4 smem_u4[];
  __shared__ float sWarpSum[kWarps];
  const int qt = round_up(chunk, kRows);
  bf16* sX = reinterpret_cast<bf16*>(smem_u4);               // (64, P + 8)
  bf16* sB = sX + kRows * kLdX;                              // (64, NK + 8)
  float* sSeg = reinterpret_cast<float*>(sB + kRows * kLdB); // qt
  float* sDt = sSeg + qt;                                    // qt
  float* sW = sDt + qt;                                      // qt

  const int ci = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c0 = ci * chunk;
  const float a_h = A[hi];
  const int64_t cix = (static_cast<int64_t>(bi) * h + hi) * nc + ci;
  const bool vec = n % 8 == 0;

  if (vec && n < NK) zero_pad_cols<NK>(sB, kRows, n, tid);
  for (int t = tid; t < qt; t += kMmaThreads) {
    const int pos = c0 + t;
    const float d = (t < chunk && pos < l)
                        ? dt[(static_cast<int64_t>(bi) * l + pos) * h + hi]
                        : 0.0f;
    sDt[t] = d;
    sSeg[t] = __fmul_rn(d, a_h);
  }
  __syncthreads();

  // inclusive scan of sSeg[0, chunk): each thread sums a run of positions,
  // the runs' sums are scanned across the warp and then across warps
  const int per = (chunk + kMmaThreads - 1) / kMmaThreads;
  const int t0 = min(tid * per, chunk);
  const int t1 = min(t0 + per, chunk);
  float run = 0.0f;
  for (int t = t0; t < t1; ++t) run = __fadd_rn(run, sSeg[t]);
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, v);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) sWarpSum[warp] = incl;
  __syncthreads();
  float base = 0.0f;
  for (int w = 0; w < warp; ++w) base = __fadd_rn(base, sWarpSum[w]);
  float s = __fadd_rn(base, excl);
  for (int t = t0; t < t1; ++t) {
    s = __fadd_rn(s, sSeg[t]);
    sSeg[t] = s;
  }
  __syncthreads();

  // seg past the chunk is seg_last (dt is 0 there): pass (c) reads whole
  // 64-position tiles and then sees exp(seg_i - seg_j) <= 1 on every row
  const float seg_last = sSeg[chunk - 1];
  float* seg_out = ws.seg + cix * qt;
  float* dt_out = ws.dt + cix * qt;
  for (int t = tid; t < qt; t += kMmaThreads) {
    const float sg = t < chunk ? sSeg[t] : seg_last;
    const float d = sDt[t];
    seg_out[t] = sg;
    dt_out[t] = d;
    // w rounded to bf16, as ssd_chunked rounds dt * exp(seg_last - seg)
    sW[t] = __bfloat162float(
        __float2bfloat16_rn(__fmul_rn(d, expf(seg_last - sg))));
  }
  if (tid == 0) ws.decay[cix] = expf(seg_last);

  const int64_t xs = static_cast<int64_t>(h) * P;
  const bf16* xb = x + (static_cast<int64_t>(bi) * l * h + hi) * P;
  const bf16* Bb = B + static_cast<int64_t>(bi) * l * n;
  float acc[kUnitsPerWarp][2][4];
#pragma unroll
  for (int u = 0; u < kUnitsPerWarp; ++u)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][f][e] = 0.0f;

  for (int r0 = 0; r0 < chunk; r0 += kRows) {
    __syncthreads();            // sW written; the previous tile is read
    load_bc<NK>(sB, Bb, n, c0, r0, chunk, l, vec, tid);
    cp_async_commit();
    // x * w rounded to bf16, 8 elements a step
    constexpr int kPerRow = P / 8;
    for (int idx = tid; idx < kRows * kPerRow; idx += kMmaThreads) {
      const int r = idx / kPerRow;
      const int c = (idx % kPerRow) * 8;
      const int t = r0 + r;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (t < chunk && c0 + t < l) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            xb + static_cast<int64_t>(c0 + t) * xs + c);
        const float w = sW[t];
        out.x = scale_bf16x2(raw.x, w);
        out.y = scale_bf16x2(raw.y, w);
        out.z = scale_bf16x2(raw.z, w);
        out.w = scale_bf16x2(raw.w, w);
      }
      *reinterpret_cast<uint4*>(sX + r * kLdX + c) = out;
    }
    cp_async_wait<0>();
    __syncthreads();
    // S += (x w)^T B: A = (x w)^T (p x positions) and B (positions x n),
    // both read transposed from position-major rows
#pragma unroll
    for (int u = 0; u < kUnitsPerWarp; ++u) {
      const int unit = warp + u * kWarps;
      if (unit < kUnits) {
        const int mt = unit / kNPairs;
        const int np = unit % kNPairs;
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          uint32_t a[4], b[4];
          ldsm_x4_trans(a, sX + (kk * 16 + lane % 8 + (lane / 16) * 8) * kLdX
                               + mt * 16 + ((lane / 8) % 2) * 8);
          ldsm_x4_trans(b, sB + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                               * kLdB + np * 16 + (lane / 16) * 8);
          mma_bf16(acc[u][0], a, b[0], b[1]);
          mma_bf16(acc[u][1], a, b[2], b[3]);
        }
      }
    }
  }

  float* S = ws.S + cix * P * NK;
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int u = 0; u < kUnitsPerWarp; ++u) {
    const int unit = warp + u * kWarps;
    if (unit < kUnits) {
      const int mt = unit / kNPairs;
      const int np = unit % kNPairs;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              S + (mt * 16 + g + 8 * r) * NK + (2 * np + f) * 8 + 2 * t4) =
              make_float2(acc[u][f][2 * r], acc[u][f][2 * r + 1]);
    }
  }
}

// Pass (b): per (b h, p, k < nk), the walk over the chunks.
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_pass_kernel(Workspace ws, const float* __restrict__ init,
                     bf16* __restrict__ state_out, int p, int n, int nk,
                     int nc) {
  const int64_t bh = blockIdx.x;
  const int idx = blockIdx.y * kPassThreads + threadIdx.x;
  if (idx >= p * nk) return;
  const int pi = idx / nk;
  const int k = idx % nk;
  float state = (init != nullptr && k < n) ? init[(bh * p + pi) * n + k]
                                           : 0.0f;
  const int64_t step = static_cast<int64_t>(p) * nk;
  const float* S = ws.S + bh * nc * step + idx;
  bf16* prior = ws.prior + bh * nc * step + idx;
  const float* decay = ws.decay + bh * nc;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    prior[c * step] = __float2bfloat16_rn(state);
    state = __fadd_rn(__fmul_rn(decay[c], state), S[c * step]);
  }
  if (k < n) state_out[(bh * p + pi) * n + k] = __float2bfloat16_rn(state);
}

// Pass (c): per (64-row tile, chunk, h, b), y of the tile's rows.
template <int P, int NK>
__global__ void __launch_bounds__(kMmaThreads)
ssd_scan_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ B,
                    const bf16* __restrict__ C, Workspace ws,
                    bf16* __restrict__ y, int l, int h, int n, int chunk) {
  constexpr int kLdX = P + 8;
  constexpr int kLdB = NK + 8;
  constexpr int kKSteps = NK / 16;       // depth of C . B^T and C . prior^T
  constexpr int kPTiles = P / 8;         // n-tiles of y
  extern __shared__ uint4 smem_u4[];
  bf16* sC = reinterpret_cast<bf16*>(smem_u4);   // (64, NK + 8)
  bf16* sB = sC + kRows * kLdB;                  // two stages (64, NK + 8)
  bf16* sPrior = sB + 2 * kRows * kLdB;          // (P, NK + 8)
  bf16* sX = sPrior + P * kLdB;                  // two stages (64, P + 8)
  float* sSegI = reinterpret_cast<float*>(sX + 2 * kRows * kLdX);  // 64
  float* sSegJ = sSegI + kRows;                  // two stages of 64
  float* sDtJ = sSegJ + 2 * kRows;               // two stages of 64

  const int n_rt = (chunk + kRows - 1) / kRows;
  const int qt = n_rt * kRows;
  const int nc = (l + chunk - 1) / chunk;
  const int ci = blockIdx.x / n_rt;
  const int it = n_rt - 1 - static_cast<int>(blockIdx.x % n_rt);
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                // fragment row (and row + 8)
  const int t4 = lane % 4;               // fragment column pair
  const int wr = warp * 16;              // the warp's first row in the tile
  const int c0 = ci * chunk;
  const int i0 = it * kRows;
  const int64_t cix = (static_cast<int64_t>(bi) * h + hi) * nc + ci;
  const float* seg = ws.seg + cix * qt;
  const float* dtw = ws.dt + cix * qt;
  const bf16* prior = ws.prior + cix * P * NK;
  const int64_t xs = static_cast<int64_t>(h) * P;
  const bf16* xb = x + (static_cast<int64_t>(bi) * l * h + hi) * P;
  const bf16* Bb = B + static_cast<int64_t>(bi) * l * n;
  const bf16* Cb = C + static_cast<int64_t>(bi) * l * n;
  const bool vec = n % 8 == 0;

  // group 0: the row tile's C and seg, the prior state, key tile 0
  if (vec && n < NK) zero_pad_cols<NK>(sC, 3 * kRows, n, tid);
  load_bc<NK>(sC, Cb, n, c0, i0, chunk, l, vec, tid);
  load_f32_64(sSegI, seg + i0, tid);
  for (int idx = tid; idx < P * (NK / 8); idx += kMmaThreads) {
    const int r = idx / (NK / 8);
    const int c = (idx % (NK / 8)) * 8;
    cp_async_16(sPrior + r * kLdB + c, prior + r * NK + c, true);
  }
  load_bc<NK>(sB, Bb, n, c0, 0, chunk, l, vec, tid);
  load_x<P>(sX, xb, xs, c0, 0, chunk, l, tid);
  load_f32_64(sSegJ, seg, tid);
  load_f32_64(sDtJ, dtw, tid);
  cp_async_commit();

  float o[kPTiles][4];
#pragma unroll
  for (int nt = 0; nt < kPTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  uint32_t cf[kKSteps][4];
  float si[2];

  for (int jt = 0; jt <= it; ++jt) {
    const int st = jt & 1;
    if (jt < it) {
      const int j1 = (jt + 1) * kRows;
      load_bc<NK>(sB + (st ^ 1) * kRows * kLdB, Bb, n, c0, j1, chunk, l, vec,
                  tid);
      load_x<P>(sX + (st ^ 1) * kRows * kLdX, xb, xs, c0, j1, chunk, l, tid);
      load_f32_64(sSegJ + (st ^ 1) * kRows, seg + j1, tid);
      load_f32_64(sDtJ + (st ^ 1) * kRows, dtw + j1, tid);
      cp_async_commit();
      cp_async_wait<1>();                // group jt (and the row data) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (jt == 0) {
      // C_i's fragments, kept for every key tile; the inter-chunk term
      // (C_i exp(seg_i))_bf16 . prior^T
      si[0] = sSegI[wr + g];
      si[1] = sSegI[wr + g + 8];
      const float e0 = expf(si[0]);
      const float e1 = expf(si[1]);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        ldsm_x4(cf[ks], sC + (wr + lane % 16) * kLdB + ks * 16
                            + (lane / 16) * 8);
        const uint32_t cd[4] = {scale_bf16x2(cf[ks][0], e0),
                                scale_bf16x2(cf[ks][1], e1),
                                scale_bf16x2(cf[ks][2], e0),
                                scale_bf16x2(cf[ks][3], e1)};
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, sPrior + (np * 16 + lane % 8 + (lane / 16) * 8) * kLdB
                             + ks * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(o[2 * np], cd, b[0], b[1]);
          mma_bf16(o[2 * np + 1], cd, b[2], b[3]);
        }
      }
    }
    const bf16* tB = sB + st * kRows * kLdB;
    const bf16* tX = sX + st * kRows * kLdX;
    const float* tSeg = sSegJ + st * kRows;
    const float* tDt = sDtJ + st * kRows;
    const bool diag = jt == it;
    // on the diagonal tile, key steps past the warp's last row add nothing
    const int ksteps = diag ? warp + 1 : kRows / 16;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      if (kk < ksteps) {
        // G = C_i . B_j^T for 16 keys (two n-tiles)
        float gacc[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[f][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t b[4];
          ldsm_x4(b, tB + (kk * 16 + lane % 8 + (lane / 16) * 8) * kLdB
                         + ks * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(gacc[0], cf[ks], b[0], b[1]);
          mma_bf16(gacc[1], cf[ks], b[2], b[3]);
        }
        // att = G exp(seg_i - seg_j) dt_j, a select on the diagonal tile,
        // rounded to bf16 as the A operand of att . x_j
        uint32_t a[4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kk * 16 + f * 8 + 2 * t4 + (e & 1);
            const int i = wr + g + (e >> 1) * 8;
            float att = 0.0f;
            if (!diag || j <= i)
              att = __fmul_rn(__fmul_rn(gacc[f][e],
                                        expf(si[e >> 1] - tSeg[j])),
                              tDt[j]);
            v[e] = att;
          }
          a[2 * f] = pack_bf16(v[0], v[1]);
          a[2 * f + 1] = pack_bf16(v[2], v[3]);
        }
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, tX + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                   * kLdX + dp * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();            // stage st is read before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + wr + g + 8 * r;
    if (i >= chunk || c0 + i >= l) continue;
    bf16* yrow = y + (static_cast<int64_t>(bi) * l + c0 + i) * xs
                 + static_cast<int64_t>(hi) * P;
#pragma unroll
    for (int nt = 0; nt < kPTiles; ++nt)
      *reinterpret_cast<uint32_t*>(yrow + nt * 8 + 2 * t4) =
          pack_bf16(o[nt][2 * r], o[nt][2 * r + 1]);
  }
}

struct MmaArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const float* init;
  bf16* y;
  bf16* state;
  bf16* prior;            // null: the priors stay in the workspace
  void* workspace;
  int b, l, h, p, n, chunk;
  cudaStream_t stream;
};

template <int P, int NK>
int launch_mma(const MmaArgs& a) {
  Workspace ws;
  workspace_layout(a.b, a.l, a.h, a.p, a.n, a.chunk, a.workspace, &ws);
  if (a.prior != nullptr) ws.prior = a.prior;
  const int nc = (a.l + a.chunk - 1) / a.chunk;
  const int n_rt = (a.chunk + kRows - 1) / kRows;
  const int smem_a = state_smem_bytes<P, NK>(a.chunk);
  constexpr int kSmemC = out_smem_bytes<P, NK>();
  auto state_k = ssd_scan_state_kernel<P, NK>;
  auto out_k = ssd_scan_out_kernel<P, NK>;
  cudaError_t err = cudaFuncSetAttribute(
      state_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      out_k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemC);
  if (err != cudaSuccess) return static_cast<int>(err);
  state_k<<<dim3(nc, a.h, a.b), kMmaThreads, smem_a, a.stream>>>(
      a.x, a.dt, a.A, a.B, ws, a.l, a.h, a.n, a.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_pass_kernel<<<dim3(a.b * a.h,
                              (P * NK + kPassThreads - 1) / kPassThreads),
                         kPassThreads, 0, a.stream>>>(
      ws, a.init, a.state, P, a.n, NK, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  out_k<<<dim3(n_rt * nc, a.h, a.b), kMmaThreads, kSmemC, a.stream>>>(
      a.x, a.B, a.C, ws, a.y, a.l, a.h, a.n, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_mma_nk(const MmaArgs& a) {
  switch (nk_for(a.n)) {
    case 16: return launch_mma<P, 16>(a);
    case 32: return launch_mma<P, 32>(a);
    case 64: return launch_mma<P, 64>(a);
    default: return launch_mma<P, 128>(a);
  }
}

template <int P>
int mma_smem_nk(int n, int chunk) {
  switch (nk_for(n)) {
    case 16:
      return std::max(state_smem_bytes<P, 16>(chunk),
                      out_smem_bytes<P, 16>());
    case 32:
      return std::max(state_smem_bytes<P, 32>(chunk),
                      out_smem_bytes<P, 32>());
    case 64:
      return std::max(state_smem_bytes<P, 64>(chunk),
                      out_smem_bytes<P, 64>());
    default:
      return std::max(state_smem_bytes<P, 128>(chunk),
                      out_smem_bytes<P, 128>());
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int simt_launch(const void* x, const float* dt, const float* A,
                const void* B, const void* C, const float* init, void* y,
                void* state, void* prior, int b, int l, int h, int p, int n,
                int chunk, int dtype, cudaStream_t s) {
  if (b <= 0 || l <= 0 || h <= 0 || n <= 0 || n > kMaxN || chunk <= 0 ||
      chunk > l || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_p<float>(p, x, dt, A, B, C, init, y, state, prior, b, l, h,
                           n, chunk, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(p, x, dt, A, B, C, init, y, state, prior,
                                   b, l, h, n, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int mma_launch(const void* x, const float* dt, const float* A, const void* B,
               const void* C, const float* init, void* y, void* state,
               void* prior, void* workspace, int b, int l, int h, int p,
               int n, int chunk, cudaStream_t stream) {
  if (b <= 0 || l <= 0 || h <= 0 || n <= 0 || n > kMaxN || chunk <= 0 ||
      chunk > l || b > 65535 || h > 65535 ||
      static_cast<int64_t>(b) * h > INT_MAX || !aligned16(x) ||
      !aligned16(B) || !aligned16(C) ||
      (reinterpret_cast<uintptr_t>(workspace) & 255u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaArgs a{static_cast<const bf16*>(x), dt, A,
                  static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                  init, static_cast<bf16*>(y), static_cast<bf16*>(state),
                  static_cast<bf16*>(prior), workspace, b, l, h, p, n, chunk,
                  stream};
  switch (p) {
    case 16: return launch_mma_nk<16>(a);
    case 32: return launch_mma_nk<32>(a);
    case 64: return launch_mma_nk<64>(a);
    case 128: return launch_mma_nk<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the scan on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take). x and y
// are (b, l, h, p) and B, C (b, l, n) of one type (dtype 0 f32, 1 bf16); dt
// (b, l, h) and A (h,) f32; init (b, h, p, n) f32 or null; state (b, h, p,
// n) of x's type. All contiguous device memory. p is 16, 32, 64 or 128;
// n is at most 128; 1 <= chunk <= l.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* B, const void* C,
                               const float* init, void* y, void* state, int b,
                               int l, int h, int p, int n, int chunk,
                               int dtype, void* stream) {
  return simt_launch(x, dt, A, B, C, init, y, state, nullptr, b, l, h, p, n,
                     chunk, dtype, static_cast<cudaStream_t>(stream));
}

// The same, also writing the state entering each chunk to prior (b, h, nc,
// p, n) of x's type, nc = ceil(l / chunk): what the backward reads.
extern "C" int ssd_scan_priors_launch(const void* x, const float* dt,
                                      const float* A, const void* B,
                                      const void* C, const float* init,
                                      void* y, void* state, void* prior,
                                      int b, int l, int h, int p, int n,
                                      int chunk, int dtype, void* stream) {
  return simt_launch(x, dt, A, B, C, init, y, state, prior, b, l, h, p, n,
                     chunk, dtype, static_cast<cudaStream_t>(stream));
}

// The most shared memory (bytes) one launch needs at these sizes, so the
// wrapper can refuse a shape before it launches.
extern "C" int ssd_scan_smem_bytes(int p, int n, int chunk) {
  switch (p) {
    case 16: return smem_floats<16>(n, chunk) * 4;
    case 32: return smem_floats<32>(n, chunk) * 4;
    case 64: return smem_floats<64>(n, chunk) * 4;
    case 128: return smem_floats<128>(n, chunk) * 4;
    default: return -1;
  }
}

// The tensor-core passes: the same arguments, bf16 only, and a workspace of
// ssd_scan_mma_workspace_bytes() bytes, 256-byte aligned. x, B and C must be
// 16-byte aligned. Returns cudaErrorInvalidValue for arguments the kernels
// do not take.
extern "C" int ssd_scan_mma_launch(const void* x, const float* dt,
                                   const float* A, const void* B,
                                   const void* C, const float* init, void* y,
                                   void* state, void* workspace, int b, int l,
                                   int h, int p, int n, int chunk,
                                   void* stream) {
  return mma_launch(x, dt, A, B, C, init, y, state, nullptr, workspace, b, l,
                    h, p, n, chunk, static_cast<cudaStream_t>(stream));
}

// The same, with the state entering each chunk (rounded to bf16, as pass (c)
// reads it) written to prior, (b, h, nc, p, nk) bf16 with nk = n padded to
// 16, 32, 64 or 128 (zeros past n): what the backward reads.
extern "C" int ssd_scan_mma_priors_launch(const void* x, const float* dt,
                                          const float* A, const void* B,
                                          const void* C, const float* init,
                                          void* y, void* state, void* prior,
                                          void* workspace, int b, int l,
                                          int h, int p, int n, int chunk,
                                          void* stream) {
  return mma_launch(x, dt, A, B, C, init, y, state, prior, workspace, b, l,
                    h, p, n, chunk, static_cast<cudaStream_t>(stream));
}

// The padded state width of the tensor-core passes' priors (nk).
extern "C" int ssd_scan_mma_prior_width(int n) { return nk_for(n); }

// Bytes of the tensor-core passes' workspace at these sizes.
extern "C" long long ssd_scan_mma_workspace_bytes(int b, int l, int h, int p,
                                                  int n, int chunk) {
  return workspace_layout(b, l, h, p, n, chunk, nullptr, nullptr);
}

// The most shared memory (bytes) one of the tensor-core passes needs.
extern "C" int ssd_scan_mma_smem_bytes(int p, int n, int chunk) {
  switch (p) {
    case 16: return mma_smem_nk<16>(n, chunk);
    case 32: return mma_smem_nk<32>(n, chunk);
    case 64: return mma_smem_nk<64>(n, chunk);
    case 128: return mma_smem_nk<128>(n, chunk);
    default: return -1;
  }
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
