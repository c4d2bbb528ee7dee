// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py ::
// ssd_scan_pallas (body _ssd_kernel). For x (b, l, h, p), dt (b, l, h) f32,
// A (h,) f32, B and C (b, l, n), and per head a (p, n) state carried across
// chunks of Q positions, everything in f32:
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
// can continue another.
//
// Design: the TPU grid walks the chunk axis in order and keeps the state in
// VMEM. Here one block of 256 threads owns a (b, h) pair -- 200 blocks at
// hymba-1.5b -- and loops over the chunks itself with the state in shared
// memory. The Pallas kernel materialises G = C B^T as a (Q, Q) tile, which
// at Q = 256 in f32 is 256 KB, more than a block may hold; here y is built
// in 64-row tiles: for row tile i and each column tile j <= i, a 64 x 64
// tile of G is formed from C_i and B_j staged in shared memory, masked,
// decayed and scaled by dt into `att`, and att . x_j is accumulated in
// registers (thread (ty, tx) holds rows ty + 16a, columns tx + 16e), on top
// of the inter-chunk term exp(seg_i) C_i . state^T. The state update then
// walks the column tiles once more.
//
// Numerics: exp(seg_i - seg_j) overflows to inf above the diagonal (A reaches
// -50 at hymba, seg about -1000 within a chunk), so the causal mask is a
// select, never a multiply (inf * 0 is NaN). seg is a sequential cumsum in
// position order by one thread, each step dt * A rounded before the sum;
// XLA's cumsum may sum in another order, which the stated tolerance covers.
// expf, not __expf; no fast-math.
//
// What bounds it on an H100: bytes. At hymba-1.5b (b 4, l 4096, h 50, p 64,
// n 16, bf16) a layer's scan reads x (105 MB), dt (3.3 MB), B and C, and
// writes y (105 MB) and the state: ~215 MB, 0.064 ms at 3.35 TB/s, against
// ~2e10 FLOP of chunked products (0.02 ms at the bf16 tensor-core rate).
// This kernel does those products on the CUDA cores from shared memory,
// with only 200 blocks for 132 SMs and the chunks in series, so it sits
// well above the bound; splitting p across blocks and tensor-core products
// are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
                T* __restrict__ y, T* __restrict__ state_out, int l, int h,
                int n, int chunk) {
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
           const void* C, const float* init, void* y, void* state, int b,
           int l, int h, int n, int chunk, cudaStream_t stream) {
  const int smem = smem_floats<P>(n, chunk) * static_cast<int>(sizeof(float));
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_scan_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), init, static_cast<T*>(y),
      static_cast<T*>(state), l, h, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(int p, const void* x, const float* dt, const float* A,
             const void* B, const void* C, const float* init, void* y,
             void* state, int b, int l, int h, int n, int chunk,
             cudaStream_t stream) {
  switch (p) {
    case 16:
      return launch<T, 16>(x, dt, A, B, C, init, y, state, b, l, h, n, chunk,
                           stream);
    case 32:
      return launch<T, 32>(x, dt, A, B, C, init, y, state, b, l, h, n, chunk,
                           stream);
    case 64:
      return launch<T, 64>(x, dt, A, B, C, init, y, state, b, l, h, n, chunk,
                           stream);
    case 128:
      return launch<T, 128>(x, dt, A, B, C, init, y, state, b, l, h, n, chunk,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
  if (b <= 0 || l <= 0 || h <= 0 || n <= 0 || n > kMaxN || chunk <= 0 ||
      chunk > l || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(p, x, dt, A, B, C, init, y, state, b, l, h, n,
                           chunk, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(p, x, dt, A, B, C, init, y, state, b, l,
                                   h, n, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
