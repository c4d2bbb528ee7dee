// Backward of the Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces XLA's autodiff of src/repro/models/ssm.py :: ssd_chunked (no
// Pallas kernel has a custom_vjp; the TPU forward is
// src/repro/kernels/ssd_scan/kernel.py :: ssd_scan_pallas). Per (b, h) and
// chunk c of Q positions, with the forward's terms (csrc/ssd_scan.cu):
// seg the within-chunk cumsum of dt * A (dt 0 past l), G_qk = C_q . B_k,
// dec_qk = exp(seg_q - seg_k) for k <= q (a select: exp overflows above the
// diagonal at strong decay), att = G dec dt_k, Cd_q = C_q exp(seg_q),
// w_k = dt_k exp(seg_last - seg_k), prior_c the state entering chunk c (as
// the forward wrote it) and dS_c the gradient of the state leaving it:
//
//   dS_{c-1} = exp(seg_last_c) dS_c + sum_q dy_q^T Cd_q   (the last: dinit)
//   dP_qk    = dy_q . x_k
//   dx_k     = sum_{q>=k} att_qk dy_q + w_k dS_c B_k
//   dC_q     = sum_{k<=q} dP dec dt_k B_k + (dy_q prior_c) exp(seg_q)
//   dB_k     = sum_{q>=k} dP dec dt_k C_q + (x_k w_k) dS_c
//   ddt_k    = sum_q dP G dec + (dS_c B_k . x_k) exp(seg_last - seg_k)
//   dseg     from att (+ on the row, - on the key), Cd, w and the chunk
//            decay (on seg_last, the chunk's last, possibly padded,
//            position); its within-chunk reverse cumsum is d(dt A), so
//            ddt += A d(dt A) and dA_h = sum dt d(dt A).
//
// B and C are shared by the heads (ngroups 1) and A by the batch, so dB, dC
// and dA are sums over h (and b and the chunks for dA). Nothing is summed
// with atomics: each block writes its own per-head partials to the
// workspace and a second kernel sums them in a fixed order, so two launches
// are bit-identical. att, x w, Cd and the prior are rounded to x's type
// where the plain version rounds them (bf16); every sum is f32. expf, no
// fast-math, no -ftz.
//
// Six kernels, one after the other on the stream (the workspace, allocated
// by the wrapper, carries what one leaves for the next):
//  1. ssd_bwd_chunk_kernel, per (chunk, h, b): seg by one thread, then
//     U_c = sum_q dy_q^T Cd_q (p x n) over 64-position tiles;
//  2. ssd_bwd_walk_kernel, per (b h, 256 state elements): the only serial
//     part, the reverse walk over the chunks, dS_c written over U_c, and
//     per chunk exp(seg_last) sum(dS_c prior_c), the chunk decay's term;
//  3. ssd_bwd_tile_kernel, per (64-position tile t, chunk, h, b): as rows,
//     dC of tile t (key tiles j <= t, then the inter term); as keys, dx and
//     dB of tile t (row tiles i >= t, then the state terms): every block
//     visits n_tiles + 1 tile pairs. Each pair forms G and dP in registers
//     (thread (ty, tx) of 16 x 16 holds rows ty + 16a, columns tx + 16c),
//     puts att and dG in shared memory and accumulates the products from
//     there. It writes dx, the per-head dB / dC partials and per position
//     dseg, the direct ddt and the seg_last terms;
//  4. ssd_bwd_dt_kernel, per (chunk, h, b): the reverse cumsum of dseg,
//     ddt, and the chunk's dA partial;
//  5. ssd_bwd_reduce_kernel: dB and dC summed over h in order;
//  6. ssd_bwd_da_kernel: dA summed over b and the chunks in order.
//
// What bounds it on an H100: at mamba2-2.7b's training shape (b 2, l 4096,
// h 80, p 64, n 128, chunk 256) the counted work is ~2 Q^2 p + 3 Q^2 n +
// 4 Q p n MACs per head and chunk (~0.2 ms at the bf16 tensor-core rate)
// against ~0.35 GB of reads and writes. This first kernel runs on the CUDA
// cores in f32 for both dtypes (TF32 would miss the f32 gradient check) and
// forms G and dP twice (once as rows, once as keys) and per head: it is
// bound by its own shared-memory traffic and FMA rate, many times the
// bound. The tensor-core redesign on the forward's pass structure, with G
// formed once per (b, chunk) for all heads, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 64;        // positions per row / key tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLdT = kTile + 1;  // 64 x 64 tiles in shared memory
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 128;

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
  // v rounded to bf16 and widened again: the plain version's rounding point
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline int n_groups(int n) { return (n + 15) / 16; }

// The workspace of one call, carved from one allocation (all f32): seg
// (bh, nc, Q); exp(seg_last) (bh, nc); U_c then dS_c (bh, nc, p, n); the
// chunk decay's term (bh, walk blocks, nc); per position dseg, the direct
// ddt and the seg_last terms (bh, nc, Q) each; the chunks' dA (bh, nc); the
// per-head dB and dC (b, l, h, n) each.
struct Workspace {
  float* seg;
  float* decay;
  float* dS;
  float* dlast_state;
  float* dseg;
  float* ddt;
  float* dlast;
  float* dA;
  float* dB;
  float* dC;
};

inline int walk_blocks(int p, int n) {
  return (p * n + kThreads - 1) / kThreads;
}

inline int64_t workspace_layout(int b, int l, int h, int p, int n, int chunk,
                                void* base, Workspace* ws) {
  const int64_t bh = static_cast<int64_t>(b) * h;
  const int64_t nc = (l + chunk - 1) / chunk;
  const int64_t blhn = static_cast<int64_t>(b) * l * h * n;
  const int64_t sizes[10] = {bh * nc * chunk, bh * nc,
                             bh * nc * p * n, bh * walk_blocks(p, n) * nc,
                             bh * nc * chunk, bh * nc * chunk,
                             bh * nc * chunk, bh * nc, blhn, blhn};
  float** slots[10] = {nullptr};
  if (ws != nullptr) {
    float** s[10] = {&ws->seg, &ws->decay, &ws->dS, &ws->dlast_state,
                     &ws->dseg, &ws->ddt, &ws->dlast, &ws->dA, &ws->dB,
                     &ws->dC};
    for (int i = 0; i < 10; ++i) slots[i] = s[i];
  }
  int64_t off = 0;
  for (int i = 0; i < 10; ++i) {
    if (slots[i] != nullptr)
      *slots[i] = reinterpret_cast<float*>(static_cast<char*>(base) + off);
    off += (sizes[i] * 4 + 255) / 256 * 256;
  }
  return off;
}

// Rows [r0, r0 + 64) of the chunk starting at position c0 of a (l, width)
// slab whose positions are `stride` elements apart, as f32 rows of `ld`
// floats; columns [width, wpad) and rows at or past the chunk or l are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int width,
                                          int wpad, int c0, int r0,
                                          int chunk, int l, int tid) {
  for (int idx = tid; idx < kTile * wpad; idx += kThreads) {
    const int r = idx / wpad;
    const int c = idx % wpad;
    const int i = r0 + r;
    const int pos = c0 + i;
    dst[r * ld + c] = (c < width && i < chunk && pos < l)
                          ? Num<T>::to_f32(src[pos * stride + c])
                          : 0.0f;
  }
}

// acc[a][e] += sum_{k < K} opA(ty + 16 a, k) * opB(k, tx + 16 e), with
// opA(r, k) = TA ? A[k lda + r] : A[r lda + k] and
// opB(k, c) = TB ? Bm[c ldb + k] : Bm[k ldb + c]. The leading dims are odd
// where a warp reads 16 rows at once, so the reads are conflict-free.
template <int MA, int NE, bool TA, bool TB>
__device__ __forceinline__ void mm(float (&acc)[MA][NE], const float* A,
                                   int lda, const float* Bm, int ldb, int K,
                                   int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[MA], bv[NE];
#pragma unroll
    for (int a = 0; a < MA; ++a)
      av[a] = TA ? A[k * lda + ty + 16 * a] : A[(ty + 16 * a) * lda + k];
#pragma unroll
    for (int e = 0; e < NE; ++e)
      bv[e] = TB ? Bm[(tx + 16 * e) * ldb + k] : Bm[k * ldb + tx + 16 * e];
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[a][e] = fmaf(av[a], bv[e], acc[a][e]);
  }
}

template <int MA, int NE>
__device__ __forceinline__ void zero(float (&acc)[MA][NE]) {
#pragma unroll
  for (int a = 0; a < MA; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[a][e] = 0.0f;
}

// The sum over the 16 lanes of a half-warp (threads tx = 0..15 of one ty),
// in a fixed order; every lane gets it.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int P, int NE>
int chunk_smem_floats(int chunk) {
  return 2 * round_up(chunk, kTile) + kTile * (P + 1)
         + kTile * (16 * NE + 1);
}

template <int P, int NE>
int tile_smem_floats(int chunk) {
  return 2 * round_up(chunk, kTile) + 3 * kTile + 2 * 16 * kTile
         + 2 * kTile * (P + 1) + 2 * kTile * (16 * NE + 1)
         + 2 * kTile * kLdT;
}

// 1. Per (chunk, h, b): seg, exp(seg_last) and U_c = sum_q dy_q^T Cd_q.
template <typename T, int P, int NE>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ C,
                     const T* __restrict__ dy, Workspace ws, int l, int h,
                     int n, int chunk) {
  constexpr int NW = 16 * NE;
  constexpr int kLdP = P + 1;
  constexpr int kLdN = NW + 1;
  constexpr int MP = P / 16;
  extern __shared__ float smem[];
  const int qp = round_up(chunk, kTile);
  float* sDt = smem;
  float* sSeg = sDt + qp;
  float* sDy = sSeg + qp;                 // (64, P + 1)
  float* sCd = sDy + kTile * kLdP;        // (64, NW + 1)

  const int ci = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int c0 = ci * chunk;
  const int64_t cix = (static_cast<int64_t>(bi) * h + hi) * nc + ci;
  const float a_h = A[hi];

  for (int t = tid; t < chunk; t += kThreads)
    sDt[t] = c0 + t < l ? dt[(static_cast<int64_t>(bi) * l + c0 + t) * h + hi]
                        : 0.0f;
  __syncthreads();
  if (tid == 0) {
    float run = 0.0f;
    for (int t = 0; t < chunk; ++t) {
      run = __fadd_rn(run, __fmul_rn(sDt[t], a_h));
      sSeg[t] = run;
    }
    ws.decay[cix] = expf(run);
  }
  __syncthreads();
  for (int t = tid; t < chunk; t += kThreads) ws.seg[cix * chunk + t] = sSeg[t];

  const int64_t xs = static_cast<int64_t>(h) * P;
  const T* dyb = dy + (static_cast<int64_t>(bi) * l * h + hi) * P;
  const T* Cb = C + static_cast<int64_t>(bi) * l * n;
  float u[MP][NE];
  zero(u);
  for (int r0 = 0; r0 < chunk; r0 += kTile) {
    __syncthreads();            // the previous tile is read
    load_tile<T>(sDy, kLdP, dyb, xs, P, P, c0, r0, chunk, l, tid);
    load_tile<T>(sCd, kLdN, Cb, n, n, NW, c0, r0, chunk, l, tid);
    __syncthreads();
    // Cd = C exp(seg), rounded to x's type
    for (int idx = tid; idx < kTile * NW; idx += kThreads) {
      const int r = idx / NW;
      const int i = r0 + r;
      if (i < chunk) {
        float* v = sCd + r * kLdN + idx % NW;
        *v = Num<T>::round(*v * expf(sSeg[i]));
      }
    }
    __syncthreads();
    mm<MP, NE, true, false>(u, sDy, kLdP, sCd, kLdN, kTile, ty, tx);
  }
  float* U = ws.dS + cix * P * n;
#pragma unroll
  for (int a = 0; a < MP; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int k = tx + 16 * e;
      if (k < n) U[(ty + 16 * a) * n + k] = u[a][e];
    }
}

// 2. Per (b h, 256 of the p x n state elements): the reverse walk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_walk_kernel(const T* __restrict__ prior, int prior_ld,
                    const float* __restrict__ dstate, float* __restrict__ dinit,
                    Workspace ws, int p, int n, int nc) {
  extern __shared__ float sPart[];        // (nc, warps)
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int idx = blockIdx.y * kThreads + tid;
  const bool valid = idx < p * n;
  const int pi = valid ? idx / n : 0;
  const int k = valid ? idx % n : 0;
  const int64_t step = static_cast<int64_t>(p) * n;
  float cur = (valid && dstate != nullptr) ? dstate[bh * step + idx] : 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t cix = bh * nc + c;
    float u = 0.0f;
    float pr = 0.0f;
    if (valid) {
      u = ws.dS[cix * step + idx];
      ws.dS[cix * step + idx] = cur;      // dS_c over U_c
      pr = Num<T>::to_f32(prior[(cix * p + pi) * prior_ld + k]);
    }
    float part = cur * pr;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tid % 32 == 0) sPart[c * kWarps + tid / 32] = part;
    cur = __fadd_rn(__fmul_rn(ws.decay[cix], cur), u);
  }
  if (valid && dinit != nullptr) dinit[bh * step + idx] = cur;
  __syncthreads();
  for (int c = tid; c < nc; c += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += sPart[c * kWarps + w];
    ws.dlast_state[(bh * gridDim.y + blockIdx.y) * nc + c] =
        ws.decay[bh * nc + c] * s;
  }
}

// 3. Per (64-position tile t, chunk, h, b): dC of the tile's rows; dx, dB
// and the per-position dseg / ddt / seg_last terms of its keys.
template <typename T, int P, int NE>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_tile_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ B, const T* __restrict__ C,
                    const T* __restrict__ prior, int prior_ld,
                    const T* __restrict__ dy, T* __restrict__ dx, Workspace ws,
                    int l, int h, int n, int chunk) {
  constexpr int NW = 16 * NE;
  constexpr int kLdP = P + 1;
  constexpr int kLdN = NW + 1;
  constexpr int MP = P / 16;
  extern __shared__ float smem[];
  const int qp = round_up(chunk, kTile);
  float* sSeg = smem;                     // qp
  float* sDt = sSeg + qp;                 // qp
  float* sRow = sDt + qp;                 // 64: the rows' dseg
  float* sKey = sRow + kTile;             // 2 x 64: the keys' state terms
  float* sRed = sKey + 2 * kTile;         // 2 x (16, 64): column partials
  float* sDy = sRed + 2 * 16 * kTile;     // (64, P + 1)
  float* sC = sDy + kTile * kLdP;         // (64, NW + 1)
  float* sAtt = sC + kTile * kLdN;        // (64, 65)
  float* sDG = sAtt + kTile * kLdT;       // (64, 65)
  float* sX = sDG + kTile * kLdT;         // (64, P + 1)
  float* sB = sX + kTile * kLdP;          // (64, NW + 1)
  float* sPrior = sAtt;   // (P, NW + 1) after the row loop, over sAtt..sB
  float* sDS = sDy;       // (P, NW + 1) after the key loop, over sDy..sDG

  const int n_rt = (chunk + kTile - 1) / kTile;
  const int nc = (l + chunk - 1) / chunk;
  const int ci = blockIdx.x / n_rt;
  const int t = blockIdx.x % n_rt;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int c0 = ci * chunk;
  const int t0 = t * kTile;
  const int64_t cix = (static_cast<int64_t>(bi) * h + hi) * nc + ci;
  const int64_t xs = static_cast<int64_t>(h) * P;
  const int64_t xoff = (static_cast<int64_t>(bi) * l * h + hi) * P;
  const T* xb = x + xoff;
  const T* dyb = dy + xoff;
  const T* Bb = B + static_cast<int64_t>(bi) * l * n;
  const T* Cb = C + static_cast<int64_t>(bi) * l * n;
  const float* seg = ws.seg + cix * chunk;
  const float seg_last = seg[chunk - 1];

  for (int i = tid; i < qp; i += kThreads) {
    sSeg[i] = i < chunk ? seg[i] : seg_last;
    sDt[i] = (i < chunk && c0 + i < l)
                 ? dt[(static_cast<int64_t>(bi) * l + c0 + i) * h + hi]
                 : 0.0f;
  }

  // ---- as rows: dC_q over the key tiles j <= t, then the inter term ----
  load_tile<T>(sDy, kLdP, dyb, xs, P, P, c0, t0, chunk, l, tid);
  load_tile<T>(sC, kLdN, Cb, n, n, NW, c0, t0, chunk, l, tid);
  float dc[4][NE];
  zero(dc);
  float rdseg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j <= t; ++j) {
    const int j0 = j * kTile;
    __syncthreads();            // the previous key tile and sDG are read
    load_tile<T>(sX, kLdP, xb, xs, P, P, c0, j0, chunk, l, tid);
    load_tile<T>(sB, kLdN, Bb, n, n, NW, c0, j0, chunk, l, tid);
    __syncthreads();
    float g[4][4], dp[4][4];
    zero(g);
    zero(dp);
    mm<4, 4, false, true>(g, sC, kLdN, sB, kLdN, n, ty, tx);
    mm<4, 4, false, true>(dp, sDy, kLdP, sX, kLdP, P, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = t0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = j0 + tx + 16 * c;
        float dg = 0.0f;
        if (qi < chunk && kj <= qi) {     // a select, not a product
          const float dec = expf(sSeg[qi] - sSeg[kj]);
          dg = dp[a][c] * dec * sDt[kj];
          rdseg[a] += dp[a][c] * (g[a][c] * dec * sDt[kj]);
        }
        sDG[(ty + 16 * a) * kLdT + tx + 16 * c] = dg;
      }
    }
    __syncthreads();
    mm<4, NE, false, false>(dc, sDG, kLdT, sB, kLdN, kTile, ty, tx);
  }
  __syncthreads();              // sDG, sX and sB are read
  const T* pr = prior + cix * P * prior_ld;
  for (int idx = tid; idx < P * NW; idx += kThreads) {
    const int r = idx / NW;
    const int c = idx % NW;
    sPrior[r * kLdN + c] = c < n ? Num<T>::to_f32(pr[r * prior_ld + c])
                                 : 0.0f;
  }
  __syncthreads();
  {
    float dcd[4][NE];
    zero(dcd);
    mm<4, NE, false, false>(dcd, sDy, kLdP, sPrior, kLdN, P, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = t0 + ty + 16 * a;
      const float es = qi < chunk ? expf(sSeg[qi]) : 0.0f;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        dc[a][e] = fmaf(dcd[a][e], es, dc[a][e]);
        rdseg[a] += dcd[a][e] * sC[(ty + 16 * a) * kLdN + tx + 16 * e] * es;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float v = sum16(rdseg[a]);
    if (tx == 0) sRow[ty + 16 * a] = v;
    const int qi = t0 + ty + 16 * a;
    const int pos = c0 + qi;
    if (qi < chunk && pos < l) {
      float* out = ws.dC + ((static_cast<int64_t>(bi) * l + pos) * h + hi) * n;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (tx + 16 * e < n) out[tx + 16 * e] = dc[a][e];
    }
  }

  // ---- as keys: dx_k and dB_k over the row tiles i >= t ----
  __syncthreads();              // sPrior and sDy are read
  load_tile<T>(sX, kLdP, xb, xs, P, P, c0, t0, chunk, l, tid);
  load_tile<T>(sB, kLdN, Bb, n, n, NW, c0, t0, chunk, l, tid);
  float dxa[4][MP], dba[4][NE];
  zero(dxa);
  zero(dba);
  float cddt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cdseg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = t; i < n_rt; ++i) {
    const int i0 = i * kTile;
    __syncthreads();            // the previous row tile, sAtt and sDG read
    load_tile<T>(sDy, kLdP, dyb, xs, P, P, c0, i0, chunk, l, tid);
    load_tile<T>(sC, kLdN, Cb, n, n, NW, c0, i0, chunk, l, tid);
    __syncthreads();
    float g[4][4], dp[4][4];
    zero(g);
    zero(dp);
    mm<4, 4, false, true>(g, sC, kLdN, sB, kLdN, n, ty, tx);
    mm<4, 4, false, true>(dp, sDy, kLdP, sX, kLdP, P, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = i0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = t0 + tx + 16 * c;
        float at = 0.0f;
        float dg = 0.0f;
        if (qi < chunk && kj <= qi) {
          const float dec = expf(sSeg[qi] - sSeg[kj]);
          const float attf = g[a][c] * dec * sDt[kj];
          at = Num<T>::round(attf);
          dg = dp[a][c] * dec * sDt[kj];
          cddt[c] += dp[a][c] * g[a][c] * dec;
          cdseg[c] -= dp[a][c] * attf;
        }
        sAtt[(ty + 16 * a) * kLdT + tx + 16 * c] = at;
        sDG[(ty + 16 * a) * kLdT + tx + 16 * c] = dg;
      }
    }
    __syncthreads();
    mm<4, MP, true, false>(dxa, sAtt, kLdT, sDy, kLdP, kTile, ty, tx);
    mm<4, NE, true, false>(dba, sDG, kLdT, sC, kLdN, kTile, ty, tx);
  }

  // ---- the state leaving the chunk: w_k dS_c B_k into dx, (x w) dS_c
  // into dB, and through w the keys' ddt, dseg and seg_last terms ----
  __syncthreads();              // sDy, sC, sAtt and sDG are read
  const float* dSg = ws.dS + cix * P * n;
  for (int idx = tid; idx < P * NW; idx += kThreads) {
    const int r = idx / NW;
    const int c = idx % NW;
    sDS[r * kLdN + c] = c < n ? dSg[r * n + c] : 0.0f;
  }
  for (int c = 0; c < 4; ++c) {
    sRed[ty * kTile + tx + 16 * c] = cddt[c];
    sRed[16 * kTile + ty * kTile + tx + 16 * c] = cdseg[c];
  }
  __syncthreads();
  float dwx[4][MP];
  zero(dwx);
  mm<4, MP, false, true>(dwx, sB, kLdN, sDS, kLdN, n, ty, tx);
  float wk[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = t0 + ty + 16 * a;
    const float e_end = kj < chunk ? expf(seg_last - sSeg[kj]) : 0.0f;
    const float wf = sDt[kj] * e_end;
    wk[a] = Num<T>::round(wf);
    float dwp = 0.0f;
#pragma unroll
    for (int e = 0; e < MP; ++e) {
      dxa[a][e] = fmaf(dwx[a][e], wk[a], dxa[a][e]);
      dwp += dwx[a][e] * sX[(ty + 16 * a) * kLdP + tx + 16 * e];
    }
    const float dw = sum16(dwp);
    if (tx == 0) {
      sKey[ty + 16 * a] = dw * e_end;                  // into ddt_k
      sKey[kTile + ty + 16 * a] = dw * wf;             // out of seg_k, into
    }                                                  // seg_last
  }
  __syncthreads();              // sX is read for dw
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < MP; ++e) {
      float* v = sX + (ty + 16 * a) * kLdP + tx + 16 * e;
      *v = Num<T>::round(*v * wk[a]);                  // wx = x w
    }
  __syncthreads();
  mm<4, NE, false, false>(dba, sX, kLdP, sDS, kLdN, P, ty, tx);

  if (tid < kTile && t0 + tid < chunk) {
    float s_ddt = 0.0f;
    float s_dseg = 0.0f;
    for (int r = 0; r < 16; ++r) {
      s_ddt += sRed[r * kTile + tid];
      s_dseg += sRed[16 * kTile + r * kTile + tid];
    }
    const int64_t o = cix * chunk + t0 + tid;
    ws.dseg[o] = sRow[tid] + s_dseg - sKey[kTile + tid];
    ws.ddt[o] = s_ddt + sKey[tid];
    ws.dlast[o] = sKey[kTile + tid];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = t0 + ty + 16 * a;
    const int pos = c0 + kj;
    if (kj >= chunk || pos >= l) continue;
    if (dx != nullptr) {
      T* out = dx + xoff + pos * xs;
#pragma unroll
      for (int e = 0; e < MP; ++e)
        out[tx + 16 * e] = Num<T>::from_f32(dxa[a][e]);
    }
    float* outb = ws.dB + ((static_cast<int64_t>(bi) * l + pos) * h + hi) * n;
#pragma unroll
    for (int e = 0; e < NE; ++e)
      if (tx + 16 * e < n) outb[tx + 16 * e] = dba[a][e];
  }
}

// 4. Per (chunk, h, b): dseg's reverse cumsum (the seg_last terms on the
// chunk's last position), ddt and the chunk's dA partial.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ ddt, Workspace ws, int l, int h,
                  int chunk, int walk_blocks) {
  extern __shared__ float sD[];           // (2, chunk)
  float* sT = sD + chunk;
  const int ci = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int c0 = ci * chunk;
  const int64_t bh = static_cast<int64_t>(bi) * h + hi;
  const int64_t cix = bh * nc + ci;
  for (int i = tid; i < chunk; i += kThreads) sD[i] = ws.dseg[cix * chunk + i];
  __syncthreads();
  if (tid == 0) {
    float last = 0.0f;
    for (int i = 0; i < chunk; ++i) last += ws.dlast[cix * chunk + i];
    for (int w = 0; w < walk_blocks; ++w)
      last += ws.dlast_state[(bh * walk_blocks + w) * nc + ci];
    sD[chunk - 1] += last;
    float acc = 0.0f;
    for (int i = chunk - 1; i >= 0; --i) {
      acc += sD[i];
      sD[i] = acc;
    }
  }
  __syncthreads();
  const float a_h = A[hi];
  for (int i = tid; i < chunk; i += kThreads) {
    const int pos = c0 + i;
    float v = 0.0f;
    if (pos < l) {
      const int64_t o = (static_cast<int64_t>(bi) * l + pos) * h + hi;
      if (ddt != nullptr) ddt[o] = ws.ddt[cix * chunk + i] + a_h * sD[i];
      v = dt[o] * sD[i];
    }
    sT[i] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int i = 0; i < chunk; ++i) s += sT[i];
    ws.dA[cix] = s;
  }
}

// 5. dB and dC (b, l, n): the per-head partials summed over h in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(Workspace ws, T* __restrict__ dB, T* __restrict__ dC,
                      int64_t rows, int h, int n) {
  T* out = blockIdx.y == 0 ? dB : dC;
  if (out == nullptr) return;
  const float* part = blockIdx.y == 0 ? ws.dB : ws.dC;
  const int64_t total = rows * n;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = e / n;
    const int k = static_cast<int>(e % n);
    const float* src = part + r * h * n + k;
    float s = 0.0f;
    for (int hh = 0; hh < h; ++hh) s += src[static_cast<int64_t>(hh) * n];
    out[e] = Num<T>::from_f32(s);
  }
}

// 6. dA (h,): the chunks' partials summed over b and the chunks in order.
__global__ void ssd_bwd_da_kernel(Workspace ws, float* __restrict__ dA,
                                  int b, int h, int nc) {
  const int hi = blockIdx.x * blockDim.x + threadIdx.x;
  if (hi >= h) return;
  float s = 0.0f;
  for (int bi = 0; bi < b; ++bi)
    for (int c = 0; c < nc; ++c)
      s += ws.dA[(static_cast<int64_t>(bi) * h + hi) * nc + c];
  dA[hi] = s;
}

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* prior;
  int prior_ld;
  const void* dy;
  const float* dstate;
  void* dx;
  float* ddt;
  float* dA;
  void* dB;
  void* dC;
  float* dinit;
  void* workspace;
  int b, l, h, p, n, chunk;
  cudaStream_t stream;
};

template <int P, int NE>
int smem_bytes_pn(int chunk) {
  const int f = chunk_smem_floats<P, NE>(chunk);
  const int g = tile_smem_floats<P, NE>(chunk);
  return 4 * (f > g ? f : g);
}

inline int dt_smem_bytes(int chunk) { return 2 * chunk * 4; }
inline int walk_smem_bytes(int nc) { return nc * kWarps * 4; }

template <typename T, int P, int NE>
int launch_bwd(const BwdArgs& a) {
  Workspace ws;
  workspace_layout(a.b, a.l, a.h, a.p, a.n, a.chunk, a.workspace, &ws);
  const int nc = (a.l + a.chunk - 1) / a.chunk;
  const int n_rt = (a.chunk + kTile - 1) / kTile;
  const int wb = walk_blocks(P, a.n);
  const int smem1 = chunk_smem_floats<P, NE>(a.chunk) * 4;
  const int smem3 = tile_smem_floats<P, NE>(a.chunk) * 4;
  const int smem2 = walk_smem_bytes(nc);
  const int smem4 = dt_smem_bytes(a.chunk);
  auto k1 = ssd_bwd_chunk_kernel<T, P, NE>;
  auto k2 = ssd_bwd_walk_kernel<T>;
  auto k3 = ssd_bwd_tile_kernel<T, P, NE>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem2)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem3)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_dt_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem4)) != cudaSuccess)
    return static_cast<int>(err);
  const T* x = static_cast<const T*>(a.x);
  const T* B = static_cast<const T*>(a.B);
  const T* C = static_cast<const T*>(a.C);
  const T* dy = static_cast<const T*>(a.dy);
  const T* prior = static_cast<const T*>(a.prior);
  k1<<<dim3(nc, a.h, a.b), kThreads, smem1, a.stream>>>(a.dt, a.A, C, dy, ws,
                                                         a.l, a.h, a.n,
                                                         a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3(a.b * a.h, wb), kThreads, smem2, a.stream>>>(
      prior, a.prior_ld, a.dstate, a.dinit, ws, P, a.n, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k3<<<dim3(n_rt * nc, a.h, a.b), kThreads, smem3, a.stream>>>(
      x, a.dt, B, C, prior, a.prior_ld, dy, static_cast<T*>(a.dx), ws, a.l,
      a.h, a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dt_kernel<<<dim3(nc, a.h, a.b), kThreads, smem4, a.stream>>>(
      a.dt, a.A, a.ddt, ws, a.l, a.h, a.chunk, wb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(a.b) * a.l;
  const int64_t want = (rows * a.n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  ssd_bwd_reduce_kernel<T><<<dim3(blocks, 2), kThreads, 0, a.stream>>>(
      ws, static_cast<T*>(a.dB), static_cast<T*>(a.dC), rows, a.h, a.n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (a.dA != nullptr)
    ssd_bwd_da_kernel<<<(a.h + kThreads - 1) / kThreads, kThreads, 0,
                        a.stream>>>(ws, a.dA, a.b, a.h, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_bwd_n(const BwdArgs& a) {
  switch (n_groups(a.n)) {
    case 1: return launch_bwd<T, P, 1>(a);
    case 2: return launch_bwd<T, P, 2>(a);
    case 3:
    case 4: return launch_bwd<T, P, 4>(a);
    default: return launch_bwd<T, P, 8>(a);
  }
}

template <typename T>
int launch_bwd_p(const BwdArgs& a) {
  switch (a.p) {
    case 16: return launch_bwd_n<T, 16>(a);
    case 32: return launch_bwd_n<T, 32>(a);
    case 64: return launch_bwd_n<T, 64>(a);
    case 128: return launch_bwd_n<T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int P>
int smem_bytes_p(int n, int chunk) {
  switch (n_groups(n)) {
    case 1: return smem_bytes_pn<P, 1>(chunk);
    case 2: return smem_bytes_pn<P, 2>(chunk);
    case 3:
    case 4: return smem_bytes_pn<P, 4>(chunk);
    default: return smem_bytes_pn<P, 8>(chunk);
  }
}

}  // namespace

// Launches the backward on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take). x, dy, dx (b, l, h,
// p) and B, C, dB, dC (b, l, n) are of one type (dtype 0 f32, 1 bf16), as
// is prior, the forward's states entering each chunk, (b, h, nc, p,
// prior_ld) with prior_ld >= n; dt, ddt (b, l, h), A, dA (h,) and dstate,
// dinit (b, h, p, n) are f32. dstate (the final state's gradient) may be
// null (0); dx, ddt, dA, dB, dC and dinit may be null where that gradient
// is not wanted. workspace holds ssd_scan_bwd_workspace_bytes() bytes,
// 256-byte aligned. All contiguous device memory. p is 16, 32, 64 or 128;
// n is at most 128; 1 <= chunk <= l.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* prior, int prior_ld, const void* dy,
    const float* dstate, void* dx, float* ddt, float* dA, void* dB,
    void* dC, float* dinit, void* workspace, int b, int l, int h, int p,
    int n, int chunk, int dtype, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || n <= 0 || n > kMaxN || chunk <= 0 ||
      chunk > l || b > 65535 || h > 65535 || prior_ld < n ||
      static_cast<int64_t>(b) * h > INT_MAX ||
      (reinterpret_cast<uintptr_t>(workspace) & 255u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, dt, A, B, C, prior, prior_ld, dy, dstate, dx, ddt, dA,
                  dB, dC, dinit, workspace, b, l, h, p, n, chunk,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_bwd_p<float>(a);
  if (dtype == 1) return launch_bwd_p<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of the backward's workspace at these sizes.
extern "C" long long ssd_scan_bwd_workspace_bytes(int b, int l, int h, int p,
                                                  int n, int chunk) {
  return workspace_layout(b, l, h, p, n, chunk, nullptr, nullptr);
}

// The most shared memory (bytes) one of the backward's kernels needs at
// these sizes, so the wrapper can refuse a shape before it launches.
extern "C" int ssd_scan_bwd_smem_bytes(int p, int n, int chunk, int l) {
  int m;
  switch (p) {
    case 16: m = smem_bytes_p<16>(n, chunk); break;
    case 32: m = smem_bytes_p<32>(n, chunk); break;
    case 64: m = smem_bytes_p<64>(n, chunk); break;
    case 128: m = smem_bytes_p<128>(n, chunk); break;
    default: return -1;
  }
  const int walk = walk_smem_bytes((l + chunk - 1) / chunk);
  const int dts = dt_smem_bytes(chunk);
  return m > walk ? (m > dts ? m : dts) : (walk > dts ? walk : dts);
}

extern "C" const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
