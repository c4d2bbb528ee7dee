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
// with atomics: each block writes its own partials to the workspace and a
// later kernel sums them in a fixed order, so two launches are
// bit-identical. att, x w, Cd and the prior are rounded to x's type where
// the plain version rounds them (bf16); every sum is f32. expf, no
// fast-math, no -ftz.
//
// What bounds it on an H100: at mamba2-2.7b's training shape (b 2, l 4096,
// h 80, p 64, n 128, chunk 256) the work the gradient needs is 2 p MACs per
// allowed (row, key) pair (dP, dx) and 4 p n per position for each head,
// and 3 n per pair once per (b, chunk) (G = C B^T, dC = D B, dB = D^T C,
// with D the sum of dG over the heads): ~33 G MACs, ~0.066 ms at the bf16
// tensor-core rate, against ~0.31 GB of reads and writes, ~0.092 ms at
// 3.35 TB/s, so the bytes bound it. Two routes, chosen by dtype in the wrapper
// (kernels/ssd_scan/kernel.py), both launched one kernel after the other on
// the stream, with a workspace the wrapper allocates:
//
// f32 ("simt", and bf16 by name as the yardstick): six kernels on the CUDA
// cores, f32 products (TF32 would miss the f32 gradient check):
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
// It forms G and dP twice (once as rows, once as keys) and per head, and
// writes (b, l, h, n) f32 partials of dB and dC: it is bound by its own
// shared-memory traffic and FMA rate, 40-110x the bound.
//
// bf16 ("mma"): every product is mma.sync m16n8k16 (bf16 in, f32
// accumulate) from 16-byte-padded shared rows read by ldmatrix, n padded
// with zeros to NK = 16, 32, 64 or 128, as in the forward's passes
// (csrc/ssd_scan.cu). It uses that B and C do not depend on the head:
// dC = D B and dB = D^T C with D = sum_h dG_h, so the products with B and
// C run once per head group, not per head. Seven kernels:
//  1. ssd_bwd_chunk_mma_kernel, per (chunk, h, b): seg by a block-wide
//     scan (written padded to whole 64-position tiles with seg_last, and dt
//     with 0), then U_c = dy^T Cd on the tensor cores, Cd rounded to bf16;
//  2. ssd_bwd_walk_kernel, as above, dS_c rounded to bf16 (and not in
//     f32: nothing later reads that);
//  3. ssd_bwd_rows_mma_kernel, per (64-row tile i, chunk, head group, b),
//     4 warps of 16 rows: first, head by head, the chunk-state terms:
//     exp(seg_q) dy_q prior^T into dC (and the rows' dseg), and the
//     group's sum of (x w) dS_c, dB's state term, into a slot of its own;
//     then for each key tile j <= i: G = C_i B_j^T once for the group, and
//     for each head of the group (x_j, dy_i double-buffered by cp.async)
//     dP = dy_i x_j^T, dG = dP exp(seg_q - seg_k) dt_k (a select, never a
//     multiply) summed over the heads into D in registers, and the rows'
//     dseg; then dC += D B_j from registers and, D through shared memory,
//     the group's dB partial of tile j from row tile i, D^T C_i;
//  4. ssd_bwd_keys_mma_kernel, per (64-key tile j, chunk, h, b), 4 warps
//     of 16 keys in the transposed frame: for each row tile i >= j (C_i,
//     dy_i double-buffered), G^T = B_j C_i^T and dP^T = x_j dy_i^T, att^T
//     rounded to bf16 in registers as the A operand of dx += att^T dy_i,
//     and the keys' ddt and dseg sums; then dS_c's terms: dx += w dS_c B_k
//     and, through dw, ddt, dseg and the seg_last term;
//  5. ssd_bwd_dt_kernel, as above, the rows' and keys' dseg added;
//  6. ssd_bwd_reduce_mma_kernel: dB and dC summed over the head groups
//     (and dB over the row tiles and the state slot) in order;
//  7. ssd_bwd_da_kernel, as above.
// Rounding points beyond the plain version's: D (the sum of dG over a head
// group) and dS_c are rounded to bf16 as mma operands.
//
// A third entry point, ssd_scan_bwd_planted_launch, runs either route with
// a fault planted between two of its kernels (ssd_bwd_plant_kernel: the
// chunk decay taken as 1 in the walk, or the last chunk's seg_last
// gradient dropped), so the check on the card can show that each reaches
// the gradients.

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
// per-head dB and dC (b, l, h, n) each. The tensor-core route lays out its
// own (workspace_layout_mma) and fills the fields after dC; they are null
// on the CUDA cores.
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
  float* dt;                    // dt (bh, nc, 64-padded Q), 0 past l
  __nv_bfloat16* dS16;          // dS_c rounded to bf16 (bh, nc, p, n)
  float* dseg_keys;             // the keys' part of dseg (bh, nc, Q)
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
  if (ws != nullptr) {
    ws->dt = nullptr;
    ws->dS16 = nullptr;
    ws->dseg_keys = nullptr;
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

// 2. Per (b h, 256 of the p x n state elements): the reverse walk, dS_c
// written over U_c (on the tensor-core route dS_c in bf16, to its own
// buffer, which is all the later kernels read). The loads of kWalkBatch
// chunks are issued together, each U_c read before dS_c is written.
constexpr int kWalkBatch = 4;

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
  for (int top = nc - 1; top >= 0; top -= kWalkBatch) {
    float u[kWalkBatch], pr[kWalkBatch], dec[kWalkBatch];
#pragma unroll
    for (int q = 0; q < kWalkBatch; ++q) {
      const int c = top - q;
      u[q] = 0.0f;
      pr[q] = 0.0f;
      dec[q] = 0.0f;
      if (c >= 0) {
        const int64_t cix = bh * nc + c;
        dec[q] = ws.decay[cix];
        if (valid) {
          u[q] = ws.dS[cix * step + idx];
          pr[q] = Num<T>::to_f32(prior[(cix * p + pi) * prior_ld + k]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kWalkBatch; ++q) {
      const int c = top - q;
      if (c < 0) break;
      const int64_t cix = bh * nc + c;
      if (valid) {
        if (ws.dS16 != nullptr)
          ws.dS16[cix * step + idx] = __float2bfloat16_rn(cur);
        else
          ws.dS[cix * step + idx] = cur;  // dS_c over U_c
      }
      float part = cur * pr[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (tid % 32 == 0) sPart[c * kWarps + tid / 32] = part;
      cur = __fadd_rn(__fmul_rn(dec[q], cur), u[q]);
    }
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
// chunk's last position), ddt and the chunk's dA partial. On the
// tensor-core route dseg comes in two parts, the rows' and the keys'.
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
  for (int i = tid; i < chunk; i += kThreads)
    sD[i] = ws.dseg_keys == nullptr
                ? ws.dseg[cix * chunk + i]
                : ws.dseg[cix * chunk + i] + ws.dseg_keys[cix * chunk + i];
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                  // positions per row / key tile
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxGroupHeads = 32;         // heads a rows block sums over
// rows blocks wanted in all: eight for each of the 132 SMs of the H100
// 80GB HBM3 (SXM) the kernels are tuned on, so the head groups are made
// smaller where there are few (b, chunk, tile)s (4% faster than four at
// both training shapes, 12% than two; more partial slots for the reduce
// to sum). A constant, not read from the card, on purpose: through
// group_heads it sets where D (the sum of dG over a group) is rounded to
// bf16 and the workspace's size, so a change of it changes the bf16
// gradients' rounding, and the same inputs give the same bits on any card.
constexpr int kTargetBlocks = 8 * 132;

// n padded with zeros to the depth of whole k-steps
__host__ __device__ inline int nk_for(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

// Heads per group of the rows kernel: at most kMaxGroupHeads, and groups
// enough for kTargetBlocks blocks where the heads allow.
inline int group_heads(int b, int l, int h, int chunk) {
  const int64_t tiles = static_cast<int64_t>(b) * ((l + chunk - 1) / chunk)
                        * ((chunk + kRows - 1) / kRows);
  int64_t groups = (kTargetBlocks + tiles - 1) / tiles;
  const int64_t least = (h + kMaxGroupHeads - 1) / kMaxGroupHeads;
  if (groups < least) groups = least;
  if (groups > h) groups = h;
  return static_cast<int>((h + groups - 1) / groups);
}

inline int n_head_groups(int b, int l, int h, int chunk) {
  const int hpg = group_heads(b, l, h, chunk);
  return (h + hpg - 1) / hpg;
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The fragments of one m16n8k16 step, by ldmatrix from shared rows of `ld`
// bf16 elements (lane = threadIdx.x % 32):
// A from rows [r0, r0 + 16), columns [k0, k0 + 16) of a row-major tile;
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int k0, int lane) {
  ldsm_x4(a, s + (r0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}

// A as the transpose of rows [k0, k0 + 16), columns [m0, m0 + 16);
__device__ __forceinline__ void frag_at(uint32_t (&a)[4], const bf16* s,
                                        int ld, int m0, int k0, int lane) {
  ldsm_x4_trans(a, s + (k0 + lane % 8 + (lane / 16) * 8) * ld + m0
                       + ((lane / 8) % 2) * 8);
}

// B of the n-tiles [n0, n0 + 8) (b[0], b[1]) and [n0 + 8, n0 + 16) (b[2],
// b[3]) at depth [k0, k0 + 16), from rows n of an (N x K) tile;
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* s,
                                       int ld, int n0, int k0, int lane) {
  ldsm_x4(b, s + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0
                 + ((lane / 8) % 2) * 8);
}

// and the same from rows k of a (K x N) tile.
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* s,
                                        int ld, int k0, int n0, int lane) {
  ldsm_x4_trans(b, s + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0
                       + (lane / 16) * 8);
}

// Rows [r0, r0 + 64) of the chunk starting at position c0 of an (l, width)
// bf16 slab whose positions are `stride` elements apart, into shared rows
// of W + 8 elements; rows past the chunk or l are zeros. With vec
// (width % 8 == 0) 16-byte cp.async of the width columns (the caller zeroes
// columns [width, W) once); else element by element, columns [width, W)
// zeros.
template <int W>
__device__ __forceinline__ void load_rows16(bf16* dst, const bf16* src,
                                            int64_t stride, int width,
                                            int c0, int r0, int chunk, int l,
                                            bool vec, int tid) {
  constexpr int kLd = W + 8;
  if (vec) {
    const int per_row = width / 8;
    for (int idx = tid; idx < kRows * per_row; idx += kMmaThreads) {
      const int r = idx / per_row;
      const int c = (idx % per_row) * 8;
      const int t = r0 + r;
      const bool ok = t < chunk && c0 + t < l;
      cp_async_16(dst + r * kLd + c,
                  ok ? src + static_cast<int64_t>(c0 + t) * stride + c : src,
                  ok);
    }
  } else {
    for (int idx = tid; idx < kRows * W; idx += kMmaThreads) {
      const int r = idx / W;
      const int c = idx % W;
      const int t = r0 + r;
      dst[r * kLd + c] = (c < width && t < chunk && c0 + t < l)
                             ? src[static_cast<int64_t>(c0 + t) * stride + c]
                             : __float2bfloat16_rn(0.0f);
    }
  }
}

// A (P, n) bf16 matrix whose rows are `ld` elements apart into P shared
// rows of NK + 8 elements: with vec (n % 8 == 0, ld % 8 == 0) by 16-byte
// cp.async of the n columns (the caller zeroes columns [n, NK) once); else
// element by element with columns [n, NK) zeros.
template <int P, int NK>
__device__ __forceinline__ void load_state16(bf16* dst, const bf16* src,
                                             int ld, int n, bool vec,
                                             int tid) {
  constexpr int kLd = NK + 8;
  if (vec) {
    const int per_row = n / 8;
    for (int idx = tid; idx < P * per_row; idx += kMmaThreads) {
      const int r = idx / per_row;
      const int c = (idx % per_row) * 8;
      cp_async_16(dst + r * kLd + c, src + static_cast<int64_t>(r) * ld + c,
                  true);
    }
  } else {
    for (int idx = tid; idx < P * NK; idx += kMmaThreads) {
      const int r = idx / NK;
      const int c = idx % NK;
      dst[r * kLd + c] = c < n ? src[static_cast<int64_t>(r) * ld + c]
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

// 64 floats by cp.async (16 threads).
__device__ __forceinline__ void load_f32_64(float* dst, const float* src,
                                            int tid) {
  if (tid < 16) cp_async_16(dst + 4 * tid, src + 4 * tid, true);
}

// The sum over the 4 lanes of a quad (one fragment row), in a fixed order;
// every lane of the quad gets it.
__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The tensor-core route's workspace, carved from one allocation: seg and dt
// (bh, nc, qt) f32, qt = chunk rounded up to 64 (seg_last and 0 past the
// chunk); exp(seg_last) (bh, nc); U_c then dS_c (bh, nc, p, n) f32 and
// dS_c in bf16; the chunk decay's term (bh, walk blocks, nc); the rows' and
// the keys' dseg, the direct ddt and the seg_last terms (bh, nc, Q) each;
// the chunks' dA (bh, nc); the dB partials (b, l, groups, n_rt + 1, n),
// slot i < n_rt from row tile i and slot n_rt the state term; the dC
// partials (b, l, groups, n). Returns its size in bytes; fills `ws` when
// given.
inline int64_t workspace_layout_mma(int b, int l, int h, int p, int n,
                                    int chunk, void* base, Workspace* ws) {
  const int64_t bh = static_cast<int64_t>(b) * h;
  const int64_t nc = (l + chunk - 1) / chunk;
  const int64_t qt = round_up(chunk, kRows);
  const int64_t n_rt = (chunk + kRows - 1) / kRows;
  const int64_t groups = n_head_groups(b, l, h, chunk);
  const int64_t bl = static_cast<int64_t>(b) * l;
  const int64_t bytes[13] = {
      bh * nc * qt * 4, bh * nc * qt * 4, bh * nc * 4,
      bh * nc * p * n * 4, bh * nc * p * n * 2,
      bh * walk_blocks(p, n) * nc * 4,
      bh * nc * chunk * 4, bh * nc * chunk * 4, bh * nc * chunk * 4,
      bh * nc * chunk * 4, bh * nc * 4,
      bl * groups * (n_rt + 1) * n * 4, bl * groups * n * 4};
  int64_t offs[13];
  int64_t off = 0;
  for (int i = 0; i < 13; ++i) {
    offs[i] = off;
    off += (bytes[i] + 255) / 256 * 256;
  }
  if (ws != nullptr) {
    char* c = static_cast<char*>(base);
    ws->seg = reinterpret_cast<float*>(c + offs[0]);
    ws->dt = reinterpret_cast<float*>(c + offs[1]);
    ws->decay = reinterpret_cast<float*>(c + offs[2]);
    ws->dS = reinterpret_cast<float*>(c + offs[3]);
    ws->dS16 = reinterpret_cast<bf16*>(c + offs[4]);
    ws->dlast_state = reinterpret_cast<float*>(c + offs[5]);
    ws->dseg = reinterpret_cast<float*>(c + offs[6]);
    ws->dseg_keys = reinterpret_cast<float*>(c + offs[7]);
    ws->ddt = reinterpret_cast<float*>(c + offs[8]);
    ws->dlast = reinterpret_cast<float*>(c + offs[9]);
    ws->dA = reinterpret_cast<float*>(c + offs[10]);
    ws->dB = reinterpret_cast<float*>(c + offs[11]);
    ws->dC = reinterpret_cast<float*>(c + offs[12]);
  }
  return off;
}

template <int P, int NK>
int chunk_mma_smem_bytes(int chunk) {
  return kRows * (P + 8 + NK + 8) * 2 + 3 * round_up(chunk, kRows) * 4;
}

// 1. Per (chunk, h, b): seg and dt (padded to whole tiles), exp(seg_last)
// and U_c = sum_q dy_q^T Cd_q with Cd = C exp(seg) rounded to bf16.
template <int P, int NK>
__global__ void __launch_bounds__(kMmaThreads)
ssd_bwd_chunk_mma_kernel(const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ C,
                         const bf16* __restrict__ dy, Workspace ws, int l,
                         int h, int n, int chunk) {
  constexpr int kLdP = P + 8;
  constexpr int kLdN = NK + 8;
  constexpr int kNPairs = NK / 16;             // 16-column pairs of n-tiles
  constexpr int kUnits = (P / 16) * kNPairs;   // 16 x 16 blocks of U
  constexpr int kUnitsPerWarp = (kUnits + kMmaWarps - 1) / kMmaWarps;
  extern __shared__ uint4 smem_u4[];
  __shared__ float sWarpSum[kMmaWarps];
  const int qt = round_up(chunk, kRows);
  bf16* sDy = reinterpret_cast<bf16*>(smem_u4);                // (64, P + 8)
  bf16* sCd = sDy + kRows * kLdP;                              // (64, NK + 8)
  float* sSeg = reinterpret_cast<float*>(sCd + kRows * kLdN);  // qt
  float* sDt = sSeg + qt;                                      // qt
  float* sE = sDt + qt;                                        // exp(seg)

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

  if (vec && n < NK) zero_pad_cols<NK>(sCd, kRows, n, tid);
  for (int t = tid; t < qt; t += kMmaThreads) {
    const int pos = c0 + t;
    const float d = (t < chunk && pos < l)
                        ? dt[(static_cast<int64_t>(bi) * l + pos) * h + hi]
                        : 0.0f;
    sDt[t] = d;
    sSeg[t] = __fmul_rn(d, a_h);
  }
  __syncthreads();

  // inclusive scan of sSeg[0, chunk), as the forward's pass (a) scans it
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

  const float seg_last = sSeg[chunk - 1];
  for (int t = tid; t < qt; t += kMmaThreads) {
    const float sg = t < chunk ? sSeg[t] : seg_last;
    ws.seg[cix * qt + t] = sg;
    ws.dt[cix * qt + t] = sDt[t];
    sE[t] = expf(sg);
  }
  if (tid == 0) ws.decay[cix] = expf(seg_last);

  const int64_t xs = static_cast<int64_t>(h) * P;
  const bf16* dyb = dy + (static_cast<int64_t>(bi) * l * h + hi) * P;
  const bf16* Cb = C + static_cast<int64_t>(bi) * l * n;
  float acc[kUnitsPerWarp][2][4];
#pragma unroll
  for (int u = 0; u < kUnitsPerWarp; ++u)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][f][e] = 0.0f;

  for (int r0 = 0; r0 < chunk; r0 += kRows) {
    __syncthreads();            // sE written; the previous tile is read
    load_rows16<P>(sDy, dyb, xs, P, c0, r0, chunk, l, true, tid);
    load_rows16<NK>(sCd, Cb, n, n, c0, r0, chunk, l, vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // Cd = C exp(seg), rounded to bf16, two elements a step
    for (int idx = tid; idx < kRows * (NK / 2); idx += kMmaThreads) {
      const int r = idx / (NK / 2);
      const int c = (idx % (NK / 2)) * 2;
      uint32_t* v = reinterpret_cast<uint32_t*>(sCd + r * kLdN + c);
      *v = scale_bf16x2(*v, sE[r0 + r]);
    }
    __syncthreads();
    // U += dy^T Cd: A = dy^T (p x positions), B = Cd (positions x nk)
#pragma unroll
    for (int u = 0; u < kUnitsPerWarp; ++u) {
      const int unit = warp + u * kMmaWarps;
      if (unit < kUnits) {
        const int mt = unit / kNPairs;
        const int np = unit % kNPairs;
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          uint32_t a[4], b[4];
          frag_at(a, sDy, kLdP, mt * 16, kk * 16, lane);
          frag_bt(b, sCd, kLdN, kk * 16, np * 16, lane);
          mma_bf16(acc[u][0], a, b[0], b[1]);
          mma_bf16(acc[u][1], a, b[2], b[3]);
        }
      }
    }
  }

  float* U = ws.dS + cix * P * n;
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int u = 0; u < kUnitsPerWarp; ++u) {
    const int unit = warp + u * kMmaWarps;
    if (unit < kUnits) {
      const int mt = unit / kNPairs;
      const int np = unit % kNPairs;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + 8 * (e >> 1);
          const int col = (2 * np + f) * 8 + 2 * t4 + (e & 1);
          if (col < n) U[row * n + col] = acc[u][f][e];
        }
    }
  }
}

template <int P, int NK>
__host__ __device__ constexpr int rows_mid2_bytes() {
  return (2 * kRows * (NK + 8) + 4 * kRows * (P + 8) + kRows * (kRows + 8))
         * 2 + 6 * kRows * 4;
}

template <int P, int NK>
__host__ __device__ constexpr int rows_mid1_bytes() {
  return (2 * P * (NK + 8) + 2 * kRows * (P + 8)) * 2 + 2 * kRows * 4;
}

template <int P, int NK>
__host__ __device__ constexpr int rows_mid_bytes() {
  return rows_mid2_bytes<P, NK>() > rows_mid1_bytes<P, NK>()
             ? rows_mid2_bytes<P, NK>() : rows_mid1_bytes<P, NK>();
}

template <int P, int NK>
__host__ __device__ constexpr int rows_smem_bytes() {
  return kRows * (NK + 8) * 2 + rows_mid_bytes<P, NK>()
         + kMaxGroupHeads * kRows * 4;
}

// 3a. Per (64-row tile i, chunk, head group, b): the group's share of dC of
// the tile's rows, the group's dB partials of the key tiles j <= i and of
// the state term, and the rows' dseg of each head of the group.
template <int P, int NK>
__global__ void __launch_bounds__(kMmaThreads)
ssd_bwd_rows_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ B,
                        const bf16* __restrict__ C,
                        const bf16* __restrict__ prior, int prior_ld,
                        const bf16* __restrict__ dy, Workspace ws, int l,
                        int h, int n, int chunk, int hpg) {
  constexpr int kLdP = P + 8;
  constexpr int kLdN = NK + 8;
  constexpr int kLdD = kRows + 8;
  constexpr int kNT = NK / 8;        // n-tiles of dC and dB (16 x NK a warp)
  constexpr int kKT = kRows / 8;     // n-tiles of G, dP and D (16 x 64)
  constexpr int kNS = NK / 16;       // k-steps over n
  constexpr int kPS = P / 16;        // k-steps over p
  extern __shared__ uint4 smem_u4[];
  bf16* sC = reinterpret_cast<bf16*>(smem_u4);       // (64, NK + 8): C_i
  char* mid = reinterpret_cast<char*>(sC + kRows * kLdN);
  float* sRd = reinterpret_cast<float*>(mid + rows_mid_bytes<P, NK>());
  // the key tiles' walk (part 2)
  bf16* sB = reinterpret_cast<bf16*>(mid);           // two stages of B_j
  bf16* sX = sB + 2 * kRows * kLdN;                  // two stages of x_j
  bf16* sDy = sX + 2 * kRows * kLdP;                 // two stages of dy_i
  bf16* sD = sDy + 2 * kRows * kLdP;                 // (64, 72): D
  float* sSegI = reinterpret_cast<float*>(sD + kRows * kLdD);  // two stages
  float* sSegJ = sSegI + 2 * kRows;                  // two stages
  float* sDtJ = sSegJ + 2 * kRows;                   // two stages
  // the chunk-state terms (part 1), over the same bytes
  bf16* sPr = reinterpret_cast<bf16*>(mid);          // (P, NK + 8): prior
  bf16* sDS = sPr + P * kLdN;                        // (P, NK + 8): dS_c
  bf16* sX1 = sDS + P * kLdN;                        // (64, P + 8): x_i
  bf16* sDy1 = sX1 + kRows * kLdP;                   // (64, P + 8): dy_i
  float* sSeg1 = reinterpret_cast<float*>(sDy1 + kRows * kLdP);  // 64
  float* sDt1 = sSeg1 + kRows;                       // 64

  const int n_rt = (chunk + kRows - 1) / kRows;
  const int qt = n_rt * kRows;
  const int nc = (l + chunk - 1) / chunk;
  const int slots = n_rt + 1;
  const int ci = blockIdx.x / n_rt;
  const int it = n_rt - 1 - static_cast<int>(blockIdx.x % n_rt);
  const int gi = blockIdx.y;
  const int groups = gridDim.y;
  const int bi = blockIdx.z;
  const int h0 = gi * hpg;
  const int nh = min(hpg, h - h0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;            // fragment row (and row + 8)
  const int t4 = lane % 4;           // fragment column pair
  const int wr = warp * 16;          // the warp's first row in the tile
  const int c0 = ci * chunk;
  const int i0 = it * kRows;
  const int64_t xs = static_cast<int64_t>(h) * P;
  const bf16* Bb = B + static_cast<int64_t>(bi) * l * n;
  const bf16* Cb = C + static_cast<int64_t>(bi) * l * n;
  const bool vec = n % 8 == 0;
  const bool vec_pr = vec && prior_ld % 8 == 0;
  auto cix_of = [&](int hl) {
    return (static_cast<int64_t>(bi) * h + h0 + hl) * nc + ci;
  };
  auto head_of = [&](const bf16* t, int hl) {
    return t + (static_cast<int64_t>(bi) * l * h + h0 + hl) * P;
  };

  // ---- 1. the chunk-state terms, head by head: exp(seg_q) dy_q prior^T
  // into dC (and its dseg), the group's (x w) dS_c into dB's state slot ----
  if (vec && n < NK) {
    zero_pad_cols<NK>(sC, kRows, n, tid);
    zero_pad_cols<NK>(sPr, P, n, tid);
    zero_pad_cols<NK>(sDS, P, n, tid);
  }
  load_rows16<NK>(sC, Cb, n, n, c0, i0, chunk, l, vec, tid);
  float dc[kNT][4], ds[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dc[nt][e] = 0.0f;
      ds[nt][e] = 0.0f;
    }
  for (int hl = 0; hl < nh; ++hl) {
    const int64_t cix = cix_of(hl);
    __syncthreads();            // the previous head's tiles are read
    load_rows16<P>(sDy1, head_of(dy, hl), xs, P, c0, i0, chunk, l, true,
                   tid);
    load_rows16<P>(sX1, head_of(x, hl), xs, P, c0, i0, chunk, l, true, tid);
    load_state16<P, NK>(sPr, prior + cix * P * prior_ld, prior_ld, n, vec_pr,
                        tid);
    load_state16<P, NK>(sDS, ws.dS16 + cix * P * n, n, n, vec, tid);
    load_f32_64(sSeg1, ws.seg + cix * qt + i0, tid);
    load_f32_64(sDt1, ws.dt + cix * qt + i0, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float seg_last = ws.seg[cix * qt + chunk - 1];
    float es[2], wk[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = wr + g + 8 * rr;
      const bool ok = i0 + row < chunk;
      const float sg = sSeg1[row];
      es[rr] = ok ? expf(sg) : 0.0f;
      wk[rr] = ok ? bf16_round(__fmul_rn(sDt1[row], expf(seg_last - sg)))
                  : 0.0f;
    }
    float rd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int np = 0; np < kNS; ++np) {
      float t1[2][4], t2[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          t1[f][e] = 0.0f;
          t2[f][e] = 0.0f;
        }
#pragma unroll
      for (int ps = 0; ps < kPS; ++ps) {
        uint32_t a[4], xa[4], b[4];
        frag_a(a, sDy1, kLdP, wr, ps * 16, lane);
        frag_bt(b, sPr, kLdN, ps * 16, np * 16, lane);
        mma_bf16(t1[0], a, b[0], b[1]);
        mma_bf16(t1[1], a, b[2], b[3]);
        // x w rounded to bf16, as the plain version rounds it
        frag_a(xa, sX1, kLdP, wr, ps * 16, lane);
        xa[0] = scale_bf16x2(xa[0], wk[0]);
        xa[1] = scale_bf16x2(xa[1], wk[1]);
        xa[2] = scale_bf16x2(xa[2], wk[0]);
        xa[3] = scale_bf16x2(xa[3], wk[1]);
        frag_bt(b, sDS, kLdN, ps * 16, np * 16, lane);
        mma_bf16(t2[0], xa, b[0], b[1]);
        mma_bf16(t2[1], xa, b[2], b[3]);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          const int row = wr + g + 8 * rr;
          const int col = np * 16 + f * 8 + 2 * t4 + (e & 1);
          dc[2 * np + f][e] = fmaf(t1[f][e], es[rr], dc[2 * np + f][e]);
          rd[rr] += t1[f][e] * __bfloat162float(sC[row * kLdN + col])
                    * es[rr];
          ds[2 * np + f][e] += t2[f][e];
        }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float v = sum_quad(rd[rr]);
      if (t4 == 0) sRd[hl * kRows + wr + g + 8 * rr] = v;
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int q = i0 + wr + g + 8 * rr;
    if (q >= chunk || c0 + q >= l) continue;
    float* o = ws.dB + ((static_cast<int64_t>(bi) * l + c0 + q) * groups + gi)
                           * slots * n
               + static_cast<int64_t>(n_rt) * n;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t4 + e;
        if (col < n) o[col] = ds[nt][2 * rr + e];
      }
  }

  // ---- 2. the key tiles j <= i: G once for the group, then per head dP
  // and dG summed into D; dC += D B_j and the dB partial D^T C_i ----
  __syncthreads();              // part 1's tiles are read
  if (vec && n < NK) zero_pad_cols<NK>(sB, 2 * kRows, n, tid);
  const int n_it = (it + 1) * nh;
  auto stage_in = [&](int s_, int st) {
    const int j = s_ / nh;
    const int hl = s_ % nh;
    const int64_t cix = cix_of(hl);
    if (hl == 0)
      load_rows16<NK>(sB + (j & 1) * kRows * kLdN, Bb, n, n, c0, j * kRows,
                      chunk, l, vec, tid);
    load_rows16<P>(sX + st * kRows * kLdP, head_of(x, hl), xs, P, c0,
                   j * kRows, chunk, l, true, tid);
    load_rows16<P>(sDy + st * kRows * kLdP, head_of(dy, hl), xs, P, c0, i0,
                   chunk, l, true, tid);
    load_f32_64(sSegI + st * kRows, ws.seg + cix * qt + i0, tid);
    load_f32_64(sSegJ + st * kRows, ws.seg + cix * qt + j * kRows, tid);
    load_f32_64(sDtJ + st * kRows, ws.dt + cix * qt + j * kRows, tid);
  };
  stage_in(0, 0);
  cp_async_commit();

  float gacc[kKT][4], dmat[kKT][4];
  for (int s_ = 0; s_ < n_it; ++s_) {
    const int st = s_ & 1;
    const int j = s_ / nh;
    const int hl = s_ % nh;
    if (s_ + 1 < n_it) {
      stage_in(s_ + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                // stage s_ landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool diag = j == it;
    // on the diagonal tile, key steps past the warp's last row add nothing
    const int kst = diag ? warp + 1 : kRows / 16;
    const bf16* tB = sB + (j & 1) * kRows * kLdN;
    const bf16* tX = sX + st * kRows * kLdP;
    const bf16* tDy = sDy + st * kRows * kLdP;
    const float* tSegI = sSegI + st * kRows;
    const float* tSegJ = sSegJ + st * kRows;
    const float* tDtJ = sDtJ + st * kRows;
    if (hl == 0) {
      // G = C_i B_j^T, the warp's 16 rows x 64 keys, once for the group
#pragma unroll
      for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gacc[nt][e] = 0.0f;
          dmat[nt][e] = 0.0f;
        }
#pragma unroll
      for (int ns = 0; ns < kNS; ++ns) {
        uint32_t a[4];
        frag_a(a, sC, kLdN, wr, ns * 16, lane);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          if (kk < kst) {
            uint32_t b[4];
            frag_b(b, tB, kLdN, kk * 16, ns * 16, lane);
            mma_bf16(gacc[2 * kk], a, b[0], b[1]);
            mma_bf16(gacc[2 * kk + 1], a, b[2], b[3]);
          }
        }
      }
    }
    // dP = dy_i x_j^T of this head
    float dp[kKT][4];
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = 0.0f;
#pragma unroll
    for (int ps = 0; ps < kPS; ++ps) {
      uint32_t a[4];
      frag_a(a, tDy, kLdP, wr, ps * 16, lane);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        if (kk < kst) {
          uint32_t b[4];
          frag_b(b, tX, kLdP, kk * 16, ps * 16, lane);
          mma_bf16(dp[2 * kk], a, b[0], b[1]);
          mma_bf16(dp[2 * kk + 1], a, b[2], b[3]);
        }
      }
    }
    // dG = dP exp(seg_q - seg_k) dt_k, a select; D += dG; the rows' dseg,
    // sum_k dP att = sum_k dP (G dec dt_k)
    float rd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int row = wr + g + 8 * rr;
        const int key = nt * 8 + 2 * t4 + (e & 1);
        if (i0 + row < chunk && (!diag || key <= row)) {
          const float dec = expf(tSegI[row] - tSegJ[key]);
          const float dtk = tDtJ[key];
          dmat[nt][e] += dp[nt][e] * dec * dtk;
          rd[rr] += dp[nt][e] * (gacc[nt][e] * dec * dtk);
        }
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float v = sum_quad(rd[rr]);
      if (t4 == 0) sRd[hl * kRows + wr + g + 8 * rr] += v;
    }
    if (hl == nh - 1) {
      // dC += D B_j: D from registers, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        if (kk < kst) {
          const uint32_t a[4] = {
              pack_bf16(dmat[2 * kk][0], dmat[2 * kk][1]),
              pack_bf16(dmat[2 * kk][2], dmat[2 * kk][3]),
              pack_bf16(dmat[2 * kk + 1][0], dmat[2 * kk + 1][1]),
              pack_bf16(dmat[2 * kk + 1][2], dmat[2 * kk + 1][3])};
#pragma unroll
          for (int np = 0; np < kNS; ++np) {
            uint32_t b[4];
            frag_bt(b, tB, kLdN, kk * 16, np * 16, lane);
            mma_bf16(dc[2 * np], a, b[0], b[1]);
            mma_bf16(dc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      // D through shared memory; dB of key tile j from this row tile,
      // D^T C_i: the warp's 16 keys x NK
#pragma unroll
      for (int nt = 0; nt < kKT; ++nt) {
        *reinterpret_cast<uint32_t*>(sD + (wr + g) * kLdD + nt * 8 + 2 * t4) =
            pack_bf16(dmat[nt][0], dmat[nt][1]);
        *reinterpret_cast<uint32_t*>(sD + (wr + g + 8) * kLdD + nt * 8
                                     + 2 * t4) =
            pack_bf16(dmat[nt][2], dmat[nt][3]);
      }
      __syncthreads();
      float db[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) db[nt][e] = 0.0f;
      // on the diagonal tile, D's rows before the warp's keys are 0
      const int kfirst = diag ? warp : 0;
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        if (kk >= kfirst) {
          uint32_t a[4];
          frag_at(a, sD, kLdD, wr, kk * 16, lane);
#pragma unroll
          for (int np = 0; np < kNS; ++np) {
            uint32_t b[4];
            frag_bt(b, sC, kLdN, kk * 16, np * 16, lane);
            mma_bf16(db[2 * np], a, b[0], b[1]);
            mma_bf16(db[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int k = j * kRows + wr + g + 8 * rr;
        if (k >= chunk || c0 + k >= l) continue;
        float* o = ws.dB
                   + ((static_cast<int64_t>(bi) * l + c0 + k) * groups + gi)
                         * slots * n
                   + static_cast<int64_t>(it) * n;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + 2 * t4 + e;
            if (col < n) o[col] = db[nt][2 * rr + e];
          }
      }
    }
    __syncthreads();            // stage st and sD are read before reuse
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int q = i0 + wr + g + 8 * rr;
    if (q >= chunk || c0 + q >= l) continue;
    float* o = ws.dC
               + ((static_cast<int64_t>(bi) * l + c0 + q) * groups + gi) * n;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t4 + e;
        if (col < n) o[col] = dc[nt][2 * rr + e];
      }
  }
  for (int idx = tid; idx < nh * kRows; idx += kMmaThreads) {
    const int hl = idx / kRows;
    const int q = i0 + idx % kRows;
    if (q < chunk) ws.dseg[cix_of(hl) * chunk + q] = sRd[idx];
  }
}

template <int P, int NK>
__host__ __device__ constexpr int keys_smem_bytes() {
  return 3 * kRows * (NK + 8 + P + 8) * 2 + 4 * kRows * 4;
}

// 3b. Per (64-key tile j, chunk, h, b): dx of the tile's keys, their ddt,
// dseg and seg_last terms.
template <int P, int NK>
__global__ void __launch_bounds__(kMmaThreads)
ssd_bwd_keys_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ B,
                        const bf16* __restrict__ C,
                        const bf16* __restrict__ dy, bf16* __restrict__ dx,
                        Workspace ws, int l, int h, int n, int chunk) {
  constexpr int kLdP = P + 8;
  constexpr int kLdN = NK + 8;
  constexpr int kKT = kRows / 8;     // n-tiles of G^T, dP^T (16 x 64 rows)
  constexpr int kPT = P / 8;         // n-tiles of dx (16 keys x P)
  constexpr int kNS = NK / 16;
  constexpr int kPS = P / 16;
  extern __shared__ uint4 smem_u4[];
  bf16* sB = reinterpret_cast<bf16*>(smem_u4);   // (64, NK + 8): B_j
  bf16* sX = sB + kRows * kLdN;                  // (64, P + 8): x_j
  bf16* sC = sX + kRows * kLdP;                  // two stages of C_i
  bf16* sDy = sC + 2 * kRows * kLdN;             // two stages of dy_i
  float* sSegJ = reinterpret_cast<float*>(sDy + 2 * kRows * kLdP);  // 64
  float* sDtJ = sSegJ + kRows;                   // 64
  float* sSegI = sDtJ + kRows;                   // two stages of 64
  bf16* sDS = sC;              // (P, NK + 8) after the walk, over sC

  const int n_rt = (chunk + kRows - 1) / kRows;
  const int qt = n_rt * kRows;
  const int nc = (l + chunk - 1) / chunk;
  const int ci = blockIdx.x / n_rt;
  const int jt = static_cast<int>(blockIdx.x % n_rt);
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr = warp * 16;          // the warp's first key in the tile
  const int c0 = ci * chunk;
  const int j0 = jt * kRows;
  const int64_t cix = (static_cast<int64_t>(bi) * h + hi) * nc + ci;
  const int64_t xs = static_cast<int64_t>(h) * P;
  const int64_t xoff = (static_cast<int64_t>(bi) * l * h + hi) * P;
  const bf16* Bb = B + static_cast<int64_t>(bi) * l * n;
  const bf16* Cb = C + static_cast<int64_t>(bi) * l * n;
  const float* seg = ws.seg + cix * qt;
  const bool vec = n % 8 == 0;

  // group 0: the key tile's B, x, seg and dt; row tile j's C, dy and seg
  if (vec && n < NK) {
    zero_pad_cols<NK>(sB, kRows, n, tid);
    zero_pad_cols<NK>(sC, 2 * kRows, n, tid);
  }
  load_rows16<NK>(sB, Bb, n, n, c0, j0, chunk, l, vec, tid);
  load_rows16<P>(sX, x + xoff, xs, P, c0, j0, chunk, l, true, tid);
  load_f32_64(sSegJ, seg + j0, tid);
  load_f32_64(sDtJ, ws.dt + cix * qt + j0, tid);
  auto stage_in = [&](int i, int st) {
    load_rows16<NK>(sC + st * kRows * kLdN, Cb, n, n, c0, i * kRows, chunk,
                    l, vec, tid);
    load_rows16<P>(sDy + st * kRows * kLdP, dy + xoff, xs, P, c0, i * kRows,
                   chunk, l, true, tid);
    load_f32_64(sSegI + st * kRows, seg + i * kRows, tid);
  };
  stage_in(jt, 0);
  cp_async_commit();

  float dxa[kPT][4];
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[pt][e] = 0.0f;
  float cddt[2] = {0.0f, 0.0f};
  float cdseg[2] = {0.0f, 0.0f};
  const int n_iter = n_rt - jt;
  for (int s_ = 0; s_ < n_iter; ++s_) {
    const int i = jt + s_;
    const int st = s_ & 1;
    if (s_ + 1 < n_iter) {
      stage_in(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                // stage s_ (and the key tile) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool diag = i == jt;
    // on the diagonal tile, row steps before the warp's first key add
    // nothing
    const int rfirst = diag ? warp : 0;
    const bf16* tC = sC + st * kRows * kLdN;
    const bf16* tDy = sDy + st * kRows * kLdP;
    const float* tSegI = sSegI + st * kRows;
    // G^T = B_j C_i^T and dP^T = x_j dy_i^T: the warp's 16 keys x 64 rows
    float gt[kKT][4], dpt[kKT][4];
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gt[nt][e] = 0.0f;
        dpt[nt][e] = 0.0f;
      }
#pragma unroll
    for (int ns = 0; ns < kNS; ++ns) {
      uint32_t a[4];
      frag_a(a, sB, kLdN, wr, ns * 16, lane);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        if (kk >= rfirst) {
          uint32_t b[4];
          frag_b(b, tC, kLdN, kk * 16, ns * 16, lane);
          mma_bf16(gt[2 * kk], a, b[0], b[1]);
          mma_bf16(gt[2 * kk + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int ps = 0; ps < kPS; ++ps) {
      uint32_t a[4];
      frag_a(a, sX, kLdP, wr, ps * 16, lane);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        if (kk >= rfirst) {
          uint32_t b[4];
          frag_b(b, tDy, kLdP, kk * 16, ps * 16, lane);
          mma_bf16(dpt[2 * kk], a, b[0], b[1]);
          mma_bf16(dpt[2 * kk + 1], a, b[2], b[3]);
        }
      }
    }
    // att^T = G^T exp(seg_q - seg_k) dt_k, a select, rounded to bf16 as
    // dx's A operand; the keys' ddt (sum_q dP G dec) and dseg (-sum_q dP
    // att) in f32
    uint32_t at[kRows / 16][4];
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int key = wr + g + 8 * rr;
        const int row = nt * 8 + 2 * t4 + (e & 1);
        float attf = 0.0f;
        if (i * kRows + row < chunk && (!diag || row >= key)) {
          const float dec = expf(tSegI[row] - sSegJ[key]);
          attf = gt[nt][e] * dec * sDtJ[key];
          cddt[rr] += dpt[nt][e] * gt[nt][e] * dec;
          cdseg[rr] -= dpt[nt][e] * attf;
        }
        v[e] = attf;
      }
      at[nt / 2][(nt % 2) * 2] = pack_bf16(v[0], v[1]);
      at[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
    }
    // dx += att^T dy_i
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      if (kk >= rfirst) {
#pragma unroll
        for (int dp = 0; dp < kPS; ++dp) {
          uint32_t b[4];
          frag_bt(b, tDy, kLdP, kk * 16, dp * 16, lane);
          mma_bf16(dxa[2 * dp], at[kk], b[0], b[1]);
          mma_bf16(dxa[2 * dp + 1], at[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();            // stage st is read before it is refilled
  }

  // ---- the state leaving the chunk: w_k dS_c B_k into dx, and through
  // dw = (dS_c B_k) . x_k the keys' ddt, dseg and seg_last terms ----
  if (vec && n < NK) zero_pad_cols<NK>(sDS, P, n, tid);
  load_state16<P, NK>(sDS, ws.dS16 + cix * P * n, n, n, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // dwx = B_j dS_c^T, the warp's 16 keys x P
  float dw[kPT][4];
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[pt][e] = 0.0f;
#pragma unroll
  for (int ns = 0; ns < kNS; ++ns) {
    uint32_t a[4];
    frag_a(a, sB, kLdN, wr, ns * 16, lane);
#pragma unroll
    for (int dp = 0; dp < kPS; ++dp) {
      uint32_t b[4];
      frag_b(b, sDS, kLdN, dp * 16, ns * 16, lane);
      mma_bf16(dw[2 * dp], a, b[0], b[1]);
      mma_bf16(dw[2 * dp + 1], a, b[2], b[3]);
    }
  }
  const float seg_last = seg[chunk - 1];
  float e_end[2], wf[2], wk[2], dwp[2] = {0.0f, 0.0f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = wr + g + 8 * rr;
    e_end[rr] = j0 + key < chunk ? expf(seg_last - sSegJ[key]) : 0.0f;
    wf[rr] = sDtJ[key] * e_end[rr];
    wk[rr] = bf16_round(wf[rr]);
  }
#pragma unroll
  for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e >> 1;
      const int col = pt * 8 + 2 * t4 + (e & 1);
      dxa[pt][e] = fmaf(dw[pt][e], wk[rr], dxa[pt][e]);
      dwp[rr] += dw[pt][e]
                 * __bfloat162float(sX[(wr + g + 8 * rr) * kLdP + col]);
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float dwr = sum_quad(dwp[rr]);
    const float sddt = sum_quad(cddt[rr]);
    const float sdseg = sum_quad(cdseg[rr]);
    const int k = j0 + wr + g + 8 * rr;
    if (k >= chunk) continue;
    if (t4 == 0) {
      const int64_t o = cix * chunk + k;
      ws.dseg_keys[o] = sdseg - dwr * wf[rr];
      ws.ddt[o] = sddt + dwr * e_end[rr];
      ws.dlast[o] = dwr * wf[rr];
    }
    if (dx != nullptr && c0 + k < l) {
      bf16* out = dx + xoff + static_cast<int64_t>(c0 + k) * xs;
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt)
        *reinterpret_cast<uint32_t*>(out + pt * 8 + 2 * t4) =
            pack_bf16(dxa[pt][2 * rr], dxa[pt][2 * rr + 1]);
    }
  }
}

// 5. dB and dC (b, l, n) from the tensor-core route's partials: dC summed
// over the head groups, dB over the groups and, in each, over the row tiles
// at or after the position's own and the state slot, in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_mma_kernel(Workspace ws, bf16* __restrict__ dB,
                          bf16* __restrict__ dC, int b, int l, int n,
                          int chunk, int groups) {
  bf16* out = blockIdx.y == 0 ? dB : dC;
  if (out == nullptr) return;
  const int slots = (chunk + kRows - 1) / kRows + 1;
  const int64_t total = static_cast<int64_t>(b) * l * n;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = e / n;
    const int k = static_cast<int>(e % n);
    float s = 0.0f;
    if (blockIdx.y == 0) {
      const int first = static_cast<int>(r % l) % chunk / kRows;
      for (int gi = 0; gi < groups; ++gi) {
        const float* src = ws.dB + (r * groups + gi) * slots * n + k;
        for (int sl = first; sl < slots; ++sl)
          s += src[static_cast<int64_t>(sl) * n];
      }
    } else {
      const float* src = ws.dC + r * groups * n + k;
      for (int gi = 0; gi < groups; ++gi)
        s += src[static_cast<int64_t>(gi) * n];
    }
    out[e] = __float2bfloat16_rn(s);
  }
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
  int fault = 0;                // kPlantWalk / kPlantTail, 0 in a real call
};

// A fault planted for the check on the card (ssd_scan_bwd_planted_launch),
// never in a real call: kPlantWalk sets every chunk decay to 1 before the
// reverse walk (its recurrence and its seg_last term), kPlantTail zeroes
// the last chunk's seg_last gradient (the keys' and the walk's terms)
// before the dt kernel. One block per (b, h).
constexpr int kPlantWalk = 1;
constexpr int kPlantTail = 2;

__global__ void ssd_bwd_plant_kernel(Workspace ws, int fault, int nc,
                                     int chunk, int walk_blocks) {
  const int64_t bh = blockIdx.x;
  if (fault == kPlantWalk) {
    for (int c = threadIdx.x; c < nc; c += blockDim.x)
      ws.decay[bh * nc + c] = 1.0f;
    return;
  }
  const int64_t cix = bh * nc + nc - 1;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x)
    ws.dlast[cix * chunk + i] = 0.0f;
  for (int w = threadIdx.x; w < walk_blocks; w += blockDim.x)
    ws.dlast_state[(bh * walk_blocks + w) * nc + nc - 1] = 0.0f;
}

// Launches the plant kernel where a.fault is `at`; else nothing.
inline cudaError_t plant(const BwdArgs& a, const Workspace& ws, int at,
                         int nc, int wb) {
  if (a.fault != at) return cudaSuccess;
  ssd_bwd_plant_kernel<<<a.b * a.h, kThreads, 0, a.stream>>>(ws, at, nc,
                                                             a.chunk, wb);
  return cudaGetLastError();
}

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
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = plant(a, ws, kPlantWalk, nc, wb)) != cudaSuccess)
    return static_cast<int>(err);
  k2<<<dim3(a.b * a.h, wb), kThreads, smem2, a.stream>>>(
      prior, a.prior_ld, a.dstate, a.dinit, ws, P, a.n, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k3<<<dim3(n_rt * nc, a.h, a.b), kThreads, smem3, a.stream>>>(
      x, a.dt, B, C, prior, a.prior_ld, dy, static_cast<T*>(a.dx), ws, a.l,
      a.h, a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = plant(a, ws, kPlantTail, nc, wb)) != cudaSuccess)
    return static_cast<int>(err);
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


template <int P, int NK>
int launch_bwd_mma(const BwdArgs& a) {
  Workspace ws;
  workspace_layout_mma(a.b, a.l, a.h, a.p, a.n, a.chunk, a.workspace, &ws);
  const int nc = (a.l + a.chunk - 1) / a.chunk;
  const int n_rt = (a.chunk + kRows - 1) / kRows;
  const int wb = walk_blocks(P, a.n);
  const int hpg = group_heads(a.b, a.l, a.h, a.chunk);
  const int groups = (a.h + hpg - 1) / hpg;
  const int smem1 = chunk_mma_smem_bytes<P, NK>(a.chunk);
  const int smem2 = walk_smem_bytes(nc);
  constexpr int kSmemRows = rows_smem_bytes<P, NK>();
  constexpr int kSmemKeys = keys_smem_bytes<P, NK>();
  const int smem5 = dt_smem_bytes(a.chunk);
  auto k1 = ssd_bwd_chunk_mma_kernel<P, NK>;
  auto k2 = ssd_bwd_walk_kernel<bf16>;
  auto k3 = ssd_bwd_rows_mma_kernel<P, NK>;
  auto k4 = ssd_bwd_keys_mma_kernel<P, NK>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem2)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemRows)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(k4, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemKeys)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_dt_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem5)) != cudaSuccess)
    return static_cast<int>(err);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* B = static_cast<const bf16*>(a.B);
  const bf16* C = static_cast<const bf16*>(a.C);
  const bf16* dy = static_cast<const bf16*>(a.dy);
  const bf16* prior = static_cast<const bf16*>(a.prior);
  k1<<<dim3(nc, a.h, a.b), kMmaThreads, smem1, a.stream>>>(a.dt, a.A, C, dy,
                                                            ws, a.l, a.h,
                                                            a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = plant(a, ws, kPlantWalk, nc, wb)) != cudaSuccess)
    return static_cast<int>(err);
  k2<<<dim3(a.b * a.h, wb), kThreads, smem2, a.stream>>>(
      prior, a.prior_ld, a.dstate, a.dinit, ws, P, a.n, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k3<<<dim3(n_rt * nc, groups, a.b), kMmaThreads, kSmemRows, a.stream>>>(
      x, B, C, prior, a.prior_ld, dy, ws, a.l, a.h, a.n, a.chunk, hpg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k4<<<dim3(n_rt * nc, a.h, a.b), kMmaThreads, kSmemKeys, a.stream>>>(
      x, B, C, dy, static_cast<bf16*>(a.dx), ws, a.l, a.h, a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = plant(a, ws, kPlantTail, nc, wb)) != cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_dt_kernel<<<dim3(nc, a.h, a.b), kThreads, smem5, a.stream>>>(
      a.dt, a.A, a.ddt, ws, a.l, a.h, a.chunk, wb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(a.b) * a.l;
  const int64_t want = (rows * a.n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  ssd_bwd_reduce_mma_kernel<<<dim3(blocks, 2), kThreads, 0, a.stream>>>(
      ws, static_cast<bf16*>(a.dB), static_cast<bf16*>(a.dC), a.b, a.l, a.n,
      a.chunk, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (a.dA != nullptr)
    ssd_bwd_da_kernel<<<(a.h + kThreads - 1) / kThreads, kThreads, 0,
                        a.stream>>>(ws, a.dA, a.b, a.h, nc);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_bwd_mma_nk(const BwdArgs& a) {
  switch (nk_for(a.n)) {
    case 16: return launch_bwd_mma<P, 16>(a);
    case 32: return launch_bwd_mma<P, 32>(a);
    case 64: return launch_bwd_mma<P, 64>(a);
    default: return launch_bwd_mma<P, 128>(a);
  }
}

template <int P, int NK>
int mma_smem_pn(int chunk) {
  const int a = chunk_mma_smem_bytes<P, NK>(chunk);
  const int b = rows_smem_bytes<P, NK>();
  const int c = keys_smem_bytes<P, NK>();
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

template <int P>
int mma_smem_p(int n, int chunk) {
  switch (nk_for(n)) {
    case 16: return mma_smem_pn<P, 16>(chunk);
    case 32: return mma_smem_pn<P, 32>(chunk);
    case 64: return mma_smem_pn<P, 64>(chunk);
    default: return mma_smem_pn<P, 128>(chunk);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Checks the arguments and launches one route: the CUDA cores in `dtype`
// (0 f32, 1 bf16), or with `mma` the tensor cores (bf16 only, x, B, C, dy
// and prior 16-byte aligned).
int launch_route(const BwdArgs& a, int dtype, bool mma) {
  if (a.b <= 0 || a.l <= 0 || a.h <= 0 || a.n <= 0 || a.n > kMaxN ||
      a.chunk <= 0 || a.chunk > a.l || a.b > 65535 || a.h > 65535 ||
      a.prior_ld < a.n || static_cast<int64_t>(a.b) * a.h > INT_MAX ||
      (reinterpret_cast<uintptr_t>(a.workspace) & 255u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!mma) {
    if (dtype == 0) return launch_bwd_p<float>(a);
    if (dtype == 1) return launch_bwd_p<__nv_bfloat16>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 1 || !aligned16(a.x) || !aligned16(a.B) || !aligned16(a.C) ||
      !aligned16(a.dy) || !aligned16(a.prior))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.p) {
    case 16: return launch_bwd_mma_nk<16>(a);
    case 32: return launch_bwd_mma_nk<32>(a);
    case 64: return launch_bwd_mma_nk<64>(a);
    case 128: return launch_bwd_mma_nk<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
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
  return launch_route(
      BwdArgs{x, dt, A, B, C, prior, prior_ld, dy, dstate, dx, ddt, dA, dB,
              dC, dinit, workspace, b, l, h, p, n, chunk,
              static_cast<cudaStream_t>(stream)},
      dtype, false);
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

// The tensor-core route: the same arguments, bf16 only (no dtype), and a
// workspace of ssd_scan_bwd_mma_workspace_bytes() bytes, 256-byte aligned.
// x, B, C, dy and prior must be 16-byte aligned.
extern "C" int ssd_scan_bwd_mma_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* prior, int prior_ld, const void* dy,
    const float* dstate, void* dx, float* ddt, float* dA, void* dB,
    void* dC, float* dinit, void* workspace, int b, int l, int h, int p,
    int n, int chunk, void* stream) {
  return launch_route(
      BwdArgs{x, dt, A, B, C, prior, prior_ld, dy, dstate, dx, ddt, dA, dB,
              dC, dinit, workspace, b, l, h, p, n, chunk,
              static_cast<cudaStream_t>(stream)},
      1, true);
}

// Either route (mma 0: ssd_scan_bwd_launch's in dtype, 1: the tensor
// cores') with a fault planted in it, kPlantWalk (1) or kPlantTail (2), so
// the check on the card can show that a broken walk or tail reaches the
// gradients. The op never calls it.
extern "C" int ssd_scan_bwd_planted_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const void* prior, int prior_ld, const void* dy,
    const float* dstate, void* dx, float* ddt, float* dA, void* dB,
    void* dC, float* dinit, void* workspace, int b, int l, int h, int p,
    int n, int chunk, int dtype, int mma, int fault, void* stream) {
  if (fault != kPlantWalk && fault != kPlantTail)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_route(
      BwdArgs{x, dt, A, B, C, prior, prior_ld, dy, dstate, dx, ddt, dA, dB,
              dC, dinit, workspace, b, l, h, p, n, chunk,
              static_cast<cudaStream_t>(stream), fault},
      dtype, mma != 0);
}

// Bytes of the tensor-core route's workspace at these sizes.
extern "C" long long ssd_scan_bwd_mma_workspace_bytes(int b, int l, int h,
                                                      int p, int n,
                                                      int chunk) {
  return workspace_layout_mma(b, l, h, p, n, chunk, nullptr, nullptr);
}

// The most shared memory (bytes) one of the tensor-core route's kernels
// needs at these sizes.
extern "C" int ssd_scan_bwd_mma_smem_bytes(int p, int n, int chunk, int l) {
  int m;
  switch (p) {
    case 16: m = mma_smem_p<16>(n, chunk); break;
    case 32: m = mma_smem_p<32>(n, chunk); break;
    case 64: m = mma_smem_p<64>(n, chunk); break;
    case 128: m = mma_smem_p<128>(n, chunk); break;
    default: return -1;
  }
  const int walk = walk_smem_bytes((l + chunk - 1) / chunk);
  const int dts = dt_smem_bytes(chunk);
  return m > walk ? (m > dts ? m : dts) : (walk > dts ? walk : dts);
}

extern "C" const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
