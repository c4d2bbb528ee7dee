// Fused bank-row gather + store-buffer max-plus scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bank_scan/kernel.py ::
// bank_scan_pallas (body _bank_scan_kernel). Per lane b, over the n stores
// of its arrivals row a = a_bank[trace_idx[b]] and its max-plus rows
// w, v, p = {w,v,p}_bank[wv_idx[b]]:
//
//   r_i = max(a_i, c_{i-sb})
//   c_i = max(r_i + w_i, c_{i-1} + v_i)
//   sb_full += c_{i-sb} > a_i
//   at_head += p_i && r_i >= c_{i-1}
//
// with the last sb commit times in a ring that starts all zero. Outputs are
// per lane: c_{n-1} (f32), at_head (i32), sb_full (i32).
//
// What bounds it on an H100. The roofline sees the unique bank rows a launch
// gathers, read once (<= (160 * 9 + 27 * 4) * 50 000 B = 77 MB for a
// mega-grid tile of 160 lanes) plus indices and outputs, against 3.35 TB/s:
// about 0.02 ms. The real floor is the serial chain: c_i needs c_{i-1}
// through one add and one max, so a lane takes n * 2 dependent f32 latencies
// (~0.2 ms at the paper's 50 000 stores), whatever the number of lanes.
// The recurrence cannot be reassociated into a parallel max-plus scan: f32
// addition is not associative, and the result must stay bit-identical to
// the plain version and the JAX package. So the design takes everything
// else off the chain.
//
// Design. A block holds 8 lanes and 5 warps. Copy warp k (k < 4) stages
// bank k (a, w, v or p) of the 8 lanes into shared memory with cp.async,
// 576 stores of a row at a time: 16-byte copies where the row segment is
// 16-byte aligned, 4-byte copies or single elements where it is not (rows
// are n words apart, and n = 2003 or n = 1 leave most rows unaligned). Three
// buffers rotate, so two chunks land while one is scanned; named barriers
// (bar.arrive / bar.sync) hand each buffer from the copy warps to the scan
// warp and back. The scan warp, one thread per lane, reads only shared
// memory and registers: each row is padded to an odd number of 16-byte
// units, so the float4 / uint4 reads of the 8 lanes fall in 8 different bank
// quads. At the repo's depths (kRegisterDepths: sb 72, the paper's Table II
// SB, and 48, the mega-grid's second size) the ring of the last sb commits
// lives in registers: the inner loop is unrolled over lcm(16, sb) stores, so
// ring slot k is a fixed register and no load, store or wrap test sits
// beside the chain. Other depths keep the ring in shared memory ([k * 8 +
// t], no bank conflicts) and, past sb = 384, in a device scratch buffer
// [k * n_lanes + lane] that the caller passes. The census is one compare
// and one predicated add per counter, off the chain.
//
// Why 8 lanes and 4 copy warps: a lane needs 13 bytes per store, and the
// chain takes a few nanoseconds per store, so 32 lanes would need tens of
// GB/s of row segments into one SM; one copy warp staging short segments
// for 32 lanes fell far short of that on the H100, while four warps staging
// 8 lanes' 2 304-byte segments keep ahead of the scan. Spreading lanes over
// more SMs costs nothing on the chain: the scan warp issues the same
// instructions for 8 lanes as for 32.
//
// Only IEEE add and fmaxf, in the order above, and no fast-math or -ftz, so
// results are bit-identical to the plain version and the JAX package. A
// lane whose row index is out of range writes NaN and -1 counts instead of
// reading out of bounds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 8;               // lanes per block
constexpr int kCopyWarps = 4;           // one per bank: a, w, v, p
constexpr int kThreads = 32 * (1 + kCopyWarps);
constexpr int kStages = 3;              // buffers in the copy pipeline
constexpr int kChunk = 576;             // stores per buffer
constexpr int kMaxSharedSb = 384;       // 12 KB of rings beside the buffers
constexpr int kFull = 1;                // named barriers kFull + buffer
constexpr int kEmpty = kFull + kStages; // and kEmpty + buffer

enum RingKind { kRegisterRing = 0, kSharedRing = 1, kScratchRing = 2 };

// Store-buffer depths with a register-ring instantiation: the paper's SB
// (Table II) and the mega-grid's second size. launch_register dispatches on
// them and bank_scan_register_ring_depth exports them.
constexpr int kRegisterDepths[] = {48, 72};
constexpr int kRegisterRings = sizeof(kRegisterDepths) / sizeof(int);

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Stores per unrolled body of the scan: a multiple of 16 (one uint4 of p)
// and of the register ring's depth SB (SB == 0: a ring in memory).
template <int SB>
constexpr int kBodyStores = SB > 0 ? 16 / gcd(16, SB) * SB : 16;

// Row strides in shared memory: an odd number of 16-byte units, so the
// float4 / uint4 reads of the 8 lanes fall in 8 different bank quads.
constexpr int kLdF = (kChunk / 4) % 2 ? kChunk : kChunk + 4;     // floats
constexpr int kLdP = (kChunk / 16) % 2 ? kChunk : kChunk + 16;   // bytes
constexpr int kBufBytes = 3 * kLanes * kLdF * 4 + kLanes * kLdP;
constexpr int kBuffersBytes = kStages * kBufBytes;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kThreads) : "memory");
}

// One row segment of `len` words of `bytes` each into shared memory, by the
// 32 threads of a copy warp: 16-byte copies where the segment is 16-byte
// aligned, else 4-byte copies where it is 4-byte aligned, and single
// elements for the rest.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int len,
                                          int t) {
  constexpr int kPer16 = 16 / sizeof(T);
  constexpr int kPer4 = 4 / sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if ((at & 15u) == 0) {
    done = len / kPer16 * kPer16;
    for (int j = kPer16 * t; j < done; j += 32 * kPer16)
      cp_async_16(dst + j, src + j);
  } else if ((at & 3u) == 0) {
    done = len / kPer4 * kPer4;
    for (int j = kPer4 * t; j < done; j += 32 * kPer4)
      cp_async_4(dst + j, src + j);
  }
  for (int j = done + t; j < len; j += 32) dst[j] = src[j];
}

struct Buffer {
  float* a;
  float* w;
  float* v;
  uint8_t* p;
  __device__ Buffer(uint8_t* smem, int b) {
    a = reinterpret_cast<float*>(smem + b * kBufBytes);
    w = a + kLanes * kLdF;
    v = w + kLanes * kLdF;
    p = reinterpret_cast<uint8_t*>(v + kLanes * kLdF);
  }
};

// Copy warp `cw` (0..3) stages bank cw (a, w, v, p) of the block's lanes,
// chunk by chunk, kStages buffers deep: chunk c + 1 is signalled full as
// soon as it has landed, before the warp waits for chunk c's buffer to be
// scanned and refills it with chunk c + kStages. Thread t holds lane t % 8's
// row offsets.
__device__ void copy_warp(uint8_t* smem, int cw, const float* a_bank,
                          const float* w_bank, const float* v_bank,
                          const uint8_t* p_bank, int64_t tr, int64_t wv,
                          bool ok, int64_t n, int n_chunks, int t) {
  auto stage = [&](int c) {
    if (c >= n_chunks) return;
    const Buffer buf(smem, c % kStages);
    const int64_t base = static_cast<int64_t>(c) * kChunk;
    const int len = static_cast<int>(n - base < kChunk ? n - base : kChunk);
    for (int lane = 0; lane < kLanes; ++lane) {
      const int64_t row = __shfl_sync(0xffffffffu, cw == 0 ? tr : wv, lane);
      if (!__shfl_sync(0xffffffffu, ok, lane)) continue;
      const int64_t off = row * n + base;
      switch (cw) {
        case 0: stage_row(buf.a + lane * kLdF, a_bank + off, len, t); break;
        case 1: stage_row(buf.w + lane * kLdF, w_bank + off, len, t); break;
        case 2: stage_row(buf.v + lane * kLdF, v_bank + off, len, t); break;
        default: stage_row(buf.p + lane * kLdP, p_bank + off, len, t);
      }
    }
  };
  // one commit group per chunk, empty past the last, so that "chunk c has
  // landed" is always "at most (groups committed) - c - 1 in flight"
  for (int c = 0; c < kStages; ++c) {
    stage(c);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();         // chunk 0
  bar_arrive(kFull + 0);
  for (int c = 0; c + 1 < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();       // chunk c + 1
    bar_arrive(kFull + (c + 1) % kStages);
    if (c + kStages < n_chunks) {
      bar_sync(kEmpty + c % kStages);   // chunk c is scanned
      stage(c + kStages);
    }
    cp_async_commit();
  }
}

// The ring of the last SB commit times in registers: after the inner loops
// are unrolled, `at(k)` names a fixed register.
template <int SB>
struct RegisterRing {
  float cell[SB];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < SB; ++k) cell[k] = 0.0f;
  }
  __device__ __forceinline__ float& at(int k) { return cell[k % SB]; }
  __device__ __forceinline__ void advance() {}
};

// The ring in shared memory or in a device scratch buffer: slot k at
// base[k * stride], the current slot advanced store by store.
struct MemoryRing {
  float* base;
  int64_t stride;
  int sb;
  int slot;
  float* cur;
  __device__ __forceinline__ void init() {
    for (int k = 0; k < sb; ++k) base[k * stride] = 0.0f;
    slot = 0;
    cur = base;
  }
  __device__ __forceinline__ float& at(int) { return *cur; }
  __device__ __forceinline__ void advance() {
    cur += stride;
    if (++slot == sb) {
      slot = 0;
      cur = base;
    }
  }
};

struct Carry {
  float last;
  int32_t at_head;
  int32_t sb_full;
};

// The census, as one compare and one predicated add each.
__device__ __forceinline__ void count_if_greater(int32_t& n, float x,
                                                 float y) {
  asm("{\n .reg .pred q;\n setp.gt.f32 q, %1, %2;\n @q add.s32 %0, %0, 1;\n}"
      : "+r"(n) : "f"(x), "f"(y));
}

__device__ __forceinline__ void count_if_flag_and_ge(int32_t& n,
                                                     uint32_t flag, float x,
                                                     float y) {
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %1, 0;\n"
      " setp.ge.and.f32 q, %2, %3, q;\n @q add.s32 %0, %0, 1;\n}"
      : "+r"(n) : "r"(flag), "f"(x), "f"(y));
}

// Stores [k0, k0 + kBody) of the chunk in shared memory, one lane's rows;
// with kGuard, stores at or past `len` are not taken (the last chunk).
template <int SB, bool kGuard, class Ring>
__device__ __forceinline__ void scan_body(const float* a, const float* w,
                                          const float* v, const uint8_t* p,
                                          int k0, int len, Ring& ring,
                                          Carry& carry) {
  constexpr int kBody = kBodyStores<SB>;
#pragma unroll
  for (int g = 0; g < kBody / 16; ++g) {
    const uint4 p16 = *reinterpret_cast<const uint4*>(p + k0 + 16 * g);
    const uint32_t pw[4] = {p16.x, p16.y, p16.z, p16.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i4 = k0 + 16 * g + 4 * q;
      const float4 a4 = *reinterpret_cast<const float4*>(a + i4);
      const float4 w4 = *reinterpret_cast<const float4*>(w + i4);
      const float4 v4 = *reinterpret_cast<const float4*>(v + i4);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * g + 4 * q + e;
        if (kGuard && k0 + k >= len) return;
        float& cell = ring.at(k);
        const float old = cell;                      // c_{i-sb}
        const float r = fmaxf(av[e], old);
        count_if_greater(carry.sb_full, old, av[e]);
        count_if_flag_and_ge(carry.at_head, pw[q] & (0xffu << (8 * e)), r,
                             carry.last);
        const float c = fmaxf(r + wv[e], carry.last + vv[e]);
        cell = c;
        carry.last = c;
        ring.advance();
      }
    }
  }
}

// The scan warp: thread t < kLanes scans lane t's rows, chunk by chunk, from
// shared memory; the warp's other threads only keep the barriers.
template <int SB, class Ring>
__device__ void scan_warp(uint8_t* smem, Ring& ring, int64_t n,
                          int n_chunks, int t, Carry& carry) {
  constexpr int kBody = kBodyStores<SB>;
  static_assert(kChunk % kBody == 0, "a chunk holds whole bodies");
  if (t < kLanes) ring.init();
  for (int c = 0; c < n_chunks; ++c) {
    bar_sync(kFull + c % kStages);
    if (t < kLanes) {
      const Buffer buf(smem, c % kStages);
      const float* a = buf.a + t * kLdF;
      const float* w = buf.w + t * kLdF;
      const float* v = buf.v + t * kLdF;
      const uint8_t* p = buf.p + t * kLdP;
      const int64_t base = static_cast<int64_t>(c) * kChunk;
      const int len = static_cast<int>(n - base < kChunk ? n - base
                                                          : kChunk);
      if (len == kChunk) {
#pragma unroll 1
        for (int k0 = 0; k0 < kChunk; k0 += kBody)
          scan_body<SB, false>(a, w, v, p, k0, len, ring, carry);
      } else {
#pragma unroll 1
        for (int k0 = 0; k0 < len; k0 += kBody)
          scan_body<SB, true>(a, w, v, p, k0, len, ring, carry);
      }
    }
    __syncwarp();
    if (c + kStages < n_chunks) bar_arrive(kEmpty + c % kStages);
  }
}

// SB > 0: the register ring of that depth; SB == 0: a ring in shared
// memory (ring_scratch null) or in ring_scratch. Warp 0 scans, warps 1-4
// copy.
template <int SB>
__global__ void __launch_bounds__(kThreads, 1)
bank_scan_kernel(const float* __restrict__ a_bank,
                 const float* __restrict__ w_bank,
                 const float* __restrict__ v_bank,
                 const uint8_t* __restrict__ p_bank,
                 const int32_t* __restrict__ trace_idx,
                 const int32_t* __restrict__ wv_idx, int n_lanes,
                 int64_t n_stores, int64_t trace_rows, int64_t wv_rows,
                 int sb, float* __restrict__ ring_scratch,
                 float* __restrict__ out_c, int32_t* __restrict__ out_at_head,
                 int32_t* __restrict__ out_sb_full) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int lane = blockIdx.x * kLanes + t % kLanes;
  const bool live = lane < n_lanes;
  const int64_t tr = live ? trace_idx[lane] : 0;
  const int64_t wv = live ? wv_idx[lane] : 0;
  const bool ok = live && tr >= 0 && tr < trace_rows && wv >= 0
                  && wv < wv_rows;
  const int n_chunks = static_cast<int>((n_stores + kChunk - 1) / kChunk);

  if (warp > 0) {
    copy_warp(smem, warp - 1, a_bank, w_bank, v_bank, p_bank, tr, wv, ok,
              n_stores, n_chunks, t);
    return;
  }
  Carry carry{0.0f, 0, 0};
  if constexpr (SB > 0) {
    RegisterRing<SB> ring;
    scan_warp<SB>(smem, ring, n_stores, n_chunks, t, carry);
  } else {
    // a lane past n_lanes keeps its (unused) ring in one shared cell
    float* ring_smem = reinterpret_cast<float*>(smem + kBuffersBytes);
    MemoryRing ring;
    ring.sb = sb;
    if (ring_scratch == nullptr) {
      ring.base = ring_smem + t % kLanes;
      ring.stride = kLanes;
    } else if (live) {
      ring.base = ring_scratch + lane;
      ring.stride = n_lanes;
    } else {
      ring.base = ring_smem + t % kLanes;
      ring.stride = 0;
    }
    scan_warp<SB>(smem, ring, n_stores, n_chunks, t, carry);
  }
  if (t >= kLanes || !live) return;
  if (!ok) {
    out_c[lane] = __int_as_float(0x7fc00000);  // NaN
    out_at_head[lane] = -1;
    out_sb_full[lane] = -1;
    return;
  }
  out_c[lane] = carry.last;
  out_at_head[lane] = carry.at_head;
  out_sb_full[lane] = carry.sb_full;
}

template <int SB>
int launch(const float* a_bank, const float* w_bank, const float* v_bank,
           const uint8_t* p_bank, const int32_t* trace_idx,
           const int32_t* wv_idx, int n_lanes, int64_t n_stores,
           int64_t trace_rows, int64_t wv_rows, int sb, float* ring_scratch,
           size_t ring_bytes, float* out_c, int32_t* out_at_head,
           int32_t* out_sb_full, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBuffersBytes) + ring_bytes;
  auto kernel = bank_scan_kernel<SB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_lanes + kLanes - 1) / kLanes;
  kernel<<<blocks, kThreads, smem, stream>>>(
      a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx, n_lanes, n_stores,
      trace_rows, wv_rows, sb, ring_scratch, out_c, out_at_head,
      out_sb_full);
  return static_cast<int>(cudaGetLastError());
}

// The register-ring instantiation of depth sb, from kRegisterDepths[K] on;
// cudaErrorInvalidValue for a depth without one.
template <int K = 0>
int launch_register(const float* a_bank, const float* w_bank,
                    const float* v_bank, const uint8_t* p_bank,
                    const int32_t* trace_idx, const int32_t* wv_idx,
                    int n_lanes, int64_t n_stores, int64_t trace_rows,
                    int64_t wv_rows, int sb, float* out_c,
                    int32_t* out_at_head, int32_t* out_sb_full,
                    cudaStream_t stream) {
  if constexpr (K == kRegisterRings) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (sb == kRegisterDepths[K])
      return launch<kRegisterDepths[K]>(
          a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx, n_lanes,
          n_stores, trace_rows, wv_rows, sb, nullptr, 0, out_c, out_at_head,
          out_sb_full, stream);
    return launch_register<K + 1>(a_bank, w_bank, v_bank, p_bank, trace_idx,
                                  wv_idx, n_lanes, n_stores, trace_rows,
                                  wv_rows, sb, out_c, out_at_head,
                                  out_sb_full, stream);
  }
}

}  // namespace

// The k-th depth with a register-ring instantiation, for k from 0 on, and 0
// past the last.
extern "C" int bank_scan_register_ring_depth(int k) {
  return k >= 0 && k < kRegisterRings ? kRegisterDepths[k] : 0;
}

// The deepest ring that fits shared memory; deeper rings need a scratch
// buffer of sb * n_lanes floats from the caller.
extern "C" int bank_scan_max_shared_sb() { return kMaxSharedSb; }

// Launches the scan on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take. Every pointer is
// device memory. `ring` picks the instantiation: 0 the register ring (sb
// one of bank_scan_register_ring_depth's), 1 the shared-memory ring (sb <=
// bank_scan_max_shared_sb()), 2 the scratch ring in `ring_scratch` (sb *
// n_lanes floats; null otherwise).
extern "C" int bank_scan_launch(
    const float* a_bank, const float* w_bank, const float* v_bank,
    const uint8_t* p_bank, const int32_t* trace_idx, const int32_t* wv_idx,
    int n_lanes, int64_t n_stores, int64_t trace_rows, int64_t wv_rows,
    int sb, int ring, float* ring_scratch, float* out_c,
    int32_t* out_at_head, int32_t* out_sb_full, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lanes <= 0 || n_stores <= 0 || sb < 1
      || (ring == kScratchRing) != (ring_scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (ring) {
    case kRegisterRing:
      return launch_register(a_bank, w_bank, v_bank, p_bank, trace_idx,
                             wv_idx, n_lanes, n_stores, trace_rows, wv_rows,
                             sb, out_c, out_at_head, out_sb_full, s);
    case kSharedRing:
      if (sb > bank_scan_max_shared_sb())
        return static_cast<int>(cudaErrorInvalidValue);
      return launch<0>(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx,
                       n_lanes, n_stores, trace_rows, wv_rows, sb, nullptr,
                       static_cast<size_t>(kLanes) * sb * sizeof(float),
                       out_c, out_at_head, out_sb_full, s);
    case kScratchRing:
      return launch<0>(a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx,
                       n_lanes, n_stores, trace_rows, wv_rows, sb,
                       ring_scratch, kLanes * sizeof(float), out_c,
                       out_at_head, out_sb_full, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bank_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
