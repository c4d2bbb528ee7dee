// Store-buffer timeline under the five commit rules, for Hopper (sm_90a).
//
// Replaces two lax.scans of the JAX package, not a Pallas kernel:
// src/repro/core/simulator.py :: _timeline (the serial oracle, one cell, its
// config static) and :: _timeline_batch (the per-step engine, time-major
// (n_stores, B) cells, the config picked per lane by config_idx, each lane
// with its own store-buffer depth). Per store i of a lane, with a_i the
// arrival, co_i the coalesce flag, coh_i the exposed coherence latency,
// tr_i the REPL->ACK latency and sv_i the replica's log service time:
//
//   old = c_{i-sb}                     (0.0 while i < sb)
//   r   = max(a, old)                  sb_full += old > a
//   wb         c = max(r, last) + t_l1
//   wt         c = max(r, last) + t_wt
//   baseline   c = max(r, last) + (co ? t_l1 : coh + tr)
//   parallel   c = max(r, last) + (co ? t_l1 : max(coh, tr))
//   proactive  c = co ? max(r, last) + t_l1
//                     : max(max(r + tr, r + coh), last + sv)
//              at_head += !co && r >= last
//   last = c
//
// Outputs per lane: the last commit time (f32), at_head and sb_full (i32).
// The rules are applied as written, before the max-plus collapse
// c = max(r + w, last + v) that bank_scan.cu scans: this kernel checks that
// collapse independently.
//
// What bounds it on an H100. A lane reads each store's inputs once, the bytes
// its rule reads (wb, wt 4: a; baseline, parallel 13: a, co, coh, tr;
// proactive 17: all five; the per-step mode all 17, and each lane's
// config_idx and sb_size once), and writes 12 bytes of outputs: at most
// 0.85 MB a lane at the paper's 50 000 stores, 0.25 us of the card's
// 3.35 TB/s. So the roofline is far below the serial chain: c_i needs c_{i-1}
// through two dependent f32 operations (max(r, last) and the add;
// proactive's last + sv and the max), ~0.2 ms at 50 000 stores whatever the
// number of lanes. The recurrence cannot be reassociated into a parallel
// scan: f32 addition is not associative and the result must stay
// bit-identical to the plain version and the JAX package. So the design
// takes everything else off the chain, as bank_scan.cu does.
//
// Design. A block holds 8 lanes and 6 warps. Copy warp k (1..5) stages input
// k - 1 (a, co, coh, tr, sv) of the block's lanes into shared memory with
// cp.async, 432 stores at a time, into three rotating buffers; named barriers
// (bar.arrive / bar.sync) hand each buffer to the scan warp and back, and a
// rule stages only the inputs it reads (wb / wt: a alone). The serial oracle's
// lone lane is a contiguous row per input: 16-byte copies where the segment is
// 16-byte aligned, 4-byte copies or single elements where it is not (a view
// that starts at element 1). The per-step engine's lanes are time-major: a
// copy warp transposes a [432 stores x 8 lanes] tile into per-lane rows,
// 4-byte copies for the f32 inputs, batches of byte loads for co. The scan
// warp, one thread per lane, reads only shared memory and registers, four
// stores at a time (a float4 of each input, a word of co): each row is padded
// to an odd number of 16-byte units, so the reads of the 8 lanes fall in 8
// different bank quads, and its index arithmetic is 32-bit within a chunk. At
// the repo's depths (kRegisterDepths: sb 72, the paper's Table II SB, and 48,
// the mega-grid's second size) the ring of the last sb commits lives in
// registers: the inner loop is unrolled over lcm(4, sb) stores, so ring slot k
// is a fixed register and no load, store or wrap test sits beside the chain (a
// body of lcm(16, sb) = 144 stores at sb 72 let ptxas hoist a whole body's
// reads and spill the ring). The per-step engine takes it when every lane has
// that depth (the wrapper reads the lanes' depths); mixed depths keep an
// sb_max-wide ring, read at (i - sb) % sb_max, in shared memory ([k * 8 + t],
// up to kMaxSharedRing slots) or past that in a device scratch buffer
// ([k * n_lanes + lane]) the caller passes. A template parameter fixes the
// serial oracle's rule at compile time; the per-step engine's eight lanes
// may each have another rule, applied without divergence: the extra term is
// picked by selects off the chain, both commits (max(r, last) + extra and
// proactive's non-coalesced one) are computed, each two operations from
// `last`, and one select keeps the lane's. The census is one compare and one
// predicated add per counter, off the chain.
//
// Only IEEE add, fmaxf, compares and selects, in the reference's order, no
// multiply, and no fast-math or -ftz, so results are bit-identical to the
// plain version and the JAX package. A lane whose depth is outside [1,
// ring_width] (on the register ring: not its depth) or whose config is not
// one of the five writes NaN and -1 counts.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 8;               // lanes per block
constexpr int kInputs = 5;              // a, co, coh, tr, sv: a copy warp each
constexpr int kThreads = 32 * (1 + kInputs);
constexpr int kStages = 3;              // buffers in the copy pipeline
constexpr int kChunk = 432;             // stores per buffer
constexpr int kMaxSharedRing = 384;     // 12 KB of rings beside the buffers
constexpr int kFull = 1;                // named barriers kFull + buffer
constexpr int kEmpty = kFull + kStages; // and kEmpty + buffer
constexpr int kPerLaneConfig = -1;      // the config comes from config_idx

enum Config { kWb = 0, kWt = 1, kBaseline = 2, kParallel = 3,
              kProactive = 4 };
enum RingKind { kRegisterRing = 0, kSharedRing = 1, kScratchRing = 2 };
enum Input { kA = 0, kCo = 1, kCoh = 2, kTr = 3, kSv = 4 };

// Store-buffer depths with a register-ring instantiation: the paper's SB
// (Table II) and the mega-grid's second size. launch_register dispatches on
// them, store_timeline_launch checks them and
// store_timeline_register_ring_depth exports them.
constexpr int kRegisterDepths[] = {48, 72};
constexpr int kRegisterRings = sizeof(kRegisterDepths) / sizeof(int);

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Stores per unrolled body of the scan: a multiple of 4 (one float4 of each
// input, one word of co) and of the register ring's depth sb (sb == 0: a
// ring in memory).
constexpr int body_stores(int sb) { return sb > 0 ? 4 / gcd(4, sb) * sb : 16; }
template <int SB>
constexpr int kBodyStores = body_stores(SB);

constexpr bool is_register_depth(int sb, int k = 0) {
  return k < kRegisterRings
         && (sb == kRegisterDepths[k] || is_register_depth(sb, k + 1));
}

// Row strides in shared memory: an odd number of 16-byte units, so the
// float4 reads of the 8 lanes fall in 8 different bank quads (and their
// words of co in 8 different banks).
constexpr int kLdF = (kChunk / 4) % 2 ? kChunk : kChunk + 4;     // floats
constexpr int kLdP = (kChunk / 16) % 2 ? kChunk : kChunk + 16;   // bytes
constexpr int kFloatInputs = 4;                                  // a coh tr sv
constexpr int kBufBytes = kFloatInputs * kLanes * kLdF * 4 + kLanes * kLdP;
constexpr int kBuffersBytes = kStages * kBufBytes;
constexpr bool chunk_holds_bodies(int k = 0) {
  return k == kRegisterRings
         || (kChunk % body_stores(kRegisterDepths[k]) == 0
             && chunk_holds_bodies(k + 1));
}
static_assert(chunk_holds_bodies(), "a chunk holds whole bodies");
static_assert(kBufBytes % 16 == 0, "buffers stay 16-byte aligned");
static_assert(kBuffersBytes + kLanes * kMaxSharedRing * 4 <= 232448,
              "buffers and the shared ring fit a block's shared memory");

// Whether rule CFG reads `input` (wb and wt read the arrivals alone).
template <int CFG>
__device__ __forceinline__ bool reads(int input) {
  if (CFG == kWb || CFG == kWt) return input == kA;
  if (CFG == kBaseline || CFG == kParallel) return input != kSv;
  return true;
}

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

// One contiguous row segment of `len` words of `bytes` each into shared
// memory, by the 32 threads of a copy warp: 16-byte copies where the
// segment is 16-byte aligned, else 4-byte copies where it is 4-byte
// aligned, and single elements for the rest.
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

// A time-major [len stores x lanes] f32 tile (store i of lane l at
// src[i * n_lanes + l]) into per-lane rows dst[l * kLdF + i]: thread t
// copies lane t % 8 of every fourth store, so a warp's copies read four
// stores' neighbouring words.
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int64_t n_lanes, int len,
                                           int lanes, int t) {
  const int l = t % kLanes;
  if (l >= lanes) return;
  const int64_t step = 4 * n_lanes;
  const float* s = src + (t / kLanes) * n_lanes + l;
  float* d = dst + l * kLdF;
  for (int i = t / kLanes; i < len; i += 4, s += step) cp_async_4(d + i, s);
}

// The same for the coalesce bytes (cp.async copies 4 bytes at least):
// batches of byte loads, all in flight before their shared stores.
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint8_t* src,
                                           int64_t n_lanes, int len,
                                           int lanes, int t) {
  constexpr int kBatch = 27;              // 4 batches cover a chunk
  const int l = t % kLanes;
  if (l >= lanes) return;
  uint8_t* d = dst + l * kLdP;
  for (int i0 = t / kLanes; i0 < len; i0 += 4 * kBatch) {
    uint8_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 4 * u;
      v[u] = i < len ? src[i * n_lanes + l] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 4 * u;
      if (i < len) d[i] = v[u];
    }
  }
}

struct Buffer {
  float* f;      // [a, coh, tr, sv][lane][kLdF]
  uint8_t* co;   // [lane][kLdP]
  __device__ Buffer(uint8_t* smem, int b) {
    f = reinterpret_cast<float*>(smem + b * kBufBytes);
    co = reinterpret_cast<uint8_t*>(f + kFloatInputs * kLanes * kLdF);
  }
  // lane t's row of a float input
  __device__ float* row(int input, int t) const {
    return f + ((input == kA ? 0 : input - 1) * kLanes + t) * kLdF;
  }
};

// Copy warp of `input`: stages it for the block's lanes, chunk by chunk,
// kStages buffers deep: chunk c + 1 is signalled full as soon as it has
// landed, before the warp waits for chunk c's buffer to be scanned and
// refills it with chunk c + kStages. `src` points at store 0 of the block's
// first lane.
template <int CFG>
__device__ void copy_warp(uint8_t* smem, int input, const void* src,
                          int64_t n_lanes, int lanes, int64_t n,
                          int n_chunks, int t) {
  if (n_chunks == 0) return;
  const bool wanted = reads<CFG>(input);
  auto stage = [&](int c) {
    if (c >= n_chunks || !wanted) return;
    const Buffer buf(smem, c % kStages);
    const int64_t row0 = static_cast<int64_t>(c) * kChunk;
    const int len = static_cast<int>(n - row0 < kChunk ? n - row0 : kChunk);
    const int64_t at = row0 * n_lanes;
    if (input == kCo) {
      const uint8_t* s = static_cast<const uint8_t*>(src) + at;
      if (n_lanes == 1) stage_row(buf.co, s, len, t);
      else stage_tile(buf.co, s, n_lanes, len, lanes, t);
    } else {
      const float* s = static_cast<const float*>(src) + at;
      if (n_lanes == 1) stage_row(buf.row(input, 0), s, len, t);
      else stage_tile(buf.row(input, 0), s, n_lanes, len, lanes, t);
    }
    __syncwarp();                       // bar.arrive is warp-aligned
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

// A lane's rule, as constants the compiler folds when CFG fixes it.
template <int CFG>
struct Rule {
  bool fixed_only;       // wb, wt: the extra term is always `fixed`
  bool baseline;         // coh + tr for a non-coalesced store, else max
  uint32_t not_proactive;
  float fixed;           // t_wt for wt, t_l1 for the others
  __device__ Rule(int cfg, float t_l1, float t_wt) {
    const int k = CFG == kPerLaneConfig ? cfg : CFG;
    fixed_only = k == kWb || k == kWt;
    baseline = k == kBaseline;
    not_proactive = k == kProactive ? 0u : 1u;
    fixed = k == kWt ? t_wt : t_l1;
  }
};

struct Carry {
  float last;
  int32_t at_head;
  int32_t sb_full;
};

// The census, as one compare and one predicated add.
__device__ __forceinline__ void count_if_greater(int32_t& n, float x,
                                                 float y) {
  asm("{\n .reg .pred q;\n setp.gt.f32 q, %1, %2;\n @q add.s32 %0, %0, 1;\n}"
      : "+r"(n) : "f"(x), "f"(y));
}

// q = (gate == 0), the proactive rule's non-coalesced store:
//   at_head += q && r >= last;  returns q ? c_pr : c_serial
// One select after the two commits, each two operations from `last`: a
// predicated pair writing one register would make the second wait on the
// first.
__device__ __forceinline__ float pick(uint32_t gate, float r, float last,
                                      float c_serial, float c_pr,
                                      int32_t& at_head) {
  float c;
  asm("{\n"
      " .reg .pred q, h;\n"
      " setp.eq.u32 q, %2, 0;\n"
      " setp.ge.and.f32 h, %3, %4, q;\n"
      " @h add.s32 %1, %1, 1;\n"
      " selp.f32 %0, %5, %6, q;\n"
      "}"
      : "=f"(c), "+r"(at_head)
      : "r"(gate), "f"(r), "f"(last), "f"(c_pr), "f"(c_serial));
  return c;
}

// One store: its commit time from c_{i-sb} (`old`) and carry.last, with
// the census; `co` is the store's coalesce byte, in place in its word.
template <int CFG>
__device__ __forceinline__ float step(const Rule<CFG>& rule, float a,
                                      uint32_t co, float coh, float tr,
                                      float sv, float old, Carry& carry) {
  const float r = fmaxf(a, old);
  count_if_greater(carry.sb_full, old, a);
  float extra = rule.fixed;
  if constexpr (CFG == kBaseline || CFG == kParallel
                || CFG == kPerLaneConfig) {
    const float own = rule.baseline ? coh + tr : fmaxf(coh, tr);
    if (co == 0 && !rule.fixed_only) extra = own;
  }
  if constexpr (CFG == kProactive || CFG == kPerLaneConfig) {
    const float y = fmaxf(r + tr, r + coh);
    return pick(co | rule.not_proactive, r, carry.last,
                fmaxf(r, carry.last) + extra, fmaxf(y, carry.last + sv),
                carry.at_head);
  } else {
    return fmaxf(r, carry.last) + extra;
  }
}

// The ring of the last SB commit times in registers: after the inner loops
// are unrolled, slot k % SB names a fixed register.
template <int SB>
struct RegisterRing {
  float cell[SB];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < SB; ++k) cell[k] = 0.0f;
  }
  __device__ __forceinline__ float take(int k) { return cell[k % SB]; }
  __device__ __forceinline__ void put(int k, float c) { cell[k % SB] = c; }
};

// A ring of `width` slots in shared memory or a device scratch buffer, slot
// k at base[k * stride], read at (i - sb) % width and written at
// i % width. c_{i+1-sb} is read before c_i is stored (its slot is another
// one when sb > 1; at sb == 1 it is c_i itself, kept in a register).
struct MemoryRing {
  float* base;
  int64_t stride;
  int width;
  bool sb1;
  int rd_slot, wr_slot;
  float* rd;
  float* wr;
  float old, next;
  __device__ void setup(float* b, int64_t s, int w, int sb) {
    base = b;
    stride = s;
    width = w;
    sb1 = sb == 1;
    rd_slot = (w - sb) % w;
    wr_slot = 0;
    rd = base + rd_slot * stride;
    wr = base;
  }
  __device__ __forceinline__ void init() {
    for (int k = 0; k < width; ++k) base[k * stride] = 0.0f;
    old = 0.0f;
  }
  __device__ __forceinline__ float take(int) {
    rd += stride;
    if (++rd_slot == width) {
      rd_slot = 0;
      rd = base;
    }
    next = *rd;
    return old;
  }
  __device__ __forceinline__ void put(int, float c) {
    *wr = c;
    wr += stride;
    if (++wr_slot == width) {
      wr_slot = 0;
      wr = base;
    }
    old = sb1 ? c : next;
  }
};

// Inputs of four stores, read from shared memory as float4.
struct Quad {
  float4 a, coh, tr, sv;
};

__device__ __forceinline__ Quad load_quad(const Buffer& buf, int t, int i4) {
  auto at = [&](int input) {
    return *reinterpret_cast<const float4*>(buf.row(input, t) + i4);
  };
  return Quad{at(kA), at(kCoh), at(kTr), at(kSv)};
}

// Stores [k0, k0 + kBody) of the chunk in shared memory, one lane's rows;
// with kGuard, stores at or past `len` are not taken (the last chunk).
template <int CFG, int SB, bool kGuard, class Ring>
__device__ __forceinline__ void scan_body(const Buffer& buf, int t, int k0,
                                          int len, const Rule<CFG>& rule,
                                          Ring& ring, Carry& carry) {
  constexpr int kQuads = kBodyStores<SB> / 4;
  const uint8_t* co = buf.co + t * kLdP;
  auto load_co = [&](int i4) {
    return reads<CFG>(kCo) ? *reinterpret_cast<const uint32_t*>(co + i4)
                           : 0u;
  };
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const Quad cur = load_quad(buf, t, k0 + 4 * j);
    const uint32_t cw = load_co(k0 + 4 * j);
    const float av[4] = {cur.a.x, cur.a.y, cur.a.z, cur.a.w};
    const float cohv[4] = {cur.coh.x, cur.coh.y, cur.coh.z, cur.coh.w};
    const float trv[4] = {cur.tr.x, cur.tr.y, cur.tr.z, cur.tr.w};
    const float svv[4] = {cur.sv.x, cur.sv.y, cur.sv.z, cur.sv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * j + e;
      if (kGuard && k0 + k >= len) return;
      const float old = ring.take(k);
      const float c = step<CFG>(rule, av[e], cw & (0xffu << (8 * e)),
                                cohv[e], trv[e], svv[e], old, carry);
      ring.put(k, c);
      carry.last = c;
    }
  }
}

// The scan warp: thread t < kLanes scans lane t's rows (when `active`),
// chunk by chunk, from shared memory; the warp's other threads only keep
// the barriers.
template <int CFG, int SB, class Ring>
__device__ void scan_warp(uint8_t* smem, const Rule<CFG>& rule, Ring& ring,
                          bool active, int64_t n, int n_chunks, int t,
                          Carry& carry) {
  constexpr int kBody = kBodyStores<SB>;
  if (active) ring.init();
  for (int c = 0; c < n_chunks; ++c) {
    bar_sync(kFull + c % kStages);
    if (active) {
      const Buffer buf(smem, c % kStages);
      const int64_t row0 = static_cast<int64_t>(c) * kChunk;
      const int len = static_cast<int>(n - row0 < kChunk ? n - row0
                                                         : kChunk);
      if (len == kChunk) {
#pragma unroll 1
        for (int k0 = 0; k0 < kChunk; k0 += kBody)
          scan_body<CFG, SB, false>(buf, t, k0, len, rule, ring, carry);
      } else {
#pragma unroll 1
        for (int k0 = 0; k0 < len; k0 += kBody)
          scan_body<CFG, SB, true>(buf, t, k0, len, rule, ring, carry);
      }
    }
    __syncwarp();
    if (c + kStages < n_chunks) bar_arrive(kEmpty + c % kStages);
  }
}

// CFG: the serial oracle's rule (0-4) or kPerLaneConfig. SB > 0: the
// register ring of that depth; SB == 0: a ring of ring_width slots in
// shared memory (scratch null) or in scratch. Warp 0 scans, warps 1-5 copy.
template <int CFG, int SB>
__global__ void __launch_bounds__(kThreads, 1)
store_timeline_kernel(const float* __restrict__ a,
                      const uint8_t* __restrict__ co,
                      const float* __restrict__ coh,
                      const float* __restrict__ tr,
                      const float* __restrict__ sv,
                      const int32_t* __restrict__ config_idx,
                      const int32_t* __restrict__ sb_size, int sb_all,
                      int n_lanes, int64_t n_stores, int ring_width,
                      float t_l1, float t_wt, float* __restrict__ scratch,
                      float* __restrict__ out_c,
                      int32_t* __restrict__ out_at_head,
                      int32_t* __restrict__ out_sb_full) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const int lane0 = blockIdx.x * kLanes;
  const int lanes = n_lanes - lane0 < kLanes ? n_lanes - lane0 : kLanes;
  const int n_chunks = static_cast<int>((n_stores + kChunk - 1) / kChunk);

  if (warp > 0) {
    const int input = warp - 1;
    const void* src = input == kA ? static_cast<const void*>(a + lane0)
                      : input == kCo ? static_cast<const void*>(co + lane0)
                      : input == kCoh ? static_cast<const void*>(coh + lane0)
                      : input == kTr ? static_cast<const void*>(tr + lane0)
                                     : static_cast<const void*>(sv + lane0);
    copy_warp<CFG>(smem, input, src, n_lanes, lanes, n_stores, n_chunks, t);
    return;
  }
  const int lane = lane0 + t;
  const bool live = t < lanes;
  const int cfg = CFG != kPerLaneConfig ? CFG
                  : live ? config_idx[lane] : kPerLaneConfig;
  const int sb = sb_size == nullptr ? sb_all : live ? sb_size[lane] : 0;
  const bool ok = live && cfg >= kWb && cfg <= kProactive
                  && (SB > 0 ? sb == SB : sb >= 1 && sb <= ring_width);
  const Rule<CFG> rule(cfg, t_l1, t_wt);
  Carry carry{0.0f, 0, 0};
  if constexpr (SB > 0) {
    RegisterRing<SB> ring;
    scan_warp<CFG, SB>(smem, rule, ring, ok, n_stores, n_chunks, t, carry);
  } else {
    MemoryRing ring;
    if (ok) {
      if (scratch == nullptr)
        ring.setup(reinterpret_cast<float*>(smem + kBuffersBytes) + t,
                   kLanes, ring_width, sb);
      else
        ring.setup(scratch + lane, n_lanes, ring_width, sb);
    }
    scan_warp<CFG, SB>(smem, rule, ring, ok, n_stores, n_chunks, t, carry);
  }
  if (!live) return;
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

struct Args {
  const float* a;
  const uint8_t* co;
  const float* coh;
  const float* tr;
  const float* sv;
  const int32_t* config_idx;
  const int32_t* sb_size;
  int sb;
  int n_lanes;
  int64_t n_stores;
  int ring_width;
  float t_l1;
  float t_wt;
  float* scratch;
  float* out_c;
  int32_t* out_at_head;
  int32_t* out_sb_full;
  cudaStream_t stream;
};

template <int CFG, int SB>
int launch(const Args& x, size_t ring_bytes) {
  const size_t smem = static_cast<size_t>(kBuffersBytes) + ring_bytes;
  auto kernel = store_timeline_kernel<CFG, SB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (x.n_lanes + kLanes - 1) / kLanes;
  kernel<<<blocks, kThreads, smem, x.stream>>>(
      x.a, x.co, x.coh, x.tr, x.sv, x.config_idx, x.sb_size, x.sb,
      x.n_lanes, x.n_stores, x.ring_width, x.t_l1, x.t_wt, x.scratch,
      x.out_c, x.out_at_head, x.out_sb_full);
  return static_cast<int>(cudaGetLastError());
}

// The register-ring instantiation of depth x.sb, from kRegisterDepths[K] on.
template <int CFG, int K = 0>
int launch_register(const Args& x) {
  if constexpr (K == kRegisterRings) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (x.sb == kRegisterDepths[K])
      return launch<CFG, kRegisterDepths[K]>(x, 0);
    return launch_register<CFG, K + 1>(x);
  }
}

template <int CFG>
int launch_ring(const Args& x, int ring) {
  switch (ring) {
    case kRegisterRing:
      return launch_register<CFG>(x);
    case kSharedRing:
      return launch<CFG, 0>(x, static_cast<size_t>(kLanes) * x.ring_width
                                   * sizeof(float));
    default:
      return launch<CFG, 0>(x, 0);
  }
}

}  // namespace

// The widest ring kept in shared memory; wider rings need a scratch buffer
// of ring_width * n_lanes floats from the caller.
extern "C" int store_timeline_max_shared_ring() { return kMaxSharedRing; }

// Stores a copy warp stages at a time: runs one below, at and one above it
// take the tail paths.
extern "C" int store_timeline_chunk_stores() { return kChunk; }

// The k-th depth with a register-ring instantiation, for k from 0 on, and 0
// past the last.
extern "C" int store_timeline_register_ring_depth(int k) {
  return k >= 0 && k < kRegisterRings ? kRegisterDepths[k] : 0;
}

// Launches the walk on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take. Every pointer is
// device memory; the five inputs are time-major (n_stores, n_lanes). `config`
// is 0-4 (wb, wt, baseline, parallel, proactive) for every lane, with
// config_idx null (the serial oracle), or -1 for a per-lane config_idx (the
// per-step engine). sb_size null gives every lane depth `sb`. `ring` picks the
// instantiation: 0 the register ring (sb one of
// store_timeline_register_ring_depth's, every lane of depth `sb`), 1 a ring of
// ring_width slots in shared memory (ring_width <=
// store_timeline_max_shared_ring()), 2 the same in `scratch` (ring_width *
// n_lanes floats; null otherwise).
extern "C" int store_timeline_launch(
    const float* a, const uint8_t* co, const float* coh, const float* tr,
    const float* sv, const int32_t* config_idx, const int32_t* sb_size,
    int config, int sb, int n_lanes, int64_t n_stores, int ring_width,
    int ring, float t_l1, float t_wt, float* scratch, float* out_c,
    int32_t* out_at_head, int32_t* out_sb_full, void* stream) {
  if (n_lanes <= 0 || n_stores < 0 || ring_width < 1
      || (config == kPerLaneConfig) != (config_idx != nullptr)
      || config < kPerLaneConfig || config > kProactive
      || (sb_size == nullptr && sb < 1)
      || ring < kRegisterRing || ring > kScratchRing
      || (ring == kScratchRing) != (scratch != nullptr)
      || (ring == kSharedRing && ring_width > kMaxSharedRing)
      || (ring == kRegisterRing
          && (!is_register_depth(sb) || sb > ring_width)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args x{a, co, coh, tr, sv, config_idx, sb_size, sb, n_lanes,
               n_stores, ring_width, t_l1, t_wt, scratch, out_c,
               out_at_head, out_sb_full, static_cast<cudaStream_t>(stream)};
  switch (config) {
    case kPerLaneConfig: return launch_ring<kPerLaneConfig>(x, ring);
    case kWb: return launch_ring<kWb>(x, ring);
    case kWt: return launch_ring<kWt>(x, ring);
    case kBaseline: return launch_ring<kBaseline>(x, ring);
    case kParallel: return launch_ring<kParallel>(x, ring);
    default: return launch_ring<kProactive>(x, ring);
  }
}

extern "C" const char* store_timeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
