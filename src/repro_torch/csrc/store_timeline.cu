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
// What bounds it on an H100. Each lane reads 17 bytes per store once (about
// 0.85 MB a lane at the paper's 50 000 stores: 0.25 us of the card's
// 3.35 TB/s), so the roofline is far below the serial chain: c_i needs
// c_{i-1} through max(r, last) and one add, two dependent f32 operations,
// ~0.2 ms at 50 000 stores whatever the number of lanes. The recurrence
// cannot be reassociated into a parallel scan: f32 addition is not
// associative and the result must stay bit-identical to the plain version
// and the JAX package.
//
// Design, simple first: one thread per lane walks the stores; 32 lanes a
// block. The inputs of the next 8 stores are loaded into registers while
// the current 8 are walked (in the time-major layout the 32 lanes of a warp
// read 32 neighbouring words). Where lanes interleave, each store is a new
// line, so the inputs kAhead stores further on are also prefetched into L2;
// a lone lane reads 32 stores from each line and needs no prefetch. The
// ring of a lane's last commits is `ring_width` slots (the serial oracle's
// sb, or the per-step engine's sb_max shared by lanes of different depths),
// written at slot i % ring_width and read at (i - sb) % ring_width, in
// shared memory ([slot * 32 + thread], no bank conflicts) up to
// kMaxSharedRing slots and past that in a device scratch buffer
// ([slot * n_lanes + lane]) the caller passes. The read of c_{i+1-sb} is
// issued before c_i is stored (its slot differs when sb > 1; at sb == 1 it
// is c_i itself, kept in a register), so the ring's latency stays off the
// chain as well. The per-lane rule is chosen with selects of the extra
// term, computed off the chain, and one select of the proactive commit; a
// template parameter fixes the serial oracle's config at compile time.
//
// Only IEEE add, fmaxf and compares, in the reference's order, and no
// fast-math or -ftz, so results are bit-identical to the plain version and
// the JAX package. A lane whose depth is outside [1, ring_width] or whose
// config is not one of the five writes NaN and -1 counts.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;        // lanes per block
constexpr int kGroup = 8;           // stores whose inputs are loaded ahead
constexpr int kAhead = 128;         // stores prefetched ahead into L2
constexpr int kMaxSharedRing = 384; // 48 KB of ring per block
constexpr int kPerLaneConfig = -1;  // the config comes from config_idx

enum Config { kWb = 0, kWt = 1, kBaseline = 2, kParallel = 3,
              kProactive = 4 };

struct Group {
  float a[kGroup];
  float coh[kGroup];
  float tr[kGroup];
  float sv[kGroup];
  bool co[kGroup];
};

// Inputs of stores [base, base + kGroup) of one lane (time-major, stride
// n_lanes); stores at or past n are not read.
__device__ __forceinline__ void load_group(
    Group& g, const float* __restrict__ a, const uint8_t* __restrict__ co,
    const float* __restrict__ coh, const float* __restrict__ tr,
    const float* __restrict__ sv, int64_t base, int64_t n, int64_t stride,
    int64_t lane) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int64_t i = base + u;
    if (i < n) {
      const int64_t at = i * stride + lane;
      g.a[u] = __ldg(a + at);
      g.coh[u] = __ldg(coh + at);
      g.tr[u] = __ldg(tr + at);
      g.sv[u] = __ldg(sv + at);
      g.co[u] = __ldg(co + at) != 0;
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// Prefetch into L2 the inputs of stores [base, base + kGroup) of one lane
// of several (stride > 1).
__device__ __forceinline__ void prefetch_group(
    const float* a, const uint8_t* co, const float* coh, const float* tr,
    const float* sv, int64_t base, int64_t n, int64_t stride, int64_t lane) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int64_t i = base + u;
    if (i >= n) return;
    const int64_t at = i * stride + lane;
    prefetch_l2(a + at);
    prefetch_l2(co + at);
    prefetch_l2(coh + at);
    prefetch_l2(tr + at);
    prefetch_l2(sv + at);
  }
}

// One store's commit time under rule `cfg` from its retire time r and the
// previous commit `last`, as the rules are written; counts the Fig. 11
// REPL-at-head candidates of the proactive rule.
__device__ __forceinline__ float commit(int cfg, bool pr, float extra_fixed,
                                       bool co, float coh, float tr,
                                       float sv, float r, float last,
                                       int32_t& at_head) {
  float extra = extra_fixed;
  if (!co) {
    if (cfg == kBaseline) extra = coh + tr;
    else if (cfg == kParallel) extra = fmaxf(coh, tr);
  }
  if (pr && !co) {
    if (r >= last) ++at_head;
    return fmaxf(fmaxf(r + tr, r + coh), last + sv);
  }
  return fmaxf(r, last) + extra;
}

template <int CFG>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float ring_smem[];
  const int t = threadIdx.x;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  if (lane >= n_lanes) return;
  const int cfg = CFG == kPerLaneConfig ? config_idx[lane] : CFG;
  const int sb = sb_size != nullptr ? sb_size[lane] : sb_all;
  if (sb < 1 || sb > ring_width || cfg < kWb || cfg > kProactive) {
    out_c[lane] = __int_as_float(0x7fc00000);  // NaN
    out_at_head[lane] = -1;
    out_sb_full[lane] = -1;
    return;
  }
  float* ring;
  int64_t ring_stride;
  if (scratch == nullptr) {
    ring = ring_smem + t;
    ring_stride = kThreads;
  } else {
    ring = scratch + lane;
    ring_stride = n_lanes;
  }
  for (int k = 0; k < ring_width; ++k) ring[k * ring_stride] = 0.0f;

  const bool pr = cfg == kProactive;
  // the extra term of the serial rules for a coalesced store, and for a
  // non-coalesced one of wb / wt (baseline and parallel take theirs per
  // store)
  const float extra_fixed = cfg == kWt ? t_wt : t_l1;
  int rd = ring_width - sb;   // slot of c_{i-sb}; 0 when sb == ring_width
  int wr = 0;                 // slot of c_i
  float old = 0.0f;           // c_{-sb}: the ring's initial zero
  float last = 0.0f;
  int32_t at_head = 0;
  int32_t sb_full = 0;

  const bool interleaved = n_lanes > 1;
  Group cur, nxt;
  if (interleaved)
    for (int64_t base = kGroup; base < kAhead; base += kGroup)
      prefetch_group(a, co, coh, tr, sv, base, n_stores, n_lanes, lane);
  load_group(cur, a, co, coh, tr, sv, 0, n_stores, n_lanes, lane);
  for (int64_t base = 0; base < n_stores; base += kGroup) {
    if (interleaved)
      prefetch_group(a, co, coh, tr, sv, base + kAhead, n_stores, n_lanes,
                     lane);
    if (base + kGroup < n_stores)
      load_group(nxt, a, co, coh, tr, sv, base + kGroup, n_stores, n_lanes,
                 lane);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (base + u >= n_stores) break;
      // c_{i+1-sb}, read before c_i is stored (its slot is another one
      // when sb > 1)
      const int rd_next = rd + 1 == ring_width ? 0 : rd + 1;
      const float old_next = ring[rd_next * ring_stride];
      const float r = fmaxf(cur.a[u], old);
      if (old > cur.a[u]) ++sb_full;
      last = commit(cfg, pr, extra_fixed, cur.co[u], cur.coh[u], cur.tr[u],
                    cur.sv[u], r, last, at_head);
      ring[wr * ring_stride] = last;
      old = sb == 1 ? last : old_next;
      rd = rd_next;
      wr = wr + 1 == ring_width ? 0 : wr + 1;
    }
    cur = nxt;
  }
  out_c[lane] = last;
  out_at_head[lane] = at_head;
  out_sb_full[lane] = sb_full;
}

template <int CFG>
int launch(const float* a, const uint8_t* co, const float* coh,
           const float* tr, const float* sv, const int32_t* config_idx,
           const int32_t* sb_size, int sb_all, int n_lanes, int64_t n_stores,
           int ring_width, float t_l1, float t_wt, float* scratch,
           float* out_c, int32_t* out_at_head, int32_t* out_sb_full,
           cudaStream_t stream) {
  const size_t smem = scratch == nullptr
      ? static_cast<size_t>(ring_width) * kThreads * sizeof(float) : 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  store_timeline_kernel<CFG><<<blocks, kThreads, smem, stream>>>(
      a, co, coh, tr, sv, config_idx, sb_size, sb_all, n_lanes, n_stores,
      ring_width, t_l1, t_wt, scratch, out_c, out_at_head, out_sb_full);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The widest ring kept in shared memory; wider rings need a scratch buffer
// of ring_width * n_lanes floats from the caller.
extern "C" int store_timeline_max_shared_ring() { return kMaxSharedRing; }

// Launches the walk on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take. Every pointer is
// device memory; the five inputs are time-major (n_stores, n_lanes).
// `config` is 0-4 (wb, wt, baseline, parallel, proactive) for every lane,
// with config_idx null (the serial oracle), or -1 for a per-lane config_idx
// (the per-step engine). sb_size null gives every lane depth `sb`. The
// ring is in shared memory when `scratch` is null (ring_width <=
// store_timeline_max_shared_ring()), else in `scratch`.
extern "C" int store_timeline_launch(
    const float* a, const uint8_t* co, const float* coh, const float* tr,
    const float* sv, const int32_t* config_idx, const int32_t* sb_size,
    int config, int sb, int n_lanes, int64_t n_stores, int ring_width,
    float t_l1, float t_wt, float* scratch, float* out_c,
    int32_t* out_at_head, int32_t* out_sb_full, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lanes <= 0 || n_stores < 0 || ring_width < 1
      || (scratch == nullptr && ring_width > kMaxSharedRing)
      || (config == kPerLaneConfig) != (config_idx != nullptr)
      || config < kPerLaneConfig || config > kProactive
      || (sb_size == nullptr && sb < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (config) {
#define STORE_TIMELINE_CASE(C)                                             \
    case C:                                                                \
      return launch<C>(a, co, coh, tr, sv, config_idx, sb_size, sb,        \
                       n_lanes, n_stores, ring_width, t_l1, t_wt, scratch, \
                       out_c, out_at_head, out_sb_full, s);
    STORE_TIMELINE_CASE(kPerLaneConfig)
    STORE_TIMELINE_CASE(kWb)
    STORE_TIMELINE_CASE(kWt)
    STORE_TIMELINE_CASE(kBaseline)
    STORE_TIMELINE_CASE(kParallel)
    STORE_TIMELINE_CASE(kProactive)
#undef STORE_TIMELINE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* store_timeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
