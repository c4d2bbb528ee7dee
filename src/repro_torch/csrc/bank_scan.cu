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
// Design: one thread per lane walks its rows in store order. The ring of
// the last sb commits lives in shared memory, slot k of thread t at
// [k * blockDim + t] (no bank conflicts); where 32 lanes' rings exceed
// 48 KB, the wrapper passes a device scratch ring laid out
// [k * n_lanes + lane] instead. Only IEEE add and fmaxf, in the order above,
// and no fast-math, so results are bit-identical to the plain version and
// to the JAX package. A lane whose row index is out of range writes NaN and
// -1 counts instead of reading out of bounds.
//
// What bounds it on an H100: the roofline sees the unique bank rows a
// launch gathers, read once (<= (160 * 9 + 27 * 4) * 50 000 B = 77 MB for a
// mega-grid tile of 160 lanes) plus indices and outputs, against
// 3.35 TB/s -- about 0.02 ms -- and ~6 operations per lane-store. The real
// floor is the serial chain of n dependent steps per lane (50 000 at the
// paper's scale), which the roofline does not see, and one launch keeps
// only 48 (Fig. 10) or 160 (one tile) threads busy. Rows are
// store-contiguous, so the 32 threads of a warp read 32 different rows:
// each load is uncoalesced, but a thread reuses each 128-byte line for 32
// stores through L1. Staging (lanes x chunk) tiles through shared memory
// and more lanes per launch are the next steps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanesPerBlock = 32;
constexpr int kMaxSharedRingBytes = 48 * 1024;

__global__ void bank_scan_kernel(
    const float* __restrict__ a_bank, const float* __restrict__ w_bank,
    const float* __restrict__ v_bank, const uint8_t* __restrict__ p_bank,
    const int32_t* __restrict__ trace_idx, const int32_t* __restrict__ wv_idx,
    int n_lanes, int64_t n_stores, int64_t trace_rows, int64_t wv_rows,
    int sb, float* __restrict__ ring_scratch, float* __restrict__ out_c,
    int32_t* __restrict__ out_at_head, int32_t* __restrict__ out_sb_full) {
  extern __shared__ float ring_smem[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;

  const int64_t tr = trace_idx[lane];
  const int64_t wv = wv_idx[lane];
  if (tr < 0 || tr >= trace_rows || wv < 0 || wv >= wv_rows) {
    out_c[lane] = __int_as_float(0x7fc00000);  // NaN
    out_at_head[lane] = -1;
    out_sb_full[lane] = -1;
    return;
  }

  float* ring;
  int64_t stride;
  if (ring_scratch != nullptr) {
    ring = ring_scratch + lane;
    stride = n_lanes;
  } else {
    ring = ring_smem + threadIdx.x;
    stride = blockDim.x;
  }
  for (int k = 0; k < sb; ++k) ring[k * stride] = 0.0f;

  const float* a = a_bank + tr * n_stores;
  const float* w = w_bank + wv * n_stores;
  const float* v = v_bank + wv * n_stores;
  const uint8_t* p = p_bank + wv * n_stores;

  float last = 0.0f;
  int32_t at_head = 0;
  int32_t sb_full = 0;
  int slot = 0;
  for (int64_t i = 0; i < n_stores; ++i) {
    float* cell = ring + slot * stride;
    const float a_i = a[i];
    const float old = *cell;  // c_{i-sb}
    const float r = fmaxf(a_i, old);
    sb_full += old > a_i;
    at_head += (p[i] != 0) & (r >= last);
    const float c = fmaxf(r + w[i], last + v[i]);
    *cell = c;
    last = c;
    if (++slot == sb) slot = 0;
  }
  out_c[lane] = last;
  out_at_head[lane] = at_head;
  out_sb_full[lane] = sb_full;
}

}  // namespace

// The deepest ring that fits shared memory; deeper rings need a scratch
// buffer of sb * n_lanes floats from the caller.
extern "C" int bank_scan_max_shared_sb() {
  return kMaxSharedRingBytes / (kLanesPerBlock * static_cast<int>(sizeof(float)));
}

// Launches the scan on `stream` and returns cudaGetLastError(). Every
// pointer is device memory; `ring_scratch` is null when sb fits shared
// memory.
extern "C" int bank_scan_launch(
    const float* a_bank, const float* w_bank, const float* v_bank,
    const uint8_t* p_bank, const int32_t* trace_idx, const int32_t* wv_idx,
    int n_lanes, int64_t n_stores, int64_t trace_rows, int64_t wv_rows,
    int sb, float* ring_scratch, float* out_c, int32_t* out_at_head,
    int32_t* out_sb_full, void* stream) {
  if (n_lanes <= 0 || sb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ring_scratch == nullptr && sb > bank_scan_max_shared_sb())
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  const size_t smem = ring_scratch != nullptr
      ? 0 : static_cast<size_t>(kLanesPerBlock) * sb * sizeof(float);
  bank_scan_kernel<<<blocks, kLanesPerBlock, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      a_bank, w_bank, v_bank, p_bank, trace_idx, wv_idx, n_lanes, n_stores,
      trace_rows, wv_rows, sb, ring_scratch, out_c, out_at_head, out_sb_full);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bank_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
