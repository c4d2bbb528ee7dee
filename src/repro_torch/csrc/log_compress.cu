// ReCXL log-dump compressor and decompressor, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/log_compress/kernel.py ::
// compress_pallas (body _compress_kernel) and decompress_pallas (body
// _decompress_kernel). Over rows of 256 f32 words (one block of the log
// payload against the same words of its base, the last dumped version):
//
//   compress:   delta = v - b
//               scale = amax(|delta|) * (1/qmax)  (1 when amax == 0)
//               code  = clamp(round_half_even(delta / scale), -qmax, qmax)
//   decompress: out   = b + code * scale
//
// with qmax = 2^(bits-1) - 1: 127 for 8 bits, 7 for 4 bits (the int4
// range is kept in int8).
//
// Design: one warp per row, eight rows per 256-thread block; rows are
// independent, so the TPU's 8-row VMEM tile does not carry over. Lane t of
// the warp holds words [4t, 4t+4) and [128+4t, 128+4t+4) as two float4
// loads, so each warp reads its row's 1 KB of values and of base fully
// coalesced, and writes its codes as two 4-byte stores. The row's amax is
// a warp-shuffle reduction of fmaxf(fabsf(.)), which is exact in any
// order; lane 0 writes the scale.
//
// Bit-identity with the plain version (ref.py) and with the JAX package:
// every operation is an IEEE round-to-nearest intrinsic (__fsub_rn,
// __fdiv_rn, __fmul_rn, __fadd_rn), so nvcc cannot contract the
// decompress product and sum into an FMA or turn delta / scale into a
// multiply by a reciprocal; rintf rounds half to even like jnp.round. The
// scale is amax times the f32 reciprocal of qmax, because that is what XLA
// makes of the reference's amax / qmax (a division by a constant): the
// IEEE quotient differs from it in the last bit in some rows. The
// build uses no fast-math and no -ftz, so subnormal words, deltas and
// scales keep their IEEE values: decompress(compress(v, v)) == v holds for
// subnormal v too (the contract of the port).
//
// Non-finite input is outside the contract. It neither faults nor hangs:
// fmaxf ignores a NaN, so a NaN word leaves its row's amax to the other
// words, and its own code is -qmax (the clamp below maps NaN to -qmax); an
// infinite delta makes the scale infinite, every finite word's code 0 and
// the infinite word's code -qmax (inf / inf is NaN).
//
// What bounds it on an H100: bytes. Compress reads 8 B and writes 1 B per
// word, plus 4 B of scale per 256 words; decompress reads 5 B and writes
// 4 B per word, plus the same scale. At the paper's 500 MB state
// (125 M words) that is about 1.13 GB each way, 0.34 ms at 3.35 TB/s,
// against some 10 operations per word (a few GFLOP, microseconds at the
// f32 rate).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;            // words per row (the dump block)
constexpr int kRowsPerCta = 8;         // one warp per row
constexpr int kThreads = 32 * kRowsPerCta;

__device__ __forceinline__ float quantize(float delta, float scale,
                                          float qmax) {
  const float q = rintf(__fdiv_rn(delta, scale));
  // fmaxf first: a NaN quotient becomes -qmax instead of an undefined cast.
  return fminf(fmaxf(q, -qmax), qmax);
}

__global__ void compress_kernel(const float* __restrict__ values,
                                const float* __restrict__ base,
                                int64_t n_rows, float qmax, float inv_qmax,
                                int8_t* __restrict__ codes,
                                float* __restrict__ scales) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t off = row * kBlock + 4 * lane;
  const float4 v0 = *reinterpret_cast<const float4*>(values + off);
  const float4 v1 = *reinterpret_cast<const float4*>(values + off + 128);
  const float4 b0 = *reinterpret_cast<const float4*>(base + off);
  const float4 b1 = *reinterpret_cast<const float4*>(base + off + 128);
  float d[8] = {__fsub_rn(v0.x, b0.x), __fsub_rn(v0.y, b0.y),
                __fsub_rn(v0.z, b0.z), __fsub_rn(v0.w, b0.w),
                __fsub_rn(v1.x, b1.x), __fsub_rn(v1.y, b1.y),
                __fsub_rn(v1.z, b1.z), __fsub_rn(v1.w, b1.w)};
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(d[k]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
  const float scale = amax > 0.0f ? __fmul_rn(amax, inv_qmax) : 1.0f;
  char4 c0, c1;
  c0.x = static_cast<int8_t>(quantize(d[0], scale, qmax));
  c0.y = static_cast<int8_t>(quantize(d[1], scale, qmax));
  c0.z = static_cast<int8_t>(quantize(d[2], scale, qmax));
  c0.w = static_cast<int8_t>(quantize(d[3], scale, qmax));
  c1.x = static_cast<int8_t>(quantize(d[4], scale, qmax));
  c1.y = static_cast<int8_t>(quantize(d[5], scale, qmax));
  c1.z = static_cast<int8_t>(quantize(d[6], scale, qmax));
  c1.w = static_cast<int8_t>(quantize(d[7], scale, qmax));
  *reinterpret_cast<char4*>(codes + off) = c0;
  *reinterpret_cast<char4*>(codes + off + 128) = c1;
  if (lane == 0) scales[row] = scale;
}

__device__ __forceinline__ float dequantize(float b, int8_t c, float s) {
  return __fadd_rn(b, __fmul_rn(static_cast<float>(c), s));
}

__global__ void decompress_kernel(const int8_t* __restrict__ codes,
                                  const float* __restrict__ scales,
                                  const float* __restrict__ base,
                                  int64_t n_rows, float* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t off = row * kBlock + 4 * lane;
  const float s = scales[row];
  const char4 c0 = *reinterpret_cast<const char4*>(codes + off);
  const char4 c1 = *reinterpret_cast<const char4*>(codes + off + 128);
  const float4 b0 = *reinterpret_cast<const float4*>(base + off);
  const float4 b1 = *reinterpret_cast<const float4*>(base + off + 128);
  float4 o0, o1;
  o0.x = dequantize(b0.x, c0.x, s);
  o0.y = dequantize(b0.y, c0.y, s);
  o0.z = dequantize(b0.z, c0.z, s);
  o0.w = dequantize(b0.w, c0.w, s);
  o1.x = dequantize(b1.x, c1.x, s);
  o1.y = dequantize(b1.y, c1.y, s);
  o1.z = dequantize(b1.z, c1.z, s);
  o1.w = dequantize(b1.w, c1.w, s);
  *reinterpret_cast<float4*>(out + off) = o0;
  *reinterpret_cast<float4*>(out + off + 128) = o1;
}

int grid_for(int64_t n_rows) {
  return static_cast<int>((n_rows + kRowsPerCta - 1) / kRowsPerCta);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Words per row the kernels take.
extern "C" int log_compress_block() { return kBlock; }

// Launches compress on `stream` and returns cudaGetLastError(). Every
// pointer is device memory: values and base (n_rows, 256) f32, codes
// (n_rows, 256) int8, scales (n_rows,) f32, each contiguous and 16-byte
// aligned. bits is 8 or 4.
extern "C" int log_compress_launch(const float* values, const float* base,
                                   int64_t n_rows, int bits, int8_t* codes,
                                   float* scales, void* stream) {
  if (n_rows <= 0 || (bits != 8 && bits != 4) ||
      n_rows > static_cast<int64_t>(kRowsPerCta) * 0x7fffffff ||
      !aligned16(values) || !aligned16(base) || !aligned16(codes))
    return static_cast<int>(cudaErrorInvalidValue);
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float inv_qmax = 1.0f / qmax;   // IEEE f32 division on the host
  compress_kernel<<<grid_for(n_rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      values, base, n_rows, qmax, inv_qmax, codes, scales);
  return static_cast<int>(cudaGetLastError());
}

// Launches decompress on `stream` and returns cudaGetLastError(). codes
// (n_rows, 256) int8, scales (n_rows,) f32, base and out (n_rows, 256) f32,
// each contiguous and 16-byte aligned.
extern "C" int log_decompress_launch(const int8_t* codes, const float* scales,
                                     const float* base, int64_t n_rows,
                                     float* out, void* stream) {
  if (n_rows <= 0 ||
      n_rows > static_cast<int64_t>(kRowsPerCta) * 0x7fffffff ||
      !aligned16(codes) || !aligned16(base) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  decompress_kernel<<<grid_for(n_rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      codes, scales, base, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* log_compress_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
