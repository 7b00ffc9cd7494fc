// Fused receive-side decode + reduce: unpack residual and lo planes, decode
// the zero-escaped exponent, merge, widen to f32, add into the accumulator.
//
// Replaces the TPU kernel src/repro/kernels/decode_reduce.py::
// _decode_reduce_kernel (pallas_call at decode_reduce.py:87).  Bit-identical
// to its plain version, repro_torch/kernels/ref.py::decode_reduce, for all
// five float formats (NaN compared as NaN).
//
// Bound: device-memory bytes: (width + lo_bits) * 4 / 32 bytes of planes,
// 4 / 32 of group base and 8 of accumulator (read + write) per element, a
// dozen integer operations and one f32 add.  The design makes exactly that
// one pass: one warp per GROUP of 32 values, lane b < width + lo_bits loads
// one plane word and __shfl_sync hands it to the other lanes, so the packed
// wire is read once and the decoded floats never reach device memory; the
// accumulator is read and written once, coalesced.
//
// The accumulator is updated IN PLACE.  That is safe on the main path because
// _decode_reduce_chunks saves the exception blocks' accumulator rows before
// the call and rewrites them afterwards.  The exponent is merged in the
// format's own unsigned width, so the clamped garbage of an exception block
// truncates exactly as the reference does (decode_reduce.py:61-69).  The add
// is __fadd_rn and the build passes neither fast-math nor flush-to-zero, so
// subnormals are kept.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// exact widening of a TOTAL-bit pattern to f32
template <int TOTAL, int EXP, int MANT>
__device__ __forceinline__ float widen(uint32_t bits) {
  if constexpr (TOTAL == 32) {
    return __uint_as_float(bits);
  } else if constexpr (TOTAL == 16 && EXP == 8) {  // bfloat16
    return __uint_as_float(bits << 16);
  } else if constexpr (TOTAL == 16) {  // float16
    return __half2float(__ushort_as_half((unsigned short)bits));
  } else if constexpr (EXP == 4) {  // float8_e4m3fn
    return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)bits, __NV_E4M3)));
  } else {  // float8_e5m2
    return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)bits, __NV_E5M2)));
  }
}

template <int TOTAL, int EXP, int MANT>
__global__ void decode_reduce_kernel(const uint32_t* __restrict__ pay,
                                     const uint32_t* __restrict__ lo_planes,
                                     const uint32_t* __restrict__ group_bases,
                                     float* __restrict__ acc,
                                     long long n_groups, int width) {
  constexpr int LO_BITS = 1 + MANT;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= n_groups) return;  // the whole warp leaves together

  const uint32_t pw = lane < width ? pay[g * width + lane] : 0u;
  const uint32_t lw = lane < LO_BITS ? lo_planes[g * LO_BITS + lane] : 0u;
  uint32_t r = 0u;
  for (int b = 0; b < width; ++b) {
    r |= ((__shfl_sync(FULL, pw, b) >> lane) & 1u) << b;
  }
  uint32_t lo = 0u;
#pragma unroll
  for (int b = 0; b < LO_BITS; ++b) {
    lo |= ((__shfl_sync(FULL, lw, b) >> lane) & 1u) << b;
  }

  // zero escape: code 0 is exponent 0; code r > 0 is (r + base - 1) & 0xFF
  const uint32_t e = r == 0u ? 0u : ((r + group_bases[g] - 1u) & 0xFFu);
  constexpr uint32_t MASK = (uint32_t)((1ull << TOTAL) - 1ull);
  const uint32_t bits =
      (((lo >> MANT) << (TOTAL - 1)) | (e << MANT) | (lo & ((1u << MANT) - 1u))) & MASK;

  const long long i = g * 32 + lane;
  acc[i] = __fadd_rn(acc[i], widen<TOTAL, EXP, MANT>(bits));
}

template <int TOTAL, int EXP, int MANT>
void launch(const void* pay, const void* lo, const void* gb, void* acc,
            long long n_groups, int width, cudaStream_t stream) {
  constexpr int WARPS = 8;  // groups per thread block
  const long long grid = (n_groups + WARPS - 1) / WARPS;
  decode_reduce_kernel<TOTAL, EXP, MANT><<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      static_cast<const uint32_t*>(pay), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(gb), static_cast<float*>(acc), n_groups, width);
}

}  // namespace

// pay (n_groups, width), lo (n_groups, lo_bits), group_bases (n_groups,):
// 32-bit words; acc: f32 (32 * n_groups,), updated in place.  `fmt` indexes
// repro_torch.kernels.FORMATS; 1 <= width <= 32.  Returns cudaGetLastError().
extern "C" int decode_reduce_launch(const void* pay, const void* lo,
                                    const void* group_bases, void* acc,
                                    int n_groups, int width, int fmt,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: launch<32, 8, 23>(pay, lo, group_bases, acc, n_groups, width, s); break;
    case 1: launch<16, 5, 10>(pay, lo, group_bases, acc, n_groups, width, s); break;
    case 2: launch<16, 8, 7>(pay, lo, group_bases, acc, n_groups, width, s); break;
    case 3: launch<8, 4, 3>(pay, lo, group_bases, acc, n_groups, width, s); break;
    case 4: launch<8, 5, 2>(pay, lo, group_bases, acc, n_groups, width, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
