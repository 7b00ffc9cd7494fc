// Fused receive-side decode + reduce: unpack residual and lo planes, decode
// the zero-escaped exponent, merge, widen to f32, add into the accumulator.
//
// Replaces the TPU kernel src/repro/kernels/decode_reduce.py::
// _decode_reduce_kernel (pallas_call at decode_reduce.py:87).  Bit-identical
// to its plain version, repro_torch/kernels/ref.py::decode_reduce, for all
// five float formats (NaN compared as NaN).
//
// Bound: device-memory bytes: (width + lo_bits + 1) * 4 / 32 bytes of planes
// and group base and 8 of accumulator (read + write) per element (bf16 at
// width 5: 9.75 bytes, 82% of them the accumulator), a dozen integer
// operations and one f32 add.  The first kernel (a warp a group, one plane
// word a lane handed round by __shfl_sync, 13 shuffle-and-extract steps a
// value) issued ~50 instructions a value and kept 4 bytes of accumulator a
// lane in flight.  This design is unpack's (bitpack.cu) for two planes:
//
// * Persistent thread blocks (as many as the card holds at once) walk over
//   TILES of `tile_groups` groups, a multiple of 32.  A tile's payload
//   words, lo words and group bases are three contiguous ranges, staged into
//   shared memory a tile ahead by 16-byte cp.async (each range's <16-byte
//   tail by 4-byte cp.async), in two stages.
// * Each thread owns 4 consecutive values of a group (8 threads a group, 32
//   groups a pass) and reads and writes them as one 16-byte float4.  A
//   tile's accumulator loads (at most DECODE_REDUCE_MAX_TILE / 32 float4 a
//   thread, kept in registers) are issued before the wait on its staged
//   planes, so the bytes that dominate the traffic are in flight while the
//   planes land.
// * The planes unpack from shared memory by bitplane::unpack4: for widths
//   1-8 one multiply a plane spreads 4 values into the bytes of one word,
//   and the zero escape of all 4 is two SIMD byte operations (__vadd4 wraps
//   each byte, which is the `& 0xFF`; __vcmpeq4 finds the zero codes).  The
//   lo planes of bf16 and fp8 (8, 4, 3 bits) take the same byte route, those
//   of f16 and f32 (11, 24) a value a word.
// * Instantiated on the format and on `width` for 1-8 (the widths the paths
//   choose); one generic instantiation serves 9-32.
//
// The accumulator is updated IN PLACE.  That is safe on the main path because
// _decode_reduce_chunks saves the exception blocks' accumulator rows before
// the call and rewrites them afterwards.  The exponent is merged in the
// format's own unsigned width, so the clamped garbage of an exception block
// truncates exactly as the reference does (decode_reduce.py:61-69).  The add
// is __fadd_rn and the build passes neither fast-math nor flush-to-zero, so
// subnormals are kept.  The wrapper (kernels/decode_reduce.py::geometry)
// computes tile, grid and shared bytes and passes DECODE_REDUCE_THREADS,
// DECODE_REDUCE_MAX_TILE and SM_THREADS to nvcc as -D defines
// (kernels/__init__.py).  All four tensors must be 16-byte aligned (the
// wrapper raises otherwise; the entry point kernels/ops.py::decode_reduce
// hands it aligned copies of views that are not).
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane.cuh"
#include "staging.cuh"

#if !defined(DECODE_REDUCE_THREADS) || !defined(DECODE_REDUCE_MAX_TILE) || \
    !defined(SM_THREADS)
#error "build with kernels/__init__.py's NVCC_FLAGS (-DDECODE_REDUCE_THREADS, -DDECODE_REDUCE_MAX_TILE, -DSM_THREADS)"
#endif

namespace {

constexpr int PASS = DECODE_REDUCE_THREADS / 8;  // groups a pass of the thread block
constexpr int MAX_PASSES = DECODE_REDUCE_MAX_TILE / PASS;
constexpr int MIN_BLOCKS = SM_THREADS / DECODE_REDUCE_THREADS;  // resident blocks an SM
static_assert(MAX_PASSES >= 1 && DECODE_REDUCE_MAX_TILE % PASS == 0, "tile of whole passes");

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

// the 4 exponents (one a byte) of values `shift` .. + 3 of a group: code 0
// is exponent 0, code r > 0 is (r + base - 1) & 0xFF
template <int WT>
__device__ __forceinline__ uint32_t exponents4(const uint32_t* pw, int width, int shift,
                                               uint32_t base) {
  if constexpr (WT >= 1 && WT <= 8) {
    const uint32_t r4 = bitplane::unpack4_bytes<WT>(pw, shift);
    return __vadd4(r4, ((base - 1u) & 0xFFu) * 0x01010101u) & ~__vcmpeq4(r4, 0u);
  } else {
    const uint4 r = bitplane::unpack4<0>(pw, width, shift);
    const uint32_t r4[4] = {r.x, r.y, r.z, r.w};
    uint32_t e4 = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e4 |= (r4[i] == 0u ? 0u : ((r4[i] + base - 1u) & 0xFFu)) << (8 * i);
    return e4;
  }
}

template <int TOTAL, int EXP, int MANT, int WT>
__global__ void __launch_bounds__(DECODE_REDUCE_THREADS, MIN_BLOCKS)
decode_reduce_kernel(const uint32_t* __restrict__ pay, const uint32_t* __restrict__ lo_planes,
                     const uint32_t* __restrict__ group_bases, float* __restrict__ acc,
                     long long n_groups, int tile_groups, int width_rt) {
  constexpr int LO = 1 + MANT;
  constexpr uint32_t MASK = (uint32_t)((1ull << TOTAL) - 1ull);
  const int W = WT > 0 ? WT : width_rt;
  // a stage: the tile's payload words, then its lo words, then its bases
  extern __shared__ __align__(16) uint32_t s_words[];
  const int stage_words = tile_groups * (W + LO + 1);
  const long long n_tiles = (n_groups + tile_groups - 1) / tile_groups;

  auto copy = [](uint32_t* dst, const uint32_t* src, int words) {
    const int n4 = words >> 2;
    for (int c = threadIdx.x; c < n4; c += DECODE_REDUCE_THREADS)
      staging::cp_async16(dst + 4 * c, src + 4 * c);
    for (int i = (n4 << 2) + threadIdx.x; i < words; i += DECODE_REDUCE_THREADS)
      staging::cp_async4(dst + i, src + i);
  };
  auto load = [&](long long t, int stage) {
    const long long g0 = t * tile_groups;
    const int ng = (int)min((long long)tile_groups, n_groups - g0);
    uint32_t* dst = s_words + stage * stage_words;
    copy(dst, pay + g0 * W, ng * W);
    copy(dst + tile_groups * W, lo_planes + g0 * LO, ng * LO);
    copy(dst + tile_groups * (W + LO), group_bases + g0, ng);
  };

  // thread: groups sub, sub + PASS, ... of the tile, values 4 quad .. + 3
  const int sub = threadIdx.x >> 3, quad = threadIdx.x & 7;
  long long t = blockIdx.x;
  if (t < n_tiles) load(t, 0);
  staging::commit();
  for (int stage = 0; t < n_tiles; t += gridDim.x, stage ^= 1) {
    const long long g0 = t * tile_groups;
    const int ng = (int)min((long long)tile_groups, n_groups - g0);
    float4* acc4 = reinterpret_cast<float4*>(acc + g0 * 32);
    float4 a[MAX_PASSES];
#pragma unroll
    for (int k = 0; k < MAX_PASSES; ++k)
      if (sub + k * PASS < ng) a[k] = acc4[(sub + k * PASS) * 8 + quad];
    if (t + gridDim.x < n_tiles) load(t + gridDim.x, stage ^ 1);
    staging::commit();
    staging::wait_prev();
    __syncthreads();
    const uint32_t* s_pay = s_words + stage * stage_words;
    const uint32_t* s_lo = s_pay + tile_groups * W;
    const uint32_t* s_base = s_lo + tile_groups * LO;
#pragma unroll
    for (int k = 0; k < MAX_PASSES; ++k) {
      const int g = sub + k * PASS;
      if (g >= ng) break;
      const uint32_t e4 = exponents4<WT>(s_pay + g * W, W, 4 * quad, s_base[g]);
      uint32_t l4[4];
      if constexpr (LO <= 8) {
        const uint32_t b = bitplane::unpack4_bytes<LO>(s_lo + g * LO, 4 * quad);
#pragma unroll
        for (int i = 0; i < 4; ++i) l4[i] = (b >> (8 * i)) & 0xFFu;
      } else {
        const uint4 l = bitplane::unpack4<LO>(s_lo + g * LO, LO, 4 * quad);
        l4[0] = l.x, l4[1] = l.y, l4[2] = l.z, l4[3] = l.w;
      }
      float v[4] = {a[k].x, a[k].y, a[k].z, a[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t e = (e4 >> (8 * i)) & 0xFFu;
        const uint32_t bits = (((l4[i] >> MANT) << (TOTAL - 1)) | (e << MANT) |
                               (l4[i] & ((1u << MANT) - 1u))) & MASK;
        v[i] = __fadd_rn(v[i], widen<TOTAL, EXP, MANT>(bits));
      }
      acc4[g * 8 + quad] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();  // the stage is loaded again one iteration on
  }
}

template <int TOTAL, int EXP, int MANT, int WT>
int launch_w(const void* pay, const void* lo, const void* gb, void* acc, long long n_groups,
             int width, int tile_groups, int grid, int smem, cudaStream_t s) {
  auto kernel = decode_reduce_kernel<TOTAL, EXP, MANT, WT>;
  if (const int err = staging::allow_smem(kernel, smem)) return err;
  kernel<<<grid, DECODE_REDUCE_THREADS, smem, s>>>(
      static_cast<const uint32_t*>(pay), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(gb), static_cast<float*>(acc), n_groups, tile_groups,
      width);
  return (int)cudaGetLastError();
}

template <int TOTAL, int EXP, int MANT>
int launch(const void* pay, const void* lo, const void* gb, void* acc, long long n_groups,
           int width, int tile_groups, int grid, int smem, cudaStream_t s) {
#define DR_ARGS pay, lo, gb, acc, n_groups, width, tile_groups, grid, smem, s
  switch (width) {
    case 1: return launch_w<TOTAL, EXP, MANT, 1>(DR_ARGS);
    case 2: return launch_w<TOTAL, EXP, MANT, 2>(DR_ARGS);
    case 3: return launch_w<TOTAL, EXP, MANT, 3>(DR_ARGS);
    case 4: return launch_w<TOTAL, EXP, MANT, 4>(DR_ARGS);
    case 5: return launch_w<TOTAL, EXP, MANT, 5>(DR_ARGS);
    case 6: return launch_w<TOTAL, EXP, MANT, 6>(DR_ARGS);
    case 7: return launch_w<TOTAL, EXP, MANT, 7>(DR_ARGS);
    case 8: return launch_w<TOTAL, EXP, MANT, 8>(DR_ARGS);
    default: return launch_w<TOTAL, EXP, MANT, 0>(DR_ARGS);
  }
#undef DR_ARGS
}

}  // namespace

// pay (n_groups, width), lo (n_groups, lo_bits), group_bases (n_groups,):
// 32-bit words; acc: f32 (32 * n_groups,), updated in place; all 16-byte
// aligned.  `fmt` indexes repro_torch.kernels.FORMATS; 1 <= width <= 32,
// n_groups >= 1.  Geometry from kernels/decode_reduce.py::geometry:
// `tile_groups` groups a tile (a multiple of 32, at most
// DECODE_REDUCE_MAX_TILE), `grid` persistent thread blocks of
// DECODE_REDUCE_THREADS, `smem` dynamic shared bytes (two stages of
// tile_groups x (width + lo_bits + 1) words).  Returns cudaGetLastError(),
// or an error without launching if the tile does not hold.
extern "C" int decode_reduce_launch(const void* pay, const void* lo,
                                    const void* group_bases, void* acc,
                                    long long n_groups, int width, int fmt,
                                    int tile_groups, int grid, int smem, void* stream) {
  if (tile_groups < PASS || tile_groups % PASS || tile_groups > DECODE_REDUCE_MAX_TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DR_ARGS pay, lo, group_bases, acc, n_groups, width, tile_groups, grid, smem, s
  switch (fmt) {
    case 0: return launch<32, 8, 23>(DR_ARGS);
    case 1: return launch<16, 5, 10>(DR_ARGS);
    case 2: return launch<16, 8, 7>(DR_ARGS);
    case 3: return launch<8, 4, 3>(DR_ARGS);
    case 4: return launch<8, 5, 2>(DR_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DR_ARGS
}
