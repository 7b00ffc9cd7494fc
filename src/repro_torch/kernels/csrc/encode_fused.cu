// Fused transmit-side encode: split + zero-escape block stats + bit-plane pack.
//
// Replaces the TPU kernel src/repro/kernels/encode_fused.py::_encode_kernel
// (pallas_call at encode_fused.py:105).  Bit-identical to its plain version,
// repro_torch/kernels/ref.py::encode_fused, for all five float formats.
//
// Bound: device-memory bytes.  The function reads each element once and
// writes (width + lo_bits) / 8 bytes of planes per element plus 8 bytes per
// block; it does a few integer operations per element.  The design reads
// each input element exactly once and keeps every intermediate (exponent
// plane, lo plane, residuals, block stats) in registers and shared memory:
// one thread block per compression block, one thread per element, block
// min/max from warp reductions plus one shared-memory pass over the warps.
// A warp is one GROUP of 32 values, so each plane word is one __ballot_sync
// (bit i = lane i, as `<< pos` at encode_fused.py:75-84); lane b stores word
// b, so a group's words go out as one coalesced store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int TOTAL> struct Storage;
template <> struct Storage<32> { using T = uint32_t; };
template <> struct Storage<16> { using T = uint16_t; };
template <> struct Storage<8> { using T = uint8_t; };

constexpr unsigned FULL = 0xffffffffu;

template <int TOTAL, int EXP, int MANT>
__global__ void encode_fused_kernel(const typename Storage<TOTAL>::T* __restrict__ x,
                                    uint32_t* __restrict__ pay,
                                    uint32_t* __restrict__ lo_planes,
                                    uint32_t* __restrict__ bases,
                                    uint32_t* __restrict__ rngs,
                                    int width) {
  constexpr int LO_BITS = 1 + MANT;
  __shared__ uint32_t s_min[32];
  __shared__ uint32_t s_max[32];
  __shared__ uint32_t s_base;

  const int block = blockDim.x;  // elements per compression block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * block + threadIdx.x;

  const uint32_t bits = (uint32_t)x[i];
  const uint32_t exp = (bits >> MANT) & ((1u << EXP) - 1u);
  const uint32_t sign = bits >> (TOTAL - 1);
  const uint32_t lo = (sign << MANT) | (bits & ((1u << MANT) - 1u));
  const bool nz = exp != 0u;

  // zero-escape stats: min and max over the NONZERO exponents of the block
  const uint32_t wmin = __reduce_min_sync(FULL, nz ? exp : 255u);
  const uint32_t wmax = __reduce_max_sync(FULL, nz ? exp : 0u);
  if (lane == 0) {
    s_min[warp] = wmin;
    s_max[warp] = wmax;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = block >> 5;
    const uint32_t m = __reduce_min_sync(FULL, lane < n_warps ? s_min[lane] : 255u);
    const uint32_t mx = __reduce_max_sync(FULL, lane < n_warps ? s_max[lane] : 0u);
    // a block has a nonzero exponent iff its max nonzero exponent is >= 1;
    // an all-zero block gets base 1 and rng 0 - 1 + 1 == 0 (uint32 wrap)
    const uint32_t base = mx != 0u ? m : 1u;
    if (lane == 0) {
      s_base = base;
      bases[blockIdx.x] = base;
      rngs[blockIdx.x] = mx - base + 1u;
    }
  }
  __syncthreads();

  // residual code: 0 for exponent 0, else exp - base + 1, clamped to width
  // bits (exception blocks carry clamped payload, patched by the caller)
  const uint32_t cmax = (uint32_t)((1ull << width) - 1ull);
  const uint32_t resid = nz ? min(exp - s_base + 1u, cmax) : 0u;

  const long long g = i >> 5;
  uint32_t word = 0u;
  for (int b = 0; b < width; ++b) {
    const uint32_t w = __ballot_sync(FULL, (resid >> b) & 1u);
    if (lane == b) word = w;
  }
  if (lane < width) pay[g * width + lane] = word;

  word = 0u;
#pragma unroll
  for (int b = 0; b < LO_BITS; ++b) {
    const uint32_t w = __ballot_sync(FULL, (lo >> b) & 1u);
    if (lane == b) word = w;
  }
  if (lane < LO_BITS) lo_planes[g * LO_BITS + lane] = word;
}

template <int TOTAL, int EXP, int MANT>
void launch(const void* x, void* pay, void* lo, void* bases, void* rng,
            int n_blocks, int block, int width, cudaStream_t stream) {
  encode_fused_kernel<TOTAL, EXP, MANT><<<n_blocks, block, 0, stream>>>(
      static_cast<const typename Storage<TOTAL>::T*>(x),
      static_cast<uint32_t*>(pay), static_cast<uint32_t*>(lo),
      static_cast<uint32_t*>(bases), static_cast<uint32_t*>(rng), width);
}

}  // namespace

// x: n elements of format `fmt` (index into repro_torch.kernels.FORMATS),
// n % block == 0, block % 32 == 0, 32 <= block <= 1024, 1 <= width <= 32.
// Outputs: pay (n/32, width), lo (n/32, lo_bits), bases (n/block,),
// rng (n/block,), all 32-bit words.  Returns cudaGetLastError().
extern "C" int encode_fused_launch(const void* x, void* pay, void* lo,
                                   void* bases, void* rng, int n, int block,
                                   int width, int fmt, void* stream) {
  const int n_blocks = n / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: launch<32, 8, 23>(x, pay, lo, bases, rng, n_blocks, block, width, s); break;
    case 1: launch<16, 5, 10>(x, pay, lo, bases, rng, n_blocks, block, width, s); break;
    case 2: launch<16, 8, 7>(x, pay, lo, bases, rng, n_blocks, block, width, s); break;
    case 3: launch<8, 4, 3>(x, pay, lo, bases, rng, n_blocks, block, width, s); break;
    case 4: launch<8, 5, 2>(x, pay, lo, bases, rng, n_blocks, block, width, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
