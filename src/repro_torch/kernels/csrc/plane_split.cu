// Float split into exponent and lo planes, with per-block plain statistics.
//
// Replaces the TPU kernel src/repro/kernels/plane_split.py::_split_kernel
// (pallas_call at plane_split.py:64).  Bit-identical to its plain version,
// repro_torch/kernels/ref.py::split_with_stats, for all five float formats.
//
// Outputs: exp (n,) and lo (n,) as 32-bit words (lo = sign << mant_bits |
// mantissa), and per compression block base = min(exp) and rng = max(exp) -
// min(exp).  Zero exponents count in the min: these are the plain min/max of
// the TPU kernel, not the zero-escape statistics of the wire (encode_fused.cu).
//
// Bound: device-memory bytes.  The function reads each element once and
// writes 8 bytes per element plus 8 bytes per block, with a few integer
// operations per element.  One thread block per compression block, one
// thread per element: each thread reads its element once and writes both
// planes (neighbouring threads on neighbouring words); the block min/max is
// a warp reduction (__reduce_min_sync / __reduce_max_sync) plus one pass of
// warp 0 over the warps' results in shared memory.  The TPU kernel's tile of
// 8 blocks per grid step, and with it its n % 4096 contract, does not carry
// over: any whole number of blocks is taken.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int TOTAL> struct Storage;
template <> struct Storage<32> { using T = uint32_t; };
template <> struct Storage<16> { using T = uint16_t; };
template <> struct Storage<8> { using T = uint8_t; };

constexpr unsigned FULL = 0xffffffffu;

template <int TOTAL, int EXP, int MANT>
__global__ void plane_split_kernel(const typename Storage<TOTAL>::T* __restrict__ x,
                                   uint32_t* __restrict__ exp_out,
                                   uint32_t* __restrict__ lo_out,
                                   uint32_t* __restrict__ bases,
                                   uint32_t* __restrict__ rngs) {
  __shared__ uint32_t s_min[32];
  __shared__ uint32_t s_max[32];

  const int block = blockDim.x;  // elements per compression block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * block + threadIdx.x;

  const uint32_t bits = (uint32_t)x[i];
  const uint32_t exp = (bits >> MANT) & ((1u << EXP) - 1u);
  const uint32_t sign = bits >> (TOTAL - 1);
  exp_out[i] = exp;
  lo_out[i] = (sign << MANT) | (bits & ((1u << MANT) - 1u));

  const uint32_t wmin = __reduce_min_sync(FULL, exp);
  const uint32_t wmax = __reduce_max_sync(FULL, exp);
  if (lane == 0) {
    s_min[warp] = wmin;
    s_max[warp] = wmax;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = block >> 5;
    const uint32_t m = __reduce_min_sync(FULL, lane < n_warps ? s_min[lane] : FULL);
    const uint32_t mx = __reduce_max_sync(FULL, lane < n_warps ? s_max[lane] : 0u);
    if (lane == 0) {
      bases[blockIdx.x] = m;
      rngs[blockIdx.x] = mx - m;
    }
  }
}

template <int TOTAL, int EXP, int MANT>
void launch(const void* x, void* exp, void* lo, void* bases, void* rng,
            long long n_blocks, int block, cudaStream_t stream) {
  plane_split_kernel<TOTAL, EXP, MANT><<<(unsigned)n_blocks, block, 0, stream>>>(
      static_cast<const typename Storage<TOTAL>::T*>(x),
      static_cast<uint32_t*>(exp), static_cast<uint32_t*>(lo),
      static_cast<uint32_t*>(bases), static_cast<uint32_t*>(rng));
}

}  // namespace

// x: n elements of format `fmt` (index into repro_torch.kernels.FORMATS),
// n % block == 0, n >= block, block % 32 == 0, 32 <= block <= 1024.
// Outputs: exp (n,), lo (n,), bases (n/block,), rng (n/block,), all 32-bit
// words.  Returns cudaGetLastError().
extern "C" int plane_split_launch(const void* x, void* exp, void* lo, void* bases,
                                  void* rng, long long n, int block, int fmt,
                                  void* stream) {
  const long long n_blocks = n / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: launch<32, 8, 23>(x, exp, lo, bases, rng, n_blocks, block, s); break;
    case 1: launch<16, 5, 10>(x, exp, lo, bases, rng, n_blocks, block, s); break;
    case 2: launch<16, 8, 7>(x, exp, lo, bases, rng, n_blocks, block, s); break;
    case 3: launch<8, 4, 3>(x, exp, lo, bases, rng, n_blocks, block, s); break;
    case 4: launch<8, 5, 2>(x, exp, lo, bases, rng, n_blocks, block, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
