// Bit-plane pack and unpack: 32 values <-> `width` plane words.
//
// Replace the TPU kernels src/repro/kernels/bitpack.py::_pack_kernel and
// ::_unpack_kernel (pallas_calls at bitpack.py:55 and :70).  Bit-identical to
// their plain versions, repro_torch/kernels/ref.py::pack and ::unpack.
//
// Bound: device-memory bytes.  Pack reads each value once (1, 4 or 8 bytes,
// whatever integer type the caller holds, so no widening copy precedes it)
// and writes width / 8 bytes per value; unpack reads width / 8 bytes per
// value and writes 4.  A few integer operations per value.  The TPU kernel
// tiles 256 groups per grid step because its grid runs in order on one core;
// here pack gives a warp one GROUP of 32 values, so each plane word is one
// __ballot_sync (bit i = lane i, as `<< pos` at bitpack.py:33-36) and lane b
// stores word b: a group's words go out as one coalesced store.
//
// Unpack writes 4 bytes a value, 86% of its bytes at width 5, so its design
// is about full 16-byte stores with the next loads already on their way:
// * persistent thread blocks (as many as the card holds at once) walk over
//   TILES of `tile_groups` groups; a tile's packed words are one contiguous
//   range, staged into shared memory by 16-byte cp.async (the last tile's
//   <16-byte tail by 4-byte cp.async) a tile ahead, in two stages;
// * each thread owns 4 consecutive values of a group (8 threads share the
//   group's words, read from shared memory) and writes them as one 16-byte
//   store: a warp's store is 512 contiguous bytes;
// * `width` is a template parameter for 1-8 (at most 8 bits a value: a
//   nibble of each plane word spreads into the four bytes of one register
//   by one multiply) and for the lo widths 11 and 24 of the five formats;
//   one generic instantiation serves the other widths.
// The wrapper (kernels/bitpack.py::unpack_geometry) computes the tile, grid
// and shared bytes, and passes UNPACK_THREADS and SM_THREADS to nvcc as -D
// defines (kernels/__init__.py).  The packed words must be
// 16-byte aligned (the wrapper raises otherwise; its callers pass fresh or
// whole tensors).  Any number of whole groups works: the 8192-value
// multiple of the TPU kernel is a tile constraint of the TPU and does not
// carry over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

#if !defined(UNPACK_THREADS) || !defined(SM_THREADS)
#error "build with kernels/__init__.py's NVCC_FLAGS (-DUNPACK_THREADS, -DSM_THREADS)"
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // groups per thread block (pack)
// unpack: UNPACK_THREADS a thread block, 4 values a thread (so
// UNPACK_THREADS / 8 groups a pass)
constexpr int UNPACK_MIN_BLOCKS = SM_THREADS / UNPACK_THREADS;  // resident blocks an SM

// the value's low 32 bits: two's complement of a signed type, as the
// reference's cast to uint32
template <typename T>
__device__ __forceinline__ uint32_t low_word(T v) {
  return (uint32_t)(unsigned long long)(long long)v;
}
template <>
__device__ __forceinline__ uint32_t low_word<uint8_t>(uint8_t v) {
  return (uint32_t)v;
}

template <typename T>
__global__ void pack_kernel(const T* __restrict__ vals, uint32_t* __restrict__ out,
                            long long n_groups, int width) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= n_groups) return;  // warp-uniform: the whole warp leaves
  const uint32_t v = low_word(vals[g * 32 + lane]);
  uint32_t word = 0u;
  for (int b = 0; b < width; ++b) {
    const uint32_t w = __ballot_sync(FULL, (v >> b) & 1u);
    if (lane == b) word = w;
  }
  if (lane < width) out[g * width + lane] = word;
}

// values 4j .. 4j + 3 of a group from its plane words w[0 .. width): bit b of
// value i is bit i of w[b]; `shift` = 4j
template <int WT>
__device__ __forceinline__ uint4 unpack4(const uint32_t* w, int width, int shift) {
  if constexpr (WT >= 1 && WT <= 8) {
    // byte i of acc is value shift + i: nibble bit i moves to bit 8i
    // (x * 0x00204081 puts bit i at 8i among no other set bits)
    uint32_t acc = 0u;
#pragma unroll
    for (int b = 0; b < WT; ++b)
      acc |= ((((w[b] >> shift) & 0xFu) * 0x00204081u) & 0x01010101u) << b;
    return make_uint4(__byte_perm(acc, 0u, 0x4440), __byte_perm(acc, 0u, 0x4441),
                      __byte_perm(acc, 0u, 0x4442), __byte_perm(acc, 0u, 0x4443));
  } else {
    const int W = WT > 0 ? WT : width;
    uint32_t v0 = 0u, v1 = 0u, v2 = 0u, v3 = 0u;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      const uint32_t x = w[b] >> shift;
      v0 |= (x & 1u) << b;
      v1 |= ((x >> 1) & 1u) << b;
      v2 |= ((x >> 2) & 1u) << b;
      v3 |= ((x >> 3) & 1u) << b;
    }
    return make_uint4(v0, v1, v2, v3);
  }
}

template <int WT>
__global__ void __launch_bounds__(UNPACK_THREADS, UNPACK_MIN_BLOCKS)
unpack_kernel(const uint32_t* __restrict__ packed, uint32_t* __restrict__ out,
              long long n_groups, int tile_groups, int width_rt) {
  const int W = WT > 0 ? WT : width_rt;
  extern __shared__ __align__(16) uint32_t s_words[];
  const int stage_words = tile_groups * W;
  const long long n_tiles = (n_groups + tile_groups - 1) / tile_groups;

  auto load = [&](long long t, int stage) {
    const long long g0 = t * tile_groups;
    const int words = (int)min((long long)tile_groups, n_groups - g0) * W;
    const uint32_t* src = packed + g0 * W;
    uint32_t* dst = s_words + stage * stage_words;
    const int n4 = words >> 2;
    for (int c = threadIdx.x; c < n4; c += UNPACK_THREADS)
      staging::cp_async16(dst + 4 * c, src + 4 * c);
    for (int i = (n4 << 2) + threadIdx.x; i < words; i += UNPACK_THREADS)
      staging::cp_async4(dst + i, src + i);
  };

  // thread: groups sub, sub + 32, ... of the tile, values 4 (tid & 7) .. + 3
  const int sub = threadIdx.x >> 3, quad = threadIdx.x & 7;
  long long t = blockIdx.x;
  if (t < n_tiles) load(t, 0);
  staging::commit();
  for (int stage = 0; t < n_tiles; t += gridDim.x, stage ^= 1) {
    if (t + gridDim.x < n_tiles) load(t + gridDim.x, stage ^ 1);
    staging::commit();
    staging::wait_prev();
    __syncthreads();
    const uint32_t* words = s_words + stage * stage_words;
    const long long g0 = t * tile_groups;
    const int ng = (int)min((long long)tile_groups, n_groups - g0);
    uint4* dst = reinterpret_cast<uint4*>(out + g0 * 32);
    for (int g = sub; g < ng; g += UNPACK_THREADS / 8)
      dst[g * 8 + quad] = unpack4<WT>(words + g * W, W, 4 * quad);
    __syncthreads();  // the stage is loaded again one iteration on
  }
}

template <typename T>
void launch_pack(const void* vals, void* out, long long n_groups, int width,
                 cudaStream_t s) {
  const long long grid = (n_groups + WARPS - 1) / WARPS;
  pack_kernel<T><<<(unsigned)grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(vals), static_cast<uint32_t*>(out), n_groups, width);
}

template <int WT>
int launch_unpack(const void* packed, void* out, long long n_groups, int width,
                  int tile_groups, int grid, int smem, cudaStream_t s) {
  auto kernel = unpack_kernel<WT>;
  if (const int err = staging::allow_smem(kernel, smem)) return err;
  kernel<<<grid, UNPACK_THREADS, smem, s>>>(static_cast<const uint32_t*>(packed),
                                            static_cast<uint32_t*>(out), n_groups,
                                            tile_groups, width);
  return (int)cudaGetLastError();
}

}  // namespace

// vals: 32 * n_groups integers of kind `in_kind` (0 uint8, 1 int32, 2 int64);
// out: (n_groups, width) 32-bit words; 1 <= width <= 32, n_groups >= 1.
// Returns cudaGetLastError().
extern "C" int pack_launch(const void* vals, void* out, long long n_groups,
                           int width, int in_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case 0: launch_pack<uint8_t>(vals, out, n_groups, width, s); break;
    case 1: launch_pack<int32_t>(vals, out, n_groups, width, s); break;
    case 2: launch_pack<long long>(vals, out, n_groups, width, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// packed: (n_groups, width) 32-bit words; out: 32 * n_groups 32-bit values;
// both 16-byte aligned; 1 <= width <= 32, n_groups >= 1.  Geometry from
// kernels/bitpack.py::unpack_geometry: `tile_groups` groups a tile (a
// multiple of 32), `grid` persistent thread blocks of UNPACK_THREADS,
// `smem` dynamic shared bytes (two stages of tile_groups x width words).
// Returns cudaGetLastError(), or an error without launching if the tile
// is not a multiple of 32 groups.
extern "C" int unpack_launch(const void* packed, void* out, long long n_groups,
                             int width, int tile_groups, int grid, int smem,
                             void* stream) {
  if (tile_groups < 32 || tile_groups % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UP_ARGS packed, out, n_groups, width, tile_groups, grid, smem, s
  switch (width) {
    case 1: return launch_unpack<1>(UP_ARGS);
    case 2: return launch_unpack<2>(UP_ARGS);
    case 3: return launch_unpack<3>(UP_ARGS);
    case 4: return launch_unpack<4>(UP_ARGS);
    case 5: return launch_unpack<5>(UP_ARGS);
    case 6: return launch_unpack<6>(UP_ARGS);
    case 7: return launch_unpack<7>(UP_ARGS);
    case 8: return launch_unpack<8>(UP_ARGS);
    case 11: return launch_unpack<11>(UP_ARGS);
    case 24: return launch_unpack<24>(UP_ARGS);
    default: return launch_unpack<0>(UP_ARGS);
  }
#undef UP_ARGS
}
