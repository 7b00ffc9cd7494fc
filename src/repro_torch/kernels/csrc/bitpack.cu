// Bit-plane pack and unpack: 32 values <-> `width` plane words.
//
// Replace the TPU kernels src/repro/kernels/bitpack.py::_pack_kernel and
// ::_unpack_kernel (pallas_calls at bitpack.py:55 and :70).  Bit-identical to
// their plain versions, repro_torch/kernels/ref.py::pack and ::unpack.
//
// Bound: device-memory bytes.  Pack reads each value once (1, 4 or 8 bytes,
// whatever integer type the caller holds, so no widening copy precedes it)
// and writes width / 8 bytes per value; unpack reads width / 8 bytes per
// value and writes 4.  A few integer operations per value.  The TPU kernels
// tile 256 groups per grid step because their grid runs in order on one
// core; here both kernels are persistent thread blocks (as many as the card
// holds at once) that walk over TILES of `tile_groups` groups, a multiple of
// 32, with each thread on 4 consecutive values of one group (8 threads a
// group, 32 groups a pass of the thread block):
//
// * Unpack writes 4 bytes a value, 86% of its bytes at width 5.  A tile's
//   packed words are one contiguous range, staged into shared memory by
//   16-byte cp.async (the last tile's <16-byte tail by 4-byte cp.async) a
//   tile ahead, in two stages; each thread writes its 4 values as one
//   16-byte store, so a warp's store is 512 contiguous bytes.
// * Pack reads 1-8 bytes a value and writes a few bits: its first kernel (a
//   warp a group, one value a lane, a __ballot_sync a plane) kept only 32
//   bytes of loads in flight a warp and spent 4 instructions a plane on
//   every value.  Here a tile's values (32 x tile x itemsize bytes, always
//   whole 16-byte pieces) are staged a tile ahead by 16-byte cp.async; each
//   thread gathers bit b of its 4 values into a nibble by one multiply a
//   plane (bitplane::pack4_nibbles, the inverse of unpack's), 8 planes'
//   nibbles into one word, and one 8 x 8 nibble transpose across the
//   group's 8 lanes (bitplane::Transpose8, three shuffles) leaves plane
//   word c + q in lane q.  Widths above 8 take 8 planes a transpose, from
//   the byte of each value that holds them.  The tile's words go out from
//   shared memory as 16-byte stores.
// * `width` is a template parameter for 1-8 (the paths' widths; at most 8
//   bits a value: a nibble of each plane word spreads into the four bytes
//   of one register by one multiply, and back) and, for unpack, for the lo
//   widths 11 and 24 of the five formats; one generic instantiation serves
//   the other widths.
// The wrappers (kernels/bitpack.py::pack_geometry, ::unpack_geometry)
// compute the tile, grid and shared bytes, and pass PACK_THREADS,
// UNPACK_THREADS and SM_THREADS to nvcc as -D defines (kernels/__init__.py).
// The values and the packed words must be 16-byte aligned (the wrappers
// raise otherwise; the entry points in core/packing.py hand them an aligned
// copy of a view that is not).  Any number of whole groups works: the
// 8192-value multiple of the TPU kernel is a tile constraint of the TPU and
// does not carry over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane.cuh"
#include "staging.cuh"

#if !defined(PACK_THREADS) || !defined(UNPACK_THREADS) || !defined(SM_THREADS)
#error "build with kernels/__init__.py's NVCC_FLAGS (-DPACK_THREADS, -DUNPACK_THREADS, -DSM_THREADS)"
#endif

namespace {

using bitplane::unpack4;
// PACK_THREADS / UNPACK_THREADS a thread block, 4 values a thread (so
// THREADS / 8 groups a pass); resident thread blocks an SM
constexpr int PACK_MIN_BLOCKS = SM_THREADS / PACK_THREADS;
constexpr int UNPACK_MIN_BLOCKS = SM_THREADS / UNPACK_THREADS;

// 4 consecutive values of type T in shared memory, by their low 32 bits
// (two's complement of a signed type, as the reference's cast to uint32):
// bytes(k) is byte k of each value, value i in byte i.
template <typename T> struct Four;
template <> struct Four<uint8_t> {
  uint32_t x;
  __device__ __forceinline__ explicit Four(const uint8_t* p)
      : x(*reinterpret_cast<const uint32_t*>(p)) {}
  __device__ __forceinline__ uint32_t bytes(int k) const { return k == 0 ? x : 0u; }
};
// byte k of a, b, c, d (in that order) as one word
__device__ __forceinline__ uint32_t gather_byte(uint32_t a, uint32_t b, uint32_t c,
                                                uint32_t d, int k) {
  const uint32_t sel = (uint32_t)k | (uint32_t)(k + 4) << 4;
  return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410);
}
template <> struct Four<int32_t> {
  uint4 v;
  __device__ __forceinline__ explicit Four(const int32_t* p)
      : v(*reinterpret_cast<const uint4*>(p)) {}
  __device__ __forceinline__ uint32_t bytes(int k) const {
    return gather_byte(v.x, v.y, v.z, v.w, k);
  }
};
template <> struct Four<long long> {
  uint32_t a, b, c, d;  // the low words
  __device__ __forceinline__ explicit Four(const long long* p) {
    const uint4 v0 = reinterpret_cast<const uint4*>(p)[0];
    const uint4 v1 = reinterpret_cast<const uint4*>(p)[1];
    a = v0.x, b = v0.z, c = v1.x, d = v1.z;
  }
  __device__ __forceinline__ uint32_t bytes(int k) const { return gather_byte(a, b, c, d, k); }
};

template <typename T, int WT>
__global__ void __launch_bounds__(PACK_THREADS, PACK_MIN_BLOCKS)
pack_kernel(const T* __restrict__ vals, uint32_t* __restrict__ out,
            long long n_groups, int tile_groups, int width_rt) {
  const int W = WT > 0 ? WT : width_rt;
  // dynamic shared memory: two stages of a tile's values, then its words
  extern __shared__ __align__(16) unsigned char dyn[];
  const int stage_bytes = tile_groups * 32 * (int)sizeof(T);
  uint32_t* s_out = reinterpret_cast<uint32_t*>(dyn + 2 * stage_bytes);
  const long long n_tiles = (n_groups + tile_groups - 1) / tile_groups;

  auto load = [&](long long t, int stage) {  // 32 * sizeof(T) bytes a group
    const long long g0 = t * tile_groups;
    const int n16 = (int)min((long long)tile_groups, n_groups - g0) * 2 * (int)sizeof(T);
    const char* src = reinterpret_cast<const char*>(vals + g0 * 32);
    unsigned char* dst = dyn + stage * stage_bytes;
    for (int c = threadIdx.x; c < n16; c += PACK_THREADS)
      staging::cp_async16(dst + 16 * c, src + 16 * c);
  };

  // thread: groups sub, sub + 32, ... of the tile, values 4 quad .. + 3
  const int sub = threadIdx.x >> 3, quad = threadIdx.x & 7;
  const bitplane::Transpose8 transpose(threadIdx.x & 31);
  long long t = blockIdx.x;
  if (t < n_tiles) load(t, 0);
  staging::commit();
  for (int stage = 0; t < n_tiles; t += gridDim.x, stage ^= 1) {
    if (t + gridDim.x < n_tiles) load(t + gridDim.x, stage ^ 1);
    staging::commit();
    staging::wait_prev();
    __syncthreads();
    const T* xs = reinterpret_cast<const T*>(dyn + stage * stage_bytes);
    const long long g0 = t * tile_groups;
    const int ng = (int)min((long long)tile_groups, n_groups - g0);
    // passes and planes are block-uniform, so every lane of a warp
    // shuffles; a group past the tile's last reads its stage's stale values
    // and stores nothing
    for (int p = 0; p < ng; p += PACK_THREADS / 8) {
      const int g = p + sub;
      const Four<T> v(xs + g * 32 + 4 * quad);
#pragma unroll
      for (int c = 0; c < (WT > 0 ? WT : 32); c += 8) {  // planes c .. c + 7: byte c / 8
        if (WT == 0 && c >= W) break;
        const uint32_t word = transpose(bitplane::pack4_nibbles<WT>(v.bytes(c >> 3)));
        if (g < ng && c + quad < W) s_out[g * W + c + quad] = word;
      }
    }
    __syncthreads();  // the words are staged, and the stage is loaded again
    staging::store_words(out + g0 * W, s_out, ng * W);
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

template <typename T, int WT>
int launch_pack(const void* vals, void* out, long long n_groups, int width,
                int tile_groups, int grid, int smem, cudaStream_t s) {
  auto kernel = pack_kernel<T, WT>;
  if (const int err = staging::allow_smem(kernel, smem)) return err;
  kernel<<<grid, PACK_THREADS, smem, s>>>(static_cast<const T*>(vals),
                                          static_cast<uint32_t*>(out), n_groups,
                                          tile_groups, width);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pack_w(const void* vals, void* out, long long n_groups, int width,
                  int tile_groups, int grid, int smem, cudaStream_t s) {
#define PK_ARGS vals, out, n_groups, width, tile_groups, grid, smem, s
  switch (width) {
    case 1: return launch_pack<T, 1>(PK_ARGS);
    case 2: return launch_pack<T, 2>(PK_ARGS);
    case 3: return launch_pack<T, 3>(PK_ARGS);
    case 4: return launch_pack<T, 4>(PK_ARGS);
    case 5: return launch_pack<T, 5>(PK_ARGS);
    case 6: return launch_pack<T, 6>(PK_ARGS);
    case 7: return launch_pack<T, 7>(PK_ARGS);
    case 8: return launch_pack<T, 8>(PK_ARGS);
    default: return launch_pack<T, 0>(PK_ARGS);
  }
#undef PK_ARGS
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
// out: (n_groups, width) 32-bit words; both 16-byte aligned; 1 <= width <=
// 32, n_groups >= 1.  Geometry from kernels/bitpack.py::pack_geometry:
// `tile_groups` groups a tile (a multiple of 32), `grid` persistent thread
// blocks of PACK_THREADS, `smem` dynamic shared bytes (two stages of
// 32 x tile_groups values, then tile_groups x width words).  Returns
// cudaGetLastError(), or an error without launching if the tile is not a
// multiple of 32 groups.
extern "C" int pack_launch(const void* vals, void* out, long long n_groups, int width,
                           int in_kind, int tile_groups, int grid, int smem,
                           void* stream) {
  if (tile_groups < 32 || tile_groups % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PK_ARGS vals, out, n_groups, width, tile_groups, grid, smem, s
  switch (in_kind) {
    case 0: return launch_pack_w<uint8_t>(PK_ARGS);
    case 1: return launch_pack_w<int32_t>(PK_ARGS);
    case 2: return launch_pack_w<long long>(PK_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PK_ARGS
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
