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
// here a warp is one GROUP of 32 values, so each plane word is one
// __ballot_sync (bit i = lane i, as `<< pos` at bitpack.py:33-36) and lane b
// stores word b: a group's words go out as one coalesced store.  Unpack runs
// one thread per output value; the 32 threads of a warp read the same
// `width` words of their group (a broadcast) and write 32 consecutive words.
// Any number of whole groups works: the 8192-value multiple of the TPU
// kernel is a tile constraint of the TPU and does not carry over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // groups per thread block (pack)
constexpr int THREADS = 256;  // values per thread block (unpack)

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

__global__ void unpack_kernel(const uint32_t* __restrict__ packed,
                              uint32_t* __restrict__ out, long long n, int width) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t* w = packed + (i >> 5) * width;
  const int lane = (int)(i & 31);
  uint32_t v = 0u;
  for (int b = 0; b < width; ++b) v |= ((__ldg(w + b) >> lane) & 1u) << b;
  out[i] = v;
}

template <typename T>
void launch_pack(const void* vals, void* out, long long n_groups, int width,
                 cudaStream_t s) {
  const long long grid = (n_groups + WARPS - 1) / WARPS;
  pack_kernel<T><<<(unsigned)grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(vals), static_cast<uint32_t*>(out), n_groups, width);
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
// 1 <= width <= 32, n_groups >= 1.  Returns cudaGetLastError().
extern "C" int unpack_launch(const void* packed, void* out, long long n_groups,
                             int width, void* stream) {
  const long long n = n_groups * 32;
  const long long grid = (n + THREADS - 1) / THREADS;
  unpack_kernel<<<(unsigned)grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<uint32_t*>(out), n, width);
  return (int)cudaGetLastError();
}
