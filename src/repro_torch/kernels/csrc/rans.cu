// Interleaved-lane rANS encode and decode: one independent stream per lane.
//
// Replace the TPU kernels src/repro/kernels/rans.py::_encode_kernel and
// ::_decode_kernel (pallas_calls at rans.py:98 and :129).  Bit-identical to
// their plain versions, repro_torch/kernels/ref.py::rans_encode,
// ::rans_decode and ::rans_decode_stream.
//
// State: 32 bits, 16-bit renormalisation, L = 1 << 16, PROB_BITS = 12, all
// in uint32 arithmetic with the reference's wrap-around (rans.py:49-62 and
// :73-82); the division by the symbol frequency is a plain `/`.
//
// Bound: neither bytes nor operations.  Each lane is a chain of `per`
// dependent steps (a division, two table lookups, a compare) and the lane
// count is part of the stream format (128 on the host path), so the work is
// 128 threads, one thread block on one SM, for `per` sequential steps: the
// latency of one step times `per`.  The design keeps the three tables in
// shared memory, reads and writes row r of the dense buffers coalesced across
// the lanes, and lets the decode read the compacted wire stream directly
// (COMPACT), because the wire carries no mask from which a dense buffer could
// be rebuilt.  A faster design (more streams per lane group, or tables of
// reciprocals) changes the format or the arithmetic and is later work.
//
// n_valid: symbols at flat index >= n_valid (row-major over (per, lanes))
// leave the state as it is and emit nothing, as core/ans.py masks padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PROB_BITS = 12;
constexpr uint32_t M = 1u << PROB_BITS;
constexpr uint32_t RANS_L = 1u << 16;
constexpr int THREADS = 128;  // lanes per thread block

__device__ __forceinline__ void load_tables(const uint32_t* __restrict__ freq,
                                            const uint32_t* __restrict__ cum,
                                            uint32_t* s_freq, uint32_t* s_cum) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_freq[i] = freq[i];
    s_cum[i] = cum[i];
  }
}

__global__ void rans_encode_kernel(const uint8_t* __restrict__ syms,
                                   const uint32_t* __restrict__ freq,
                                   const uint32_t* __restrict__ cum,
                                   uint32_t* __restrict__ words,
                                   uint32_t* __restrict__ mask,
                                   uint32_t* __restrict__ state_out, int per,
                                   int lanes, long long n_valid) {
  __shared__ uint32_t s_freq[256];
  __shared__ uint32_t s_cum[256];
  load_tables(freq, cum, s_freq, s_cum);
  __syncthreads();
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t state = RANS_L;
  for (int r = per - 1; r >= 0; --r) {
    const long long idx = (long long)r * lanes + lane;
    const bool valid = idx < n_valid;
    const uint32_t s = syms[idx];
    const uint32_t f = s_freq[s];
    const uint32_t x_max = ((RANS_L >> PROB_BITS) << 16) * f;
    const bool need = valid && state >= x_max;
    words[idx] = need ? (state & 0xFFFFu) : 0u;
    mask[idx] = need ? 1u : 0u;
    if (valid) {
      if (need) state >>= 16;
      const uint32_t q = state / f;
      state = (q << PROB_BITS) + (state - q * f) + s_cum[s];
    }
  }
  state_out[lane] = state;
}

// COMPACT = false: words are the dense (per, lanes) 32-bit buffer and the
// start states come from `state` (the TPU kernel's contract).
// COMPACT = true: words are lane j's uint16 stream at row j of a (lanes, cap)
// buffer, `lens` counts each lane's words; the state starts from the two
// flush words and the lane pulls words LIFO from lens - 3 down.
template <bool COMPACT>
__global__ void rans_decode_kernel(const void* __restrict__ words,
                                   const int32_t* __restrict__ lens,
                                   const uint32_t* __restrict__ state_in,
                                   const uint32_t* __restrict__ freq,
                                   const uint32_t* __restrict__ cum,
                                   const uint8_t* __restrict__ s2s,
                                   uint8_t* __restrict__ syms, int per, int lanes,
                                   int cap, long long n_valid) {
  __shared__ uint32_t s_freq[256];
  __shared__ uint32_t s_cum[256];
  __shared__ uint8_t s_s2s[M];
  load_tables(freq, cum, s_freq, s_cum);
  for (int i = threadIdx.x; i < (int)M; i += blockDim.x) s_s2s[i] = s2s[i];
  __syncthreads();
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const uint16_t* stream =
      static_cast<const uint16_t*>(words) + (long long)lane * cap;
  const uint32_t* dense = static_cast<const uint32_t*>(words);
  uint32_t state;
  int ptr = 0;
  if (COMPACT) {
    ptr = lens[lane] - 2;
    state = (uint32_t)stream[ptr] | ((uint32_t)stream[ptr + 1] << 16);
  } else {
    state = state_in[lane];
  }
  for (int r = 0; r < per; ++r) {
    const long long idx = (long long)r * lanes + lane;
    const bool valid = idx < n_valid;
    const uint32_t slot = state & (M - 1u);
    const uint32_t sym = s_s2s[slot];
    uint32_t x = s_freq[sym] * (state >> PROB_BITS) + slot - s_cum[sym];
    if (valid && x < RANS_L) {
      uint32_t w;
      if (COMPACT) {
        --ptr;
        w = stream[ptr > 0 ? ptr : 0];
      } else {
        w = dense[idx];
      }
      x = (x << 16) | w;
    }
    if (valid) state = x;
    syms[idx] = (uint8_t)sym;
  }
}

}  // namespace

// syms uint8 (per, lanes); freq, cum: 256 32-bit entries; words, mask
// (per, lanes) and state (lanes,): 32-bit words.  Returns cudaGetLastError().
extern "C" int rans_encode_launch(const void* syms, const void* freq,
                                  const void* cum, void* words, void* mask,
                                  void* state, int per, int lanes,
                                  long long n_valid, void* stream) {
  const int grid = (lanes + THREADS - 1) / THREADS;
  rans_encode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const uint32_t*>(freq),
      static_cast<const uint32_t*>(cum), static_cast<uint32_t*>(words),
      static_cast<uint32_t*>(mask), static_cast<uint32_t*>(state), per, lanes,
      n_valid);
  return (int)cudaGetLastError();
}

// compact = 0: words (per, lanes) 32-bit, state (lanes,) 32-bit, lens unused;
// compact = 1: words uint16 (lanes, cap), lens int32 (lanes,), state unused.
// freq, cum: 256 32-bit entries; s2s uint8 (4096,); syms uint8 (per, lanes).
// Returns cudaGetLastError().
extern "C" int rans_decode_launch(const void* words, const void* lens,
                                  const void* state, const void* freq,
                                  const void* cum, const void* s2s, void* syms,
                                  int per, int lanes, int cap, long long n_valid,
                                  int compact, void* stream) {
  const int grid = (lanes + THREADS - 1) / THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(lens);
  const uint32_t* st = static_cast<const uint32_t*>(state);
  const uint32_t* f = static_cast<const uint32_t*>(freq);
  const uint32_t* c = static_cast<const uint32_t*>(cum);
  const uint8_t* t = static_cast<const uint8_t*>(s2s);
  uint8_t* out = static_cast<uint8_t*>(syms);
  if (compact) {
    rans_decode_kernel<true><<<grid, THREADS, 0, s>>>(words, l, st, f, c, t, out,
                                                      per, lanes, cap, n_valid);
  } else {
    rans_decode_kernel<false><<<grid, THREADS, 0, s>>>(words, l, st, f, c, t, out,
                                                       per, lanes, cap, n_valid);
  }
  return (int)cudaGetLastError();
}
