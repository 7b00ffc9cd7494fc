// Interleaved-lane rANS encode and decode: one independent stream per lane.
//
// Replace the TPU kernels src/repro/kernels/rans.py::_encode_kernel and
// ::_decode_kernel (pallas_calls at rans.py:98 and :129).  Bit-identical to
// their plain versions, repro_torch/kernels/ref.py::rans_encode,
// ::rans_decode and ::rans_decode_stream.
//
// State: 32 bits, 16-bit renormalisation, L = 1 << 16, PROB_BITS = 12, all
// in uint32 arithmetic with the reference's wrap-around (rans.py:49-62 and
// :73-82).
//
// What bounds these kernels: each lane's chain of dependent steps, not
// bytes.  A lane is `per` steps, each needing the state the step before
// left, and the lane count is the stream format, not the kernel's to choose
// (128 lanes on the host wire: a stream cut into more lanes is another
// stream, which the JAX package and every earlier message decode
// differently), so a 46 080 x 128 KV plane is 128 threads walking 46 080
// steps each.  A warp issues in order, so a step costs its chain's latency
// plus whatever the compiler schedules between the links; the design takes
// off the chain all that does not depend on the state:
//
// - one warp a block (THREADS = 32): the wire's 128 lanes run as four
//   blocks, which the card spreads over four SMs, so no two warps share an
//   SM's shared-memory pipe or a scheduler.
// - encode: the symbols of ROWS rows are staged in shared memory by
//   cp.async, one tile ahead (double-buffered, block-wide 4-byte copies);
//   a row's table entry loads one row ahead and its symbol two.  The
//   division by f is an exact 44-bit reciprocal from a per-symbol table
//   that the wrapper builds, so the chain is compare, shift, umulhi, wide
//   multiply-add, shift, multiply-add; the words and mask go straight to
//   global memory.
// - decode: one 8-byte slot entry {f, slot - cum} (also built by the
//   wrapper) replaces the three dependent lookups, so the chain is one
//   shared-memory load, multiply-add, compare, and the next entry's
//   address, taken from the word pulled in (after a renormalisation the
//   slot is the word's low 12 bits) or from x; the symbol comes from its
//   own byte table beside it.  The renormalisation word is read ahead,
//   when the pointer moves.  The compacted stream (COMPACT) is staged per
//   lane in a ring of RING words: a lane pulls at most one word a row, so
//   at the start of a tile of ROWS rows each thread fetches its own lane's
//   words down to ptr - 2 ROWS - 1 with 16-byte cp.async (ring index =
//   global word index mod RING, so an aligned copy never wraps), while the
//   tile reads words fetched one tile before.  The dense buffer (COMPACT =
//   false, the TPU kernels' contract) stages DENSE_ROWS rows of each lane's
//   words the same way.  Nothing in the decode needs a barrier.
// - lanes == 128 (LANES_T) makes every row stride a constant, so the
//   unrolled loops address with immediates.
//
// The floor of each kernel is what its chain alone costs: rans_chain_kernel
// runs `steps` steps of one lane's chain through the same encode_step or
// decode_step, in one thread, with every operand that is not the state in
// registers, and counts their SM cycles (clock64).  Per step, that is the
// least time this build's step takes with no load, store or other lane
// beside it (chip_smoke.py reports it as floor_ms).
//
// n_valid: symbols at flat index >= n_valid (row-major over (per, lanes))
// leave the state as it is and emit nothing, as core/ans.py masks padding.
// They are the last rows of a lane, which the encode meets first and the
// decode last, so each lane's loop splits into its valid rows and the rest.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PROB_BITS = 12;
constexpr uint32_t M = 1u << PROB_BITS;
constexpr uint32_t RANS_L = 1u << 16;
constexpr int THREADS = 32;   // lanes per thread block: one warp
constexpr int WIRE_LANES = 128;  // the host wire's lane count (LANES_T)
constexpr int ROWS = 248;     // rows per tile: encode symbols, decode stream window
constexpr int DENSE_ROWS = ROWS / 4;  // rows per tile of the dense decode's words
constexpr int RING = 512;     // stream words per lane in the decode's ring
constexpr int SLOT = THREADS + 4;  // bytes of one staged symbol row (4-byte copies)
constexpr int CHUNKS = SLOT / 4;
// The first fill spans <= 2 ROWS + 15 words; a later one writes words at
// most 2 ROWS + 8 below the lane's pointer, whose ring slots held words
// above it (already consumed).
static_assert(RING >= 2 * ROWS + 16 && (RING & (RING - 1)) == 0, "ring too small");

constexpr int ENC_SMEM = 256 * 32 + 2 * ROWS * SLOT;
// dynamic shared memory; the decode's tables (36 KB) are static
constexpr int DEC_SMEM_COMPACT = THREADS * RING * 2;
constexpr int DEC_SMEM_DENSE = 2 * DENSE_ROWS * THREADS * 4;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, result) of `lane` hold valid symbols (flat index < n_valid).
__device__ __forceinline__ int valid_rows(long long n_valid, int lane, int lanes,
                                          int per) {
  if (n_valid <= lane) return 0;
  const long long r = (n_valid - lane + lanes - 1) / lanes;
  return r < per ? (int)r : per;
}

struct Entry {
  uint4 a;     // x_max, m_lo, m_hi, M - f
  uint32_t c;  // cum
};

__device__ __forceinline__ Entry entry_of(const uint32_t* s_info, uint32_t s) {
  const uint32_t* p = s_info + 8 * s;
  return {*reinterpret_cast<const uint4*>(p), p[4]};
}

// One encode step: emit the low half of the state if it is at or above
// x_max, then state = q (M - f) + (x + cum) with q = x / f.
__device__ __forceinline__ uint32_t encode_step(uint32_t state, const Entry& e,
                                                uint32_t* word, uint32_t* mask) {
  const bool need = state >= e.a.x;
  *word = need ? (state & 0xFFFFu) : 0u;
  *mask = need;
  const uint32_t x = need ? state >> 16 : state;
  const uint32_t q = (uint32_t)(((uint64_t)x * e.a.z + __umulhi(x, e.a.y)) >> 12);
  return q * e.a.w + (x + e.c);
}

// info[s] = {x_max, m_lo, m_hi, M - f, cum, 0, 0, 0} (rans.py
// encode_table), m = m_hi 2^32 + m_lo = ceil(2^44 / f): (x m_hi +
// umulhi(x, m_lo)) >> 12 is x / f for every uint32 x and f <= 4096, and
// (q << 12) + (x - q f) + cum is q (M - f) + (x + cum) modulo 2^32.
// LANES_T: the lane count when it is 128 (the host wire's), so that every
// row stride is a constant; 0: `lanes` at run time.
template <int LANES_T>
__global__ void __launch_bounds__(THREADS)
    rans_encode_kernel(const uint8_t* __restrict__ syms, const uint4* __restrict__ info,
                       uint32_t* __restrict__ words, uint32_t* __restrict__ mask,
                       uint32_t* __restrict__ state_out, int per, int lanes_arg,
                       long long n_valid) {
  const int lanes = LANES_T ? LANES_T : lanes_arg;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_info = reinterpret_cast<uint32_t*>(smem);  // [256][8]
  uint8_t* s_syms = smem + 256 * 32;                     // [2][ROWS][SLOT]
  const int tid = threadIdx.x;
  for (int i = tid; i < 512; i += THREADS)
    reinterpret_cast<uint4*>(s_info)[i] = info[i];
  const int lane0 = blockIdx.x * THREADS;
  const int lane = lane0 + tid;
  const bool active = lane < lanes;
  const int width = min(THREADS, lanes - lane0);
  const long long total = (long long)per * lanes;
  const int nvr = active ? valid_rows(n_valid, lane, lanes, per) : 0;
  const int tiles = (per + ROWS - 1) / ROWS;

  // Tile k holds rows [lo, hi), hi = per - k ROWS, lo = max(hi - ROWS, 0);
  // row r sits at slot r - lo from the 4-byte boundary at or below its
  // first lane, so any lane count stages with aligned 4-byte copies.
  auto stage = [&](int k) {
    const int hi = per - k * ROWS, lo = max(hi - ROWS, 0);
    uint8_t* dst = s_syms + (k & 1) * ROWS * SLOT;
    for (int i = tid; i < (hi - lo) * CHUNKS; i += THREADS) {
      const int row = i / CHUNKS, c = i - row * CHUNKS;
      const long long first = (long long)(lo + row) * lanes + lane0;
      const long long src = (first & ~3LL) + 4 * c;
      if (src >= first + width) continue;
      cp_async4(dst + row * SLOT + 4 * c, syms + src,
                (int)(total - src < 4 ? total - src : 4));
    }
    cp_async_commit();
  };

  uint32_t state = RANS_L;
  if (tiles > 0) stage(0);
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      stage(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k (and, at k = 0, the table) seen by every thread
    const int hi = per - k * ROWS, lo = max(hi - ROWS, 0);
    const uint8_t* tile = s_syms + (k & 1) * ROWS * SLOT;
    auto sym_at = [&](int r) {
      return (uint32_t)tile[(r - lo) * SLOT + (int)(((long long)r * lanes + lane0) & 3) + tid];
    };
    if (active) {
      int r = hi - 1;
      for (; r >= lo && r >= nvr; --r) {  // padding: no word, state kept
        const long long idx = (long long)r * lanes + lane;
        words[idx] = 0u;
        mask[idx] = 0u;
      }
      // valid rows r..lo: row r - 1's entry and row r - 2's symbol load
      // while row r runs (reads below lo land in the table or the other
      // buffer and feed only entries that are never used)
      if (r >= lo) {
        Entry next = entry_of(s_info, sym_at(r));
        uint32_t s1 = sym_at(r - 1);
#pragma unroll 4
        for (; r >= lo; --r) {
          const Entry e = next;
          next = entry_of(s_info, s1);
          s1 = sym_at(r - 2);
          const long long idx = (long long)r * lanes + lane;
          state = encode_step(state, e, words + idx, mask + idx);
        }
      }
    }
    __syncthreads();  // every thread done with this buffer before it is refilled
  }
  if (active) state_out[lane] = state;
}

// The byte offset of the slot entry of state or word v.
__device__ __forceinline__ uint32_t slot_addr(uint32_t v) { return (v & (M - 1u)) * 8u; }

// One decode step from the slot entry at byte offset `addr` of the table:
// x = f (state >> 12) + (slot - cum); below L it pulls the word w.  The
// next entry's offset comes from w's low bits after a pull, x's otherwise.
// Returns whether the step pulled w.
__device__ __forceinline__ bool decode_step(uint32_t& state, uint32_t& addr, uint32_t w,
                                            const char* tab) {
  const uint2 e = *reinterpret_cast<const uint2*>(tab + addr);
  const uint32_t x = e.x * (state >> PROB_BITS) + e.y;
  const bool need = x < RANS_L;
  addr = need ? slot_addr(w) : slot_addr(x);
  state = need ? (x << 16) | w : x;
  return need;
}

// slots[slot] = {f, slot - cum[sym]} of its symbol sym = s2s[slot] (rans.py
// slot_table): the multiply-add f * (state >> 12) + bias takes both from
// one 8-byte lookup; the symbol, which no later step needs, comes from its
// own byte table beside it.
// COMPACT = false: words are the dense (per, lanes) 32-bit buffer and the
// start states come from `state` (the TPU kernel's contract).
// COMPACT = true: words are lane j's uint16 stream at row j of a (lanes, cap)
// buffer (16-byte aligned), `lens` counts each lane's words; the state starts
// from the two flush words and the lane pulls words LIFO from lens - 3 down.
template <bool COMPACT, int LANES_T>
__global__ void __launch_bounds__(THREADS)
    rans_decode_kernel(const void* __restrict__ words, const int32_t* __restrict__ lens,
                       const uint32_t* __restrict__ state_in,
                       const uint2* __restrict__ slots, const uint8_t* __restrict__ s2s,
                       uint8_t* __restrict__ syms, int per, int lanes_arg, int cap,
                       long long n_valid) {
  const int lanes = LANES_T ? LANES_T : lanes_arg;
  // static, so that a lookup is one load at a constant offset from its
  // byte address (slot * 8)
  __shared__ __align__(16) uint2 s_tab[M];
  __shared__ uint8_t s_sym[M];
  extern __shared__ __align__(16) uint8_t stage_mem[];
  const int tid = threadIdx.x;
  for (int i = tid; i < (int)M; i += THREADS) {
    s_tab[i] = slots[i];
    s_sym[i] = s2s[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * THREADS + tid;
  if (lane >= lanes) return;
  const int nvr = valid_rows(n_valid, lane, lanes, per);
  uint8_t* out = syms + lane;
  const char* tab = reinterpret_cast<const char*>(s_tab);
  uint32_t state;
  if (COMPACT) {
    const uint16_t* stream = static_cast<const uint16_t*>(words);
    uint16_t* ring = reinterpret_cast<uint16_t*>(stage_mem) + tid * RING;
    const long long g0 = (long long)lane * cap;  // global index of the lane's word 0
    const long long end = (long long)lanes * cap;
    int ptr = lens[lane] - 2;
    state = (uint32_t)stream[g0 + ptr] | ((uint32_t)stream[g0 + ptr + 1] << 16);
    // words [low, top) of the buffer are in the ring, slot g mod RING; the
    // top includes word 0 (the clamp's) even when the lane emitted none
    long long low = (g0 + (ptr > 1 ? ptr : 1) + 7) & ~7LL;
    auto fill = [&](int target) {  // fetch down to lane-local word `target`
      const long long want = (g0 + (target > 0 ? target : 0)) & ~7LL;
      for (long long g = low - 8; g >= want; g -= 8)
        cp_async16(ring + (g & (RING - 1)), stream + g,
                   (int)(end - g < 8 ? (end - g) * 2 : 16));
      if (want < low) low = want;
      cp_async_commit();
    };
    const int ring0 = (int)(g0 & (RING - 1));
    // the word a renormalisation at pointer p pulls (the plain version's clamp at 0)
    auto word = [&](int p) {
      return (uint32_t)ring[(ring0 + (p > 0 ? p : 0)) & (RING - 1)];
    };
    // a tile moves the pointer down by at most ROWS and then reads one word
    // below it, so a fill reaches 2 ROWS + 1 below the pointer
    fill(ptr - 2 * ROWS - 1);
    cp_async_wait<0>();
    uint32_t w = word(ptr - 1);
    uint32_t addr = slot_addr(state);
    for (int r0 = 0; r0 < nvr; r0 += ROWS) {
      fill(ptr - 2 * ROWS - 1);  // the next tile's words, while this tile runs
      const int r1 = min(r0 + ROWS, nvr);
#pragma unroll 4
      for (int r = r0; r < r1; ++r) {
        out[(long long)r * lanes] = s_sym[addr / 8u];
        if (decode_step(state, addr, w, tab)) w = word(--ptr - 1);
      }
      cp_async_wait<0>();
    }
  } else {
    const uint32_t* dense = static_cast<const uint32_t*>(words);
    uint32_t* tile = reinterpret_cast<uint32_t*>(stage_mem);  // [2][DENSE_ROWS][THREADS]
    auto stage = [&](int r0, int buf) {
      const int r1 = min(r0 + DENSE_ROWS, nvr);
      for (int r = r0; r < r1; ++r)
        cp_async4(tile + (buf * DENSE_ROWS + r - r0) * THREADS + tid,
                  dense + (long long)r * lanes + lane, 4);
      cp_async_commit();
    };
    state = state_in[lane];
    uint32_t addr = slot_addr(state);
    stage(0, 0);
    for (int r0 = 0, buf = 0; r0 < nvr; r0 += DENSE_ROWS, buf ^= 1) {
      stage(r0 + DENSE_ROWS, buf ^ 1);
      cp_async_wait<1>();
      const uint32_t* t = tile + (buf * DENSE_ROWS - r0) * THREADS + tid;
      const int r1 = min(r0 + DENSE_ROWS, nvr);
#pragma unroll 4
      for (int r = r0; r < r1; ++r) {
        out[(long long)r * lanes] = s_sym[addr / 8u];
        decode_step(state, addr, t[r * THREADS], tab);
      }
    }
    cp_async_wait<0>();
  }
  // padding rows: the state stays, so every one reads the same symbol
  const uint8_t tail = s_sym[state & (M - 1u)];
  for (int r = nvr; r < per; ++r) out[(long long)r * lanes] = tail;
}

// The SM clock, read once v is known.
__device__ __forceinline__ long long clock_after(uint32_t v) {
  long long t;
  asm volatile("{\n .reg .u32 dep;\n mov.u32 dep, %1;\n mov.u64 %0, %%clock64;\n}"
               : "=l"(t)
               : "r"(v)
               : "memory");
  return t;
}

// `steps` (a multiple of 8) steps of one lane's chain, in thread 0 alone:
// kind 0 the encode's from RANS_L over the entries of syms[0..7], kind 1 the
// decode's from `state` with the slot table `slots`, pulling words[0..7]
// (step i takes entry or word i mod 8).  sink = {the final state, the
// encode's words and mask folded (kept alive), the SM cycles of the steps}.
// Plain version of the state: rans.py plain_chain.
__global__ void __launch_bounds__(THREADS)
    rans_chain_kernel(const uint4* __restrict__ info, const uint2* __restrict__ slots,
                      const uint8_t* __restrict__ syms, const uint32_t* __restrict__ words,
                      uint32_t state, int steps, int kind, long long* __restrict__ sink) {
  __shared__ __align__(16) uint2 s_tab[M];
  for (int i = threadIdx.x; i < (int)M; i += THREADS) s_tab[i] = slots[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t acc = 0;
  long long t0;
  if (kind == 0) {
    Entry e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = entry_of(reinterpret_cast<const uint32_t*>(info), syms[j]);
    state = RANS_L;
    t0 = clock_after(e[7].c);
    for (int i = 0; i < steps; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t w, m;
        state = encode_step(state, e[j], &w, &m);
        acc += w ^ m;
      }
    }
  } else {
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = words[j];
    const char* tab = reinterpret_cast<const char*>(s_tab);
    uint32_t addr = slot_addr(state);
    t0 = clock_after(w[7]);
    for (int i = 0; i < steps; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) decode_step(state, addr, w[j], tab);
    }
  }
  const long long t1 = clock_after(state);
  sink[0] = state;
  sink[1] = acc;
  sink[2] = t1 - t0;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int LANES_T>
int encode(const void* syms, const void* info, void* words, void* mask, void* state,
           int per, int lanes, long long n_valid, cudaStream_t s) {
  const cudaError_t attr = allow_smem(rans_encode_kernel<LANES_T>, ENC_SMEM);  // per device
  if (attr != cudaSuccess) return (int)attr;
  const int grid = (lanes + THREADS - 1) / THREADS;
  rans_encode_kernel<LANES_T><<<grid, THREADS, ENC_SMEM, s>>>(
      static_cast<const uint8_t*>(syms), static_cast<const uint4*>(info),
      static_cast<uint32_t*>(words), static_cast<uint32_t*>(mask),
      static_cast<uint32_t*>(state), per, lanes, n_valid);
  return (int)cudaGetLastError();
}

template <bool COMPACT, int LANES_T>
int decode(const void* words, const void* lens, const void* state, const void* slots,
           const void* s2s, void* syms, int per, int lanes, int cap, long long n_valid,
           cudaStream_t s) {
  const int smem = COMPACT ? DEC_SMEM_COMPACT : DEC_SMEM_DENSE;
  const cudaError_t attr = allow_smem(rans_decode_kernel<COMPACT, LANES_T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = (lanes + THREADS - 1) / THREADS;
  rans_decode_kernel<COMPACT, LANES_T><<<grid, THREADS, smem, s>>>(
      words, static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(state),
      static_cast<const uint2*>(slots), static_cast<const uint8_t*>(s2s),
      static_cast<uint8_t*>(syms), per, lanes, cap, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// syms uint8 (per, lanes), 16-byte aligned; info: 256 x 8 32-bit words
// (rans.py encode_table); words, mask (per, lanes) and state (lanes,):
// 32-bit words.  Returns the first CUDA error of the launch, or 0.
extern "C" int rans_encode_launch(const void* syms, const void* info, void* words,
                                  void* mask, void* state, int per, int lanes,
                                  long long n_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lanes == WIRE_LANES
             ? encode<WIRE_LANES>(syms, info, words, mask, state, per, lanes, n_valid, s)
             : encode<0>(syms, info, words, mask, state, per, lanes, n_valid, s);
}

// compact = 0: words (per, lanes) 32-bit, state (lanes,) 32-bit, lens unused;
// compact = 1: words uint16 (lanes, cap), 16-byte aligned, lens int32
// (lanes,), state unused.  slots: 4096 x 2 32-bit words (rans.py
// slot_table); s2s: uint8 (4096,); syms uint8 (per, lanes).  Returns the
// first CUDA error of the launch, or 0.
extern "C" int rans_decode_launch(const void* words, const void* lens,
                                  const void* state, const void* slots, const void* s2s,
                                  void* syms, int per, int lanes, int cap,
                                  long long n_valid, int compact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compact)
    return lanes == WIRE_LANES
               ? decode<true, WIRE_LANES>(words, lens, state, slots, s2s, syms, per, lanes,
                                       cap, n_valid, s)
               : decode<true, 0>(words, lens, state, slots, s2s, syms, per, lanes, cap,
                                 n_valid, s);
  return lanes == WIRE_LANES
             ? decode<false, WIRE_LANES>(words, lens, state, slots, s2s, syms, per, lanes,
                                      cap, n_valid, s)
             : decode<false, 0>(words, lens, state, slots, s2s, syms, per, lanes, cap,
                                n_valid, s);
}

// The chain probe (rans_chain_kernel): info and slots as for the kernels
// above, syms uint8 (8,), words (8,) 32-bit, each < 2^16, sink int64 (3,); steps
// a multiple of 8.  One block.  Returns the first CUDA error of the launch,
// or 0.
extern "C" int rans_chain_launch(const void* info, const void* slots, const void* syms,
                                 const void* words, unsigned state, int steps, int kind,
                                 void* sink, void* stream) {
  rans_chain_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(info), static_cast<const uint2*>(slots),
      static_cast<const uint8_t*>(syms), static_cast<const uint32_t*>(words), state, steps,
      kind, static_cast<long long*>(sink));
  return (int)cudaGetLastError();
}
