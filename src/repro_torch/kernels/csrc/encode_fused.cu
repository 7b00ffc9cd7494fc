// Fused transmit-side encode: split + zero-escape block stats + bit-plane pack.
//
// Replaces the TPU kernel src/repro/kernels/encode_fused.py::_encode_kernel
// (pallas_call at encode_fused.py:105).  Bit-identical to its plain version,
// repro_torch/kernels/ref.py::encode_fused, for all five float formats.
//
// Bound: device-memory bytes.  The function reads each element once and
// writes (width + lo_bits) / 8 bytes of planes per element plus 8 bytes per
// block (bf16 at width 5: 2 + 1.625 bytes an element).  Its integer work is
// a few operations an element, so the design is about keeping enough bytes
// in flight and few instructions a group:
//
// * Persistent thread blocks (grid: as many as fit on the card at once) walk
//   over TILES of `tile` compression blocks.  A tile's input is one
//   contiguous range, staged into shared memory a tile ahead (two stages)
//   by one 1-D bulk copy (TMA, completion counted on an mbarrier), so
//   every SM keeps tens of KB of loads in flight whatever the format's
//   item size, and no thread spends instructions on the copy.
// * A warp owns one compression block.  Pass 1 folds each lane's min/max of
//   the nonzero exponents over 16-byte shared-memory reads (two exponents a
//   word for 8- and 16-bit formats, by Hopper's min/max.u16x2); one
//   __reduce_min_sync / __reduce_max_sync finishes the block: no
//   __syncthreads and no shared-memory pass for the stats.
// * Pass 2 gives lane i element i of each GROUP of 32 and packs its residual
//   and lo bits into one word; when width + lo_bits <= 16 (bf16 and fp8 at
//   widths 1-8, f16 at 1-5) two groups share the word, one in each 16-bit
//   half, and their codes are computed together.  One 32 x 32 bit transpose
//   across the warp (five stages of rotate, shuffle, select) then leaves
//   plane word b in lane b (bit i = lane i's bit b, as `<< pos` at
//   encode_fused.py:75-84): every plane of one or two groups at once,
//   instead of one __ballot_sync per plane.
// * A tile's payload words, lo words, bases and rng are each one contiguous
//   range of device memory: they are staged in shared memory and go out as
//   16-byte stores (the <16-byte tail of the last tile word by word).
// * `width` is a template parameter for 1-8 (the widths the paths choose);
//   one generic instantiation (runtime width, two transposes a group)
//   serves 9-32.
//
// The wrapper (kernels/encode_fused.py::geometry) computes tile, threads,
// grid and shared bytes (the mbarriers, two input stages, the tile's
// outputs), and passes ENCODE_FUSED_THREADS and SM_THREADS to nvcc as
// -D defines (kernels/__init__.py).  The input must be 16-byte aligned (the wrapper raises otherwise):
// the callers pass a fresh or whole tensor, or a chunk row that starts at a
// multiple of 512 elements.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane.cuh"
#include "staging.cuh"

#if !defined(ENCODE_FUSED_THREADS) || !defined(SM_THREADS)
#error "build with kernels/__init__.py's NVCC_FLAGS (-DENCODE_FUSED_THREADS, -DSM_THREADS)"
#endif

namespace {

template <int TOTAL> struct Storage;
template <> struct Storage<32> { using T = uint32_t; };
template <> struct Storage<16> { using T = uint16_t; };
template <> struct Storage<8> { using T = uint8_t; };

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = ENCODE_FUSED_THREADS;
constexpr int MIN_BLOCKS = SM_THREADS / MAX_THREADS;  // resident blocks an SM

using bitplane::select_bits;

// 32 x 32 bit transpose across the warp: bit i of lane b's result is bit b
// of lane i's x.  Stage j swaps bit j of the lane and of the bit position:
// each lane sends its word rotated towards the partner's columns, and keeps
// the columns whose bit j equals its own (`Transpose`: per-lane constants).
struct Transpose {
  uint32_t keep[5], rot[5];
  __device__ __forceinline__ explicit Transpose(int lane) {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int j = 16 >> s;
      const uint32_t lo = 0xFFFFFFFFu / ((1u << j) + 1u);  // columns with bit j clear
      keep[s] = (lane & j) ? ~lo : lo;
      rot[s] = (lane & j) ? j : 32 - j;
    }
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const { return stages<0>(x); }
  // the last four stages, for a word that is already as the first leaves it
  __device__ __forceinline__ uint32_t from8(uint32_t x) const { return stages<1>(x); }
  template <int FIRST>
  __device__ __forceinline__ uint32_t stages(uint32_t x) const {
#pragma unroll
    for (int s = FIRST; s < 5; ++s) {
      const uint32_t y = __shfl_xor_sync(FULL, __funnelshift_l(x, x, rot[s]), 16 >> s);
      x = select_bits(keep[s], x, y);
    }
    return x;
  }
};

// per 16-bit half: min and max (Hopper's SIMD integer min/max)
__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
constexpr uint32_t H2 = 0x00010001u;  // one in each 16-bit half

template <int TOTAL, int EXP, int MANT, int WT>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
encode_fused_kernel(const typename Storage<TOTAL>::T* __restrict__ x,
                    uint32_t* __restrict__ pay, uint32_t* __restrict__ lo_out,
                    uint32_t* __restrict__ bases, uint32_t* __restrict__ rngs,
                    int n_blocks, int block, int tile, int width_rt) {
  using T = typename Storage<TOTAL>::T;
  constexpr int LO = 1 + MANT;
  constexpr int ISZ = TOTAL / 8;
  constexpr uint32_t EXP_MASK = (1u << EXP) - 1u;
  constexpr uint32_t MANT_MASK = (1u << MANT) - 1u;
  constexpr uint32_t EXPF = EXP_MASK << MANT;  // the exponent field in place
  constexpr uint32_t ONE = 1u << MANT, KF = 1u << (EXP + MANT);
  // two groups share a transpose when their planes fit in 16 bits; their
  // codes are then computed in the two 16-bit halves of one word
  constexpr bool PAIR = WT > 0 && WT + LO <= 16;
  const int W = WT > 0 ? WT : width_rt;

  // dynamic shared memory: two mbarriers (16 bytes), two input stages, then
  // the tile's payload, lo, bases and rng words
  extern __shared__ __align__(16) unsigned char dyn[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(dyn);
  unsigned char* smem = dyn + 16;
  const int gpb = block >> 5;
  const int stage_bytes = tile * block * ISZ;
  uint32_t* s_pay = reinterpret_cast<uint32_t*>(smem + 2 * stage_bytes);
  uint32_t* s_lo = s_pay + tile * gpb * W;
  uint32_t* s_base = s_lo + tile * gpb * LO;
  uint32_t* s_rng = s_base + tile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_tiles = (n_blocks + tile - 1) / tile;
  const uint32_t cmax = (uint32_t)((1ull << W) - 1ull);
  const Transpose transpose(lane);

  // stage s holds tile t + s' grid for the s'-th tile this block takes with
  // s' = s (mod 2); bars[s] counts its bytes, one phase a tile
  if (threadIdx.x == 0) {
    staging::bar_init(&bars[0]);
    staging::bar_init(&bars[1]);
  }
  __syncthreads();
  auto load = [&](int t, int stage) {  // one thread
    const long long b0 = (long long)t * tile;
    const uint32_t bytes = (uint32_t)(min((long long)tile, n_blocks - b0) * block * ISZ);
    staging::bulk_load(smem + stage * stage_bytes,
                       reinterpret_cast<const char*>(x) + b0 * block * ISZ, bytes, &bars[stage]);
  };

  int t = blockIdx.x;
  if (threadIdx.x == 0 && t < n_tiles) load(t, 0);
  for (int it = 0; t < n_tiles; t += gridDim.x, ++it) {
    const int stage = it & 1;
    // the other stage was read in the last iteration, before its barrier
    if (threadIdx.x == 0 && t + (int)gridDim.x < n_tiles) load(t + gridDim.x, stage ^ 1);
    staging::bar_wait(&bars[stage], (it >> 1) & 1);
    // and the staged output of the last tile has gone out
    __syncthreads();

    const int b0 = t * tile;
    const int nb = min(tile, n_blocks - b0);
    const T* xs = reinterpret_cast<const T*>(smem + stage * stage_bytes);
    for (int lb = warp; lb < nb; lb += n_warps) {
      const T* xb = xs + lb * block;
      // pass 1: min and max of the block's exponents over 16-byte reads;
      // the min is taken of e - 1 (uint wrap: a zero exponent is the
      // largest), so it is the min NONZERO exponent less 1
      uint32_t mn, mx;
      const uint4* xb4 = reinterpret_cast<const uint4*>(xb);
      if constexpr (TOTAL == 32) {
        mn = 0xFFFFFFFFu, mx = 0u;
        for (int c = lane; c < block / 4; c += 32) {
          const uint4 v = xb4[c];
          const uint32_t q4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t ex = (q4[q] >> MANT) & EXP_MASK;
            mn = min(mn, ex - 1u);
            mx = max(mx, ex);
          }
        }
      } else {  // two exponent fields a word, one in each 16-bit half
        // f: the field in place; (f + KF - ONE) ^ KF is (e - 1) << MANT for
        // e >= 1 and above every such value for e == 0
        uint32_t mn2 = 0xFFFFFFFFu, mx2 = 0u;
        auto fold = [&](uint32_t f) {
          mn2 = min_u16x2(mn2, (f + (KF - ONE) * H2) ^ (KF * H2));
          mx2 = max_u16x2(mx2, f);
        };
        for (int c = lane; c < block * ISZ / 16; c += 32) {
          const uint4 v = xb4[c];
          const uint32_t q4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            fold(q4[q] & (EXPF * H2));
            if constexpr (TOTAL == 8) fold((q4[q] >> 8) & (EXPF * H2));
          }
        }
        mn = min(mn2 & 0xFFFFu, mn2 >> 16) >> MANT;
        mx = max(mx2 & 0xFFFFu, mx2 >> 16) >> MANT;
      }
      mn = __reduce_min_sync(FULL, mn);
      mx = __reduce_max_sync(FULL, mx);
      // a block has a nonzero exponent iff its max exponent is >= 1; an
      // all-zero block gets base 1 and rng 0 - 1 + 1 == 0 (uint32 wrap)
      const uint32_t base = mx != 0u ? mn + 1u : 1u;
      if (lane == 0) {
        s_base[lb] = base;
        s_rng[lb] = mx - base + 1u;
      }

      // pass 2: residual code (0 for exponent 0, else exp - base + 1,
      // clamped to width bits: exception blocks carry clamped payload,
      // patched by the caller) and lo bits (sign | mantissa) of element
      // `lane` of each group, then its planes by one transpose
      const int g_blk = lb * gpb;  // first group of the block in the tile
      if constexpr (PAIR) {
        // Lane L holds elements c and c + 16 (c = L & 15) of group k + h
        // (h = L >> 4) in its two halves: the natural layout (element L of
        // groups k and k + 1) after the transpose's first stage, which the
        // loads so take on.  After the other four, lane L holds plane c of
        // group k + h (bit i = element i's bit c).
        const int half = lane >> 4, col = lane & 15;
        // which plane word lane L's result is: with the codes in place
        // (16-bit formats), bits 0 .. MANT-1 are the mantissa (lo planes),
        // MANT .. MANT+W-1 the residual, 15 the sign (lo plane MANT); else
        // the residual's W bits, then the lo bits
        int p_pay, p_lo;
        if constexpr (TOTAL == 16) {
          p_pay = col >= MANT && col < MANT + WT ? col - MANT : -1;
          p_lo = col < MANT ? col : (col == 15 ? MANT : -1);
        } else {
          p_pay = col < WT ? col : -1;
          p_lo = col >= WT && col < WT + LO ? col - WT : -1;
        }
        uint32_t* dst = p_pay >= 0 ? s_pay + (g_blk + half) * WT + p_pay
                                   : s_lo + (g_blk + half) * LO + p_lo;
        const int step = p_pay >= 0 ? 2 * WT : 2 * LO;
        const bool plane = p_pay >= 0 || p_lo >= 0;
        const uint32_t bias = TOTAL == 16 ? (((1u << EXP) + 1u - base) << MANT) * H2
                                          : (257u - base) * H2;
        const uint32_t top = TOTAL == 16 ? ((cmax + (1u << EXP)) << MANT) * H2
                                         : (cmax + 256u) * H2;
        const T* e = xb + half * 32 + col;  // element c of group k + h
        for (int k = 0; k < gpb; k += 2, dst += step, e += 64) {
          const bool mine = half == 0 || k + 1 < gpb;  // the block has group k + h
          const uint32_t w = mine ? (uint32_t)e[0] | (uint32_t)e[16] << 16 : 0u;
          uint32_t v;
          if constexpr (TOTAL == 16) {
            // in place, per half: t = (e + 2^EXP + 1 - base) << MANT, at
            // least KF = 2^EXP << MANT iff e != 0; max with KF zeroes the
            // code of e == 0, and bits MANT .. 14 of t are then the code
            uint32_t t = max_u16x2((w & (EXPF * H2)) + bias, KF * H2);
            if constexpr (WT < EXP) t = min_u16x2(t, top);
            v = select_bits(EXPF * H2, t, w);
          } else {
            // per half: e + 257 - base is in [2, 512], at least 256 iff e != 0
            const uint32_t e2 = (w >> MANT) & (EXP_MASK * H2);
            const uint32_t r2 = min_u16x2(max_u16x2(e2 + bias, 256u * H2), top) - 256u * H2;
            const uint32_t l2 = ((w >> (TOTAL - 1 - MANT)) & ((1u << MANT) * H2)) |
                                (w & (MANT_MASK * H2));
            v = r2 | (l2 << WT);
          }
          const uint32_t planes = transpose.from8(v);
          if (plane && mine) *dst = planes;
        }
      } else {
        auto codes = [&](int k, uint32_t& r, uint32_t& l) {
          const uint32_t bits = (uint32_t)xb[k * 32 + lane];
          const uint32_t ex = (bits >> MANT) & EXP_MASK;
          r = ex ? min(ex - base + 1u, cmax) : 0u;
          l = ((bits >> (TOTAL - 1)) << MANT) | (bits & MANT_MASK);
        };
        if constexpr (WT > 0) {  // WT + LO <= 32: one transpose a group
          for (int k = 0; k < gpb; ++k) {
            uint32_t r, l;
            codes(k, r, l);
            const uint32_t planes = transpose(r | (l << WT));
            const int g = g_blk + k;
            if (lane < WT) s_pay[g * WT + lane] = planes;
            else if (lane < WT + LO) s_lo[g * LO + (lane - WT)] = planes;
          }
        } else {  // generic width: the residual planes and the lo planes apart
          for (int k = 0; k < gpb; ++k) {
            uint32_t r, l;
            codes(k, r, l);
            const uint32_t pr = transpose(r);
            const uint32_t pl = transpose(l);
            const int g = g_blk + k;
            if (lane < W) s_pay[g * W + lane] = pr;
            if (lane < LO) s_lo[g * LO + lane] = pl;
          }
        }
      }
    }
    __syncthreads();

    const long long g0 = (long long)b0 * gpb;
    staging::store_words(pay + g0 * W, s_pay, nb * gpb * W);
    staging::store_words(lo_out + g0 * LO, s_lo, nb * gpb * LO);
    staging::store_words(bases + b0, s_base, nb);
    staging::store_words(rngs + b0, s_rng, nb);
  }
}

template <int TOTAL, int EXP, int MANT, int WT>
int launch_w(const void* x, void* pay, void* lo, void* bases, void* rng, int n_blocks,
             int block, int tile, int width, int grid, int threads, int smem,
             cudaStream_t stream) {
  auto kernel = encode_fused_kernel<TOTAL, EXP, MANT, WT>;
  if (const int err = staging::allow_smem(kernel, smem)) return err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const typename Storage<TOTAL>::T*>(x), static_cast<uint32_t*>(pay),
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(bases),
      static_cast<uint32_t*>(rng), n_blocks, block, tile, width);
  return (int)cudaGetLastError();
}

template <int TOTAL, int EXP, int MANT>
int launch(const void* x, void* pay, void* lo, void* bases, void* rng, int n_blocks,
           int block, int tile, int width, int grid, int threads, int smem,
           cudaStream_t s) {
  if (tile % 4 || threads % 32 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
#define EF_ARGS x, pay, lo, bases, rng, n_blocks, block, tile, width, grid, threads, smem, s
  switch (width) {
    case 1: return launch_w<TOTAL, EXP, MANT, 1>(EF_ARGS);
    case 2: return launch_w<TOTAL, EXP, MANT, 2>(EF_ARGS);
    case 3: return launch_w<TOTAL, EXP, MANT, 3>(EF_ARGS);
    case 4: return launch_w<TOTAL, EXP, MANT, 4>(EF_ARGS);
    case 5: return launch_w<TOTAL, EXP, MANT, 5>(EF_ARGS);
    case 6: return launch_w<TOTAL, EXP, MANT, 6>(EF_ARGS);
    case 7: return launch_w<TOTAL, EXP, MANT, 7>(EF_ARGS);
    case 8: return launch_w<TOTAL, EXP, MANT, 8>(EF_ARGS);
    default: return launch_w<TOTAL, EXP, MANT, 0>(EF_ARGS);
  }
#undef EF_ARGS
}

}  // namespace

// x: n elements of format `fmt` (index into repro_torch.kernels.FORMATS),
// 16-byte aligned, n % block == 0, block % 32 == 0, 32 <= block <= 1024,
// 1 <= width <= 32.  Outputs: pay (n/32, width), lo (n/32, lo_bits), bases
// (n/block,), rng (n/block,), all 32-bit words, 16-byte aligned.  Geometry
// from kernels/encode_fused.py::geometry: `tile` compression blocks a tile
// (a multiple of 4), `grid` persistent thread blocks of `threads` threads,
// `smem` dynamic shared bytes.  Returns cudaGetLastError(), or an error
// without launching if tile or threads do not hold.
extern "C" int encode_fused_launch(const void* x, void* pay, void* lo, void* bases,
                                   void* rng, int n, int block, int width, int fmt,
                                   int tile, int grid, int threads, int smem,
                                   void* stream) {
  const int n_blocks = n / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EF_ARGS x, pay, lo, bases, rng, n_blocks, block, tile, width, grid, threads, smem, s
  switch (fmt) {
    case 0: return launch<32, 8, 23>(EF_ARGS);
    case 1: return launch<16, 5, 10>(EF_ARGS);
    case 2: return launch<16, 8, 7>(EF_ARGS);
    case 3: return launch<8, 4, 3>(EF_ARGS);
    case 4: return launch<8, 5, 2>(EF_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef EF_ARGS
}
