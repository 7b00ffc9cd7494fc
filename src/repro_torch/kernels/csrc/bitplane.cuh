// Bit-plane helpers of the kernels that work on 4 consecutive values of a
// GROUP of 32 per thread (bitpack.cu's pack and unpack, decode_reduce.cu):
// plane words to values and values to plane words.  A group's plane word b
// holds bit b of value i at bit i.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace bitplane {

constexpr unsigned FULL = 0xffffffffu;

// per bit: mask ? a : b, one instruction
__device__ __forceinline__ uint32_t select_bits(uint32_t mask, uint32_t a, uint32_t b) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(d) : "r"(a), "r"(b), "r"(mask));
  return d;
}

// values 4j .. 4j + 3 of a group from its WT <= 8 plane words w[0 .. WT),
// one value a byte (byte i is value shift + i); `shift` = 4j.  A nibble of
// each plane word spreads into the four bytes by one multiply: x * 0x00204081
// puts bit i at 8i among no other set bits.
template <int WT>
__device__ __forceinline__ uint32_t unpack4_bytes(const uint32_t* w, int shift) {
  static_assert(WT >= 1 && WT <= 8, "one byte a value");
  uint32_t acc = 0u;
#pragma unroll
  for (int b = 0; b < WT; ++b)
    acc |= ((((w[b] >> shift) & 0xFu) * 0x00204081u) & 0x01010101u) << b;
  return acc;
}

// the same values as 32-bit words, for any width (WT = 0: `width` at run time)
template <int WT>
__device__ __forceinline__ uint4 unpack4(const uint32_t* w, int width, int shift) {
  if constexpr (WT >= 1 && WT <= 8) {
    const uint32_t acc = unpack4_bytes<WT>(w, shift);
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

// The inverse: planes 0 .. 7 (those below WT when WT > 0) of 4
// consecutive values, one a byte of `bytes`, as the nibbles of one word
// (nibble b holds byte i's bit b at bit i).  x * 0x10204080 moves bit 8i of
// x to bit 28 + i, and every other product lands below bit 28 or above bit
// 31, each on a bit of its own (no carries).
template <int WT>
__device__ __forceinline__ uint32_t pack4_nibbles(uint32_t bytes) {
  uint32_t nibs = 0u;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (WT == 0 || b < WT)
      nibs |= ((((bytes >> b) & 0x01010101u) * 0x10204080u) >> 28) << (4 * b);
  return nibs;
}

// 8 x 8 nibble transpose across the 8 lanes of a group (lanes 8k .. 8k + 7):
// nibble i of lane q's result is nibble q of lane i's x.  Stage j swaps bit
// j of the lane and of the nibble position, as encode_fused.cu's 32 x 32 bit
// transpose does with bits: each lane sends its word rotated towards the
// partner's nibbles, and keeps the nibbles whose position has bit j as its
// lane has.
struct Transpose8 {
  uint32_t keep[3], rot[3];
  __device__ __forceinline__ explicit Transpose8(int lane) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int j = 4 >> s;
      const uint32_t lo = 0xFFFFFFFFu / ((1u << (4 * j)) + 1u);  // nibbles with bit j clear
      keep[s] = (lane & j) ? ~lo : lo;
      rot[s] = (lane & j) ? 4 * j : 32 - 4 * j;
    }
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint32_t y = __shfl_xor_sync(FULL, __funnelshift_l(x, x, rot[s]), 4 >> s);
      x = select_bits(keep[s], x, y);
    }
    return x;
  }
};

}  // namespace bitplane
