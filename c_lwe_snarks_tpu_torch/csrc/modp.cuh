// Mod-p device helpers of K8 (modp.cu), shared with K11 (verify.cu):
// p = 2^32 - 5, the fold of a 64-bit sum by 2^32 = 5 (mod p), mulmod and
// square and multiply, and K8's at-s power walk (w = s^c made in the
// block, one mulmod a column).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"

namespace cls {

// x folded by 2^32 = 5 (mod p): for any 64-bit x the result is < 6 * 2^32 < 2^35
__device__ __forceinline__ uint64_t fold35(uint64_t x) {
  return 5ull * (x >> 32) + (x & 0xFFFFFFFFull);
}

// x mod p for 0 <= x < 2^53: 5 * hi + lo < 2^32 + 2^24 < 2p
__device__ __forceinline__ int64_t reduce53_mod_p(uint64_t x) {
  uint64_t r = fold35(x);
  if (r >= kP) r -= kP;
  if (r >= kP) r -= kP;
  return static_cast<int64_t>(r);
}

__device__ __forceinline__ uint32_t mulmod_p(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  return fold64_mod_p(static_cast<uint32_t>(x >> 32), static_cast<uint32_t>(x));
}

// b^e mod p by square and multiply over e's bits
__device__ __forceinline__ uint32_t pow_mod_p(uint32_t b, uint64_t e) {
  uint32_t r = 1u;
  for (; e; e >>= 1) {
    if (e & 1u) r = mulmod_p(r, b);
    b = mulmod_p(b, b);
  }
  return r;
}

// the at-s form's operand, made in the block: s^c at the thread's columns
// c0, c0 + kStride, ..., in that order, one mulmod a column (kStride: the
// threads of the block that walks the columns; s: int64 or uint32, < p)
template <int kStride, class T = int64_t>
struct WPowers {
  const T* s;
  uint32_t cur, step;
  __device__ __forceinline__ void start(int64_t c0) {
    const uint32_t b = static_cast<uint32_t>(*s);
    cur = pow_mod_p(b, static_cast<uint64_t>(c0));
    step = pow_mod_p(b, kStride);
  }
  __device__ __forceinline__ uint32_t next(int64_t) {
    const uint32_t x = cur;
    cur = mulmod_p(cur, step);
    return x;
  }
};

}  // namespace cls
