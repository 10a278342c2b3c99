// Device helpers shared by the keystream kernels K1..K4: the byte swap of
// the cipher's big-endian state words, the fold of K2 (p = 2^32 - 5; exact
// for every pair of words, as ops/modp.py:fold64_mod_p is), and small
// host-side grid arithmetic.  The cipher itself is aes_core_cf.cuh.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cls {

constexpr uint32_t kP = 0xFFFFFFFBu;  // p = 2^32 - 5

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// (hi * 2^32 + lo) mod p, the function of ops/modp.py:fold64_mod_p, in two
// multiply-adds.  2^32 = 5 (mod p), so the value is t = 5 * hi + lo, one
// 32 x 32 -> 64 bit multiply-add with th = t >> 32 <= 5, and again
// r = tl + 5 * th with 5 * th <= 25.  If that sum wraps, the wrapped r is
// <= 24 and stands for r + 2^32 = r + 5 <= 29 < p; if not, r < 2^32 < 2p and
// one conditional subtraction brings it under p.
__device__ __forceinline__ uint32_t fold64_mod_p(uint32_t hi, uint32_t lo) {
  const uint64_t t = static_cast<uint64_t>(hi) * 5u + lo;
  const uint32_t tl = static_cast<uint32_t>(t);
  uint32_t r = tl + 5u * static_cast<uint32_t>(t >> 32);
  if (r < tl) r += 5u;
  return r >= kP ? r - kP : r;
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

inline int grid_1d(int64_t items, int threads, int64_t cap) {
  int64_t g = (items + threads - 1) / threads;
  if (g > cap) g = cap;
  return static_cast<int>(g < 1 ? 1 : g);
}

}  // namespace cls
