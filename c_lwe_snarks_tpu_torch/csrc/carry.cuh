// The row fold of K10 (digits.cu), shared with K11 (verify.cu): a row of
// non-negative 64-bit planes spread over a group of kLanes lanes (half a
// warp), lane g owning the kPer contiguous positions kPer g ... kPer g +
// kPer - 1 of a pass, folded to base-256 digits by the lane's own walk, two
// carry rounds by __shfl_up_sync and a carry lookahead over the group's
// __ballot_sync bits.  Every lane of the warp must call it (full masks);
// the two half-warps fold two rows.  The design is digits.cu's header.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cls {

constexpr int kLanes = 16;               // lanes a row is spread over
constexpr int kPer = 6;                  // contiguous positions a lane owns
constexpr int kSeg = kLanes * kPer;      // positions of one pass over a row
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kBlockMask = (1ull << (8 * kPer)) - 1;  // a lane's six digits

// The fold of one pass: lane g holds x[j] at position p0 + j (< 2^63 each;
// lane 0's x[0] < 2^63 + 2^58 with the carry in).  Returns the lane's six
// digits; out, in the group's top lane, is the carry out of the pass.
__device__ __forceinline__ uint64_t fold_group(const uint64_t (&x)[kPer], int g, int shift,
                                               uint64_t& out) {
  // round 0: the lane's own positions in order; the carry stays < 2^56
  uint64_t d = 0, c = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const uint64_t v = x[j] + c;
    d |= (v & 255u) << (8 * j);
    c = v >> 8;
  }
  out = c;
  // round 1: + the lane below's carry: < 2^48 + 2^56, so the carry <= 2^8
  const uint64_t c1 = __shfl_up_sync(kFull, c, 1, kLanes);
  d += g ? c1 : 0;
  c = d >> (8 * kPer);
  d &= kBlockMask;
  out += c;
  // round 2: + the lane below's carry: < 2^48 + 2^8, so the carry <= 1
  const uint32_t c2 = __shfl_up_sync(kFull, static_cast<uint32_t>(c), 1, kLanes);
  d += g ? c2 : 0u;
  c = d >> (8 * kPer);
  d &= kBlockMask;
  out += c;
  // round 3: the last one-bit ripple by lookahead over the group's ballot bits
  const unsigned cb = (__ballot_sync(kFull, c != 0) >> shift) & 0xFFFFu;
  d += (cb << 1 >> g) & 1u;  // <= 2^48
  const unsigned gen = (__ballot_sync(kFull, d > kBlockMask) >> shift) & 0xFFFFu;
  const unsigned prop = (__ballot_sync(kFull, d == kBlockMask) >> shift) & 0xFFFFu;
  const unsigned carries = ((gen | prop) + gen) ^ prop;  // bit g: the carry into lane g
  d += (carries >> g) & 1u;
  out += carries >> kLanes;  // the top lane's overflow
  return d & kBlockMask;
}

}  // namespace cls
