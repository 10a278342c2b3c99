// K10 carry_fold: non-negative accumulator planes [rows, K] (position t of
// weight 256^t) -> uint8 digits [rows, ndigits], the value
// sum_t x_t * 256^t mod 256^ndigits.  One core, four forms, each one launch:
//
// - the planes form (cls_carry_fold): int64 or int32 planes, any K and any
//   ndigits.  Replaces the jnp function c_lwe_snarks_tpu/ops/digits.py:73
//   carry_fold (shift-add passes and a carry lookahead by two cummax);
//   bigint_dot's fold, the mesh's int32 sums, ct_add and ct_mul_ui of the
//   stage-wise path.
// - the b-row form (cls_carry_fold_b_rows): setup's b = <sk, a> + p * e + m
//   mod 2^704 from K4's two nibble plane arrays, the error bytes and the
//   message words.  Replaces the epilogue of
//   c_lwe_snarks_tpu/models/lwe.py:113 encrypt_b.
// - the MAC-plane form (cls_carry_fold_mac): the epilogue of the prover's
//   evaluations, K3's planes [4, k, n, 88] and the b-row MAC [4, k, 88],
//   plane c added at a shift of c positions, each split into its low byte
//   and its high part as combine_shift_planes does -> uint8 [k, n+1, 88].
//   Replaces c_lwe_snarks_tpu/models/lwe.py:440-454 (concatenate,
//   combine_shift_planes, carry_fold).
// - the smudge form (cls_carry_fold_smudge): b += sum_i sigma_i * p * s_i
//   mod 2^704 over a row's smudging draws, in place.  Replaces the JAX
//   package's smudge (c_lwe_snarks_tpu/models/lwe.py:328: scalar_mul_digits,
//   add_digits, sub_digits, where), all five draws of the prover's
//   smudging in one launch (v_w's two in one walk).
// The port's plain versions are ops/digits.py:carry_fold_plain,
// b_rows_plain, fold_mac_planes_plain and smudge_draws_plain.
//
// Bound on the H100: the bytes, read once and written once (setup's b-row
// call: 2 x 30.8 MB of int32 planes, 7.7 MB of errors and 0.7 MB of
// messages in, 7.7 MB of digits out: 0.023 ms; the prover's MAC planes
// 20.7 MB in, 0.65 MB out: 0.0064 ms); a few integer operations a position.
// The carry is a dependency along the row; a lane that walked a whole row
// in order left setup's 87,381 rows to one wave of serial walkers.  Design:
// a row is spread over a group of kLanes lanes (half a warp), lane g owning
// the kPer contiguous positions p0 = kPer g ... p0 + kPer - 1 of a pass
// (kSeg = 96 positions: one pass for ndigits <= 96), so the grid has a
// group a row (tens of thousands of warps at setup's rows) and the row's
// bytes are read by the group's lanes side by side, with no shared-memory
// staging; the 88-digit forms load two positions at a time from rows that
// start pair-aligned (their wrappers check), predicated off past the row's
// end instead of branching on each address (a per-pair alignment test held
// the b-row form at twice its time, 78 registers against 38).  The fold
// (carry.cuh's fold_group, which K11 shares):
// round 0, the lane walks its own positions (x < 2^63 each, the carry out
// < 2^56) and keeps six digits, one base-2^48 digit; rounds 1 and 2 add
// the carry of the lane below (__shfl_up_sync; after them every lane's
// carry is <= 1); round 3 resolves the last one-bit ripple by lookahead
// with __ballot_sync: a lane generates if its value is 2^48 and propagates
// if it is 2^48 - 1, and it takes a carry iff the nearest lane below it
// that does not propagate generates -- the rule of carry_fold_plain and of
// the JAX package's two cummax, on six positions at once, which is
// ((gen | prop) + gen) ^ prop over the group's ballot bits.  Every add is
// under 2^64 for every non-negative int64 or int32 plane (any K); passes
// past the first take the carry out of the pass before (ndigits > 96).
// Positions past K read 0; positions at or past ndigits are never read and
// never stored.  The forms differ only in what a lane loads: the b-row
// form adds p * e from its error bytes and the lane below's top three
// (one shuffle) and m's bytes in lane 0; the MAC-plane form splits each
// plane entry into low byte and high part, and hands what lands on the
// next lane's positions up by four shuffles; the smudge form adds p * s
// (p's four bytes against the draw's bytes and the lane below's top three)
// or, for a negative sign, (2^24 - p * s) at each position and the
// constant (256, 255, 255, 254, ..., 254) -- the planes of -p * s mod
// 2^704, all non-negative -- for each draw that targets the row.
#include <cstdint>
#include <cuda_runtime.h>

#include "carry.cuh"

using namespace cls;

namespace {

constexpr int kThreads = 256;            // threads of a block
constexpr int kRowsPerBlock = kThreads / kLanes;
constexpr int kDigits = 88;              // mod-2^704 digits: the b-row, MAC-plane and smudge forms
constexpr uint32_t kP0 = 0xFBu;          // p = 2^32 - 5: bytes FB FF FF FF
constexpr uint32_t kPHi = 0xFFu;

__device__ __forceinline__ uint64_t ld1(const int64_t* a) { return static_cast<uint64_t>(__ldg(a)); }
__device__ __forceinline__ uint64_t ld1(const int32_t* a) {
  return static_cast<uint32_t>(__ldg(a));
}
__device__ __forceinline__ uint64_t ld1(const uint8_t* a) { return __ldg(a); }

__device__ __forceinline__ void ld2(const int64_t* a, uint64_t& x0, uint64_t& x1) {
  const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(a));
  x0 = static_cast<uint64_t>(v.x);
  x1 = static_cast<uint64_t>(v.y);
}
__device__ __forceinline__ void ld2(const int32_t* a, uint64_t& x0, uint64_t& x1) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(a));
  x0 = static_cast<uint32_t>(v.x);
  x1 = static_cast<uint32_t>(v.y);
}
__device__ __forceinline__ void ld2(const uint8_t* a, uint64_t& x0, uint64_t& x1) {
  const unsigned short v = __ldg(reinterpret_cast<const unsigned short*>(a));
  x0 = v & 255u;
  x1 = v >> 8;
}

// x[j] = row[p0 + j] for p0 + j < lim, else 0: one position a load
template <class T>
__device__ __forceinline__ void load_each(const T* row, int64_t p0, int64_t lim,
                                          uint64_t (&x)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = p0 + j < lim ? ld1(row + p0 + j) : 0;
}

// the same for a row of kDigits positions that starts pair-aligned (the
// wrappers check the tensors' alignment): two positions a load, and as
// kDigits and p0 are even a pair is all in or all out, so the lanes past
// the row's end are predicated off and no lane branches on an address
template <class T>
__device__ __forceinline__ void load_pairs(const T* row, int64_t p0, uint64_t (&x)[kPer]) {
#pragma unroll
  for (int q = 0; q < kPer; q += 2) {
    uint64_t a = 0, b = 0;
    if (p0 + q < kDigits) ld2(row + p0 + q, a, b);
    x[q] = a;
    x[q + 1] = b;
  }
}

// the coherent path's bytes, for a row this launch rewrites
__device__ __forceinline__ void load_bytes(const uint8_t* row, int64_t p0, uint64_t (&x)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = p0 + j < kDigits ? row[p0 + j] : 0;
}

// dst[p0 + j] = byte j of d for p0 + j < lim; two bytes a store when pairs
// (lim and every row's start even: the launcher's test, uniform)
__device__ __forceinline__ void store_run(uint8_t* dst, int64_t p0, int64_t lim, bool pairs,
                                          uint64_t d) {
  if (pairs) {
#pragma unroll
    for (int q = 0; q < kPer; q += 2)
      if (p0 + q < lim)
        *reinterpret_cast<unsigned short*>(dst + p0 + q) = static_cast<unsigned short>(d >> (8 * q));
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (p0 + j < lim) dst[p0 + j] = static_cast<uint8_t>(d >> (8 * j));
  }
}

// the lane below's bytes at p0 - 1, p0 - 2, p0 - 3 as E[2], E[1], E[0],
// the lane's own bytes as E[3 + j]; zero below the group's lane 0
__device__ __forceinline__ void with_below(const uint64_t (&v)[kPer], int g, uint32_t (&E)[kPer + 3]) {
  const uint32_t top = static_cast<uint32_t>(v[kPer - 3] | v[kPer - 2] << 8 | v[kPer - 1] << 16);
  const uint32_t below = __shfl_up_sync(kFull, top, 1, kLanes);
  const uint32_t b = g ? below : 0u;
  E[0] = b & 255u;
  E[1] = (b >> 8) & 255u;
  E[2] = b >> 16;
#pragma unroll
  for (int j = 0; j < kPer; ++j) E[3 + j] = static_cast<uint32_t>(v[j]);
}

// p times bytes at position j (E from with_below): sum_c p_c E[3 + j - c] < 2^18
__device__ __forceinline__ uint32_t p_times(const uint32_t (&E)[kPer + 3], int j) {
  return kP0 * E[3 + j] + kPHi * (E[2 + j] + E[1 + j] + E[j]);
}

// the planes form: int64 or int32 [rows, k], positions past lim = min(k, ndigits) read 0
template <class T>
struct Planes {
  const T* x;
  int64_t k, lim;
  __device__ __forceinline__ void operator()(int64_t row, int64_t p0, int, uint64_t (&v)[kPer]) const {
    load_each(x + row * k, p0, lim, v);
  }
};

// the b-row form: lo + 16 hi (K4's nibble planes, int32 [rows, 88]) + p * e
// (e: uint8 [rows, 88]) + m's four bytes (m: int64 [rows]); x < 2^37
struct BRow {
  const int32_t* lo;
  const int32_t* hi;
  const uint8_t* e;
  const int64_t* m;
  __device__ __forceinline__ void operator()(int64_t row, int64_t p0, int g,
                                             uint64_t (&x)[kPer]) const {
    uint64_t a[kPer], b[kPer], ev[kPer];
    load_pairs(lo + row * kDigits, p0, a);
    load_pairs(hi + row * kDigits, p0, b);
    load_pairs(e + row * kDigits, p0, ev);
    const uint64_t msg = g == 0 ? ld1(m + row) : 0;  // lane 0 holds positions 0..5
    uint32_t E[kPer + 3];
    with_below(ev, g, E);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      x[j] = a[j] + 16 * b[j] + p_times(E, j) + (j < 4 ? (msg >> (8 * j)) & 255u : 0);
  }
};

// the MAC-plane form: row (kk, i) of [k, n+1] reads plane c at a[c, kk, i]
// (int64 [4, k, n, 88]) for i < n, at b[c, kk] (int64 [4, k, 88]) for i = n;
// position t takes lo(P_c[t - c]) + hi(P_c[t - c - 1]): x < 2^59
struct Mac {
  const int64_t* a;
  const int64_t* b;
  int64_t k, n;
  __device__ __forceinline__ void operator()(int64_t row, int64_t p0, int g,
                                             uint64_t (&x)[kPer]) const {
    const int64_t kk = row / (n + 1), i = row - kk * (n + 1);
    uint64_t acc[kPer + 4] = {};  // the lane's positions and the four above them
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t* src = i < n ? a + ((c * k + kk) * n + i) * kDigits : b + (c * k + kk) * kDigits;
      uint64_t v[kPer];
      load_pairs(src, p0, v);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        acc[j + c] += v[j] & 255u;
        acc[j + c + 1] += v[j] >> 8;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // what lands on the next lane's first four positions
      const uint64_t up = __shfl_up_sync(kFull, acc[kPer + q], 1, kLanes);
      x[q] = acc[q] + (g ? up : 0);
    }
#pragma unroll
    for (int j = 4; j < kPer; ++j) x[j] = acc[j];
  }
};

// the smudge form: row r's b digits at b + r * b_stride (uint8 [88], rewritten
// in place); draw i at s + i * s_stride: its s_len digits, then its sign byte
// (positive iff its low bit is 0); its target row (targets >> 4 i) & 15, 15
// meaning every row; x < 2^26 for 2 draws a row
struct Smudge {
  const uint8_t* b;
  int64_t b_stride;
  const uint8_t* s;
  int64_t s_stride, s_len;
  uint32_t draws, targets;
  __device__ __forceinline__ void operator()(int64_t row, int64_t p0, int g,
                                             uint64_t (&x)[kPer]) const {
    load_bytes(b + row * b_stride, p0, x);
    for (uint32_t i = 0; i < draws; ++i) {  // every lane takes part in each shuffle
      uint64_t sv[kPer];
      load_each(s + i * s_stride, p0, s_len, sv);
      uint32_t E[kPer + 3];
      with_below(sv, g, E);
      const uint32_t tgt = (targets >> (4 * i)) & 15u;
      if (tgt != 15u && tgt != row) continue;
      const bool pos = (__ldg(s + i * s_stride + s_len) & 1u) == 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const uint32_t y = p_times(E, j);
        const int64_t t = p0 + j;
        x[j] += pos ? y : (1u << 24) - y + (t == 0 ? 256u : t < 3 ? 255u : 254u);
      }
    }
  }
};

template <class Load>
__global__ void __launch_bounds__(kThreads)
carry_fold_kernel(Load load, int64_t rows, int64_t ndigits, uint8_t* out, int64_t out_stride,
                  bool pair_stores) {
  const int lane = threadIdx.x & 31, g = lane & (kLanes - 1), shift = lane & kLanes;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31)) / kLanes;
  if (row0 >= rows) return;  // the warp's rows are all past the last
  const int64_t row = row0 + lane / kLanes;
  const bool live = row < rows;
  const int64_t r = live ? row : rows - 1;  // a group past the last row folds it and stores nothing
  uint8_t* dst = out + r * out_stride;
  uint64_t in = 0;  // the carry out of the pass before
  for (int64_t s0 = 0; s0 < ndigits; s0 += kSeg) {
    const int64_t p0 = s0 + kPer * g;
    uint64_t x[kPer];
    load(r, p0, g, x);
    if (g == 0) x[0] += in;
    uint64_t carry;
    const uint64_t d = fold_group(x, g, shift, carry);
    if (live) store_run(dst, p0, ndigits, pair_stores, d);
    in = __shfl_sync(kFull, carry, kLanes - 1, kLanes);
  }
}

unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

// two-byte stores: every row of out starts even and so does its length
bool pairs_at(const void* out, int64_t stride, int64_t ndigits) {
  return reinterpret_cast<uintptr_t>(out) % 2 == 0 && stride % 2 == 0 && ndigits % 2 == 0;
}

}  // namespace

// x: int64 (is32 == 0) or int32 (is32 != 0) [rows, k], non-negative;
// out: uint8 [rows, ndigits].  rows, k, ndigits > 0.
extern "C" int cls_carry_fold(const void* x, uint32_t is32, int64_t rows, int64_t k,
                              int64_t ndigits, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  const int64_t lim = k < ndigits ? k : ndigits;
  const bool pairs = pairs_at(out, ndigits, ndigits);
  if (is32)
    carry_fold_kernel<<<blocks_for(rows), kThreads, 0, st>>>(
        Planes<int32_t>{static_cast<const int32_t*>(x), k, lim}, rows, ndigits, o, ndigits, pairs);
  else
    carry_fold_kernel<<<blocks_for(rows), kThreads, 0, st>>>(
        Planes<int64_t>{static_cast<const int64_t*>(x), k, lim}, rows, ndigits, o, ndigits, pairs);
  return static_cast<int>(cudaGetLastError());
}

// lo, hi: int32 [rows, 88] (non-negative, 8-byte aligned), e: uint8 [rows,
// 88] (2-byte aligned), m: int64 [rows] (< 2^32); out: uint8 [rows, 88]
// (2-byte aligned).  rows > 0.
extern "C" int cls_carry_fold_b_rows(const void* lo, const void* hi, const void* e, const void* m,
                                     int64_t rows, void* out, void* stream) {
  const BRow load{static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
                  static_cast<const uint8_t*>(e), static_cast<const int64_t*>(m)};
  carry_fold_kernel<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      load, rows, kDigits, static_cast<uint8_t*>(out), kDigits, true);
  return static_cast<int>(cudaGetLastError());
}

// a: int64 [4, k, n, 88], b: int64 [4, k, 88], non-negative, 16-byte
// aligned; out: uint8 [k, n+1, 88] (2-byte aligned).  k > 0, n >= 0.
extern "C" int cls_carry_fold_mac(const void* a, const void* b, int64_t k, int64_t n, void* out,
                                  void* stream) {
  const Mac load{static_cast<const int64_t*>(a), static_cast<const int64_t*>(b), k, n};
  const int64_t rows = k * (n + 1);
  carry_fold_kernel<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      load, rows, kDigits, static_cast<uint8_t*>(out), kDigits, true);
  return static_cast<int>(cudaGetLastError());
}

// b: uint8, row r's 88 digits at b + b_off + r * b_stride, rewritten in
// place; s: uint8, draw i at s + i * s_stride, its s_len <= 88 digits then
// its sign byte; draws <= 8, rows <= 15 unless every draw's target is 15
// (every row).
extern "C" int cls_carry_fold_smudge(void* b, int64_t b_off, int64_t b_stride, int64_t rows,
                                     const void* s, int64_t s_stride, int64_t s_len,
                                     uint32_t draws, uint32_t targets, void* stream) {
  uint8_t* rows_at = static_cast<uint8_t*>(b) + b_off;
  const Smudge load{rows_at, b_stride, static_cast<const uint8_t*>(s), s_stride, s_len, draws,
                    targets};
  carry_fold_kernel<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      load, rows, kDigits, rows_at, b_stride, pairs_at(rows_at, b_stride, kDigits));
  return static_cast<int>(cudaGetLastError());
}
