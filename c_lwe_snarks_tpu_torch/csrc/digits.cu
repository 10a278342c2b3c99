// K10 carry_fold: non-negative accumulator planes [rows, K] (position t of
// weight 256^t) -> uint8 digits [rows, ndigits], the value
// sum_t x_t * 256^t mod 256^ndigits; and its b-row form, setup's
// b = <sk, a> + p * e + m mod 2^704 from K4's two nibble plane arrays.
//
// Replaces the jnp function c_lwe_snarks_tpu/ops/digits.py:carry_fold (four
// shift-add passes and a carry lookahead by two cummax) and, in the b-row
// form, the epilogue of c_lwe_snarks_tpu/models/lwe.py:encrypt_b (the fold
// of the dot planes, p * e by shifted planes, the message digits); the
// port's plain versions are ops/digits.py:carry_fold_plain and
// b_rows_plain.
//
// Bound on the H100: the bytes, read once and written once (setup's b-row
// call: 2 x 30.8 MB of int32 planes, 7.7 MB of errors and 0.7 MB of
// messages in, 7.7 MB of digits out: 0.023 ms); a few integer operations a
// position.  The carry is a dependency along the row, so a lane owns one
// row and walks its positions in order with a 64-bit carry: x + carry < 2^64
// for every x < 2^63, so the fold is exact for every non-negative int64 or
// int32 plane, with no bound on K.  Design: a warp owns 32 rows and walks
// them kChunk positions at a time.  It stages a chunk of its 32 rows in
// shared memory with coalesced loads (one row's chunk a load instruction,
// a lane a position), each lane walks its row's chunk there (row stride
// kChunk + 1 words of 8 bytes: 16 lanes on 16 distinct bank pairs, the
// least two wavefronts an 8-byte access needs), writes the digits to a byte
// tile (row stride kChunk + 4 bytes: 9 words, 32 lanes on 32 banks), and
// the warp stores the tile one row's chunk an instruction.  A lane issues
// kBatch rows' loads, with no branch between them, before it stages them,
// so a warp has that many rows in flight (at setup's 87,381 rows the grid
// is about one wave of warps: the kernel is bound by a warp's latency).  Positions at or
// past ndigits are never read (carries only rise); positions past K read 0
// and take the carry on.  The b-row form stages lo_t + 16 hi_t and the error
// byte e_t (in the digit tile, which the walk overwrites), and the walk adds
// sum_c p_c e_(t-c) from the last three bytes it keeps in registers and the
// message's byte m_t: x_t < 2^36, every input byte read once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;     // positions a warp stages at a time
constexpr int kWarps = 4;      // warps of a block, 32 rows each
constexpr int kRowsPerBlock = 32 * kWarps;
constexpr int kPad = kChunk + 1;     // row stride of the plane tile, 8-byte words
constexpr int kOutPad = kChunk + 4;  // row stride of the digit tile, bytes
constexpr int kBatch = 16;     // rows whose loads a lane has in flight before it stages them
constexpr uint32_t kP = 0xFFFFFFFBu;  // p = 2^32 - 5

// the planes of carry_fold: int64 or int32 [rows, k]
template <class T>
struct Planes {
  static constexpr bool kErrors = false;
  const T* x;
  int64_t k;
  __device__ __forceinline__ uint64_t operator()(int64_t row, int64_t t) const {
    return static_cast<uint64_t>(__ldg(x + row * k + t));
  }
  __device__ __forceinline__ uint8_t err(int64_t, int64_t) const { return 0; }
  __device__ __forceinline__ uint64_t msg(int64_t) const { return 0; }
};

// the b-row form: the staged value lo + 16 hi (K4's nibble planes, int32
// [rows, k]), the error byte e (uint8 [rows, k]) staged beside it, and the
// row's message word m (int64 [rows]); the walk adds p * e from p's four
// bytes and the last three error bytes it keeps, and m's bytes at t < 4
struct BRow {
  static constexpr bool kErrors = true;
  const int32_t* lo;
  const int32_t* hi;
  const uint8_t* e;
  const int64_t* m;
  int64_t k;
  __device__ __forceinline__ uint64_t operator()(int64_t row, int64_t t) const {
    const int64_t at = row * k + t;
    return static_cast<uint64_t>(static_cast<uint32_t>(__ldg(lo + at))) +
           16ull * static_cast<uint32_t>(__ldg(hi + at));
  }
  __device__ __forceinline__ uint8_t err(int64_t row, int64_t t) const { return __ldg(e + row * k + t); }
  __device__ __forceinline__ uint64_t msg(int64_t row) const {
    return static_cast<uint64_t>(__ldg(m + row));
  }
};

template <class Load>
__global__ void __launch_bounds__(kRowsPerBlock)
carry_fold_kernel(Load load, int64_t rows, int64_t k, int64_t ndigits, uint8_t* __restrict__ out) {
  __shared__ uint64_t xs[kWarps][32][kPad];
  __shared__ uint8_t ds[kWarps][32][kOutPad];  // the error bytes in, the digits out
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + 32 * warp;
  if (row0 >= rows) return;  // a whole warp past the last row
  const int nr = static_cast<int>(rows - row0 < 32 ? rows - row0 : 32);
  const int64_t kr = k < ndigits ? k : ndigits;  // positions that reach a digit
  uint64_t carry = 0;
  const uint64_t msg = load.msg(row0 + (lane < nr ? lane : nr - 1));  // the lane's row's
  uint32_t e1 = 0, e2 = 0, e3 = 0;  // the error bytes at t - 1, t - 2, t - 3
  for (int64_t c0 = 0; c0 < ndigits; c0 += kChunk) {
    const int cw = static_cast<int>(ndigits - c0 < kChunk ? ndigits - c0 : kChunk);
    const int64_t t = c0 + lane;
    const int64_t tc = t < kr ? t : kr - 1;  // a position that exists; dropped past kr
    // kBatch rows' loads, unconditional (rows past the last read the last
    // one's, positions past kr read one that exists), so all are in flight
    // before their values are selected and staged
    for (int b = 0; b < 32; b += kBatch) {
      uint64_t x[kBatch];
      uint8_t ev[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t row = row0 + (b + u < nr ? b + u : nr - 1);
        x[u] = load(row, tc);
        ev[u] = load.err(row, tc);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = b + u < nr && t < kr;
        xs[warp][b + u][lane] = in ? x[u] : 0ull;
        if (Load::kErrors) ds[warp][b + u][lane] = in ? ev[u] : 0;
      }
    }
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < cw; ++j) {
      uint64_t x = xs[warp][lane][j] + carry;
      if (Load::kErrors) {  // + p * e (p = 2^32 - 5: bytes FB FF FF FF) + m's byte
        const uint32_t e0 = ds[warp][lane][j];
        x += (kP & 255u) * e0 + 255ull * (e1 + e2 + e3);
        x += c0 + j < 4 ? (msg >> (8 * (j & 3))) & 255u : 0ull;
        e3 = e2, e2 = e1, e1 = e0;
      }
      ds[warp][lane][j] = static_cast<uint8_t>(x & 255u);
      carry = x >> 8;
    }
    __syncwarp();
    if (lane < cw) {
#pragma unroll 8
      for (int r = 0; r < nr; ++r) out[(row0 + r) * ndigits + t] = ds[warp][r][lane];
    }
    __syncwarp();
  }
}

int grid_for(int64_t rows) {
  return static_cast<int>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// x: int64 (is32 == 0) or int32 (is32 != 0) [rows, k], non-negative;
// out: uint8 [rows, ndigits].  rows, k, ndigits > 0.
extern "C" int cls_carry_fold(const void* x, uint32_t is32, int64_t rows, int64_t k,
                              int64_t ndigits, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is32)
    carry_fold_kernel<<<grid_for(rows), kRowsPerBlock, 0, st>>>(
        Planes<int32_t>{static_cast<const int32_t*>(x), k}, rows, k, ndigits, o);
  else
    carry_fold_kernel<<<grid_for(rows), kRowsPerBlock, 0, st>>>(
        Planes<int64_t>{static_cast<const int64_t*>(x), k}, rows, k, ndigits, o);
  return static_cast<int>(cudaGetLastError());
}

// lo, hi: int32 [rows, k] (non-negative), e: uint8 [rows, k], m: int64
// [rows] (< 2^32); out: uint8 [rows, k].  rows, k > 0.
extern "C" int cls_carry_fold_b_rows(const void* lo, const void* hi, const void* e, const void* m,
                                     int64_t rows, int64_t k, void* out, void* stream) {
  const BRow load{static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
                  static_cast<const uint8_t*>(e), static_cast<const int64_t*>(m), k};
  carry_fold_kernel<<<grid_for(rows), kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      load, rows, k, k, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
