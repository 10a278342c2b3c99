// K5 keystream_blocks_v1: the raw AES-256-CTR keystream from a bitsliced,
// table-free register cipher.
//
// Replaces c_lwe_snarks_tpu/ops/aes_pallas.py:_kernel (wrapper
// keystream_blocks(version != 2)): counter bit planes by a 32x32 bit
// transpose, 14 rounds of the 115-gate Boyar-Peralta S-box with the affine
// constant 0x63 folded into round keys 1..14, ShiftRows, MixColumns on
// planes, and a transpose back to bytes.  It shares nothing with the
// T-table core of aes_core.cuh but the host key schedule.
//
// Layout chosen for this card, not the TPU's [16, W] sublane planes: one
// thread owns one group of 32 consecutive counters and keeps the whole
// state, 128 bit planes of one uint32 each, in registers.  Plane 8 * i + k
// holds bit k (LSB first) of state byte i (FIPS input order, i = r + 4c);
// bit b of a plane belongs to block b of the group.  SubBytes is the
// generated gate list (sbox_bp_gates.cuh) on the 8 planes of each byte,
// ShiftRows moves planes between registers, MixColumns is XORs of planes
// (xtime on planes is a renaming plus three XORs), AddRoundKey XORs 0 / ~0
// masks read from shared memory (15 x 128 words, every thread the same
// address, so the loads broadcast).  The round loop is not unrolled: two
// round bodies keep the code small and every plane index static.  The
// 64-bit counter is start + 32 * group + b in a uint64_t, so the hi-word
// carry needs no mask logic; the last, ragged group masks its stores.
//
// Bound on the H100: about 1,170 32-bit logic operations per 16-byte block
// before LOP3 fusing (S-box 115 * 16 * 14 / 32 = 805, MixColumns 214,
// AddRoundKey 60, six transposes 90) against 132 SMs * 64 INT32 lanes; the
// 16 bytes written per block would allow 200 G blocks/s at 3.35 TB/s, so
// the kernel is bound by operations, not bytes.  Known costs of this
// simple form, left for later work: ~128 live planes plus S-box and
// MixColumns temporaries sit near the 255-register limit (occupancy 2
// warps per scheduler at best), a short stream gives few threads (one per
// 512 bytes), and each thread stores its 32 blocks 512 bytes apart from
// its neighbour's, so one store of a warp touches 32 sectors.
#include <cstdint>
#include <cuda_runtime.h>

#include "sbox_bp_gates.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int64_t kMaxGrid = 132 * 64;
constexpr int kRkWords = 15 * 128;

// One stage of the SWAR transpose: swap the high-column bits of row t with
// the low-column bits of row t + J inside every 2J-row band.
template <int J, uint32_t M>
__device__ __forceinline__ void swap_stage(uint32_t* a) {
#pragma unroll
  for (int band = 0; band < 32; band += 2 * J) {
#pragma unroll
    for (int t = 0; t < J; ++t) {
      const uint32_t lo = a[band + t];
      const uint32_t hi = a[band + J + t];
      const uint32_t x = ((lo >> J) ^ hi) & M;
      a[band + t] = lo ^ (x << J);
      a[band + J + t] = hi ^ x;
    }
  }
}

// In-place transpose of the 32x32 bit matrix a[32] (bit j of a[i] = M[i][j]).
__device__ __forceinline__ void transpose32(uint32_t* a) {
  swap_stage<16, 0x0000FFFFu>(a);
  swap_stage<8, 0x00FF00FFu>(a);
  swap_stage<4, 0x0F0F0F0Fu>(a);
  swap_stage<2, 0x33333333u>(a);
  swap_stage<1, 0x55555555u>(a);
}

__device__ __forceinline__ void add_round_key(uint32_t* s, const uint32_t* rk) {
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] ^= rk[i];
}

__device__ __forceinline__ void sub_bytes(uint32_t* s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) cls::sbox_bp(s + 8 * i);
}

// new[r][c] = old[r][(c + r) % 4] with byte index i = r + 4c.
__device__ __forceinline__ void shift_rows(uint32_t* s) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t t = s[8 * 1 + k];  // row 1: rotate left by one column
    s[8 * 1 + k] = s[8 * 5 + k];
    s[8 * 5 + k] = s[8 * 9 + k];
    s[8 * 9 + k] = s[8 * 13 + k];
    s[8 * 13 + k] = t;
    t = s[8 * 2 + k];  // row 2: swap columns 0 <-> 2 and 1 <-> 3
    s[8 * 2 + k] = s[8 * 10 + k];
    s[8 * 10 + k] = t;
    t = s[8 * 6 + k];
    s[8 * 6 + k] = s[8 * 14 + k];
    s[8 * 14 + k] = t;
    t = s[8 * 15 + k];  // row 3: rotate right by one column
    s[8 * 15 + k] = s[8 * 11 + k];
    s[8 * 11 + k] = s[8 * 7 + k];
    s[8 * 7 + k] = s[8 * 3 + k];
    s[8 * 3 + k] = t;
  }
}

// Per column: new_r = a_r ^ t ^ xtime(a_r ^ a_{r+1}), t = a_0 ^ a_1 ^ a_2 ^ a_3.
__device__ __forceinline__ void mix_columns(uint32_t* s) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t a[4][8];
    uint32_t t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r][k] = s[8 * (r + 4 * c) + k];
      t[k] = a[0][k] ^ a[1][k] ^ a[2][k] ^ a[3][k];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = a[r][k] ^ a[(r + 1) & 3][k];
      // xtime(u) = (u << 1) ^ (u7 ? 0x1B : 0): bits 0, 1, 3, 4 take u7
      uint32_t* o = s + 8 * (r + 4 * c);
      o[0] = a[r][0] ^ t[0] ^ u[7];
      o[1] = a[r][1] ^ t[1] ^ u[0] ^ u[7];
      o[2] = a[r][2] ^ t[2] ^ u[1];
      o[3] = a[r][3] ^ t[3] ^ u[2] ^ u[7];
      o[4] = a[r][4] ^ t[4] ^ u[3] ^ u[7];
      o[5] = a[r][5] ^ t[5] ^ u[4];
      o[6] = a[r][6] ^ t[6] ^ u[5];
      o[7] = a[r][7] ^ t[7] ^ u[6];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
keystream_blocks_v1_kernel(const uint32_t* __restrict__ rk_planes, uint32_t nonce_lo,
                           uint32_t nonce_hi, uint64_t start, int64_t nblocks,
                           uint4* __restrict__ out) {
  __shared__ uint32_t rk[kRkWords];
  for (int i = threadIdx.x; i < kRkWords; i += blockDim.x) rk[i] = rk_planes[i];
  __syncthreads();

  const int64_t ngroups = (nblocks + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < ngroups;
       g += stride) {
    uint32_t s[128];
    // bytes 0..7: the nonce, the same in every block, so constant planes
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = 0u - ((nonce_lo >> j) & 1u);
      s[32 + j] = 0u - ((nonce_hi >> j) & 1u);
    }
    // bytes 8..15: the 64-bit LE counter of block b, transposed into planes
    const uint64_t base = start + 32ull * static_cast<uint64_t>(g);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint64_t ctr = base + static_cast<uint64_t>(b);
      s[64 + b] = static_cast<uint32_t>(ctr);
      s[96 + b] = static_cast<uint32_t>(ctr >> 32);
    }
    transpose32(s + 64);
    transpose32(s + 96);

    add_round_key(s, rk);
#pragma unroll 1
    for (int r = 1; r < 14; ++r) {
      sub_bytes(s);
      shift_rows(s);
      mix_columns(s);
      add_round_key(s, rk + 128 * r);
    }
    sub_bytes(s);
    shift_rows(s);
    add_round_key(s, rk + 128 * 14);

    // planes 32w .. 32w + 31 are the bits of LE word w; transposed, row b
    // is word w of block b
#pragma unroll
    for (int w = 0; w < 4; ++w) transpose32(s + 32 * w);
    const int64_t first = 32 * g;
    const int64_t left = nblocks - first;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (b < left) out[first + b] = make_uint4(s[b], s[32 + b], s[64 + b], s[96 + b]);
    }
  }
}

}  // namespace

extern "C" int cls_keystream_blocks_v1(const void* rk_planes, uint32_t nonce_lo, uint32_t nonce_hi,
                                       uint64_t start, int64_t nblocks, void* out, void* stream) {
  const int64_t ngroups = (nblocks + 31) / 32;
  int64_t grid = (ngroups + kThreads - 1) / kThreads;
  if (grid > kMaxGrid) grid = kMaxGrid;
  if (grid < 1) grid = 1;
  keystream_blocks_v1_kernel<<<static_cast<int>(grid), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rk_planes), nonce_lo, nonce_hi, start, nblocks,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
