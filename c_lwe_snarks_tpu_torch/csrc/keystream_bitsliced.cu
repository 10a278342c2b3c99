// K5 keystream_blocks_v1: the raw AES-256-CTR keystream from a bitsliced,
// table-free register cipher.
//
// Replaces c_lwe_snarks_tpu/ops/aes_pallas.py:_kernel (wrapper
// keystream_blocks(version != 2)): counter bit planes, 14 rounds of the
// 115-gate Boyar-Peralta S-box with the affine constant 0x63 folded into
// round keys 1..14, ShiftRows, MixColumns on planes, and a transpose back
// to bytes.  It shares nothing with the T-table core of aes_core_cf.cuh but
// the host key schedule.
//
// Layout chosen for this card, not the TPU's [16, W] sublane planes: a
// group of 32 consecutive counters is held by a quad of lanes, and lane c
// of the quad holds column c of the state (bytes 4c..4c+3, LE word c of
// the block) as 32 bit planes of one uint32 each: plane 8r + k is bit k
// (LSB first) of row r of the column, bit b of a plane belongs to block b
// of the group.  Every plane index is static, so the state stays in
// registers with the round loop rolled.
//   - The planes start from two words a lane (initial_planes): lanes 0 and 1
//     hold the nonce, lanes 2 and 3 the low and high counter words, built
//     from the group's base by funnel shifts, no transpose.
//   - SubBytes: sbox_bp_gates.cuh, the gate list as 80 three-input lookup
//     tables (one LOP3 each), on each of the lane's 4 bytes.
//   - ShiftRows: 24 shuffles inside the quad (row r of lane c comes from
//     lane (c + r) & 3).
//   - MixColumns mixes inside a column, so it is the lane's own planes: two
//     three-input XORs an output plane, the round key's 0 / ~0 mask among
//     the inputs.  The masks sit in shared memory as [round][q][c][4]: lane c
//     reads its 32 with 8 16-byte loads, the 4 lanes of a quad on 16 banks,
//     the 8 quads of a warp on the same words (a broadcast).
//   - After the rounds each lane transposes its planes into word c of its 32
//     blocks and writes them to its warp's 4 KiB staging buffer, block R at
//     row R ^ (R >> 5 & 7), so the 32 lanes of a store hit 32 banks; then each
//     lane reads one 16-byte row and a warp store writes 512 contiguous bytes.
//     Only the ragged tail of the stream is masked.
// A warp's tile is 8 groups, 256 blocks.  The grid-stride loop runs over
// tiles, so its condition is the same for the 32 lanes and every lane
// reaches every shuffle; a quad past the last group computes and stores
// nothing.  The 64-bit counter wraps modulo 2^64, as the wrapper allows.
//
// Bound on the H100: the two-input gates this layout needs, two to a LOP3,
// against 132 SMs * 64 INT32 lanes (chip_smoke.py:BITSLICED_OPS, 550.25
// operations a block); the 16 bytes written per block would allow 200 G
// blocks/s at 3.35 TB/s, so the kernel is bound by operations, not bytes.
// Its SASS (tools/k5_sass.py) holds 778 logic operations a block: 560 the
// S-box's tables, 156 MixColumns with its round key, 62 the first and last
// round keys, the counter planes, one transpose a lane and the staging.
// Beside them, 42 shuffles and 20 shared-memory accesses a block (other
// pipes, but dispatch slots).  Known costs of this layout: the S-box at 1.44
// gates a LOP3, where the two gates a LOP3 of the bound would need another
// circuit; a scan tile's 8,453 tiles are 4.002 passes of the 2,112 resident
// warps, so a few warps finish alone.
#include <cstdint>
#include <cuda_runtime.h>

#include "sbox_bp_gates.cuh"

namespace {

constexpr int kLanes = 4;                          // lanes a group of 32 counters
constexpr int kGroupsPerWarp = 32 / kLanes;        // a warp tile: 8 groups, 256 blocks
constexpr int kTileBlocks = 32 * kGroupsPerWarp;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;                      // 128 registers a thread at most
constexpr int64_t kMaxGrid = 132 * kMinBlocks;
constexpr int kRkWords = 15 * 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One stage of the SWAR transpose: swap the high-column bits of row t with
// the low-column bits of row t + J inside every 2J-row band.  For J = 16
// and 8 the swap moves whole bytes, one byte permute a row.
template <int J, uint32_t M>
__device__ __forceinline__ void swap_stage(uint32_t* a) {
#pragma unroll
  for (int band = 0; band < 32; band += 2 * J) {
#pragma unroll
    for (int t = 0; t < J; ++t) {
      const uint32_t lo = a[band + t];
      const uint32_t hi = a[band + J + t];
      if constexpr (J == 16) {
        a[band + t] = __byte_perm(lo, hi, 0x5410);
        a[band + J + t] = __byte_perm(lo, hi, 0x7632);
      } else if constexpr (J == 8) {
        a[band + t] = __byte_perm(lo, hi, 0x6240);
        a[band + J + t] = __byte_perm(lo, hi, 0x7351);
      } else {
        a[band + t] = (lo & ~(M << J)) | ((hi << J) & (M << J));
        a[band + J + t] = (hi & ~M) | ((lo >> J) & M);
      }
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

// The planes of this lane's column before round 0: lanes 0 and 1 the nonce
// (the same in every block), lanes 2 and 3 the low or high words of the
// counters base + b.  With off = base & 31, blocks b < 32 - off share bits
// 5..63 with base0 = base - off and the others with base0 + 32, so plane j
// is a funnel of two constant planes; bits 0..4 of the low word are those
// of off + b, the pattern of bit j over 0..31 rotated by off.
__device__ __forceinline__ void initial_planes(uint32_t* s, int c, uint32_t nonce_lo,
                                               uint32_t nonce_hi, uint64_t base) {
  constexpr uint32_t kPattern[5] = {0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u, 0xFF00FF00u, 0xFFFF0000u};
  const uint32_t off = static_cast<uint32_t>(base) & 31u;
  const uint64_t base0 = base - off;
  const uint64_t base1 = base0 + 32;
  const uint32_t w0 = c == 0 ? nonce_lo : c == 1 ? nonce_hi
                    : static_cast<uint32_t>(c == 2 ? base0 : base0 >> 32);
  const uint32_t w1 = c == 0 ? nonce_lo : c == 1 ? nonce_hi
                    : static_cast<uint32_t>(c == 2 ? base1 : base1 >> 32);
  const uint32_t low = c == 2 ? ~0u : 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t m0 = static_cast<uint32_t>(static_cast<int32_t>(w0 << (31 - j)) >> 31);
    const uint32_t m1 = static_cast<uint32_t>(static_cast<int32_t>(w1 << (31 - j)) >> 31);
    s[j] = __funnelshift_r(m0, m1, off);
    if (j < 5) s[j] |= low & __funnelshift_r(kPattern[j], kPattern[j], off);
  }
}

// The 32 masks of lane c in round rnd: planes 4q..4q+3 of its column.
__device__ __forceinline__ void round_key(const uint4* rk, int rnd, int c, uint32_t* m) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 v = rk[32 * rnd + 4 * q + c];
    m[4 * q] = v.x;
    m[4 * q + 1] = v.y;
    m[4 * q + 2] = v.z;
    m[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void add_round_key(uint32_t* s, const uint32_t* m) {
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] ^= m[j];
}

__device__ __forceinline__ void sub_bytes(uint32_t* s) {
#pragma unroll
  for (int r = 0; r < 4; ++r) cls::sbox_bp(s + 8 * r);
}

// new[r][c] = old[r][(c + r) % 4]: row r of this lane from lane (c + r) & 3.
__device__ __forceinline__ void shift_rows(uint32_t* s, int c) {
#pragma unroll
  for (int r = 1; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s[8 * r + k] = __shfl_sync(kFull, s[8 * r + k], (c + r) & 3, kLanes);
  }
}

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  return cls::lop3<0x96>(a, b, c);
}

// The lane's column, then its round key: new_r = a_r ^ t ^ xtime(a_r ^ a_{r+1})
// with t = a_0 ^ a_1 ^ a_2 ^ a_3, written as a_{r+1} ^ u_{r+2} ^ xtime(u_r)
// where u_r = a_r ^ a_{r+1}: two three-input XORs an output plane.
__device__ __forceinline__ void mix_columns_add_round_key(uint32_t* s, const uint32_t* m) {
  uint32_t u[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 8; ++k) u[r][k] = s[8 * r + k] ^ s[8 * ((r + 1) & 3) + k];
  }
  uint32_t o[32];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t* a = s + 8 * ((r + 1) & 3);
    const uint32_t* v = u[(r + 2) & 3];
    const uint32_t* x = u[r];
    const uint32_t* rk = m + 8 * r;
    // xtime(x) = (x << 1) ^ (x7 ? 0x1B : 0): bits 0, 1, 3, 4 take x7
    o[8 * r + 0] = xor3(xor3(a[0], v[0], x[7]), rk[0], 0u);
    o[8 * r + 1] = xor3(xor3(a[1], v[1], x[0]), x[7], rk[1]);
    o[8 * r + 2] = xor3(xor3(a[2], v[2], x[1]), rk[2], 0u);
    o[8 * r + 3] = xor3(xor3(a[3], v[3], x[2]), x[7], rk[3]);
    o[8 * r + 4] = xor3(xor3(a[4], v[4], x[3]), x[7], rk[4]);
    o[8 * r + 5] = xor3(xor3(a[5], v[5], x[4]), rk[5], 0u);
    o[8 * r + 6] = xor3(xor3(a[6], v[6], x[5]), rk[6], 0u);
    o[8 * r + 7] = xor3(xor3(a[7], v[7], x[6]), rk[7], 0u);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = o[j];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
keystream_blocks_v1_kernel(const uint32_t* __restrict__ rk_planes, uint32_t nonce_lo,
                           uint32_t nonce_hi, uint64_t start, int64_t nblocks,
                           uint4* __restrict__ out) {
  __shared__ __align__(16) uint32_t rk_smem[kRkWords];
  __shared__ uint4 stage[kWarps][kTileBlocks];
  // plane p = 32c + 4q + t of round rnd (p = 8 * byte + bit) at [rnd][q][c][t]
  for (int i = threadIdx.x; i < kRkWords; i += kThreads) {
    const int p = i & 127;
    rk_smem[(i & ~127) | ((p & 31) >> 2) << 4 | (p >> 5) << 2 | (p & 3)] = rk_planes[i];
  }
  __syncthreads();
  const uint4* rk = reinterpret_cast<const uint4*>(rk_smem);

  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int quad = lane >> 2;
  uint4* buf = stage[threadIdx.x >> 5];
  uint32_t* buf32 = reinterpret_cast<uint32_t*>(buf);
  const int64_t ntiles = (nblocks + kTileBlocks - 1) / kTileBlocks;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); tile < ntiles;
       tile += nwarps) {
    const int64_t first = tile * kTileBlocks;
    uint32_t s[32];
    initial_planes(s, c, nonce_lo, nonce_hi, start + static_cast<uint64_t>(first + 32 * quad));

    uint32_t m[32];
    round_key(rk, 0, c, m);
    add_round_key(s, m);
#pragma unroll 1
    for (int rnd = 1; rnd < 14; ++rnd) {
      sub_bytes(s);
      shift_rows(s, c);
      round_key(rk, rnd, c, m);
      mix_columns_add_round_key(s, m);
    }
    sub_bytes(s);
    shift_rows(s, c);
    round_key(rk, 14, c, m);
    add_round_key(s, m);

    transpose32(s);
    // s[b] = LE word c of block 32 * quad + b of the tile; row R of the
    // staging buffer lives at row R ^ (R >> 5 & 7), R = 32 * quad + 8h + l
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      uint32_t* row = buf32 + 4 * (32 * quad + (l ^ quad)) + c;
#pragma unroll
      for (int h = 0; h < 4; ++h) row[32 * h] = s[8 * h + l];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 v = buf[32 * i + (lane ^ i)];
      const int64_t blk = first + 32 * i + lane;
      if (blk < nblocks) out[blk] = v;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int cls_keystream_blocks_v1(const void* rk_planes, uint32_t nonce_lo, uint32_t nonce_hi,
                                       uint64_t start, int64_t nblocks, void* out, void* stream) {
  const int64_t ntiles = (nblocks + kTileBlocks - 1) / kTileBlocks;
  int64_t grid = (ntiles + kWarps - 1) / kWarps;
  if (grid > kMaxGrid) grid = kMaxGrid;
  if (grid < 1) grid = 1;
  keystream_blocks_v1_kernel<<<static_cast<int>(grid), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rk_planes), nonce_lo, nonce_hi, start, nblocks,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
