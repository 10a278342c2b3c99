// K3 eval_mac_planes and K4 encrypt_b_fused: the keystream regenerated
// and contracted inside one kernel, so the a-vectors of the CRS
// ciphertexts never reach device memory.
//
// Ciphertext i of a section owns stream bytes [off + i*92n, off + (i+1)*92n):
// n draws of 92 bytes, whose low 88 bytes are the mod-2^704 digits of one
// a-vector coordinate (the top 4 are dead).  Both kernels regenerate any
// byte range from its counter (CTR mode), at any byte alignment, with the
// conflict-free T-table core of aes_core_cf.cuh, write the keystream tile
// to shared memory and contract it there on the tensor cores with
// mma.sync.m16n8k32 on unsigned bytes (s32 += u8 * u8): both operands are
// unsigned, so none of the TPU kernels' int8 recentring is needed.
//
// K3 replaces c_lwe_snarks_tpu/ops/eval_fused.py:_mac_kernel (AES tile
// _aes_pair_tile): out[c, k, coord, digit] = sum_i byte_c(coeff_k[i]) *
// a_i[coord, digit].  As a matrix product the contraction index is the
// ciphertext row i, but the cipher emits bytes along a row, and an 8-bit
// MMA operand wants 4 consecutive contraction indices in one register.  So
// a thread encrypts the same 16-byte block column of 4 rows (rows 4 apart:
// 4 * 92n is a multiple of 16, so the four share their byte skip),
// transposes the 4 x 4 bytes of each word with 8 PRMTs and stores one word
// per byte column into a [column][row] tile.  The row order inside a group
// of 16 rows is thereby permuted (position 4 * (row % 4) + row / 4 % 4);
// the coefficient bytes are laid out [plane][row] with the same
// permutation.  A block owns 496 byte columns (32 AES blocks cover them at
// any skip) and loops over a segment of rows in tiles of 128, each warp
// keeping its 32 columns x 8 * NT planes of sums in registers; the sums go
// into the int64 output once at the end (atomics merge the segments).
// Signed 32-bit sums stay exact for 32768 rows: 32768 * 255^2 < 2^31.
// Bound: the cipher (224 shared-memory loads and ~450 integer operations a
// 16-byte block, both near their pipe's rate); the MMA phase is a few per
// cent, for any k.
//
// K3's many-lane form (cls_eval_mac_lanes, more than 8 lanes, one sweep for
// several proofs): a block's sums are its byte columns x its planes, in
// registers, so more lanes mean fewer columns a block.  A warp keeps one row
// tile of 16 columns x 80 planes (20 lanes, 40 sums a thread), a block 240
// columns (16 AES blocks a row: 6.7 % of the cipher's bytes fall outside the
// columns, against 3.2 % at 496), in tiles of 256 rows so that a thread still
// encrypts 8 blocks between two barriers (a lane's second 4 rows 128 rows on,
// word 32 + L of a column); a tile's coefficient words are loaded before its
// cipher phase and stored behind it, which hides their latency.  Block row y
// sweeps segment y of a table passed as a kernel parameter: its rows and the
// window of at most 20 lanes it reads.  So a lane that is zero over a
// segment's rows costs nothing there (the prover's batch of B: 2B of its 5B
// lanes over s and over as, B over bt and bv), and plane tiles past a
// window's lanes are skipped.  The kernel keeps K3's name
// (lanes::eval_mac_kernel), and both forms run one sweep body.
//
// K4 replaces ops/eval_fused.py:_enc_kernel (helpers _sk_band_blocks):
// <sk, a_i> mod 2^704 for sequential ciphertexts, as the matrix product
// v_nib[ct, t] = sum_q a[ct, q] * Band_nib[q, t] over a ciphertext's 92n
// stream bytes q = 92j + k, with Band_nib[92j + k, t] = nib(sk[j, t - k])
// (zero for the 4 dead bytes and for t < k).  The band is Toeplitz: with
// the nibble row reversed and zero-padded, r_j[x] = nib(sk[j, 87 - x]) for
// x < 88 and 0 up to x = 183, Band[92j + k, t] = r_j[87 - t + k], so a B
// fragment register (4 consecutive k of one column t) is 4 consecutive
// bytes of r_j, and the dead bytes fall into the zeros by themselves.
// Those reads are unaligned by (87 - t) mod 4, so shared memory holds the
// four byte-shifted copies of r_j.  The keystream is the A operand as the
// cipher writes it (row = ciphertext, contraction index = stream byte,
// contiguous); each AES block is stored with one 16-byte store at its own
// position and a row's byte skip is added when the A fragments are read.
// A block takes 128 ciphertexts x a range of draws in tiles of 8 draws
// (736 bytes), 16 warps = 8 row tiles of 16 ciphertexts x 2 nibbles, 44
// sums a thread.  A draw is contracted as three chunks of 32 bytes at
// digits 0, 32 and 64 (the third runs into the band row's zero padding):
// column tiles left of a chunk's first digit are all zero and are skipped,
// 21 MMAs a draw and warp.  The draws are split over gridDim.y to fill the
// card evenly, and the signed sums (at most n * 88 * 255 * 15 < 2^31, the
// wrapper's guard) are merged with atomics.  The table's window and the
// tile take the whole shared memory of an SM, so one block runs there and
// its cipher and MMA phases do not overlap: on an H100 the cipher phase is
// four fifths of the time and the MMA phase, which runs at the rate of
// mma.sync on 8-bit operands, the rest.
#include "aes_core_cf.cuh"
#include "mma_u8.cuh"

using namespace cls;

namespace {

// ---- K3 ------------------------------------------------------------------
constexpr int kMacThreads = 512;     // one block an SM (its shared memory), 16 warps
constexpr int kMacWarps = kMacThreads / 32;
constexpr int kMacCols = 496;        // byte columns a block owns
constexpr int kMacColsPad = 512;     // columns of the tile: 32 MMA row tiles of 16
constexpr int kMacAesBlocks = 32;    // cover 496 bytes at any skip (15 + 496 <= 512)
constexpr int kMacRows = 128;        // ciphertext rows per tile: 4 chunks of 32
constexpr int kMacColStride = 36;    // words per tile column (32 + 4: conflict-free fragments)
constexpr int kMacPlanes = 32;       // coefficient-byte planes of the B tile (4k <= 32)
constexpr int64_t kMacMaxSegment = 32768;  // rows per segment: 32768 * 255^2 < 2^31
constexpr int kMacBeforeTable = kMacPlanes * kMacColStride * 4;  // the coefficient bytes
constexpr int kMacTileBytes = kMacColsPad * kMacColStride * 4;  // behind the table
// the many-lane form
constexpr int kWideTiles = 10;       // plane tiles of 8
constexpr int kWideLanes = 20;       // lanes a segment: 4 planes each
constexpr int kWideCols = 240;       // byte columns a block owns
constexpr int kWideColsPad = 256;    // columns of the tile: 16 MMA row tiles of 16
constexpr int kWideRows = 256;       // rows a tile: 8 AES blocks a thread a tile, as at 496 columns
constexpr int kWideStride = kWideRows / 4 + 4;  // words a tile column (conflict-free fragments)
constexpr int kWideBeforeTable = 8 * kWideTiles * kWideStride * 4;
constexpr int kWideTileBytes = kWideColsPad * kWideStride * 4;
constexpr int kWideMaxSegments = 128;  // a launch's segment table, a kernel parameter
static_assert(4 * kWideLanes == 8 * kWideTiles, "a window's planes fill the plane tiles");

// Block row y of a many-lane launch sweeps rows [row_begin[y], row_end[y])
// with lanes [lane0[y], lane0[y] + lanes[y]).
struct MacSegments {
  int32_t row_begin[kWideMaxSegments];
  int32_t row_end[kWideMaxSegments];
  int32_t lane0[kWideMaxSegments];
  int32_t lanes[kWideMaxSegments];
};

// One block's sweep: rows [r_begin, r_end) of the kw lanes from lane0 over its
// byte columns, added into out's planes of those lanes.  NT: tiles of 8
// coefficient-byte planes; MT: MMA row tiles of 16 columns a warp.  WIDE:
// kw and lane0 are the segment's, and plane tiles past 4 kw planes are skipped.
template <int NT, int MT, bool WIDE>
__device__ __forceinline__ void mac_sweep(uint32_t* smem, const uint32_t* __restrict__ tables,
                                          const RoundKeys& rk, uint32_t nonce_lo,
                                          uint32_t nonce_hi, uint64_t offset,
                                          const uint32_t* __restrict__ coeffs, int k, int64_t d,
                                          int64_t n, int64_t r_begin, int64_t r_end, int lane0,
                                          int kw, unsigned long long* __restrict__ out) {
  constexpr int kColsPad = 16 * MT * kMacWarps;
  constexpr int kCols = kColsPad - 16;  // kColsPad / 16 AES blocks cover them at any skip
  constexpr int kAesBlocks = kColsPad / 16;
  constexpr int kPlanes = 8 * NT > kMacPlanes ? 8 * NT : kMacPlanes;
  constexpr int RT = WIDE ? kWideRows / kMacRows : 1;  // row groups of 128 a tile
  constexpr int kRows = kMacRows * RT;                 // rows a tile
  constexpr int kStride = 32 * RT + 4;                 // words a tile column
  static_assert(kStride == (WIDE ? kWideStride : kMacColStride), "the layout the launcher sizes");
  uint8_t* window = cf_window(smem, kPlanes * kStride * 4);
  uint32_t* cfb = smem;                                                  // [plane][words of rows]
  uint32_t* tile = reinterpret_cast<uint32_t*>(window + kCfAfterTable);  // [column][words of rows]
  cf_load_table(window, tables);
  for (int i = threadIdx.x; i < kPlanes * kStride; i += kMacThreads) cfb[i] = 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const uint32_t lane_base = cf_lane_base();
  const uint64_t ctr_ct = 92ull * static_cast<uint64_t>(n);
  const uint64_t c0 = static_cast<uint64_t>(blockIdx.x) * kCols;
  const int live = WIDE ? (4 * kw + 7) / 8 : NT;  // plane tiles that hold a lane's bytes
  const uint32_t* cw_lanes = coeffs + static_cast<int64_t>(lane0) * d;
  constexpr int kPre = WIDE ? kRows * kWideLanes / kMacThreads : 1;  // words a thread a tile
  static_assert(!WIDE || kRows * kWideLanes % kMacThreads == 0, "whole words a thread");
  const int pre_row = threadIdx.x % kRows;

  int32_t acc[MT][NT][4];  // [row tile of 16 columns][plane tile][fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += kRows) {
    const int rows = static_cast<int>(min64(kRows, r_end - r0));
    __syncthreads();  // table loaded / previous tile consumed
    // coefficient bytes, [plane c * kw + kk][permuted row].  The many-lane form
    // loads its words (row threadIdx.x % 256, lanes threadIdx.x / 256 + 2u) here
    // and stores them behind the cipher phase, whose work hides the loads.
    uint8_t* cb = reinterpret_cast<uint8_t*>(cfb);
    uint32_t pre[kPre];
    if constexpr (WIDE) {
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int kk = threadIdx.x / kRows + u * (kMacThreads / kRows);
        pre[u] = kk < kw && pre_row < rows ? cw_lanes[kk * d + r0 + pre_row] : 0u;
      }
    } else {
      for (int i = threadIdx.x; i < kRows * kw; i += kMacThreads) {
        const int rr = i % kRows, kk = i / kRows;
        const uint32_t cw = rr < rows ? cw_lanes[kk * d + r0 + rr] : 0u;
        const int pos = (rr & ~15) | ((rr & 3) << 2) | ((rr >> 2) & 3);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cb[(c * kw + kk) * (4 * kStride) + pos] = static_cast<uint8_t>(cw >> (8 * c));
      }
    }
    // keystream: lane L takes rows 128 h + 16 * (L / 4) + L % 4 + {0, 4, 8, 12},
    // which are word 32 h + L of every tile column; warps take the AES block
    // columns.  Rows 128 apart share their byte skip (128 * 92n is a multiple of 16).
#pragma unroll
    for (int h = 0; h < RT; ++h) {
      const int64_t row0 = r0 + 128 * h + 16 * (lane >> 2) + (lane & 3);
      if (row0 < r_end) {  // else all four rows are past the end (their coefficient bytes are 0)
        const uint64_t first0 = offset + static_cast<uint64_t>(row0) * ctr_ct + c0;
        const int skip = static_cast<int>(first0 & 15);
        for (int b = warp; b < kAesBlocks; b += kMacWarps) {
          uint64_t ctr[4];
          uint4 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ctr[i] = ((first0 + 4ull * i * ctr_ct) >> 4) + b;
          aes256_ctr_cf<4>(lane_base, rk, nonce_lo, nonce_hi, ctr, w);
          const uint32_t wi[4][4] = {{w[0].x, w[1].x, w[2].x, w[3].x},
                                     {w[0].y, w[1].y, w[2].y, w[3].y},
                                     {w[0].z, w[1].z, w[2].z, w[3].z},
                                     {w[0].w, w[1].w, w[2].w, w[3].w}};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // 4 rows x 4 byte columns -> 4 byte columns x 4 rows
            const uint32_t t0 = __byte_perm(wi[i][0], wi[i][1], 0x5140);
            const uint32_t t1 = __byte_perm(wi[i][2], wi[i][3], 0x5140);
            const uint32_t t2 = __byte_perm(wi[i][0], wi[i][1], 0x7362);
            const uint32_t t3 = __byte_perm(wi[i][2], wi[i][3], 0x7362);
            const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                                   __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int col = 16 * b + 4 * i + c - skip;
              if (static_cast<unsigned>(col) < static_cast<unsigned>(kColsPad))
                tile[col * kStride + 32 * h + lane] = o[c];
            }
          }
        }
      }
    }
    if constexpr (WIDE) {
      const int pos = (pre_row & ~15) | ((pre_row & 3) << 2) | ((pre_row >> 2) & 3);
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int kk = threadIdx.x / kRows + u * (kMacThreads / kRows);
        if (kk >= kw) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cb[(c * kw + kk) * (4 * kStride) + pos] = static_cast<uint8_t>(pre[u] >> (8 * c));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kRows / 32; ++kc) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= live) continue;
        bf[nt][0] = cfb[(8 * nt + g) * kStride + 8 * kc + t4];
        bf[nt][1] = cfb[(8 * nt + g) * kStride + 8 * kc + 4 + t4];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* p = tile + (16 * (MT * warp + mt) + g) * kStride + 8 * kc + t4;
        const uint32_t a[4] = {p[0], p[8 * kStride], p[4], p[8 * kStride + 4]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < live) mma_u8(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rel = 16 * (MT * warp + mt) + g + (e >> 1) * 8;
      const uint64_t col = c0 + rel;
      const uint64_t coord = col / 92, digit = col % 92;
      // the tile's padding, past the row, or a dead byte
      if (rel >= kCols || col >= ctr_ct || digit >= 88) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int plane = 8 * nt + 2 * t4 + (e & 1);
        const int32_t v = acc[mt][nt][e];
        if (plane >= 4 * kw || v == 0) continue;
        // plane c * kw + kk of the window is plane c * k + lane0 + kk of out
        const int oplane = WIDE ? plane / kw * k + lane0 + plane % kw : plane;
        atomicAdd(&out[(static_cast<uint64_t>(oplane) * n + coord) * 88 + digit],
                  static_cast<unsigned long long>(v));
      }
    }
}
static_assert(16 * 2 * kMacWarps == kMacColsPad && kMacColsPad - 16 == kMacCols &&
                  kMacColsPad / 16 == kMacAesBlocks,
              "the form of at most 8 lanes: two row tiles a warp");
static_assert(16 * kMacWarps == kWideColsPad && kWideColsPad - 16 == kWideCols,
              "the many-lane form: one row tile a warp");

// NT = ceil(4k / 8): column tiles of 8 coefficient-byte planes.
template <int NT>
__global__ void __launch_bounds__(kMacThreads, 1)
eval_mac_kernel(const uint32_t* __restrict__ tables, const __grid_constant__ RoundKeys rk,
                uint32_t nonce_lo, uint32_t nonce_hi, uint64_t offset,
                const uint32_t* __restrict__ coeffs, int k, int64_t d, int64_t n,
                int64_t seg_rows, unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * seg_rows;
  mac_sweep<NT, 2, false>(smem, tables, rk, nonce_lo, nonce_hi, offset, coeffs, k, d, n, r_begin,
                          min64(d, r_begin + seg_rows), 0, k, out);
}

template <int NT>
int launch_mac(dim3 grid, cudaStream_t stream, const uint32_t* tables, const RoundKeys& rk,
               uint32_t nonce_lo, uint32_t nonce_hi, uint64_t offset, const uint32_t* coeffs,
               int k, int64_t d, int64_t n, int64_t seg_rows, unsigned long long* out) {
  int bytes = 0;
  const cudaError_t err = cf_configure(eval_mac_kernel<NT>, kMacBeforeTable, kMacTileBytes, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  eval_mac_kernel<NT><<<grid, kMacThreads, bytes, stream>>>(
      tables, rk, nonce_lo, nonce_hi, offset, coeffs, k, d, n, seg_rows, out);
  return static_cast<int>(cudaGetLastError());
}

// The many-lane form, under K3's kernel name in a namespace of its own.
namespace lanes {
__global__ void __launch_bounds__(kMacThreads, 1)
eval_mac_kernel(const uint32_t* __restrict__ tables, const __grid_constant__ RoundKeys rk,
                uint32_t nonce_lo, uint32_t nonce_hi, uint64_t offset,
                const uint32_t* __restrict__ coeffs, int k, int64_t d, int64_t n,
                const __grid_constant__ MacSegments seg, unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int y = blockIdx.y;
  mac_sweep<kWideTiles, 1, true>(smem, tables, rk, nonce_lo, nonce_hi, offset, coeffs, k, d, n,
                                 seg.row_begin[y], seg.row_end[y], seg.lane0[y], seg.lanes[y],
                                 out);
}
}  // namespace lanes

// ---- K4 ------------------------------------------------------------------
constexpr int kEncThreads = 512;       // 16 warps: 8 row tiles of 16 ciphertexts x 2 nibbles
constexpr int kEncCts = 128;           // ciphertexts per block
constexpr int kEncDraws = 8;           // draws per tile: 736 bytes, a multiple of 16
constexpr int kEncAesBlocks = 47;      // cover 736 bytes at any skip (15 + 736 <= 752)
constexpr int kEncRowWords = 188;      // 752 bytes a tile row; 28 mod 32: conflict-free fragments
static_assert(kEncAesBlocks * 16 == kEncRowWords * 4, "a tile row holds its AES blocks");
constexpr int kEncBandStride = 184;    // bytes of one draw's reversed nibble row: 88 digits + zeros
constexpr int kEncBandWords = kEncDraws * kEncBandStride / 4;  // 368 words a copy
constexpr int kEncBandCopy = 376;      // a copy's stride in words (24 mod 32: copies on other banks)
constexpr int kEncBeforeTable = 8 * kEncBandCopy * 4;  // the band: 2 nibbles x 4 shifts
// behind the table; one word more: with a sub-word offset the last row's last A
// register is funnel-shifted out of two words, the second past the row (it meets band zeros)
constexpr int kEncTileBytes = kEncCts * kEncRowWords * 4 + 4;
constexpr int64_t kEncTargetBlocks = 16 * 132;  // blocks the draw split aims at

__global__ void __launch_bounds__(kEncThreads, 1)
encrypt_kernel(const uint32_t* __restrict__ tables, const __grid_constant__ RoundKeys rk,
               uint32_t nonce_lo, uint32_t nonce_hi, uint64_t offset,
               const uint8_t* __restrict__ sk, int64_t count, int64_t n, int64_t split_draws,
               int32_t* __restrict__ out_lo, int32_t* __restrict__ out_hi) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint8_t* window = cf_window(smem, kEncBeforeTable);
  uint32_t* band = smem;  // [nibble][byte shift][draw][184 bytes]
  // [ciphertext][752 bytes], AES blocks in place
  uint32_t* tile = reinterpret_cast<uint32_t*>(window + kCfAfterTable);
  cf_load_table(window, tables);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int mg = warp & 7, nib = warp >> 3;
  const uint32_t lane_base = cf_lane_base();
  const uint64_t ctr_ct = 92ull * static_cast<uint64_t>(n);
  const int64_t ct0 = static_cast<int64_t>(blockIdx.x) * kEncCts;
  const int cts = static_cast<int>(min64(kEncCts, count - ct0));
  const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * split_draws;
  const int64_t j_end = min64(n, j_begin + split_draws);
  // every ciphertext and every tile starts a multiple of 4 bytes after the
  // section offset, so the sub-word shift of the A reads is one for all
  const uint32_t sub = static_cast<uint32_t>(offset & 3);

  // byte offsets of this lane's two tile rows, with the row's skip: a tile
  // advances a row's stream by 736 bytes, a multiple of 16, so they hold for all
  uint32_t arow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * mg + g + 8 * h;
    const uint64_t first = offset + static_cast<uint64_t>(ct0 + row) * ctr_ct + 92ull * j_begin;
    arow[h] = row * (4 * kEncRowWords) + (static_cast<uint32_t>(first & 15) - sub);
  }
  // this lane's B column is t = 8 * nt + g: its reads are unaligned by
  // (87 - t) mod 4 = (3 - g) mod 4 and come from that byte-shifted copy
  const int shift = (3 - g) & 3;
  const uint8_t* band_b =
      reinterpret_cast<const uint8_t*>(band + (4 * nib + shift) * kEncBandCopy);
  const int boff = 87 - g - shift;  // a multiple of 4
  const uint8_t* tile_b = reinterpret_cast<const uint8_t*>(tile);

  int32_t acc[11][4];  // [column tile of 8 digits][fragment]
#pragma unroll
  for (int nt = 0; nt < 11; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

  for (int64_t j0 = j_begin; j0 < j_end; j0 += kEncDraws) {
    const int draws = static_cast<int>(min64(kEncDraws, j_end - j0));
    __syncthreads();  // table loaded / previous tile consumed
    // the reversed, zero-padded nibble rows, four byte-shifted copies each:
    // word a of copy s of draw j holds r_j[4a + s .. 4a + s + 3]
    for (int i = threadIdx.x; i < 8 * kEncBandWords; i += kEncThreads) {
      const int a = i % 46, j = (i / 46) % kEncDraws, copy = i / kEncBandWords;
      uint32_t word = 0;
      if (j < draws) {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int x = 4 * a + bb + (copy & 3);
          if (x < 88) {
            const uint32_t v = sk[(j0 + j) * 88 + 87 - x];
            word |= ((copy >> 2) ? v >> 4 : v & 15) << (8 * bb);
          }
        }
      }
      band[copy * kEncBandCopy + j * 46 + a] = word;
    }
    // keystream: every AES block that holds bytes of this tile, stored whole
    const int nblk = (15 + draws * 92 + 15) / 16;  // <= 47
    const int items = cts * nblk;
    for (int i = threadIdx.x; i < items; i += 2 * kEncThreads) {
      uint64_t ctr[2];
      uint4 w[2];
      int at[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int it = i + u * kEncThreads;
        const int row = it < items ? it / nblk : 0, b = it < items ? it % nblk : 0;
        const uint64_t first = offset + static_cast<uint64_t>(ct0 + row) * ctr_ct + 92ull * j0;
        ctr[u] = (first >> 4) + b;
        at[u] = it < items ? row * kEncRowWords + 4 * b : -1;
      }
      aes256_ctr_cf<2>(lane_base, rk, nonce_lo, nonce_hi, ctr, w);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (at[u] >= 0) *reinterpret_cast<uint4*>(tile + at[u]) = w[u];
    }
    __syncthreads();
    // Three chunks of 32 bytes a draw, at digits k0 = 0, 32, 64: the third
    // runs 4 bytes into the next draw, where this draw's band row is zero
    // padding (k = 92..95), and columns t < k0 are all zero, so 11 + 7 + 3
    // column tiles a draw.  Every draw of the tile, also the ones a short
    // last tile lacks (their band is zero): no branch between chunks, so the
    // loads of the next one are issued among the MMAs of this one.
#pragma unroll
    for (int c = 0; c < 3 * kEncDraws; ++c) {
      const int j = c / 3, k0 = 32 * (c % 3), nt0 = k0 / 8;
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
            tile_b + arow[e & 1] + 92 * j + k0 + 16 * (e >> 1) + 4 * t4);
        a[e] = sub ? __funnelshift_r(p[0], p[1], 8 * sub) : p[0];
      }
      // B register of digits k..k+3 of draw j and column t: bytes
      // r_j[87 - t + k ..], at j * 184 + k + 87 - t
      const uint8_t* bp = band_b + kEncBandStride * j + k0 + 4 * t4 + boff;
#pragma unroll
      for (int nt = nt0; nt < 11; ++nt)
        mma_u8(acc[nt], a, *reinterpret_cast<const uint32_t*>(bp - 8 * nt),
               *reinterpret_cast<const uint32_t*>(bp + 16 - 8 * nt));
    }
  }

  int32_t* out = nib ? out_hi : out_lo;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = 16 * mg + g + (e >> 1) * 8;
    if (row >= cts) continue;
#pragma unroll
    for (int nt = 0; nt < 11; ++nt)
      atomicAdd(&out[(ct0 + row) * 88 + 8 * nt + 2 * t4 + (e & 1)], acc[nt][e]);
  }
}

}  // namespace

// rk_host: 60 words on the host, RoundKeys' layout.  out: int64 [4, k, n, 88], zeroed.
extern "C" int cls_eval_mac_planes(const void* tables, const void* rk_host, uint32_t nonce_lo,
                                   uint32_t nonce_hi, uint64_t offset, const void* coeffs,
                                   int64_t k, int64_t d, int64_t n, void* out, void* stream) {
  if (k < 1 || k > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t gx = (92 * n + kMacCols - 1) / kMacCols;
  int64_t gy = (4096 + gx - 1) / gx;                              // about 4096 blocks in all
  gy = min64(gy, (d + kMacRows - 1) / kMacRows);                    // at least a tile each
  gy = max64(gy, (d + kMacMaxSegment - 1) / kMacMaxSegment);        // int32 sums stay exact
  int64_t seg = (d + gy - 1) / gy;
  seg = (seg + kMacRows - 1) / kMacRows * kMacRows;
  gy = (d + seg - 1) / seg;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  auto st = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const uint32_t*>(tables);
  const RoundKeys rk = round_keys(rk_host);
  auto cf = static_cast<const uint32_t*>(coeffs);
  auto o = static_cast<unsigned long long*>(out);
  const int kk = static_cast<int>(k);
  switch ((4 * kk + 7) / 8) {
    case 1: return launch_mac<1>(grid, st, tb, rk, nonce_lo, nonce_hi, offset, cf, kk, d, n, seg, o);
    case 2: return launch_mac<2>(grid, st, tb, rk, nonce_lo, nonce_hi, offset, cf, kk, d, n, seg, o);
    case 3: return launch_mac<3>(grid, st, tb, rk, nonce_lo, nonce_hi, offset, cf, kk, d, n, seg, o);
    default: return launch_mac<4>(grid, st, tb, rk, nonce_lo, nonce_hi, offset, cf, kk, d, n, seg, o);
  }
}

// The many-lane form.  segs_host: int32 [count, 4] on the host, a row each
// (row_begin, row_end, lane0, lanes), 1 <= count <= 128; a segment outside
// the rows or lanes, or of more than kMacMaxSegment rows or kWideLanes lanes,
// is cudaErrorInvalidValue before any launch.  out: int64 [4, k, n, 88], zeroed.
extern "C" int cls_eval_mac_lanes(const void* tables, const void* rk_host, uint32_t nonce_lo,
                                  uint32_t nonce_hi, uint64_t offset, const void* coeffs,
                                  int64_t k, int64_t d, int64_t n, const void* segs_host,
                                  int64_t count, void* out, void* stream) {
  if (count < 1 || count > kWideMaxSegments || d >= (int64_t{1} << 31) || k >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  MacSegments seg{};
  const int32_t* s = static_cast<const int32_t*>(segs_host);
  for (int64_t i = 0; i < count; ++i) {
    const int32_t* r = s + 4 * i;
    if (r[0] < 0 || r[1] <= r[0] || r[1] > d || r[1] - r[0] > kMacMaxSegment || r[2] < 0 ||
        r[3] < 1 || r[3] > kWideLanes || r[2] + r[3] > k)
      return static_cast<int>(cudaErrorInvalidValue);
    seg.row_begin[i] = r[0];
    seg.row_end[i] = r[1];
    seg.lane0[i] = r[2];
    seg.lanes[i] = r[3];
  }
  int bytes = 0;
  const cudaError_t err =
      cf_configure(lanes::eval_mac_kernel, kWideBeforeTable, kWideTileBytes, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t gx = (92 * n + kWideCols - 1) / kWideCols;
  lanes::eval_mac_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(count)),
                           kMacThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tables), round_keys(rk_host), nonce_lo, nonce_hi, offset,
      static_cast<const uint32_t*>(coeffs), static_cast<int>(k), d, n, seg,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out_lo, out_hi: int32 [count, 88], zeroed.
extern "C" int cls_encrypt_b_fused(const void* tables, const void* rk_host, uint32_t nonce_lo,
                                   uint32_t nonce_hi, uint64_t offset, const void* sk,
                                   int64_t count, int64_t n, void* out_lo, void* out_hi,
                                   void* stream) {
  const int64_t gx = (count + kEncCts - 1) / kEncCts;
  int64_t gy = (kEncTargetBlocks + gx - 1) / gx;
  int64_t split = (n + gy - 1) / gy;
  split = (split + kEncDraws - 1) / kEncDraws * kEncDraws;  // tiles keep their 16-byte phase
  gy = (n + split - 1) / split;
  int bytes = 0;
  const cudaError_t err = cf_configure(encrypt_kernel, kEncBeforeTable, kEncTileBytes, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  encrypt_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), kEncThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tables), round_keys(rk_host), nonce_lo, nonce_hi, offset,
      static_cast<const uint8_t*>(sk), count, n, split, static_cast<int32_t*>(out_lo),
      static_cast<int32_t*>(out_hi));
  return static_cast<int>(cudaGetLastError());
}
