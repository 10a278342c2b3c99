// K7 gated_rowsum_p: sum_{i : gate_i} v[i, :] mod p, the witness row
// selection of the prover's w (and of random_ssp's t, tile by tile).
//
// Replaces the jnp function c_lwe_snarks_tpu/ops/modp.py:gated_rowsum_mod_p
// (four byte-plane int8 matmuls on the TPU's matrix unit); the port's plain
// version is ops/modp.py:gated_rowsum_plain (float64 gemv a row chunk).
//
// Bound on the H100: the bytes of the gated rows, read once (v is uint32
// [rows, d], as the JAX package holds it: 4 bytes an entry, 2.86 GB for the
// prover's 21,844 x 2^15 if every gate were 1).  One addition an entry is
// far under the integer rate.  Design: a thread owns one column, so a warp
// reads 128 contiguous bytes of a row; a CUDA block owns kThreads columns
// of kChunkRows rows.  The block compacts its chunk's gated row indices
// into shared memory (ballot and a prefix over its warps), so rows whose
// gate is 0 are never read, then walks them kUnroll at a time with
// independent loads: 16 rows of 4 bytes, 64 bytes in flight a thread.
// Entries are < 2^32 and rows < 2^21, so 64-bit sums are exact.  Each
// block writes its column sums to a partial [chunks, d]; the last block of
// a column group to finish (a counter per group, zeroed by the launcher)
// adds the chunks' partials in chunk order and writes (sum mod p): one
// launch, deterministic.
//
// K7's many-witness form (cls_gated_rowsums_p): the B row-sums of one v, one
// a statement's gates, for a batch of statements of one circuit.  Replaces
// B launches of the kernel above, each reading its own gated rows, with one
// that reads each row once if any statement gates it.  Bound on the H100:
// the bytes of the union of the gated rows, read once (2.86 GB at the
// prover's 21,844 x 2^15 for a batch of 10 random witnesses: 0.855 ms).
// Adding each word into B accumulators on the CUDA cores costs ~3 integer
// operations a statement an entry (~1.3 ms at B = 10 on the integer pipe),
// above the memory bound; so, as the JAX package's design (four byte-plane
// int8 matrix products), the sums run on the tensor cores: mma.sync
// m16n8k32 on unsigned bytes, A = the gates of 16 statements (B padded with
// zero gates) by 32 rows, B = one byte plane of 8 columns by 32 rows, int32
// accumulators (255 x kManyChunkRows < 2^31, exact).  A block owns 256
// columns of kManyChunkRows rows: it compacts the rows any statement
// gates into shared memory with their 16 gate bytes (a row no statement
// gates is never read), then each warp walks 32 columns in groups of 32
// compacted rows: a lane loads 16 bytes (4 columns) of 8 rows, transposes
// each column's 4 x 4 bytes into byte planes with PRMTs and issues one MMA a
// column and plane.  Per column and statement, the four planes combine as
// sum_p acc_p 2^(8p) (< 2^53), written as the chunk's int64 partial; the last
// block of a column group adds the chunks' partials in chunk order and
// writes (sum mod p), as above: one launch for up to 16 statements.
#include "aes_core.cuh"
#include "mma_u8.cuh"

using namespace cls;

namespace {

constexpr int kThreads = 256;    // columns of a CUDA block
constexpr int kChunkRows = 256;  // rows of a CUDA block (one a thread in the compaction)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;
static_assert(kChunkRows == kThreads, "the compaction gives each thread one row");

// x mod p for 0 <= x < 2^53: 2^32 = 5 (mod p), so x = 5 * hi + lo with
// hi < 2^21, a value < 2^32 + 2^24, then at most two subtractions of p.
__device__ __forceinline__ int64_t reduce53_mod_p(uint64_t x) {
  uint64_t r = 5u * (x >> 32) + (x & 0xFFFFFFFFull);
  if (r >= kP) r -= kP;
  if (r >= kP) r -= kP;
  return static_cast<int64_t>(r);
}

__global__ void __launch_bounds__(kThreads)
gated_rowsum_kernel(const uint32_t* __restrict__ v, const uint8_t* __restrict__ gate, int64_t rows,
                    int64_t d, int64_t* __restrict__ partial, unsigned* __restrict__ done,
                    int64_t* __restrict__ out) {
  __shared__ int idx[kChunkRows];
  __shared__ int warp_count[kWarps];
  __shared__ bool last;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kChunkRows;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool g = r0 + t < rows && gate[r0 + t] != 0;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, g);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? warp_count[w] : 0;
    total += warp_count[w];
  }
  if (g) idx[base + __popc(ballot & ((1u << lane) - 1u))] = t;
  __syncthreads();

  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  if (col < d) {
    const uint32_t* src = v + r0 * d + col;
    uint64_t s = 0;
    int k = 0;
    for (; k + kUnroll <= total; k += kUnroll) {
      uint32_t x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(src + idx[k + u] * d);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s += x[u];
    }
    for (; k < total; ++k) s += __ldg(src + idx[k] * d);
    partial[static_cast<int64_t>(blockIdx.y) * d + col] = static_cast<int64_t>(s);
  }

  // the last block of this column group adds every chunk's partial
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last || col >= d) return;
  __threadfence();
  uint64_t sum = 0;
  for (unsigned c = 0; c < gridDim.y; ++c)
    sum += static_cast<uint64_t>(*(volatile const int64_t*)(partial + c * d + col));
  out[col] = reduce53_mod_p(sum);
}

// ---- the many-witness form ------------------------------------------------
constexpr int kStatements = 16;        // the MMA's 16 rows: statements a launch
constexpr int kManyThreads = 256;      // 8 warps of 32 columns
constexpr int kManyWarps = kManyThreads / 32;
constexpr int kManyCols = 256;         // columns a block
constexpr int kManyChunkRows = 2048;   // rows a block: 255 * 2048 < 2^31
constexpr int kGateStride = kManyChunkRows + 16;  // bytes a statement's staged gates
constexpr int kGateWords = kGateStride / 4;      // 516 = 4 (mod 32): conflict-free A fragments
static_assert(kManyCols == 32 * kManyWarps, "a warp owns 32 columns");
static_assert(kManyChunkRows % kManyThreads == 0, "the compaction takes a row a thread a round");

// four words (rows k..k+3) -> their byte planes: o[p] holds byte p of each,
// the first row's in the lowest byte
__device__ __forceinline__ void byte_planes(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                            uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// columns col..col+3 of one row (0 past d); VEC: one 16-byte load (d % 4 == 0
// and v 16-byte aligned, so col < d puts all four inside the row)
template <bool VEC>
__device__ __forceinline__ void load4(const uint32_t* __restrict__ p, int64_t col, int64_t d,
                                      uint32_t (&x)[4]) {
  if constexpr (VEC) {
    uint4 w = make_uint4(0, 0, 0, 0);
    if (col < d) w = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = col + j < d ? __ldg(p + j) : 0u;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kManyThreads, 2)
gated_rowsums_kernel(const uint32_t* __restrict__ v, const uint8_t* __restrict__ gates,
                     int64_t gate_stride, int statements, int64_t rows, int64_t d,
                     int64_t* __restrict__ partial, unsigned* __restrict__ done,
                     int64_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t gs[kStatements * kGateStride];
  __shared__ int idx[kManyChunkRows];
  __shared__ int warp_count[kManyWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kManyChunkRows;
  const int n_rows = static_cast<int>(rows - r0 < kManyChunkRows ? rows - r0 : kManyChunkRows);

  // the chunk's rows that some statement gates, in row order, with their gates
  int total = 0;
  for (int rr = 0; rr < n_rows; rr += kManyThreads) {
    const int r = rr + tid;
    unsigned mask = 0;  // bit s: statement s gates row r
    if (r < n_rows)
      for (int s = 0; s < statements; ++s)
        mask |= static_cast<unsigned>(gates[s * gate_stride + r0 + r] != 0) << s;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, mask != 0);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int base = total, add = 0;
#pragma unroll
    for (int w = 0; w < kManyWarps; ++w) {
      base += w < warp ? warp_count[w] : 0;
      add += warp_count[w];
    }
    if (mask != 0) {
      const int pos = base + __popc(ballot & ((1u << lane) - 1u));
      idx[pos] = r;
#pragma unroll
      for (int s = 0; s < kStatements; ++s) gs[s * kGateStride + pos] = (mask >> s) & 1u;
    }
    total += add;
    __syncthreads();  // warp_count is rewritten next round
  }
  // the last group of 32 is padded with zero gates on the chunk's first row
  const int padded = (total + 31) & ~31;
  for (int pos = total + tid; pos < padded; pos += kManyThreads) {
    idx[pos] = 0;
#pragma unroll
    for (int s = 0; s < kStatements; ++s) gs[s * kGateStride + pos] = 0;
  }
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int64_t col4 = static_cast<int64_t>(blockIdx.x) * kManyCols + 32 * warp + 4 * g;
  const uint32_t* src = v + r0 * d + col4;
  const uint32_t* gw = reinterpret_cast<const uint32_t*>(gs);
  int32_t acc[4][4][4];  // [column j][byte plane][fragment]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][p][e] = 0;
  for (int kb = 0; kb < padded; kb += 32) {
    const uint32_t a[4] = {gw[g * kGateWords + kb / 4 + t4], gw[(g + 8) * kGateWords + kb / 4 + t4],
                           gw[g * kGateWords + kb / 4 + 4 + t4],
                           gw[(g + 8) * kGateWords + kb / 4 + 4 + t4]};
    uint32_t x[8][4];  // rows kb + 4 t4 + i and kb + 16 + 4 t4 + i (i < 4), columns col4 + j
#pragma unroll
    for (int i = 0; i < 8; ++i)
      load4<VEC>(src + static_cast<int64_t>(idx[kb + 4 * t4 + (i & 3) + 16 * (i >> 2)]) * d,
                 col4, d, x[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b0[4], b1[4];
      byte_planes(x[0][j], x[1][j], x[2][j], x[3][j], b0);
      byte_planes(x[4][j], x[5][j], x[6][j], x[7][j], b1);
#pragma unroll
      for (int p = 0; p < 4; ++p) mma_u8(acc[j][p], a, b0[p], b1[p]);
    }
  }

  // fragment e of column tile j: statement g + 8 (e >> 1), column 8 t4 + 4 (e & 1) + j
  const int64_t c8 = static_cast<int64_t>(blockIdx.x) * kManyCols + 32 * warp + 8 * t4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = g + 8 * (e >> 1);
    if (s >= statements) continue;
    int64_t* dst = partial + (static_cast<int64_t>(blockIdx.y) * statements + s) * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = c8 + 4 * (e & 1) + j;
      if (col >= d) continue;
      uint64_t sum = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) sum += static_cast<uint64_t>(static_cast<uint32_t>(acc[j][p][e])) << (8 * p);
      dst[col] = static_cast<int64_t>(sum);
    }
  }

  // the last block of this column group adds every chunk's partials
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kManyCols + tid;
  if (!last || col >= d) return;
  __threadfence();
  for (int s = 0; s < statements; ++s) {
    uint64_t sum = 0;
    for (unsigned c = 0; c < gridDim.y; ++c)
      sum += static_cast<uint64_t>(
          *(volatile const int64_t*)(partial + (static_cast<int64_t>(c) * statements + s) * d + col));
    out[s * d + col] = reduce53_mod_p(sum);
  }
}

}  // namespace

// v: uint32 [rows, d] (rows < 2^21), gate: uint8 [rows],
// partial: int64 [ceil(rows / 256), d], done: int32 [ceil(d / 256)] (zeroed
// here), out: int64 [d].  rows and d > 0.
extern "C" int cls_gated_rowsum_p(const void* v, const void* gate, int64_t rows, int64_t d,
                                  void* partial, void* done, void* out, void* stream) {
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads),
                  static_cast<unsigned>((rows + kChunkRows - 1) / kChunkRows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(done, 0, grid.x * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gated_rowsum_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(v), static_cast<const uint8_t*>(gate), rows, d,
      static_cast<int64_t*>(partial), static_cast<unsigned*>(done), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The many-witness form.  v: uint32 [rows, d] (rows < 2^21); gates: uint8
// [statements, rows], row s at gates + s * gate_stride (1 <= statements <=
// 16); partial: int64 [ceil(rows / 2048), statements, d]; done: int32
// [ceil(d / 256)] (zeroed here); out: int64 [statements, d].  rows and d > 0.
extern "C" int cls_gated_rowsums_p(const void* v, const void* gates, int64_t gate_stride,
                                   int64_t statements, int64_t rows, int64_t d, void* partial,
                                   void* done, void* out, void* stream) {
  if (statements < 1 || statements > kStatements) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((d + kManyCols - 1) / kManyCols),
                  static_cast<unsigned>((rows + kManyChunkRows - 1) / kManyChunkRows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(done, 0, grid.x * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kernel = vec ? gated_rowsums_kernel<true> : gated_rowsums_kernel<false>;
  kernel<<<grid, kManyThreads, 0, s>>>(
      static_cast<const uint32_t*>(v), static_cast<const uint8_t*>(gates), gate_stride,
      static_cast<int>(statements), rows, d, static_cast<int64_t*>(partial),
      static_cast<unsigned*>(done), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
