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
#include "aes_core.cuh"

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
