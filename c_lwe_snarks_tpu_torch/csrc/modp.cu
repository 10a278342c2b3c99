// K8 matvec_mod_p: out[r] = sum_i v[r, i] * w[i] mod p, the message
// schedule's v_i(s) and t(s) at setup and the verifier's evaluations at s;
// K9 powers_mod_p: out[i] = s^i mod p, the powers those contract with.
//
// Replace the jnp functions c_lwe_snarks_tpu/ops/modp.py:matvec_mod_p (one
// int8 contraction over byte planes on the TPU's matrix unit, or a mulmod
// and tree sum for d > 32,768 or d < 8) and :powers_mod_p (doubling), which
// the JAX package compiles into its programs; the port's plain versions
// are ops/modp.py:matvec_plain (float64 products over 16-bit halves) and
// powers_plain (doubling).
//
// K8's bound on the H100 is the bytes of v, read once (int64 [rows, d]:
// 5.73 GB for setup's 21,845 x 2^15, 1.71 ms at 3.35 TB/s); its products are
// a few integer operations an entry, far under the integer rate.  Design: a
// CUDA block takes kRows consecutive rows and a segment of columns; a thread
// walks its columns kThreads apart (a warp reads 256 contiguous bytes of a
// row), reads w[i] once for the block's kRows rows, and adds each 64-bit
// product v * w (both < 2^32) folded to < 2^35 by 2^32 = 5 (mod p) into a
// 64-bit sum per row: a thread adds at most ceil(d / kThreads) < 2^29 such
// terms for d < 2^37, under 2^64 (the wrapper refuses d >= 2^37, a row of
// 1 TiB).  The sums fold to < 2^35 again, add up a warp by shuffles
// (< 2^40) and the block's warps in shared memory (< 2^43), and reduce mod
// p.  When the row groups alone do not fill the card (the verifier's and
// t's single rows), each row's columns are split over gridDim.y blocks;
// each writes its residue to partial[row, split], and the last block of
// the row group to finish (a counter per group, zeroed by the launcher)
// adds the splits in split order and writes the result: one launch,
// deterministic.
//
// K9 is launch-bound (2^15 words written at release): a thread computes
// s^i by square and multiply over i's bits, with s read from device memory,
// so the host never reads s.
#include "aes_core.cuh"

using namespace cls;

namespace {

constexpr int kThreads = 256;  // threads of a K8 block: columns it walks at a time
constexpr int kRows = 4;       // rows a K8 block sums together (w read once for them)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // columns a thread has in flight
constexpr int kPowThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
matvec_kernel(const int64_t* __restrict__ v, const int64_t* __restrict__ w, int64_t rows,
              int64_t d, int64_t seg, int64_t* __restrict__ partial,
              unsigned* __restrict__ done, int64_t* __restrict__ out) {
  __shared__ uint64_t warp_sum[kWarps][kRows];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int nr = static_cast<int>(min64(kRows, rows - r0));
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * seg;
  const int64_t c1 = min64(d, c0 + seg);
  const int64_t* src = v + r0 * d;

  uint64_t acc[kRows] = {};
  int64_t c = c0 + t;
  for (; c + (kUnroll - 1) * kThreads < c1; c += kUnroll * kThreads) {
    uint32_t wv[kUnroll];
    uint32_t x[kUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      wv[u] = static_cast<uint32_t>(__ldg(w + c + u * kThreads));
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        x[u][r] = r < nr ? static_cast<uint32_t>(__ldg(src + r * d + c + u * kThreads)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += fold35(static_cast<uint64_t>(x[u][r]) * wv[u]);
  }
  for (; c < c1; c += kThreads) {
    const uint32_t wc = static_cast<uint32_t>(__ldg(w + c));
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) acc[r] += fold35(static_cast<uint64_t>(static_cast<uint32_t>(__ldg(src + r * d + c))) * wc);
  }

  // the thread's sums < 2^35, a warp's < 2^40, the block's < 2^43
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    unsigned long long s = fold35(acc[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
    if (lane == 0) warp_sum[warp][r] = s;
  }
  __syncthreads();
  if (t < nr) {
    uint64_t s = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += warp_sum[k][t];
    const int64_t res = reduce53_mod_p(s);
    if (gridDim.y == 1) {
      out[r0 + t] = res;
      return;
    }
    partial[(r0 + t) * gridDim.y + blockIdx.y] = res;
  }
  if (gridDim.y == 1) return;

  // the last block of this row group adds every split's residue, in order
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last || t >= nr) return;
  __threadfence();
  uint64_t s = 0;  // < 65,535 p < 2^48
  for (unsigned k = 0; k < gridDim.y; ++k)
    s += static_cast<uint64_t>(*(volatile const int64_t*)(partial + (r0 + t) * gridDim.y + k));
  out[r0 + t] = reduce53_mod_p(s);
}

__global__ void __launch_bounds__(kPowThreads)
powers_kernel(const int64_t* __restrict__ s, int64_t count, int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPowThreads + threadIdx.x;
  if (i >= count) return;
  uint32_t base = static_cast<uint32_t>(*s), r = 1u;
  for (uint64_t e = static_cast<uint64_t>(i); e; e >>= 1) {
    if (e & 1u) r = mulmod_p(r, base);
    base = mulmod_p(base, base);
  }
  out[i] = r;
}

}  // namespace

// v: int64 [rows, d] (entries < 2^32, d < 2^37), w: int64 [d], splits in
// [1, 65535]: blocks a row's columns are split over; when splits > 1,
// partial: int64 [rows * splits] and done: int32 [ceil(rows / kRows)]
// (zeroed here), else both unused; out: int64 [rows].  rows, d > 0.
extern "C" int cls_matvec_mod_p(const void* v, const void* w, int64_t rows, int64_t d,
                                int64_t splits, void* partial, void* done, void* out,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), static_cast<unsigned>(splits));
  // a split's columns: ceil(d / splits), rounded up to whole warps' strides
  int64_t seg = (d + splits - 1) / splits;
  seg = (seg + kThreads - 1) / kThreads * kThreads;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(done, 0, grid.x * sizeof(unsigned), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  matvec_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int64_t*>(v), static_cast<const int64_t*>(w), rows, d, seg,
      static_cast<int64_t*>(partial), static_cast<unsigned*>(done), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// s: int64 [1] (< p), out: int64 [count], count > 0.
extern "C" int cls_powers_mod_p(const void* s, int64_t count, void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((count + kPowThreads - 1) / kPowThreads);
  powers_kernel<<<blocks, kPowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s), count, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
