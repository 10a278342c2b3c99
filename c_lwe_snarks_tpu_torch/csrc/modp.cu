// K8 matvec_mod_p: out[r] = sum_i v[r, i] * w[i] mod p, the message
// schedule's v_i(s) and t(s) at setup; its at-s form, w = s^i made in the
// block: the verifier's t(s) and v_0(s) in one launch.  K9 powers_mod_p:
// out[i] = s^i mod p, and its messages form, setup's first 2d plaintexts
// s^i and alpha s^i written into the message buffer by one launch.
//
// Replace the jnp functions c_lwe_snarks_tpu/ops/modp.py:matvec_mod_p (one
// int8 contraction over byte planes on the TPU's matrix unit, or a mulmod
// and tree sum for d > 32,768 or d < 8), :poly_eval_mod_p (powers_mod_p,
// then mulmod_p and sum_mod_p), :powers_mod_p (doubling) and setup's
// mulmod_p(alpha, powers) (c_lwe_snarks_tpu/models/snark.py), which the
// JAX package compiles into its programs; the port's plain versions are
// ops/modp.py:matvec_plain (float64 products over 16-bit halves),
// poly_eval_plain, powers_plain (doubling) and message_powers_plain.
//
// K8's bound on the H100 is the bytes of v, read once (int64 [rows, d]:
// 5.73 GB for setup's 21,845 x 2^15, 1.71 ms at 3.35 TB/s); its products are
// a few integer operations an entry, far under the integer rate.  Design: a
// CUDA block takes kRows consecutive rows and a segment of columns; a thread
// walks its columns kThreads apart (a warp reads 256 contiguous bytes of a
// row), takes w[i] once for the block's kRows rows, and adds each 64-bit
// product v * w (both < 2^32) folded to < 2^35 by 2^32 = 5 (mod p) into a
// 64-bit sum per row: a thread adds at most ceil(d / kThreads) < 2^29 such
// terms for d < 2^37, under 2^64 (the wrapper refuses d >= 2^37, a row of
// 1 TiB).  The sums fold to < 2^35 again, add up a warp by shuffles
// (< 2^40) and the block's warps in shared memory (< 2^43), and reduce mod
// p.  When the row groups alone do not fill the card (t's and the
// verifier's rows), each row's columns are split over gridDim.y blocks;
// each writes its residue to partial[row, split], and the last block of
// the row group to finish (a counter per group, zeroed by the launcher)
// adds the splits in split order and writes the result: one launch,
// deterministic.  The at-s form reads s instead of w: a thread makes s^c
// for its first column by square and multiply and s^kThreads once, then
// steps one mulmod a column, so w is never written or read (the verifier's
// two rows are launch-bound: 2 x 2^15 entries).
//
// K9 is launch-bound (2^15 words written at release; its bound on the H100
// is those bytes, 0.08 us, a mulmod a word being far under the integer
// rate, and the messages form's 2 x 2^15 words 0.16 us): a thread computes
// s^i by square and multiply over i's bits, with s (and alpha) read from
// device memory, so the host never reads them; the messages form writes
// s^i at i and alpha s^i at count + i of the message buffer, so setup's
// schedule has no separate multiply by alpha and no concatenation.
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

// b^e mod p by square and multiply over e's bits
__device__ __forceinline__ uint32_t pow_mod_p(uint32_t b, uint64_t e) {
  uint32_t r = 1u;
  for (; e; e >>= 1) {
    if (e & 1u) r = mulmod_p(r, b);
    b = mulmod_p(b, b);
  }
  return r;
}

// K8's operand w, read from memory: column c's word
struct WRead {
  const int64_t* w;
  __device__ __forceinline__ void start(int64_t) {}
  __device__ __forceinline__ uint32_t next(int64_t c) { return static_cast<uint32_t>(__ldg(w + c)); }
};

// the at-s form's operand, made in the block: s^c at the thread's columns
// c0, c0 + kThreads, ..., in that order, one mulmod a column
struct WPowers {
  const int64_t* s;
  uint32_t cur, step;
  __device__ __forceinline__ void start(int64_t c0) {
    const uint32_t b = static_cast<uint32_t>(*s);
    cur = pow_mod_p(b, static_cast<uint64_t>(c0));
    step = pow_mod_p(b, kThreads);
  }
  __device__ __forceinline__ uint32_t next(int64_t) {
    const uint32_t x = cur;
    cur = mulmod_p(cur, step);
    return x;
  }
};

template <class W>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const int64_t* __restrict__ v, W w, int64_t rows,
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
  w.start(c);
  for (; c + (kUnroll - 1) * kThreads < c1; c += kUnroll * kThreads) {
    uint32_t wv[kUnroll];
    uint32_t x[kUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      wv[u] = w.next(c + u * kThreads);
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
    const uint32_t wc = w.next(c);
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
powers_kernel(const int64_t* __restrict__ s, const int64_t* __restrict__ alpha, int64_t count,
              int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPowThreads + threadIdx.x;
  if (i >= count) return;
  const uint32_t r = pow_mod_p(static_cast<uint32_t>(*s), static_cast<uint64_t>(i));
  out[i] = r;
  if (alpha) out[count + i] = mulmod_p(static_cast<uint32_t>(*alpha), r);
}

template <class W>
int launch_matvec(const void* v, W w, int64_t rows, int64_t d, int64_t splits, void* partial,
                  void* done, void* out, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), static_cast<unsigned>(splits));
  // a split's columns: ceil(d / splits), rounded up to whole warps' strides
  int64_t seg = (d + splits - 1) / splits;
  seg = (seg + kThreads - 1) / kThreads * kThreads;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(done, 0, grid.x * sizeof(unsigned), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  matvec_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int64_t*>(v), w, rows, d, seg, static_cast<int64_t*>(partial),
      static_cast<unsigned*>(done), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v: int64 [rows, d] (entries < 2^32, d < 2^37), w: int64 [d], splits in
// [1, 65535]: blocks a row's columns are split over; when splits > 1,
// partial: int64 [rows * splits] and done: int32 [ceil(rows / kRows)]
// (zeroed here), else both unused; out: int64 [rows].  rows, d > 0.
extern "C" int cls_matvec_mod_p(const void* v, const void* w, int64_t rows, int64_t d,
                                int64_t splits, void* partial, void* done, void* out,
                                void* stream) {
  return launch_matvec(v, WRead{static_cast<const int64_t*>(w)}, rows, d, splits, partial, done,
                       out, static_cast<cudaStream_t>(stream));
}

// the at-s form: as cls_matvec_mod_p with w[i] = s^i mod p, s: int64 [1] (< p)
extern "C" int cls_matvec_at_s_mod_p(const void* v, const void* s, int64_t rows, int64_t d,
                                     int64_t splits, void* partial, void* done, void* out,
                                     void* stream) {
  return launch_matvec(v, WPowers{static_cast<const int64_t*>(s), 0u, 0u}, rows, d, splits,
                       partial, done, out, static_cast<cudaStream_t>(stream));
}

// s, alpha: int64 [1] (< p); out: int64 [count] (s^i), or with_alpha != 0
// int64 [2 count] (s^i, then alpha s^i), count > 0.
extern "C" int cls_powers_mod_p(const void* s, const void* alpha, uint32_t with_alpha,
                                int64_t count, void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((count + kPowThreads - 1) / kPowThreads);
  powers_kernel<<<blocks, kPowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s), with_alpha ? static_cast<const int64_t*>(alpha) : nullptr,
      count, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
