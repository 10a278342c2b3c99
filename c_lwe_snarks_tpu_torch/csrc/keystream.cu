// K1 keystream_blocks and K2 keystream_fold_p: the raw AES-256-CTR stream
// as bytes, and the stream folded to uint64-LE draws mod p.
//
// K1 replaces c_lwe_snarks_tpu/ops/aes_pallas.py:_kernel_v2 (wrappers
// keystream_words and keystream_blocks); K2 replaces
// aes_pallas.py:_kernel_v2_fold (wrapper keystream_fold_p), which folds
// (w[2k+1] * 2^32 + w[2k]) mod p inside the cipher kernel so the raw words
// never reach device memory.
//
// Bound on the H100: the cipher.  The conflict-free core of aes_core_cf.cuh
// takes 224 shared-memory loads and ~450 integer operations a 16-byte
// block, both near their pipe's rate, ~27 ps a block on the whole card; the
// 16 bytes K1 writes a block take 4.8 ps at 3.35 TB/s, K2's 8 bytes 2.4 ps.
// Design: one thread per counter block in a grid-stride loop, one CUDA block of
// 1024 threads an SM (the table's window takes 128 KiB of its shared
// memory), the table staged once per CUDA block, round keys as a kernel
// parameter.  The table costs 16,384 shared-memory stores a CUDA block, so
// the grid is no wider than the work: ceil(blocks / 1024), at most 132, and
// a call of a few blocks fills one table, not 132.
//
// Each kernel writes what its callers read, so no elementwise pass follows
// it.  K1 stores a block's four little-endian words with one 16-byte store:
// in memory these are the stream's bytes, uint8 [nblocks, 16].  K2 stores
// the two folds of a block as uint32 words, {f0, f1} in one 8-byte store,
// the type the TPU kernel returns; an odd pair count ends with one 4-byte
// store, so nothing behind out[npairs - 1] is touched (the caller's next row).
#include "aes_core_cf.cuh"

using namespace cls;

namespace {

constexpr int kThreads = 1024;  // one CUDA block an SM
constexpr int kMaxGrid = 132;   // SMs of an H100

__global__ void __launch_bounds__(kThreads)
keystream_blocks_kernel(const uint32_t* __restrict__ tables, const __grid_constant__ RoundKeys rk,
                        uint32_t nonce_lo, uint32_t nonce_hi, uint64_t start, int64_t nblocks,
                        uint4* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  cf_load_table(cf_window(smem, 0), tables);
  __syncthreads();
  const uint32_t lane_base = cf_lane_base();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < nblocks;
       i += stride) {
    const uint64_t ctr[1] = {start + static_cast<uint64_t>(i)};
    uint4 w[1];
    aes256_ctr_cf<1>(lane_base, rk, nonce_lo, nonce_hi, ctr, w);
    out[i] = w[0];
  }
}

__global__ void __launch_bounds__(kThreads)
keystream_fold_p_kernel(const uint32_t* __restrict__ tables, const __grid_constant__ RoundKeys rk,
                        uint32_t nonce_lo, uint32_t nonce_hi, uint64_t start, int64_t npairs,
                        uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  cf_load_table(cf_window(smem, 0), tables);
  __syncthreads();
  const uint32_t lane_base = cf_lane_base();
  const int64_t nblocks = (npairs + 1) / 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < nblocks;
       i += stride) {
    const uint64_t ctr[1] = {start + static_cast<uint64_t>(i)};
    uint4 w[1];
    aes256_ctr_cf<1>(lane_base, rk, nonce_lo, nonce_hi, ctr, w);
    const uint32_t f0 = fold64_mod_p(w[0].y, w[0].x);
    if (2 * i + 1 < npairs)
      *reinterpret_cast<uint2*>(out + 2 * i) = make_uint2(f0, fold64_mod_p(w[0].w, w[0].z));
    else
      out[2 * i] = f0;
  }
}

// Configure (the table's window, nothing before or behind it) and launch.
template <class Kernel, class Out>
int launch(Kernel* kernel, int64_t aes_blocks, const void* tables, const void* rk_host,
           uint32_t nonce_lo, uint32_t nonce_hi, uint64_t start, int64_t count, Out* out,
           void* stream) {
  int bytes = 0;
  const cudaError_t err = cf_configure(kernel, 0, 0, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_1d(aes_blocks, kThreads, kMaxGrid), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tables), round_keys(rk_host), nonce_lo, nonce_hi, start, count,
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rk_host: 60 words on the host, RoundKeys' layout.  out: uint8 [nblocks, 16],
// 16-byte aligned.
extern "C" int cls_keystream_blocks(const void* tables, const void* rk_host, uint32_t nonce_lo,
                                    uint32_t nonce_hi, uint64_t start, int64_t nblocks, void* out,
                                    void* stream) {
  return launch(keystream_blocks_kernel, nblocks, tables, rk_host, nonce_lo, nonce_hi, start,
                nblocks, static_cast<uint4*>(out), stream);
}

// out: uint32 [npairs], 8-byte aligned.
extern "C" int cls_keystream_fold_p(const void* tables, const void* rk_host, uint32_t nonce_lo,
                                    uint32_t nonce_hi, uint64_t start, int64_t npairs, void* out,
                                    void* stream) {
  return launch(keystream_fold_p_kernel, (npairs + 1) / 2, tables, rk_host, nonce_lo, nonce_hi,
                start, npairs, static_cast<uint32_t*>(out), stream);
}
