// K11 verify: the designated verifier in one launch -- the proof's five
// decrypts, t(s) and v_0(s), the relations eq_pke1, eq_pke2, eq_div and
// eq_lin and the test-error bound -- and its decrypt form, (b - <a, sk>)
// mod p of k ciphertexts in one launch (the CRS probes, the proof probe).
//
// Replaces the jnp code c_lwe_snarks_tpu/models/snark.py:441 verifier (five
// decrypts, two poly_eval_mod_p, five mulmods), :422 test_error_ok (b_w's
// bigint_dot a second time, 11 digits_ge against p * 2^(64j)),
// models/lwe.py:294 decrypt and ops/digits.py:182 bigint_dot, which the JAX
// package compiles into its programs; the port's plain versions are
// ops/verify.py:decrypt_plain, error_count_plain and verify_plain (a float64
// GEMM for the byte products, anti-diagonal sums, the carry fold, mod_p).
//
// What the function needs (release, n = 1,470, d = 2^15): the proof (5 x
// 1,471 x 88 bytes), sk, t and v_0 read once, 1.04 MB, 0.31 us at
// 3.35 TB/s; 28.8 M byte products (5 x 1,470 x 88 * 89 / 2) and 2 x 2^15
// mulmods, ~1.7 us on the integer pipe at a multiply-add a product.  Any
// launch is latency-bound at a few us; what the verifier paid before was
// the host's issue of its 108 launches (~25-47 us each through a wrapper).
//
// Design: one grid of k * S decrypt blocks and, in the verifier form, A
// at-s blocks.  Decrypt block (c, sl) takes ciphertext c's rows [32 sl,
// 32 sl + 32) (kSliceRows) and sk's, staged in shared memory a word a
// load (sk's rows reversed and zero-padded to 96 bytes), and computes the
// planes P[t] =
// sum_r sum_{x + y = t} a[r][x] sk[r][y] for t < 88 only: the products
// landing at digit 88 and above are dropped, the truncation mod 2^704 of
// bigint_dot.  Digit t of a row is then a dot of a's bytes 0..t with the
// reversed row's bytes from 87 - t on: __dp4a on a's words and windows of
// the reversed row (two aligned words funnel-shifted), four products an
// instruction, the terms past t meeting the zero padding.  A thread owns
// the digit pair (q, 87 - q) (23 or 24 words a row, so every thread does
// about the same work) over the rows of its row group; a slice's plane is
// < 32 * 88 * 255^2 < 2^32, so the partials are uint32 (unsigned 32-bit
// sums hold up to 750 rows).  The last slice block of c to finish (a
// counter per ciphertext, zeroed by the launcher) adds the S partials of
// each plane in 64 bits, all its threads reading from L2 at once (a
// quarter of the slices each, then the quarters in order: a fixed order),
// folds the planes to digits with K10's group fold (carry.cuh: a row over
// 16 lanes) and drops the digits at 88 and above and the carry out: the
// dot mod 2^704.  It takes each side mod p directly, sum_t d_t (256^t mod
// p) for the dot and for b, and writes (b - dot) mod p: the difference is
// never taken mod 2^704 first, so b < <a, sk> (after a negative smudge)
// gives the JAX package's value.  For b_w (the verifier form's row 4) it
// also counts the thresholds p * 2^(64j), j < 11, that are <= the dot,
// each compared digit by digit from the top as digits_ge does (equal
// counts as >=): the dot is computed once, not twice.  At-s block i sums
// t[c] s^c and v_0[c] s^c over its kAtSCols columns with K8's power walk
// (modp.cuh: s^c made in the block, one mulmod a column), each product
// folded to < 2^35, and writes the two residues.  The last of the k
// combines and the A at-s blocks (a second counter) adds the at-s residues
// over a warp and checks the four relations and the bound on one thread:
// the verdict is a device bool, beside the seven words (the five decrypts,
// t(s), v_0(s)) and the limb count.  Integer sums are exact in any order;
// the fixed order and the in-kernel combine keep the verifier to one launch
// with nothing read back to the host.
#include <cstdint>
#include <cuda_runtime.h>

#include "aes_core.cuh"
#include "carry.cuh"
#include "modp.cuh"

using namespace cls;

namespace {

constexpr int kDigits = 88;                    // mod-2^704 digits
constexpr int kPairs = kDigits / 2;            // digit pairs (q, 87 - q)
constexpr int kGroups = 8;                     // row groups of a decrypt block
constexpr int kThreads = kPairs * kGroups;     // 352
constexpr int kWarps = kThreads / 32;
constexpr int kSliceRows = 32;                 // rows of a decrypt block
constexpr int kRowBytes = 96;                  // a staged row: 88 digits, zero padding, whole words
constexpr int kRowWords = kRowBytes / 4;
constexpr int kDigitWords = kDigits / 4;       // 22 words of digits a row
constexpr int kQuarters = kThreads / kDigits;  // the combine's threads a plane: 4
constexpr int kAtSCols = 2048;                 // columns of an at-s block
constexpr int kThresholds = 11;                // p * 2^(64j), j < 11
static_assert(kThreads % 32 == 0, "whole warps");
static_assert(kQuarters * kDigits == kThreads, "the combine's threads cover the planes");
static_assert(kRowBytes >= kDigits + 4 && kRowBytes % 16 == 0, "a window's last word is padding");
constexpr int kStage = (kSliceRows * kDigitWords + kThreads - 1) / kThreads;  // words a thread stages
static_assert(static_cast<uint64_t>(kSliceRows) * kDigits * 255 * 255 < (1ull << 32),
              "a slice's planes fit in 32 bits");
static_assert(kLanes * kPer >= kDigits, "one fold pass covers a row");

struct Args {
  const uint8_t* ct[5];       // ciphertext c at ct[c] (the verifier form: h, hat_h, hat_v, v_w, b_w)
  const uint8_t* base;        // or at base + c * (n + 1) * 88 (the decrypt form)
  const uint8_t* sk;          // [n, 88]
  int64_t n, k, slices;
  int count_row;              // the ciphertext whose dot is counted against the thresholds, or -1
  const uint32_t* t;          // the verifier form: t, v_0 [d], s, alpha, beta (uint32 < p)
  const uint32_t* v0;
  const uint32_t* s;
  const uint32_t* alpha;
  const uint32_t* beta;
  int64_t d, segs, limb_bound;
  uint32_t* part;             // [k, slices, 88] planes of each slice
  uint32_t* seg;              // [2, segs] residues of t and v_0 over each at-s block
  unsigned* done;             // [k] slices done per ciphertext, then [1] combines and at-s blocks
  int64_t* dec;               // [k] decrypts; the verifier form: [8] words, count at dec[7]
  bool* ok;                   // the verdict (the verifier form)
};

__device__ __forceinline__ const uint8_t* ct_at(const Args& a, int64_t c) {
  return a.base ? a.base + c * (a.n + 1) * kDigits : a.ct[c];
}

// (a - b) and (a + b) mod p for a, b < p
__device__ __forceinline__ uint32_t submod_p(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (kP - b);
}

__device__ __forceinline__ uint32_t addmod_p(uint32_t a, uint32_t b) {
  const uint64_t s = static_cast<uint64_t>(a) + b;
  return static_cast<uint32_t>(s >= kP ? s - kP : s);
}

// another block's results, read from L2 after the counter said they are there
__device__ __forceinline__ uint64_t ld_l2(const uint32_t* p) { return __ldcg(p); }
__device__ __forceinline__ int64_t ld_l2(const int64_t* p) {
  return __ldcg(reinterpret_cast<const long long*>(p));
}

// sum_{x <= t} a[x] sk[t - x] of one staged row: kr is sk reversed (kr[j] =
// sk[87 - j]) and zero from byte 88, so digit t is the dot of a's words
// 0 .. t / 4 with kr's bytes from 87 - t on, each window word two aligned
// words funnel-shifted; the terms x > t meet kr's zero padding
__device__ __forceinline__ uint32_t digit_dot(const uint32_t* ar, const uint32_t* kr, int t) {
  const int o = kDigits - 1 - t, base = o >> 2, sh = 8 * (o & 3);
  uint32_t s = 0, k0 = kr[base];
  for (int i = 0; i <= (t >> 2); ++i) {
    const uint32_t k1 = kr[base + i + 1];
    s = __dp4a(ar[i], __funnelshift_r(k0, k1, sh), s);
    k0 = k1;
  }
  return s;
}

// planes of slice sl of ciphertext c: part[c, sl, t] for t < 88
__device__ void slice_planes(const Args& a, int64_t c, int64_t sl, uint32_t (*a_s)[kRowWords],
                             uint32_t (*kr_s)[kRowWords], uint32_t (*red)[kDigits]) {
  const int tid = threadIdx.x;
  const int64_t r0 = sl * kSliceRows;
  const int nr = static_cast<int>(min64(kSliceRows, a.n - r0));
  // rows of a are contiguous, as are sk's, and start on a word (the
  // wrappers check): a word a load, every thread's loads in flight together;
  // sk's word j lands byte-reversed at word 21 - j of its reversed row
  const uint32_t* src_a = reinterpret_cast<const uint32_t*>(ct_at(a, c) + r0 * kDigits);
  const uint32_t* src_k = reinterpret_cast<const uint32_t*>(a.sk + r0 * kDigits);
  const int words = nr * kDigitWords;
  uint32_t va[kStage], vk[kStage];
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = tid + u * kThreads;
    va[u] = i < words ? __ldg(src_a + i) : 0u;
    vk[u] = i < words ? __ldg(src_k + i) : 0u;
  }
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = tid + u * kThreads;
    if (i < words) {
      const int r = i / kDigitWords, j = i - r * kDigitWords;
      a_s[r][j] = va[u];
      kr_s[r][kDigitWords - 1 - j] = bswap32(vk[u]);
    }
  }
  for (int i = tid; i < nr * (kRowWords - kDigitWords); i += kThreads) {
    const int r = i / (kRowWords - kDigitWords);
    kr_s[r][kDigitWords + i - r * (kRowWords - kDigitWords)] = 0u;  // the windows' padding
  }
  __syncthreads();
  const int q = tid % kPairs, g = tid / kPairs;
  const int lo = q, hi = kDigits - 1 - q;
  uint32_t s_lo = 0, s_hi = 0;
  for (int r = g; r < nr; r += kGroups) {
    s_lo += digit_dot(a_s[r], kr_s[r], lo);
    s_hi += digit_dot(a_s[r], kr_s[r], hi);
  }
  red[g][lo] = s_lo;
  red[g][hi] = s_hi;
  __syncthreads();
  if (tid < kDigits) {
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) sum += red[j][tid];
    a.part[(c * a.slices + sl) * kDigits + tid] = sum;
  }
}

// the last slice block of c: its planes, the S partials added by all its
// threads (a quarter of the slices each, then the quarters in order); then
// warp 0: the dot mod 2^704, each side mod p, dec[c]; for count_row, the
// threshold count
__device__ void combine(const Args& a, int64_t c, uint64_t (*quarter_sums)[kDigits],
                        uint64_t* planes, uint8_t* dot_s) {
  const int tid = threadIdx.x;
  {
    const int t = tid % kDigits, quarter = tid / kDigits;
    uint64_t acc = 0;
    for (int64_t sl = quarter; sl < a.slices; sl += kQuarters)
      acc += ld_l2(a.part + (c * a.slices + sl) * kDigits + t);
    quarter_sums[quarter][t] = acc;
  }
  __syncthreads();
  if (tid < kDigits) {
    uint64_t sum = 0;
#pragma unroll
    for (int j = 0; j < kQuarters; ++j) sum += quarter_sums[j][tid];
    planes[tid] = sum;
  }
  __syncthreads();
  if (tid >= 32) return;
  const int lane = tid, g = lane & (kLanes - 1), shift = lane & kLanes;
  const bool live = lane < kLanes;  // lanes 16..31 fold a zero row beside it
  const int p0 = kPer * g;
  uint64_t x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = live && p0 + j < kDigits ? planes[p0 + j] : 0;
  uint64_t carry_out;  // past position 95: dropped with the digits at 88 and above
  const uint64_t dig = fold_group(x, g, shift, carry_out);
  const uint8_t* b = ct_at(a, c) + a.n * kDigits;
  uint64_t acc_d = 0, acc_b = 0;  // < 6 * 255 * 2^32 a lane, < 2^47 for the row
  uint32_t w = pow_mod_p(256u, static_cast<uint64_t>(p0));
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (live && p0 + j < kDigits) {
      acc_d += ((dig >> (8 * j)) & 255u) * static_cast<uint64_t>(w);
      acc_b += static_cast<uint64_t>(__ldg(b + p0 + j)) * w;
    }
    w = mulmod_p(w, 256u);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    acc_d += __shfl_xor_sync(kFull, acc_d, o, kLanes);
    acc_b += __shfl_xor_sync(kFull, acc_b, o, kLanes);
  }
  if (lane == 0)
    a.dec[c] = submod_p(static_cast<uint32_t>(reduce53_mod_p(acc_b)),
                        static_cast<uint32_t>(reduce53_mod_p(acc_d)));
  if (c != a.count_row) return;
  if (live)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (p0 + j < kDigits) dot_s[p0 + j] = static_cast<uint8_t>(dig >> (8 * j));
  __syncwarp();
  bool ge = false;
  if (lane < kThresholds) {  // dot >= p * 2^(64 lane): p's bytes FB FF FF FF at 8 lane
    ge = true;
    for (int t = kDigits - 1; t >= 0; --t) {
      const int u = t - 8 * lane;
      const uint32_t thr = u == 0 ? 0xFBu : (u > 0 && u < 4) ? 0xFFu : 0u;
      if (dot_s[t] != thr) {
        ge = dot_s[t] > thr;
        break;
      }
    }
  }
  const unsigned count = __popc(__ballot_sync(kFull, ge));
  if (lane == 0) a.dec[7] = count;
}

// at-s block i: sum of t[c] s^c and of v_0[c] s^c over its columns mod p
__device__ void at_s(const Args& a, int64_t i, uint64_t (*warp_sum)[2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = i * kAtSCols, c1 = min64(a.d, c0 + kAtSCols);
  WPowers<kThreads, uint32_t> w{a.s, 0u, 0u};
  int64_t c = c0 + tid;
  w.start(c);
  uint64_t st = 0, sv = 0;  // a thread adds < kAtSCols / kThreads terms < 2^35
  for (; c < c1; c += kThreads) {
    const uint32_t wc = w.next(c);
    st += fold35(static_cast<uint64_t>(__ldg(a.t + c)) * wc);
    sv += fold35(static_cast<uint64_t>(__ldg(a.v0 + c)) * wc);
  }
  st = fold35(st);
  sv = fold35(sv);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // a warp's sums < 2^40
    st += __shfl_xor_sync(kFull, st, o);
    sv += __shfl_xor_sync(kFull, sv, o);
  }
  if (lane == 0) {
    warp_sum[warp][0] = st;
    warp_sum[warp][1] = sv;
  }
  __syncthreads();
  if (tid < 2) {
    uint64_t sum = 0;  // < 11 * 2^40
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += warp_sum[k][tid];
    a.seg[tid * a.segs + i] = static_cast<uint32_t>(reduce53_mod_p(sum));
  }
}

// the verdict, by warp 0 of the last block: the at-s residues added over
// the warp, then lane 0 reads the decrypts and the count (written by other
// blocks) and checks the relations
__device__ void finish(const Args& a) {
  const int lane = threadIdx.x;
  uint64_t ts = 0, vs = 0;  // < segs * p < 2^53
  for (int64_t i = lane; i < a.segs; i += 32) {
    ts += ld_l2(a.seg + i);
    vs += ld_l2(a.seg + a.segs + i);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ts += __shfl_xor_sync(kFull, ts, o);
    vs += __shfl_xor_sync(kFull, vs, o);
  }
  if (lane != 0) return;
  const uint32_t t_s = static_cast<uint32_t>(reduce53_mod_p(ts));
  const uint32_t v0_s = static_cast<uint32_t>(reduce53_mod_p(vs));
  uint32_t dec[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) dec[c] = static_cast<uint32_t>(ld_l2(a.dec + c));
  const int64_t count = ld_l2(a.dec + 7);
  const uint32_t h = dec[0], hat_h = dec[1], hat_v = dec[2], w_s = dec[3], b_s = dec[4];
  const uint32_t alpha = __ldg(a.alpha), beta = __ldg(a.beta);
  const uint32_t v_s = addmod_p(v0_s, w_s);
  const bool eq_pke1 = mulmod_p(h, alpha) == hat_h;
  const bool eq_pke2 = mulmod_p(v_s, alpha) == hat_v;
  const bool eq_div = submod_p(submod_p(mulmod_p(v_s, v_s), 1u), mulmod_p(h, t_s)) == 0u;
  const bool eq_lin = mulmod_p(w_s, beta) == b_s;
  const bool eq_err = -count < a.limb_bound;
  a.dec[5] = t_s;
  a.dec[6] = v0_s;
  *a.ok = eq_pke1 && eq_pke2 && eq_div && eq_lin && eq_err;
}

__global__ void __launch_bounds__(kThreads) verify_kernel(Args a) {
  __shared__ uint32_t a_s[kSliceRows][kRowWords];
  __shared__ uint32_t kr_s[kSliceRows][kRowWords];
  __shared__ uint32_t red[kGroups][kDigits];
  __shared__ uint64_t quarter_sums[kQuarters][kDigits];
  __shared__ uint64_t planes[kDigits];
  __shared__ uint64_t warp_sum[kWarps][2];
  __shared__ uint8_t dot_s[kDigits];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  if (b < a.k * a.slices) {
    const int64_t c = b / a.slices, sl = b - c * a.slices;
    slice_planes(a, c, sl, a_s, kr_s, red);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.done + c, 1u) == a.slices - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    combine(a, c, quarter_sums, planes, dot_s);
    if (a.segs == 0) return;  // the decrypt form ends with the combine
  } else {
    at_s(a, b - a.k * a.slices, warp_sum);
  }
  // the verifier form: the last of the k combines and the at-s blocks decides
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.done + a.k, 1u) == a.k + a.segs - 1;
  __syncthreads();
  if (!last || tid >= 32) return;
  __threadfence();
  finish(a);
}

int launch(const Args& a, cudaStream_t st) {
  const int64_t counters = a.k + (a.segs ? 1 : 0);
  cudaError_t err = cudaMemsetAsync(a.done, 0, counters * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = a.k * a.slices + a.segs;
  verify_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int64_t slices_of(int64_t n) { return (n + kSliceRows - 1) / kSliceRows; }

}  // namespace

// ct: uint8 [k, n + 1, 88] (contiguous), sk: uint8 [n, 88], both 4-byte aligned; part: uint32
// [k, ceil(n / 32), 88]; done: uint32 [k] (zeroed here); out: int64 [k].
// k, n > 0; k * ceil(n / 32) < 2^31.
extern "C" int cls_decrypt(const void* ct, int64_t k, const void* sk, int64_t n, void* part,
                           void* done, void* out, void* stream) {
  Args a{};
  a.base = static_cast<const uint8_t*>(ct);
  a.sk = static_cast<const uint8_t*>(sk);
  a.n = n;
  a.k = k;
  a.slices = slices_of(n);
  a.count_row = -1;
  a.part = static_cast<uint32_t*>(part);
  a.done = static_cast<unsigned*>(done);
  a.dec = static_cast<int64_t*>(out);
  return launch(a, static_cast<cudaStream_t>(stream));
}

// h, hat_h, hat_v, v_w, b_w: uint8 [n + 1, 88] each (contiguous), sk: uint8
// [n, 88], all 4-byte aligned; t, v0: uint32 [d]; s, alpha, beta: uint32 [1] (< p); part:
// uint32 [5, ceil(n / 32), 88]; seg: uint32 [2, ceil(d / 2048)]; done:
// uint32 [6] (zeroed here); words: int64 [8] (the five decrypts, t(s),
// v_0(s), the limb count); ok: bool [1].  n, d > 0.
extern "C" int cls_verify(const void* h, const void* hat_h, const void* hat_v, const void* v_w,
                          const void* b_w, const void* sk, int64_t n, const void* t,
                          const void* v0, int64_t d, const void* s, const void* alpha,
                          const void* beta, int64_t limb_bound, void* part, void* seg,
                          void* done, void* words, void* ok, void* stream) {
  Args a{};
  const void* cts[5] = {h, hat_h, hat_v, v_w, b_w};
  for (int c = 0; c < 5; ++c) a.ct[c] = static_cast<const uint8_t*>(cts[c]);
  a.sk = static_cast<const uint8_t*>(sk);
  a.n = n;
  a.k = 5;
  a.slices = slices_of(n);
  a.count_row = 4;
  a.t = static_cast<const uint32_t*>(t);
  a.v0 = static_cast<const uint32_t*>(v0);
  a.s = static_cast<const uint32_t*>(s);
  a.alpha = static_cast<const uint32_t*>(alpha);
  a.beta = static_cast<const uint32_t*>(beta);
  a.d = d;
  a.segs = (d + kAtSCols - 1) / kAtSCols;
  a.limb_bound = limb_bound;
  a.part = static_cast<uint32_t*>(part);
  a.seg = static_cast<uint32_t*>(seg);
  a.done = static_cast<unsigned*>(done);
  a.dec = static_cast<int64_t*>(words);
  a.ok = static_cast<bool*>(ok);
  return launch(a, static_cast<cudaStream_t>(stream));
}
