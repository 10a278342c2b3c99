// K6 ntt_pass: the prime-batched CRT-NTT of the polynomial engine mod
// p = 2^32 - 5 (ops/ntt.py): one launch is one pass of a transform over all
// three primes and the whole batch.
//
// Replaces the jnp code c_lwe_snarks_tpu/ops/ntt.py:_poly_mul_batched
// (_ntt_core_v, crt_to_mod_p) that the JAX package compiles into one device
// program; the port's plain version is ops/ntt.py:_ntt / _poly_mul_cyclic.
//
// Bound on the H100: at the prover's sizes (n <= 2^16, three primes,
// 0.75 MiB of residues a transform) neither bytes nor operations: ~1-2 us a
// transform against a launch's few microseconds.  What the design removes is
// the eager form's ~8 launches a radix-2 stage and its per-call table
// uploads: a product is two launches for n <= kSmemN (forward of both
// operands; inverse with the pointwise product in its first step and the
// n^-1 scale and the CRT to mod p in its last) and four above (two passes a
// transform).
//
// A CUDA block holds, for one row of the batch and one prime (all three in
// the pass with the CRT), `cols` transforms of length L in shared memory
// (cols * L <= kSmemN residues a prime, 48 KiB at most): load (bit-reversed into shared memory), log2 L radix-2
// Cooley-Tukey stages, store in natural order.  n <= kSmemN is one pass
// (L = n).  Above, n = n1 * n2 runs as a four-step: the column transforms
// (L = n1, stride n2) times w_n^(j2 * k1), then the row transforms (L = n2),
// which leave X[k1 + n1 * k2] at [k1, k2]; the pointwise product does not
// care about order, and the inverse undoes the same steps in reverse.  Every
// pass works in place on its own elements, so a product needs one scratch.
//
// Arithmetic: residues are uint32.  q3 = 2,281,701,377 > 2^31, so a + b can
// wrap 32 bits: add_mod catches the wrap (the NTT's counterpart of the
// double-wrap of mod-p adds).  Twiddles are fixed, so a butterfly multiplies
// with Shoup's precomputed quotient w' = floor(w * 2^32 / q) (the table keeps
// w and w' side by side); the remainder x * w - qhat * q lies in [0, 2q),
// which exceeds 32 bits for q3, so it is formed in 64 bits.  The pointwise
// product of two variables is one Montgomery multiply (a * b * 2^-32 mod q);
// the 2^32 comes back in the inverse's final scale (n^-1 * 2^32 mod q).
// Nothing uses a 64-bit division.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kQ1 = 2013265921u;  // 15 * 2^27 + 1
constexpr uint32_t kQ2 = 1811939329u;  // 27 * 2^26 + 1
constexpr uint32_t kQ3 = 2281701377u;  // 17 * 2^27 + 1
constexpr uint32_t kP = 4294967291u;   // 2^32 - 5
constexpr int kSmemN = 4096;           // residues of one prime a pass holds; n above it: four-step
constexpr int kMaxCols = 2;            // transforms of one prime a CUDA block holds
constexpr int kThreads = 512;

// flags (ops/ntt.py: _K6_FLAGS)
constexpr uint32_t kInInt64 = 1;     // input int64 words < 2^32, reduced mod q (else uint32 residues)
constexpr uint32_t kInProduct = 2;   // input mont(in, in2): the pointwise product
constexpr uint32_t kInverse = 4;     // inverse roots w^-e
constexpr uint32_t kTwiddle = 8;     // after the transform, x (t, i) times w_n^(+-t * i): four-step
constexpr uint32_t kScale = 16;      // times n^-1
constexpr uint32_t kScaleMont = 32;  // times n^-1 * 2^32 (after a Montgomery product)
constexpr uint32_t kOutInt64 = 64;   // store int64 residues (else uint32)
constexpr uint32_t kOutCrt = 128;    // store the CRT of the three primes mod p, int64

constexpr uint32_t shoup(uint32_t w, uint32_t q) {
  return static_cast<uint32_t>((static_cast<uint64_t>(w) << 32) / q);
}
constexpr uint32_t neg_inv32(uint32_t q) {  // -q^-1 mod 2^32 (Newton: 5 steps double the bits)
  uint32_t x = q;
  for (int i = 0; i < 5; ++i) x *= 2u - q * x;
  return 0u - x;
}
constexpr uint64_t powmod(uint64_t b, uint64_t e, uint64_t m) {
  uint64_t r = 1;
  for (b %= m; e; e >>= 1, b = b * b % m)
    if (e & 1) r = r * b % m;
  return r;
}
// Garner's constants
constexpr uint32_t kInvQ1ModQ2 = static_cast<uint32_t>(powmod(kQ1, kQ2 - 2, kQ2));
constexpr uint32_t kInvQ1Q2ModQ3 = static_cast<uint32_t>(
    powmod(static_cast<uint64_t>(kQ1) * kQ2 % kQ3, kQ3 - 2, kQ3));
constexpr uint32_t kQ1ModP = kQ1;  // q1 < p
constexpr uint32_t kQ1Q2ModP = static_cast<uint32_t>(static_cast<uint64_t>(kQ1) * kQ2 % kP);
// evaluated here, on the host compiler's side: device code reads only the values
constexpr uint32_t kQinv1 = neg_inv32(kQ1), kQinv2 = neg_inv32(kQ2), kQinv3 = neg_inv32(kQ3);
constexpr uint32_t kInvQ1ModQ2S = shoup(kInvQ1ModQ2, kQ2), kQ1S = shoup(kQ1, kQ3);
constexpr uint32_t kInvQ1Q2ModQ3S = shoup(kInvQ1Q2ModQ3, kQ3);
constexpr uint32_t kQ1ModPS = shoup(kQ1ModP, kP), kQ1Q2ModPS = shoup(kQ1Q2ModP, kP);

__device__ __forceinline__ uint32_t prime(int pi) { return pi == 0 ? kQ1 : pi == 1 ? kQ2 : kQ3; }

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;  // a, b < q: the true sum < 2q, which wraps 32 bits for q3
  return (s < a || s >= q) ? s - q : s;
}
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a - b + q;
}
// x * w mod q for any x < 2^32 and w < q, w' = shoup(w, q)
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w, uint32_t wp, uint32_t q) {
  const uint32_t qhat = __umulhi(x, wp);
  const uint64_t r = static_cast<uint64_t>(x) * w - static_cast<uint64_t>(qhat) * q;  // [0, 2q)
  return static_cast<uint32_t>(r >= q ? r - q : r);
}
// a * b * 2^-32 mod q for a, b < q: t + m * q < q * (q + 2^32) < 2^64
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * (q == kQ1 ? kQinv1 : q == kQ2 ? kQinv2 : kQinv3);
  const uint64_t u = (t + static_cast<uint64_t>(m) * q) >> 32;  // < 2q
  return static_cast<uint32_t>(u >= q ? u - q : u);
}
// a word < 2^32 mod q: q > 2^32 / 3 for the three primes, so two subtractions
__device__ __forceinline__ uint32_t reduce_u32(uint32_t x, uint32_t q) {
  if (x >= q) x -= q;
  return x >= q ? x - q : x;
}
// residues mod (q1, q2, q3) -> value mod p (value < q1 q2 q3), Garner:
// x = r1 + q1 t2 + q1 q2 t3
__device__ __forceinline__ int64_t crt_mod_p(uint32_t r1, uint32_t r2, uint32_t r3) {
  const uint32_t r1q2 = r1 >= kQ2 ? r1 - kQ2 : r1;  // r1 < q1 < 2 q2
  const uint32_t t2 = mul_shoup(sub_mod(r2, r1q2, kQ2), kInvQ1ModQ2, kInvQ1ModQ2S, kQ2);
  const uint32_t u = sub_mod(sub_mod(r3, r1, kQ3), mul_shoup(t2, kQ1, kQ1S, kQ3), kQ3);
  const uint32_t t3 = mul_shoup(u, kInvQ1Q2ModQ3, kInvQ1Q2ModQ3S, kQ3);
  uint64_t x = static_cast<uint64_t>(r1) + mul_shoup(t2, kQ1ModP, kQ1ModPS, kP) +
               mul_shoup(t3, kQ1Q2ModP, kQ1Q2ModPS, kP);  // < 3p
  if (x >= kP) x -= kP;
  if (x >= kP) x -= kP;
  return static_cast<int64_t>(x);
}

struct Pass {
  const void* in;   // int64 rows (kInInt64) or uint32 residues [np, rows, n] at in_pstride
  const void* in2;  // int64: rows [rows_a, rows) of the input; product: the second factor
  void* out;        // uint32 or int64 residues at out_pstride, or int64 [rows, n] (kOutCrt)
  const uint32_t* table;  // per prime [2n + 4]: w^e, shoup(w^e), n^-1 and n^-1 2^32 with theirs
  int64_t rows, rows_a, len_a, len_b, in_pstride, out_pstride, n, istride, tstride;
  int L, log_l, cols, p0, np;
  uint32_t flags;
};

__device__ __forceinline__ const uint32_t* prime_table(const Pass& a, int pi) {
  return a.table + static_cast<int64_t>(pi) * (2 * a.n + 4);
}

// element i of transform c of the block at position k of a prime's tile:
// consecutive threads take consecutive addresses of device memory
__device__ __forceinline__ void split(const Pass& a, int k, int& c, int& i) {
  if (a.istride == 1) {
    c = k / a.L;
    i = k % a.L;
  } else {
    i = k / a.cols;
    c = k % a.cols;
  }
}

__device__ __forceinline__ uint32_t load(const Pass& a, int pl, int64_t r, int64_t e, uint32_t q) {
  if (a.flags & kInInt64) {
    const bool first = r < a.rows_a;
    const int64_t len = first ? a.len_a : a.len_b;
    if (e >= len) return 0u;  // the zero padding to n
    const int64_t* src = static_cast<const int64_t*>(first ? a.in : a.in2);
    return reduce_u32(static_cast<uint32_t>(src[pl * a.in_pstride + (first ? r : r - a.rows_a) * len + e]), q);
  }
  const int64_t off = pl * a.in_pstride + r * a.n + e;
  const uint32_t x = static_cast<const uint32_t*>(a.in)[off];
  return (a.flags & kInProduct) ? mont_mul(x, static_cast<const uint32_t*>(a.in2)[off], q) : x;
}

// w_n^(+-e) and its Shoup companion
__device__ __forceinline__ void root(const uint32_t* tab, int64_t n, int64_t e, bool inverse,
                                     uint32_t& w, uint32_t& wp) {
  if (inverse && e) e = n - e;
  w = __ldg(tab + e);
  wp = __ldg(tab + n + e);
}

// the twiddle and the scale after the transform: element i of transform t
__device__ __forceinline__ uint32_t finish(const Pass& a, int pi, int64_t t, int i, uint32_t y) {
  const uint32_t q = prime(pi);
  const uint32_t* tab = prime_table(a, pi);
  if (a.flags & kTwiddle) {
    uint32_t w, wp;
    root(tab, a.n, t * i, a.flags & kInverse, w, wp);  // t * i < n
    y = mul_shoup(y, w, wp, q);
  }
  if (a.flags & (kScale | kScaleMont)) {
    const int64_t s = 2 * a.n + ((a.flags & kScaleMont) ? 2 : 0);
    y = mul_shoup(y, tab[s], tab[s + 1], q);
  }
  return y;
}

// a pass without the CRT spreads its primes over blockIdx.z: one a block
__device__ __forceinline__ Pass prime_of_block(const Pass& all) {
  if (gridDim.z == 1) return all;
  Pass a = all;
  const int64_t z = blockIdx.z;
  const bool in64 = a.flags & kInInt64;
  a.in = in64 ? static_cast<const void*>(static_cast<const int64_t*>(a.in) + z * a.in_pstride)
              : static_cast<const void*>(static_cast<const uint32_t*>(a.in) + z * a.in_pstride);
  a.in2 = in64 ? static_cast<const void*>(static_cast<const int64_t*>(a.in2) + z * a.in_pstride)
               : static_cast<const void*>(static_cast<const uint32_t*>(a.in2) + z * a.in_pstride);
  a.out = (a.flags & kOutInt64) ? static_cast<void*>(static_cast<int64_t*>(a.out) + z * a.out_pstride)
                                : static_cast<void*>(static_cast<uint32_t*>(a.out) + z * a.out_pstride);
  a.p0 += static_cast<int>(z);
  a.np = 1;
  return a;
}

__global__ void __launch_bounds__(kThreads) ntt_pass_kernel(const Pass all) {
  extern __shared__ uint32_t tile[];  // [np][cols][L]
  const Pass a = prime_of_block(all);
  const int64_t r = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * a.cols;
  const int per = a.cols * a.L;
  const bool inverse = a.flags & kInverse;

  for (int k = threadIdx.x; k < a.np * per; k += kThreads) {
    const int pl = k / per;
    int c, i;
    split(a, k % per, c, i);
    const int64_t e = (t0 + c) * a.tstride + i * a.istride;
    const int rev = a.log_l ? static_cast<int>(__brev(static_cast<uint32_t>(i)) >> (32 - a.log_l)) : 0;
    tile[pl * per + c * a.L + rev] = load(a, pl, r, e, prime(a.p0 + pl));
  }
  __syncthreads();

  const int halves = a.L / 2;
  for (int st = 1; st <= a.log_l; ++st) {
    const int half = 1 << (st - 1);
    for (int b = threadIdx.x; b < a.np * a.cols * halves; b += kThreads) {
      const int seg = b / halves, j0 = b % halves;  // seg = pl * cols + c
      const int pi = a.p0 + seg / a.cols;
      const int j = j0 & (half - 1);
      const int i0 = 2 * (j0 - j) + j;
      const uint32_t q = prime(pi);
      uint32_t w, wp;
      root(prime_table(a, pi), a.n, static_cast<int64_t>(j) * (a.n >> st), inverse, w, wp);
      uint32_t* x = tile + seg * a.L;
      const uint32_t u = x[i0], v = mul_shoup(x[i0 + half], w, wp, q);
      x[i0] = add_mod(u, v, q);
      x[i0 + half] = sub_mod(u, v, q);
    }
    __syncthreads();
  }

  if (a.flags & kOutCrt) {  // np == 3
    int64_t* out = static_cast<int64_t*>(a.out);
    for (int k = threadIdx.x; k < per; k += kThreads) {
      int c, i;
      split(a, k, c, i);
      const int64_t t = t0 + c;
      uint32_t y[3];
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) y[pl] = finish(a, pl, t, i, tile[pl * per + c * a.L + i]);
      out[r * a.n + t * a.tstride + i * a.istride] = crt_mod_p(y[0], y[1], y[2]);
    }
    return;
  }
  for (int k = threadIdx.x; k < a.np * per; k += kThreads) {
    const int pl = k / per;
    int c, i;
    split(a, k % per, c, i);
    const int64_t t = t0 + c;
    const uint32_t y = finish(a, a.p0 + pl, t, i, tile[pl * per + c * a.L + i]);
    const int64_t off = pl * a.out_pstride + r * a.n + t * a.tstride + i * a.istride;
    if (a.flags & kOutInt64)
      static_cast<int64_t*>(a.out)[off] = y;
    else
      static_cast<uint32_t*>(a.out)[off] = y;
  }
}

}  // namespace

// One pass over rows x (n / L) transforms of length L of primes p0 .. p0 + np - 1.
// Element i of transform t lies at t * tstride + i * istride of a row.
// n, L: powers of two, 2 <= L <= min(n, kSmemN); kOutCrt needs p0 = 0, np = 3.
extern "C" int cls_ntt_pass(const void* in, const void* in2, void* out, const void* table,
                            int64_t rows, int64_t rows_a, int64_t len_a, int64_t len_b,
                            int64_t in_pstride, int64_t out_pstride, int64_t n, int64_t L,
                            int64_t istride, int64_t tstride, uint32_t flags, uint32_t p0,
                            uint32_t np, void* stream) {
  if (n < 2 || (n & (n - 1)) || L < 2 || (L & (L - 1)) || L > n || L > kSmemN || rows < 1 ||
      rows > 65535 || np < 1 || p0 + np > 3 || ((flags & kOutCrt) && (p0 != 0 || np != 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  Pass a;
  a.in = in;
  a.in2 = in2;
  a.out = out;
  a.table = static_cast<const uint32_t*>(table);
  a.rows = rows;
  a.rows_a = rows_a;
  a.len_a = len_a;
  a.len_b = len_b;
  a.in_pstride = in_pstride;
  a.out_pstride = out_pstride;
  a.n = n;
  a.istride = istride;
  a.tstride = tstride;
  a.L = static_cast<int>(L);
  a.log_l = 0;
  while ((1 << a.log_l) < L) ++a.log_l;
  const int64_t transforms = n / L;
  int64_t cols = kSmemN / L < kMaxCols ? kSmemN / L : kMaxCols;
  if (cols > transforms) cols = transforms;
  a.cols = static_cast<int>(cols);
  a.p0 = static_cast<int>(p0);
  a.np = static_cast<int>(np);
  a.flags = flags;
  // the CRT needs a block's three primes together; any other pass takes one a block
  const unsigned per_block = (flags & kOutCrt) ? np : 1;
  const size_t smem = static_cast<size_t>(per_block) * cols * L * sizeof(uint32_t);  // <= 48 KiB
  const dim3 grid(static_cast<unsigned>(transforms / cols), static_cast<unsigned>(rows),
                  np / per_block);
  ntt_pass_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
