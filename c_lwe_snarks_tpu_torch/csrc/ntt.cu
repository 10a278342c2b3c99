// K6: the prime-batched CRT-NTT of the polynomial engine mod p = 2^32 - 5
// (ops/ntt.py), as three entry points:
//
//   cls_ntt_newton  every Newton level of a power-series inverse whose
//                   product length n is at most N (<= kNewtonMaxN) in ONE
//                   launch: a cluster of three CTAs (one a prime) a row;
//   cls_ntt_pass    one pass of transforms over the primes and the batch:
//                   a whole transform (n <= kSmemN), or the column passes
//                   of a four-step (forward; inverse with the scale and the
//                   CRT to mod p);
//   cls_ntt_rows    the four-step's fused row pass of a product: forward
//                   rows of both operands, the Montgomery pointwise
//                   product, inverse rows and their twiddle, in one block;
//   cls_ntt_levels  the Newton levels above N, issued from here: one host
//                   call for their six launches a level.
//
// So a product is two launches for n <= kSmemN and three above; a Newton
// level above N is two products, the second reusing the first's forward
// transform of s (kRowStoreB, then kRowBHat).
//
// Replaces the jnp code c_lwe_snarks_tpu/ops/ntt.py:_poly_mul_batched
// (_ntt_core_v, crt_to_mod_p) and poly_inv_series_mod_p, which the JAX
// package compiles into one device program; the port's plain versions are
// ops/ntt.py:_poly_mul_plain and _newton_plain.
//
// Bound on the H100: at the prover's sizes (n <= 2^16, three primes) the
// work is ~10^8 32-bit operations and ~2 MB a product, a few microseconds
// either way, against a launch's few microseconds and the host's ~10-40 us
// of issue a call.  So the design cuts launches and host calls first: the
// eleven Newton levels up to n = 4,096 (22 products) are one launch, whose
// CTAs keep every array in shared memory and exchange the CRT's residues
// through distributed shared memory, and a four-step product is three
// launches.  Inside each pass a thread takes four elements and two radix-2
// stages at a time (radix 4, one barrier a pair of stages), the stage
// twiddles sit in shared memory, one stage's side by side (tm[h + j] =
// w_2h^j: no bank conflict), and the loads are coalesced (the row pass: 16
// bytes a thread).
//
// Order: forward transforms are decimation in frequency (natural order in,
// bit-reversed out), inverse transforms of a product decimation in time
// (bit-reversed in, natural out), so a product never permutes; a pass that
// stores one transform reads its bit-reversed tile.  An inverse uses the
// forward table: w_2h^-j = -w_2h^(h - j) for 0 < j < h.  The four-step: n =
// n1 * n2, the column transforms (length n1, stride n2) times w_n^(j2 k1),
// then the row transforms (length n2), which leave X[k1 + n1 k2] at
// [k1, k2]; the pointwise product does not care about order, and the
// inverse undoes the same steps in reverse.
//
// Arithmetic: residues are uint32.  q3 = 2,281,701,377 > 2^31, so a + b can
// wrap 32 bits: add_mod catches the wrap (the NTT's counterpart of the
// double-wrap of mod-p adds).  A butterfly's twiddle is kept as w * 2^32 mod
// q and applied by one Montgomery multiply (x * w' * 2^-32 mod q: t + m * q <
// q (q + 2^32) < 2^64); so is the pointwise product of two variables, whose
// 2^-32 comes back in the inverse's final scale (n^-1 * 2^32 mod q).  The
// four-step twiddles, the scales and Garner's constants multiply with
// Shoup's precomputed quotient w' = floor(w * 2^32 / q): the remainder
// x * w - qhat * q lies in [0, 2q), which exceeds 32 bits for q3, so it is
// formed in 64 bits.  Nothing uses a 64-bit division.
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kQ1 = 2013265921u;  // 15 * 2^27 + 1
constexpr uint32_t kQ2 = 1811939329u;  // 27 * 2^26 + 1
constexpr uint32_t kQ3 = 2281701377u;  // 17 * 2^27 + 1
constexpr uint32_t kP = 4294967291u;   // 2^32 - 5
constexpr int kSmemN = 4096;           // longest transform a pass holds; n above it: four-step
constexpr int kPassTile = 2048;        // residues of one prime a pass block takes (at least one transform)
constexpr int kRowTile = 1024;         // residues of one operand a row-pass block takes
constexpr int kThreads = 256;          // threads of a pass block
constexpr int kMinBlocks = 256;        // a pass narrows its tiles until its grid has this many blocks
constexpr int kNewtonMaxN = 16384;     // the longest product the Newton launch holds (3.5 N words a CTA)
constexpr int kNewtonThreads = 1024;
constexpr int kNewtonCluster = 3;      // CTAs of a Newton cluster: one a prime

// pass flags (ops/ntt.py: _IN_INT64 ...)
constexpr uint32_t kInInt64 = 1;     // input int64 words < 2^32, reduced mod q (else uint32 residues)
constexpr uint32_t kInProduct = 2;   // input mont(in, in2): the pointwise product
constexpr uint32_t kInverse = 4;     // inverse roots w^-e
constexpr uint32_t kTwiddle = 8;     // after the transform, x (t, i) times w_n^(+-t * i): four-step
constexpr uint32_t kScale = 16;      // times n^-1
constexpr uint32_t kScaleMont = 32;  // times n^-1 * 2^32 (after a Montgomery product)
constexpr uint32_t kOutInt64 = 64;   // store int64 residues (else uint32)
constexpr uint32_t kOutCrt = 128;    // store the CRT of the three primes mod p, int64
constexpr uint32_t kTwoMinus = 256;  // with kOutCrt: store 2 - x (coefficient 0) or -x mod p
// row-pass flags (ops/ntt.py: _ROW_SQUARE ...)
constexpr uint32_t kRowSquare = 1;  // the second operand is the first
constexpr uint32_t kRowStoreB = 2;  // write the second operand's forward rows to bhat
constexpr uint32_t kRowBHat = 4;    // the second operand's rows are bhat's, already forward

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
__device__ __forceinline__ uint32_t crt_mod_p(uint32_t r1, uint32_t r2, uint32_t r3) {
  const uint32_t r1q2 = r1 >= kQ2 ? r1 - kQ2 : r1;  // r1 < q1 < 2 q2
  const uint32_t t2 = mul_shoup(sub_mod(r2, r1q2, kQ2), kInvQ1ModQ2, kInvQ1ModQ2S, kQ2);
  const uint32_t u = sub_mod(sub_mod(r3, r1, kQ3), mul_shoup(t2, kQ1, kQ1S, kQ3), kQ3);
  const uint32_t t3 = mul_shoup(u, kInvQ1Q2ModQ3, kInvQ1Q2ModQ3S, kQ3);
  uint64_t x = static_cast<uint64_t>(r1) + mul_shoup(t2, kQ1ModP, kQ1ModPS, kP) +
               mul_shoup(t3, kQ1Q2ModP, kQ1Q2ModPS, kP);  // < 3p
  if (x >= kP) x -= kP;
  if (x >= kP) x -= kP;
  return static_cast<uint32_t>(x);
}
// 2 - x (coefficient 0) or -x mod p, x < p
__device__ __forceinline__ uint32_t two_minus(uint32_t x, bool first) {
  const uint64_t y = static_cast<uint64_t>(first ? 2u : 0u) + kP - x;  // (0, p + 2]
  return static_cast<uint32_t>(y >= kP ? y - kP : y);
}

// ---- radix-4 stages in shared memory ---------------------------------------

// One prime's modulus, -q^-1 mod 2^32 and its stage table: tm[h + j] =
// w_2h^j * 2^32 mod q for the stage of half h (a power of two) and j < h, so
// a stage's twiddles lie side by side (no bank conflict) and a twiddle is one
// Montgomery multiply.
struct Prime {
  uint32_t q, qinv;
  const uint32_t* tm;
};

__device__ __forceinline__ uint32_t qinv_of(int pi) { return pi == 0 ? kQinv1 : pi == 1 ? kQinv2 : kQinv3; }

// x * w for x < q and the table entry w * 2^32 mod q
__device__ __forceinline__ uint32_t mul_tw(uint32_t x, uint32_t wm, const Prime& p) {
  const uint64_t t = static_cast<uint64_t>(x) * wm;
  const uint32_t m = static_cast<uint32_t>(t) * p.qinv;
  const uint64_t u = (t + static_cast<uint64_t>(m) * p.q) >> 32;  // < 2q
  return static_cast<uint32_t>(u >= p.q ? u - p.q : u);
}
// w_2h^(+-j), j < h: w_2h^-j = -w_2h^(h - j) for j > 0
__device__ __forceinline__ uint32_t twiddle(const Prime& p, int h, int j, bool inverse, bool& neg) {
  neg = inverse && j != 0;
  return p.tm[h + (neg ? h - j : j)];
}
// decimation in frequency: (u, v) -> (u + v, (u - v) w_2h^(+-j))
__device__ __forceinline__ void bf_dif(uint32_t& u, uint32_t& v, const Prime& p, int h, int j,
                                       bool inverse) {
  bool neg;
  const uint32_t w = twiddle(p, h, j, inverse, neg);
  const uint32_t s = add_mod(u, v, p.q);
  const uint32_t d = neg ? sub_mod(v, u, p.q) : sub_mod(u, v, p.q);
  u = s;
  v = mul_tw(d, w, p);
}
// decimation in time: (u, v) -> (u + v w_2h^(+-j), u - v w_2h^(+-j))
__device__ __forceinline__ void bf_dit(uint32_t& u, uint32_t& v, const Prime& p, int h, int j,
                                       bool inverse) {
  bool neg;
  const uint32_t t = mul_tw(v, twiddle(p, h, j, inverse, neg), p);
  const uint32_t a = add_mod(u, t, p.q), b = sub_mod(u, t, p.q);
  u = neg ? b : a;
  v = neg ? a : b;
}

// In place on ntr transforms of length L = 2^log_l (transform t at x + t * ld,
// of prime prime_of(t)), all threads of the block: DIF takes natural order
// and leaves bit-reversed order, DIT the converse.  An odd log_l takes one
// radix-2 stage first; then a thread takes four elements x[b + {0, g, 2g,
// 3g}] and the two stages of halves 2g and g (DIF) or g and 2g (DIT).  Ends
// with a barrier.
template <bool kDif, class PrimeOf>
__device__ __forceinline__ void stages(uint32_t* x, int ld, int ntr, int log_l, bool inverse, PrimeOf prime_of) {
  const int half = 1 << (log_l - 1);
  int todo = log_l;
  if (log_l & 1) {
    const int h = kDif ? half : 1;
    for (int k = threadIdx.x; k < ntr * half; k += blockDim.x) {
      const int t = k >> (log_l - 1), j0 = k & (half - 1);
      const int j = j0 & (h - 1), i0 = 2 * (j0 - j) + j;
      const Prime p = prime_of(t);
      uint32_t* y = x + t * ld;
      uint32_t u = y[i0], v = y[i0 + h];
      if (kDif)
        bf_dif(u, v, p, h, j, inverse);
      else
        bf_dit(u, v, p, h, j, inverse);
      y[i0] = u;
      y[i0 + h] = v;
    }
    __syncthreads();
    --todo;
  }
  const int quarter = half >> 1;
  for (int pr = 0; pr < todo / 2; ++pr) {
    const int lg = kDif ? log_l - (log_l & 1) - 2 - 2 * pr : (log_l & 1) + 2 * pr;  // log2 g
    const int g = 1 << lg;
    for (int k = threadIdx.x; k < ntr * quarter; k += blockDim.x) {
      const int t = k >> (log_l - 2), r = k & (quarter - 1);
      const int j = r & (g - 1), b = 4 * (r - j) + j;
      const Prime p = prime_of(t);
      uint32_t* y = x + t * ld + b;
      uint32_t x0 = y[0], x1 = y[g], x2 = y[2 * g], x3 = y[3 * g];
      if (kDif) {  // w_4g^j, w_4g^(j + g), then w_2g^j
        bf_dif(x0, x2, p, 2 * g, j, inverse);
        bf_dif(x1, x3, p, 2 * g, j + g, inverse);
        bf_dif(x0, x1, p, g, j, inverse);
        bf_dif(x2, x3, p, g, j, inverse);
      } else {
        bf_dit(x0, x1, p, g, j, inverse);
        bf_dit(x2, x3, p, g, j, inverse);
        bf_dit(x0, x2, p, 2 * g, j, inverse);
        bf_dit(x1, x3, p, 2 * g, j + g, inverse);
      }
      y[0] = x0;
      y[g] = x1;
      y[2 * g] = x2;
      y[3 * g] = x3;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int bitrev(int i, int log_l) {
  return log_l ? static_cast<int>(__brev(static_cast<uint32_t>(i)) >> (32 - log_l)) : 0;
}

// w_n^(+-e) from a full table of w_n^e, e < n, and its Shoup companion
__device__ __forceinline__ uint32_t times_root(const uint32_t* tab, int64_t n, int64_t e,
                                               bool inverse, uint32_t y, uint32_t q) {
  if (inverse && e) e = n - e;
  return mul_shoup(y, __ldg(tab + e), __ldg(tab + n + e), q);
}

// ---- cls_ntt_pass -----------------------------------------------------------

struct Pass {
  const void* in;   // int64 rows (kInInt64) or uint32 residues [np, rows, n] at in_pstride
  const void* in2;  // int64: rows [rows_a, rows) of the input; product: the second factor
  void* out;        // uint32 or int64 residues at out_pstride, or int64 [rows, out_len] (kOutCrt)
  const uint32_t* table;  // per prime [3n + 4]: w^e, shoup(w^e) (e < n), the stage table (n), then
                          // n^-1 and n^-1 2^32 with their Shoup companions
  int64_t rows, rows_a, len_a, len_b, lda, ldb, in_pstride, out_pstride, n, istride, tstride;
  int64_t out_len;
  int L, log_l, cols, log_cols, ld, p0, np;
  uint32_t flags;
};

__device__ __forceinline__ const uint32_t* prime_table(const Pass& a, int pi) {
  return a.table + static_cast<int64_t>(pi) * (3 * a.n + 4);
}

// element i of transform c of the block at position k of a prime's tile:
// consecutive threads take consecutive addresses of device memory
__device__ __forceinline__ void split(const Pass& a, int k, int& c, int& i) {
  if (a.istride == 1) {
    c = k >> a.log_l;
    i = k & (a.L - 1);
  } else {
    i = k >> a.log_cols;
    c = k & (a.cols - 1);
  }
}

__device__ __forceinline__ uint32_t load(const Pass& a, int pl, int64_t r, int64_t e, uint32_t q) {
  if (a.flags & kInInt64) {
    const bool first = r < a.rows_a;
    if (e >= (first ? a.len_a : a.len_b)) return 0u;  // the zero padding to n
    const int64_t* src = static_cast<const int64_t*>(first ? a.in : a.in2);
    const int64_t row = first ? r * a.lda : (r - a.rows_a) * a.ldb;
    return reduce_u32(static_cast<uint32_t>(src[pl * a.in_pstride + row + e]), q);
  }
  const int64_t off = pl * a.in_pstride + r * a.n + e;
  const uint32_t x = static_cast<const uint32_t*>(a.in)[off];
  return (a.flags & kInProduct) ? mont_mul(x, static_cast<const uint32_t*>(a.in2)[off], q) : x;
}

// the twiddle and the scale (sc: its value and Shoup companion) after the
// transform: element i of transform t
__device__ __forceinline__ uint32_t finish(const Pass& a, int pi, int64_t t, int i, uint32_t y,
                                           const uint32_t* sc) {
  const uint32_t q = prime(pi);
  if (a.flags & kTwiddle) y = times_root(prime_table(a, pi), a.n, t * i, a.flags & kInverse, y, q);
  if (a.flags & (kScale | kScaleMont)) y = mul_shoup(y, sc[0], sc[1], q);  // t * i < n above
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

// A block: one row of the batch, `cols` transforms of length L of one prime
// (all three with the CRT): coalesced natural-order load, radix-4 DIF in
// shared memory (forward or inverse), store of the bit-reversed tile in
// natural order with the twiddle, the scale and the CRT.
__global__ void __launch_bounds__(kThreads) ntt_pass_kernel(const Pass all) {
  extern __shared__ uint32_t sm[];  // [np][cols][ld] residues, then [np][L] twiddles
  __shared__ uint32_t scale[3][2];
  const Pass a = prime_of_block(all);
  const int64_t r = blockIdx.y;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * a.cols;
  const int per = a.cols * a.ld, elems = a.cols * a.L;
  const bool inverse = a.flags & kInverse;
  uint32_t* tw = sm + a.np * per;

  for (int k = threadIdx.x; k < a.np * a.L; k += kThreads) {  // the stage table's first L entries
    const int pl = k >> a.log_l;
    tw[k] = __ldg(prime_table(a, a.p0 + pl) + 2 * a.n + (k & (a.L - 1)));
  }
  if (threadIdx.x < 2 * a.np) {
    const int pl = threadIdx.x >> 1;
    const int64_t s = 3 * a.n + ((a.flags & kScaleMont) ? 2 : 0) + (threadIdx.x & 1);
    scale[pl][threadIdx.x & 1] = prime_table(a, a.p0 + pl)[s];
  }
  for (int k = threadIdx.x; k < a.np * elems; k += kThreads) {
    const int pl = k / elems;
    int c, i;
    split(a, k % elems, c, i);
    const int64_t e = (t0 + c) * a.tstride + i * a.istride;
    sm[pl * per + c * a.ld + i] = load(a, pl, r, e, prime(a.p0 + pl));
  }
  __syncthreads();
  const int cols = a.cols, L = a.L, p0 = a.p0;
  stages<true>(sm, a.ld, a.np * cols, a.log_l, inverse, [=](int t) {
    const int pl = t / cols;
    return Prime{prime(p0 + pl), qinv_of(p0 + pl), tw + pl * L};
  });

  if (a.flags & kOutCrt) {  // np == 3
    int64_t* out = static_cast<int64_t*>(a.out);
    for (int k = threadIdx.x; k < elems; k += kThreads) {
      int c, i;
      split(a, k, c, i);
      const int64_t t = t0 + c, e = t * a.tstride + i * a.istride;
      if (e >= a.out_len) continue;
      const int at = c * a.ld + bitrev(i, a.log_l);
      uint32_t y[3];
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) y[pl] = finish(a, pl, t, i, sm[pl * per + at], scale[pl]);
      uint32_t v = crt_mod_p(y[0], y[1], y[2]);
      if (a.flags & kTwoMinus) v = two_minus(v, e == 0);
      out[r * a.out_len + e] = v;
    }
    return;
  }
  for (int k = threadIdx.x; k < a.np * elems; k += kThreads) {
    const int pl = k / elems;
    int c, i;
    split(a, k % elems, c, i);
    const int64_t t = t0 + c;
    const uint32_t y =
        finish(a, a.p0 + pl, t, i, sm[pl * per + c * a.ld + bitrev(i, a.log_l)], scale[pl]);
    const int64_t off = pl * a.out_pstride + r * a.n + t * a.tstride + i * a.istride;
    if (a.flags & kOutInt64)
      static_cast<int64_t*>(a.out)[off] = y;
    else
      static_cast<uint32_t*>(a.out)[off] = y;
  }
}

// ---- cls_ntt_rows -----------------------------------------------------------

struct Rows {
  uint32_t* x;            // uint32 [3, *, n] at x_pstride: operand a's rows at r, b's at b_off + r
  uint32_t* bhat;         // uint32 [3, rows, n] at h_pstride: b's forward rows (kRowStoreB, kRowBHat)
  const uint32_t* table;  // the pass table of n
  int64_t x_pstride, h_pstride, b_off, n;
  int n1, n2, log_n2, R;
  uint32_t flags;
};

// A block: R rows (k1) of the four-step layout of one row of the batch and
// one prime, both operands: forward rows (DIF), the Montgomery product,
// inverse rows (DIT) and w_n^(-k1 j2), written over operand a.
// (No __launch_bounds__: with (kThreads) ptxas holds this kernel to 48
// registers and spills, with (kThreads, 1) it takes 162; without, 55 and no
// spill.)
__global__ void ntt_rows_kernel(const Rows a) {
  extern __shared__ uint32_t sm[];  // A [R][n2], B [R][n2], twiddles [n2]
  const int pi = blockIdx.z;
  const uint32_t q = prime(pi);
  const int per = a.R * a.n2;
  uint32_t* A = sm;
  uint32_t* B = sm + per;
  uint32_t* tw = sm + 2 * per;
  const uint32_t* tab = a.table + static_cast<int64_t>(pi) * (3 * a.n + 4);
  const int64_t k1_0 = static_cast<int64_t>(blockIdx.x) * a.R;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * a.n + k1_0 * a.n2;
  uint32_t* xa = a.x + pi * a.x_pstride + row;
  const bool square = a.flags & kRowSquare, bhat_in = a.flags & kRowBHat;
  const uint32_t* xb = bhat_in ? a.bhat + pi * a.h_pstride + row : xa + a.b_off * a.n;
  uint32_t* hb = a.bhat + pi * a.h_pstride + row;

  for (int j = threadIdx.x; j < a.n2; j += kThreads) tw[j] = __ldg(tab + 2 * a.n + j);
  for (int v = threadIdx.x; v < per / 4; v += kThreads) {
    reinterpret_cast<uint4*>(A)[v] = reinterpret_cast<const uint4*>(xa)[v];
    if (!square) reinterpret_cast<uint4*>(B)[v] = reinterpret_cast<const uint4*>(xb)[v];
  }
  __syncthreads();
  const Prime p{q, qinv_of(pi), tw};
  const auto same = [p](int) { return p; };
  stages<true>(A, a.n2, (square || bhat_in) ? a.R : 2 * a.R, a.log_n2, false, same);  // B = A + per
  if (a.flags & kRowStoreB)
    for (int v = threadIdx.x; v < per / 4; v += kThreads)
      reinterpret_cast<uint4*>(hb)[v] = reinterpret_cast<const uint4*>(B)[v];
  const uint32_t* F = square ? A : B;
  for (int i = threadIdx.x; i < per; i += kThreads) A[i] = mont_mul(A[i], F[i], q);
  __syncthreads();
  stages<false>(A, a.n2, a.R, a.log_n2, true, same);
  for (int v = threadIdx.x; v < per / 4; v += kThreads) {
    uint4 y = reinterpret_cast<const uint4*>(A)[v];
    // the four share k1 (n2 is a multiple of 4); k1 j2 < n
    const int64_t k1 = k1_0 + ((4 * v) >> a.log_n2), e = k1 * ((4 * v) & (a.n2 - 1));
    y.x = times_root(tab, a.n, e, true, y.x, q);
    y.y = times_root(tab, a.n, e + k1, true, y.y, q);
    y.z = times_root(tab, a.n, e + 2 * k1, true, y.z, q);
    y.w = times_root(tab, a.n, e + 3 * k1, true, y.w, q);
    reinterpret_cast<uint4*>(xa)[v] = y;
  }
}

// ---- cls_ntt_newton ---------------------------------------------------------

struct Newton {
  const int64_t* t;       // int64 [rows, ldt], the series (entries < p), lt of them
  const int64_t* seeds;   // int64 [rows]: t[0]^-1 mod p (kSeedTensor), else `seed` for every row
  int64_t* out;           // int64 [rows, 2^levels]: s mod x^(2^levels)
  const uint32_t* table;  // per prime [N + 2 (log N + 1)]: the stage table; then for
                          // log n = 0 .. log N: n^-1 2^32 mod q and its Shoup companion
  int64_t lt, ldt;
  uint32_t seed;
  int levels, N, log_n_max, seed_tensor;
};

// The CRT of the three CTAs' products, coefficients [0, k2): this CTA takes
// a third, reads the residues of the others through distributed shared
// memory, and writes each result (or 2 - it) into every CTA's P.
__device__ __forceinline__ void newton_crt(cg::cluster_group& cluster, uint32_t* X, uint32_t* P,
                                           const uint32_t* sc, int log_n, int k2, bool two,
                                           int rank) {
  cluster.sync();  // every CTA's inverse is done
  const uint32_t* xr[3];
  uint32_t* pr[3];
  uint32_t s[3], sp[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    xr[j] = cluster.map_shared_rank(X, j);
    pr[j] = cluster.map_shared_rank(P, j);
    s[j] = sc[2 * (j * 32 + log_n)];
    sp[j] = sc[2 * (j * 32 + log_n) + 1];
  }
  const int third = (k2 + 2) / 3, lo = rank * third, hi = min(k2, lo + third);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    uint32_t y[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) y[j] = mul_shoup(xr[j][i], s[j], sp[j], prime(j));
    uint32_t v = crt_mod_p(y[0], y[1], y[2]);
    if (two) v = two_minus(v, i == 0);
#pragma unroll
    for (int j = 0; j < 3; ++j) pr[j][i] = v;
  }
  cluster.sync();  // every P is whole; nobody reads X any more
}

// A cluster of three CTAs a row of the batch, CTA j computing mod prime j.
// Level k (s mod x^k -> mod x^2k, n = 4k, n = 2 at k = 1) in shared memory:
//   S = DIF(s), X = DIF(t mod x^2k); X = DIT^-1(X S)  -> ts;
//   CRT: P = 2 - ts mod x^2k (every CTA's P);
//   X = DIF(P); X = DIT^-1(X S)                       -> s (2 - ts);
//   CRT: P = s mod x^2k.
// S, the forward transform of s, serves both products.
__global__ void __launch_bounds__(kNewtonThreads) ntt_newton_kernel(const Newton a) {
  extern __shared__ uint32_t sm[];  // twiddles [N], S [N], X [N], P [N / 2], scales [3][32][2]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const uint32_t q = prime(rank);
  const int N = a.N;
  uint32_t* tw = sm;
  uint32_t* S = sm + N;
  uint32_t* X = S + N;
  uint32_t* P = X + N;
  uint32_t* sc = P + N / 2;
  const int64_t r = blockIdx.y;
  const int64_t* t = a.t + r * a.ldt;
  const int tabw = N + 2 * (a.log_n_max + 1);
  for (int i = threadIdx.x; i < N; i += blockDim.x) tw[i] = __ldg(a.table + rank * tabw + i);
  for (int i = threadIdx.x; i < 3 * (a.log_n_max + 1); i += blockDim.x) {
    const int j = i / (a.log_n_max + 1), ln = i % (a.log_n_max + 1);
    sc[2 * (j * 32 + ln)] = __ldg(a.table + j * tabw + N + 2 * ln);
    sc[2 * (j * 32 + ln) + 1] = __ldg(a.table + j * tabw + N + 2 * ln + 1);
  }
  if (threadIdx.x == 0) P[0] = a.seed_tensor ? static_cast<uint32_t>(a.seeds[r]) : a.seed;
  __syncthreads();

  const Prime p{q, qinv_of(rank), tw};
  const auto same = [p](int) { return p; };
  for (int lv = 0; lv < a.levels; ++lv) {
    const int k = 1 << lv, k2 = 2 * k;
    const int log_n = lv == 0 ? 1 : lv + 2, n = 1 << log_n;
    const int64_t tl = a.lt < k2 ? a.lt : k2;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      S[i] = i < k ? reduce_u32(P[i], q) : 0u;
      X[i] = i < tl ? reduce_u32(static_cast<uint32_t>(t[i]), q) : 0u;
    }
    __syncthreads();
    stages<true>(S, N, 2, log_n, false, same);  // S and X = S + N
    for (int i = threadIdx.x; i < n; i += blockDim.x) X[i] = mont_mul(X[i], S[i], q);
    __syncthreads();
    stages<false>(X, N, 1, log_n, true, same);
    newton_crt(cluster, X, P, sc, log_n, k2, true, rank);

    for (int i = threadIdx.x; i < n; i += blockDim.x) X[i] = i < k2 ? reduce_u32(P[i], q) : 0u;
    __syncthreads();
    stages<true>(X, N, 1, log_n, false, same);
    for (int i = threadIdx.x; i < n; i += blockDim.x) X[i] = mont_mul(X[i], S[i], q);
    __syncthreads();
    stages<false>(X, N, 1, log_n, true, same);
    newton_crt(cluster, X, P, sc, log_n, k2, false, rank);
  }
  const int kf = 1 << a.levels, third = (kf + 2) / 3, lo = rank * third;
  const int hi = min(kf, lo + third);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) a.out[r * kf + i] = P[i];
}

bool is_pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }
int log2i(int64_t x) {
  int l = 0;
  while ((int64_t{1} << l) < x) ++l;
  return l;
}

// dynamic shared memory past 48 KiB needs the kernel's attribute raised first
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

int pass_launch(const void* in, const void* in2, void* out, const void* table, int64_t rows,
                int64_t rows_a, int64_t len_a, int64_t len_b, int64_t lda, int64_t ldb,
                int64_t in_pstride, int64_t out_pstride, int64_t n, int64_t L, int64_t istride,
                int64_t tstride, int64_t out_len, uint32_t flags, uint32_t p0, uint32_t np,
                void* stream) {
  if (n < 2 || !is_pow2(n) || L < 2 || !is_pow2(L) || L > n || L > kSmemN || rows < 1 ||
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
  a.lda = lda;
  a.ldb = ldb;
  a.in_pstride = in_pstride;
  a.out_pstride = out_pstride;
  a.n = n;
  a.istride = istride;
  a.tstride = tstride;
  a.out_len = out_len;
  a.L = static_cast<int>(L);
  a.log_l = log2i(L);
  // the CRT needs a block's three primes together; any other pass takes one a block
  const unsigned per_block = (flags & kOutCrt) ? np : 1;
  const int64_t transforms = n / L;
  int64_t cols = kPassTile / L < 1 ? 1 : kPassTile / L;
  if (cols > transforms) cols = transforms;
  while (cols > 1 && transforms / cols * rows * (np / per_block) < kMinBlocks) cols >>= 1;
  a.cols = static_cast<int>(cols);
  a.log_cols = log2i(cols);
  a.ld = a.L + (istride != 1 ? 1 : 0);  // a column tile: odd pitch, so a warp's stores miss no bank
  a.p0 = static_cast<int>(p0);
  a.np = static_cast<int>(np);
  a.flags = flags;
  const size_t smem = per_block * (static_cast<size_t>(cols) * a.ld + L) * sizeof(uint32_t);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(ntt_pass_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(transforms / cols), static_cast<unsigned>(rows),
                  np / per_block);
  ntt_pass_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int rows_launch(void* x, void* bhat, const void* table, int64_t rows, int64_t b_off,
                int64_t x_pstride, int64_t h_pstride, int64_t n, int64_t n1, uint32_t flags,
                void* stream) {
  if (!is_pow2(n) || !is_pow2(n1) || n1 > n || n / n1 < 4 || n / n1 > kSmemN || rows < 1 ||
      rows > 65535 || ((flags & kRowStoreB) && (flags & (kRowBHat | kRowSquare))))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows a;
  a.x = static_cast<uint32_t*>(x);
  a.bhat = static_cast<uint32_t*>(bhat);
  a.table = static_cast<const uint32_t*>(table);
  a.x_pstride = x_pstride;
  a.h_pstride = h_pstride;
  a.b_off = b_off;
  a.n = n;
  a.n1 = static_cast<int>(n1);
  a.n2 = static_cast<int>(n / n1);
  a.log_n2 = log2i(a.n2);
  int64_t R = kRowTile / a.n2 < 1 ? 1 : kRowTile / a.n2;
  if (R > n1) R = n1;
  a.R = static_cast<int>(R);
  a.flags = flags;
  const size_t smem = (2 * static_cast<size_t>(R) * a.n2 + a.n2) * sizeof(uint32_t);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(ntt_rows_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n1 / R), static_cast<unsigned>(rows), 3);
  ntt_rows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int64_t split4(int64_t n) { return int64_t{1} << (log2i(n) - log2i(n) / 2); }  // n1

}  // namespace

// One pass over rows x (n / L) transforms of length L of primes p0 .. p0 + np - 1.
// Element i of transform t lies at t * tstride + i * istride of a row.
// n, L: powers of two, 2 <= L <= min(n, kSmemN); kOutCrt needs p0 = 0, np = 3.
extern "C" int cls_ntt_pass(const void* in, const void* in2, void* out, const void* table,
                            int64_t rows, int64_t rows_a, int64_t len_a, int64_t len_b,
                            int64_t lda, int64_t ldb, int64_t in_pstride, int64_t out_pstride,
                            int64_t n, int64_t L, int64_t istride, int64_t tstride,
                            int64_t out_len, uint32_t flags, uint32_t p0, uint32_t np,
                            void* stream) {
  return pass_launch(in, in2, out, table, rows, rows_a, len_a, len_b, lda, ldb, in_pstride,
                     out_pstride, n, L, istride, tstride, out_len, flags, p0, np, stream);
}

// The four-step's row pass of a product at length n = n1 * n2 over rows of
// the batch (n2 = n / n1 <= kSmemN, a multiple of 4), in place on operand a.
extern "C" int cls_ntt_rows(void* x, void* bhat, const void* table, int64_t rows, int64_t b_off,
                            int64_t x_pstride, int64_t h_pstride, int64_t n, int64_t n1,
                            uint32_t flags, void* stream) {
  return rows_launch(x, bhat, table, rows, b_off, x_pstride, h_pstride, n, n1, flags, stream);
}

// Newton levels k = k0, 2 k0, ..., k0 2^(levels-1) of the series inverse of
// each row of t (int64 [rows, lt]), each level's n = 4k above kSmemN: from s0
// (int64 [rows, k0]) to out (int64 [rows, k0 2^levels]), six launches a
// level, issued here so the host pays one call for all of them:
//   ts:          forward columns of t mod x^2k and s, the row pass (s's
//                forward rows kept in bhat), inverse columns with the CRT
//                storing 2 - ts (2k entries);
//   s (2 - ts):  forward columns of 2 - ts, the row pass with bhat, inverse
//                columns with the CRT storing s mod x^2k.
// tables: the pass tables of each level's n, one after another; ws: int32
// [11 rows n_max]: x [3, 2 rows, n] and bhat [3, rows, n] residues, then the
// int64 2 - ts and s [rows, n_max / 2] each.
extern "C" int cls_ntt_levels(const void* t, const void* s0, void* out, void* ws,
                              const void* tables, int64_t rows, int64_t lt, int64_t k0,
                              int64_t levels, void* stream) {
  if (!is_pow2(k0) || 4 * k0 <= kSmemN || levels < 1 || lt < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_max = (4 * k0) << (levels - 1);
  uint32_t* x = static_cast<uint32_t*>(ws);
  uint32_t* bhat = x + 6 * rows * n_max;
  int64_t* two = reinterpret_cast<int64_t*>(x + 9 * rows * n_max);
  int64_t* sbuf = two + rows * n_max / 2;
  const uint32_t* table = static_cast<const uint32_t*>(tables);
  constexpr uint32_t kFwd = kInInt64 | kTwiddle, kInv = kInverse | kScaleMont | kOutCrt;
  for (int64_t i = 0; i < levels; ++i) {
    const int64_t k = k0 << i, k2 = 2 * k, n = 4 * k, n1 = split4(n), r2 = 2 * rows;
    const void* s_in = i == 0 ? s0 : sbuf;
    void* s_out = i == levels - 1 ? out : sbuf;
    const int64_t ta = lt < k2 ? lt : k2;
    int err = pass_launch(t, s_in, x, table, r2, rows, ta, k, lt, k, 0, r2 * n, n, n1, n / n1, 1, n,
                          kFwd, 0, 3, stream);
    if (!err) err = rows_launch(x, bhat, table, rows, rows, r2 * n, rows * n, n, n1, kRowStoreB, stream);
    if (!err)
      err = pass_launch(x, x, two, table, rows, rows, n, n, n, n, r2 * n, 0, n, n1, n / n1, 1, k2,
                        kInv | kTwoMinus, 0, 3, stream);
    if (!err)
      err = pass_launch(two, two, x, table, rows, rows, k2, k2, k2, k2, 0, rows * n, n, n1, n / n1,
                        1, n, kFwd, 0, 3, stream);
    if (!err) err = rows_launch(x, bhat, table, rows, 0, rows * n, rows * n, n, n1, kRowBHat, stream);
    if (!err)
      err = pass_launch(x, x, s_out, table, rows, rows, n, n, n, n, rows * n, 0, n, n1, n / n1, 1, k2,
                        kInv, 0, 3, stream);
    if (err) return err;
    table += 3 * (3 * n + 4);
  }
  return 0;
}

// Newton levels k = 1, 2, ..., 2^(levels-1) of the power-series inverse of
// each row of t (one cluster of three CTAs a row), every level's product
// length 4k (2 at k = 1) at most N, 4 <= N <= kNewtonMaxN (P holds N / 2 >= 2k
// coefficients).  out: int64 [rows, 2^levels].
extern "C" int cls_ntt_newton(const void* t, const void* seeds, void* out, const void* table,
                              int64_t rows, int64_t lt, int64_t ldt, int64_t levels, int64_t N,
                              uint32_t seed, uint32_t seed_tensor, void* stream) {
  if (!is_pow2(N) || N < 4 || N > kNewtonMaxN || levels < 1 || levels > 30 ||
      (levels > 1 && (int64_t{1} << (levels + 1)) > N) || rows < 1 || rows > 65535 || lt < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Newton a;
  a.t = static_cast<const int64_t*>(t);
  a.seeds = static_cast<const int64_t*>(seeds);
  a.out = static_cast<int64_t*>(out);
  a.table = static_cast<const uint32_t*>(table);
  a.lt = lt;
  a.ldt = ldt;
  a.seed = seed;
  a.levels = static_cast<int>(levels);
  a.N = static_cast<int>(N);
  a.log_n_max = log2i(N);
  a.seed_tensor = seed_tensor ? 1 : 0;
  const size_t smem = (static_cast<size_t>(N) * 7 / 2 + 3 * 32 * 2) * sizeof(uint32_t);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(ntt_newton_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kNewtonCluster, static_cast<unsigned>(rows), 1);
  cfg.blockDim = dim3(kNewtonThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kNewtonCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ntt_newton_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
