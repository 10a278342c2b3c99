// Conflict-free T-table AES-256-CTR core of every table kernel of the port:
// K1 and K2 (keystream.cu), K3 and K4 (eval_fused.cu).
//
// Block layout (reference src/aes.c:104-144): nonce (8 bytes LE) || counter
// (8 bytes LE); the keystream is E_k(block) for consecutive 64-bit counters.
// The state words of the T-table form are big-endian columns, so the LE
// nonce and counter words are byte-swapped on the way in.
//
// A textbook core indexes four 1 KiB tables with random bytes, so the 32
// loads of a warp fall on the 32 shared-memory banks at random and every
// load is replayed a few times; and each lookup costs four integer
// operations of address arithmetic (shift, mask, scale, add the base),
// which is what bounds such a core on this card: the integer pipe issues a
// warp's operation every second clock.
//
// Here entry x of the table is 256 bytes: 32 copies of Te0[x], one per
// lane, then 32 copies of Te2[x].  Lane L of a warp reads only word L (or
// 32 + L) of an entry, so it always hits bank L and every load issues once
// (the replicated layout of Tezcan, "Optimization of Advanced Encryption
// Standard on Graphics Processing Units", IEEE Access 2021).  The table
// sits at byte 0x10000 of the block's shared-memory window, a multiple of
// 64 KiB, so the address of a lookup is (window byte 2, x, 4 * L) as bytes:
// ONE byte permute (PRMT) of the state word and a per-lane constant makes
// it, with no shift, mask, scale or add; Te2 is the same address plus an
// immediate 128.  Te1 and Te3 are Te0 and Te2 rotated by a byte, and the
// rotation distributes over XOR, so a state word takes one rotation:
// Te0[a] ^ Te2[c] ^ rk ^ ror8(Te0[b] ^ Te2[d]).  The last round takes S[x]
// from the middle bytes of Te0[x] = (2S, S, S, 3S), so no S-box table is
// needed.  The round keys are a kernel parameter: they sit in the constant
// bank and reach the XORs as instruction operands, with no load (a
// table core reads 60 shared-memory words a block for them).  The last round key
// comes byte-swapped, so the output words are assembled little-endian.
//
// Per 16-byte block: 224 shared-memory loads (each one issue) and about
// 8 integer operations a state word and round (4 addresses, 1 rotation, 3
// XORs), ~450 in all, against a four-table core's 284 loads and ~900.
// NB blocks are encrypted side by side in one thread for instruction-level
// parallelism: the 16 loads of a round depend on the whole previous round.
//
// A kernel that uses the core declares no static shared memory and finds
// the window's start with cf_window().  Its dynamic shared memory begins
// behind the bytes the system reserves at the window's start (1 KiB a block
// on this card): the kernel may use the bytes from there up to the table,
// and whatever it places behind the table's 64 KiB.  Its launcher calls
// cf_configure(), which checks that layout on the host (no static shared
// memory, the reserve plus the bytes before the table end at or before
// 0x10000), sizes the dynamic request from that real start and raises the
// kernel's limit; a layout that does not fit comes back as a CUDA error
// code, before any launch.
#pragma once

#include "aes_core.cuh"

#include <cstring>

namespace cls {

constexpr uint32_t kCfTableAddr = 0x10000;   // the table's byte address in the shared window
constexpr uint32_t kCfAfterTable = 0x20000;  // first byte behind the table's 64 KiB

struct RoundKeys {
  uint32_t w[56];       // big-endian words of round keys 0..13
  uint32_t last_le[4];  // round key 14, little-endian (byte-swapped) words
};

// rk_host: 60 words on the host in RoundKeys' layout (ops/aes.py:AESKey.rk_param).
inline RoundKeys round_keys(const void* rk_host) {
  RoundKeys rk;
  std::memcpy(&rk, rk_host, sizeof(rk));
  return rk;
}

// Generic pointer to byte 0 of the block's shared-memory window, from the
// start of its dynamic shared memory.  The bytes between that start and the
// table are the kernel's to use: it says how many it takes.  cf_configure()
// has checked on the host that they fit; the trap only keeps a runtime that
// placed the dynamic memory elsewhere from corrupting the table silently.
__device__ __forceinline__ uint8_t* cf_window(void* dynamic_smem, uint32_t bytes_before_table) {
  const uint32_t start = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (start + bytes_before_table > kCfTableAddr) __trap();
  return static_cast<uint8_t*>(dynamic_smem) - start;
}

// Host side, before a launch: *dynamic_bytes is the dynamic shared memory
// that reaches from the window's real start (behind the system's reserve)
// to bytes_after_table behind the table, and the kernel's limit is raised
// to it.  Fails with cudaErrorInvalidConfiguration if the kernel has static
// shared memory (it would move the start) or if the reserve and the bytes
// the kernel takes before the table would run into the table.
template <class Kernel>
inline cudaError_t cf_configure(Kernel* kernel, uint32_t bytes_before_table,
                                uint32_t bytes_after_table, int* dynamic_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  int device = 0, reserved = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes != 0 || reserved + bytes_before_table > kCfTableAddr)
    return cudaErrorInvalidConfiguration;
  *dynamic_bytes = static_cast<int>(kCfAfterTable + bytes_after_table) - reserved;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, *dynamic_bytes);
}

// Entry x: words 0..31 = Te0[x], words 32..63 = Te2[x]; tables holds
// Te0..Te3 (256 words each).  Called by every thread of a 1-D block; the
// caller synchronizes before use.
__device__ __forceinline__ void cf_load_table(uint8_t* window, const uint32_t* __restrict__ tables) {
  uint32_t* te = reinterpret_cast<uint32_t*>(window + kCfTableAddr);
  for (int i = threadIdx.x; i < 256 * 64; i += blockDim.x)
    te[i] = tables[((i & 32) << 4) + (i >> 6)];
}

// The per-lane constant of the lookup addresses: window bytes 2 and 3 of
// the table, byte 1 free for the index, byte 0 the lane's word.
__device__ __forceinline__ uint32_t cf_lane_base() {
  return kCfTableAddr | ((threadIdx.x & 31) << 2);
}

__device__ __forceinline__ uint32_t cf_te0(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t cf_te2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1+128];" : "=r"(v) : "r"(addr));
  return v;
}

// Keystream blocks of the counters ctr[0..NB): the four LE words of each.
template <int NB>
__device__ __forceinline__ void aes256_ctr_cf(uint32_t lane_base, const RoundKeys& rk,
                                              uint32_t nonce_lo, uint32_t nonce_hi,
                                              const uint64_t (&ctr)[NB], uint4 (&out)[NB]) {
// the entry address of byte 3, 2, 1, 0 of a state word: (base.3, base.2, byte, base.0)
#define CLS_A3(s) __byte_perm(s, lane_base, 0x7634)
#define CLS_A2(s) __byte_perm(s, lane_base, 0x7624)
#define CLS_A1(s) __byte_perm(s, lane_base, 0x7614)
#define CLS_A0(s) __byte_perm(s, lane_base, 0x7604)
  const uint32_t n0 = bswap32(nonce_lo) ^ rk.w[0];
  const uint32_t n1 = bswap32(nonce_hi) ^ rk.w[1];
  uint32_t s[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    s[b][0] = n0;
    s[b][1] = n1;
    s[b][2] = bswap32(static_cast<uint32_t>(ctr[b])) ^ rk.w[2];
    s[b][3] = bswap32(static_cast<uint32_t>(ctr[b] >> 32)) ^ rk.w[3];
  }
#pragma unroll
  for (int r = 1; r < 14; ++r) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      uint32_t t[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t e0 = cf_te0(CLS_A3(s[b][c]));
        const uint32_t e1 = cf_te0(CLS_A2(s[b][(c + 1) & 3]));  // Te1 = ror8(Te0)
        const uint32_t e2 = cf_te2(CLS_A1(s[b][(c + 2) & 3]));
        const uint32_t e3 = cf_te2(CLS_A0(s[b][(c + 3) & 3]));  // Te3 = ror8(Te2)
        t[c] = e0 ^ e2 ^ rk.w[4 * r + c] ^ __byte_perm(e1 ^ e3, 0, 0x0321);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) s[b][c] = t[c];
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    uint32_t o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t e0 = cf_te0(CLS_A3(s[b][c]));
      const uint32_t e1 = cf_te0(CLS_A2(s[b][(c + 1) & 3]));
      const uint32_t e2 = cf_te0(CLS_A1(s[b][(c + 2) & 3]));
      const uint32_t e3 = cf_te0(CLS_A0(s[b][(c + 3) & 3]));
      // byte 1 of Te0[x] is S[x]: LE output word = (S0, S1, S2, S3)
      const uint32_t lo = __byte_perm(e0, e1, 0x5151);
      const uint32_t hi = __byte_perm(e2, e3, 0x5151);
      o[c] = __byte_perm(lo, hi, 0x5410) ^ rk.last_le[c];
    }
    out[b] = make_uint4(o[0], o[1], o[2], o[3]);
  }
#undef CLS_A3
#undef CLS_A2
#undef CLS_A1
#undef CLS_A0
}

}  // namespace cls
