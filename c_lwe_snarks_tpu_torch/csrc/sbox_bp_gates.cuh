// Bitsliced AES S-box computing S(x) ^ 0x63 on eight bit planes (x[k] =
// bit k of 32 bytes, LSB first), in place: the 115 XOR/AND gates as a
// cover of 80 three-input lookup tables, one lop3.b32 each.
//
// GENERATED by tools/gen_sbox_bp_cuh.py from the gate list of
// c_lwe_snarks_tpu_torch/ops/sbox_bp.py; do not edit by hand.
#pragma once

#include <cstdint>

namespace cls {

constexpr int kSboxBpGates = 115;
constexpr int kSboxBpTables = 80;

template <uint32_t kTable>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kTable));
  return d;
}

__device__ __forceinline__ void sbox_bp(uint32_t* __restrict__ x) {
  const uint32_t r0 = x[0];
  const uint32_t r1 = x[1];
  const uint32_t r2 = x[2];
  const uint32_t r3 = x[3];
  const uint32_t r4 = x[4];
  const uint32_t r5 = x[5];
  const uint32_t r6 = x[6];
  const uint32_t r7 = x[7];
  const uint32_t r8 = lop3<0x3C>(r2, r4, r2);
  const uint32_t r9 = lop3<0x3C>(r1, r7, r1);
  const uint32_t r10 = lop3<0x3C>(r4, r7, r4);
  const uint32_t r11 = lop3<0x3C>(r2, r7, r2);
  const uint32_t r13 = lop3<0x96>(r0, r5, r6);
  const uint32_t r15 = lop3<0x96>(r2, r4, r9);
  const uint32_t r17 = lop3<0x3C>(r1, r13, r1);
  const uint32_t r18 = lop3<0x96>(r2, r7, r17);
  const uint32_t r20 = lop3<0x96>(r2, r3, r15);
  const uint32_t r21 = lop3<0x96>(r3, r6, r15);
  const uint32_t r22 = lop3<0x3C>(r0, r20, r0);
  const uint32_t r23 = lop3<0x96>(r5, r6, r20);
  const uint32_t r24 = lop3<0x96>(r4, r7, r21);
  const uint32_t r25 = lop3<0x3C>(r0, r24, r0);
  const uint32_t r26 = lop3<0x3C>(r23, r24, r23);
  const uint32_t r28 = lop3<0x96>(r5, r6, r24);
  const uint32_t r29 = lop3<0x96>(r1, r7, r28);
  const uint32_t r31 = lop3<0x82>(r2, r3, r15);
  const uint32_t r33 = lop3<0x6A>(r18, r22, r31);
  const uint32_t r34 = lop3<0x60>(r0, r4, r13);
  const uint32_t r36 = lop3<0x28>(r1, r7, r28);
  const uint32_t r38 = lop3<0xA6>(r1, r13, r36);
  const uint32_t r39 = lop3<0x28>(r7, r13, r25);
  const uint32_t r41 = lop3<0x28>(r4, r7, r24);
  const uint32_t r43 = lop3<0x6A>(r8, r26, r41);
  const uint32_t r45 = lop3<0x6A>(r11, r23, r41);
  const uint32_t r47 = lop3<0x96>(r31, r34, r45);
  const uint32_t r49 = lop3<0x96>(r36, r39, r45);
  const uint32_t r50 = lop3<0x96>(r21, r33, r43);
  const uint32_t r51 = lop3<0x96>(r11, r23, r47);
  const uint32_t r52 = lop3<0x96>(r29, r38, r43);
  const uint32_t r53 = lop3<0x96>(r7, r28, r49);
  const uint32_t r54 = lop3<0x3C>(r50, r51, r50);
  const uint32_t r55 = lop3<0xC0>(r50, r52, r50);
  const uint32_t r56 = lop3<0x3C>(r53, r55, r53);
  const uint32_t r58 = lop3<0x78>(r51, r54, r56);
  const uint32_t r60 = lop3<0x3C>(r51, r55, r51);
  const uint32_t r62 = lop3<0xE4>(r52, r53, r60);
  const uint32_t r65 = lop3<0x60>(r53, r56, r62);
  const uint32_t r66 = lop3<0x96>(r52, r62, r65);
  const uint32_t r68 = lop3<0x48>(r56, r58, r65);
  const uint32_t r69 = lop3<0x3C>(r54, r68, r54);
  const uint32_t r70 = lop3<0x3C>(r66, r69, r66);
  const uint32_t r71 = lop3<0x3C>(r58, r62, r58);
  const uint32_t r72 = lop3<0x3C>(r58, r69, r58);
  const uint32_t r73 = lop3<0x3C>(r62, r66, r62);
  const uint32_t r74 = lop3<0x3C>(r70, r71, r70);
  const uint32_t r77 = lop3<0xC0>(r0, r62, r0);
  const uint32_t r78 = lop3<0xC0>(r28, r72, r28);
  const uint32_t r79 = lop3<0xC0>(r13, r69, r13);
  const uint32_t r80 = lop3<0x28>(r0, r24, r58);
  const uint32_t r81 = lop3<0xC0>(r24, r71, r24);
  const uint32_t r82 = lop3<0x28>(r23, r24, r74);
  const uint32_t r85 = lop3<0x28>(r11, r17, r66);
  const uint32_t r86 = lop3<0x28>(r4, r13, r62);
  const uint32_t r87 = lop3<0x28>(r1, r7, r72);
  const uint32_t r89 = lop3<0x28>(r7, r13, r58);
  const uint32_t r91 = lop3<0x28>(r2, r4, r74);
  const uint32_t r93 = lop3<0x6A>(r10, r71, r91);
  const uint32_t r94 = lop3<0x3C>(r79, r93, r79);
  const uint32_t r95 = lop3<0x6A>(r15, r73, r85);
  const uint32_t r96 = lop3<0x3C>(r94, r95, r94);
  const uint32_t r97 = lop3<0x6A>(r22, r66, r96);
  const uint32_t r98 = lop3<0x6A>(r20, r73, r78);
  const uint32_t r101 = lop3<0x6A>(r17, r69, r80);
  const uint32_t r102 = lop3<0x96>(r77, r87, r98);
  const uint32_t r103 = lop3<0x6A>(r23, r70, r94);
  const uint32_t r104 = lop3<0x3C>(r82, r103, r82);
  const uint32_t r106 = lop3<0x3C>(r97, r98, r97);
  const uint32_t r107 = lop3<0x96>(r78, r81, r82);
  const uint32_t r108 = lop3<0x3C>(r79, r107, r79);
  const uint32_t r109 = lop3<0x96>(r89, r102, r104);
  const uint32_t r110 = lop3<0x3C>(r106, r108, r106);
  const uint32_t r111 = lop3<0x3C>(r96, r107, r96);
  const uint32_t r113 = lop3<0x96>(r87, r101, r104);
  const uint32_t r115 = lop3<0x96>(r85, r86, r109);
  const uint32_t r117 = lop3<0x96>(r93, r101, r102);
  const uint32_t r119 = lop3<0x96>(r77, r80, r97);
  const uint32_t r121 = lop3<0x6A>(r11, r70, r91);
  const uint32_t r122 = lop3<0x96>(r108, r109, r121);
  x[0] = r117;
  x[1] = r113;
  x[2] = r115;
  x[3] = r119;
  x[4] = r106;
  x[5] = r122;
  x[6] = r110;
  x[7] = r111;
}

}  // namespace cls
