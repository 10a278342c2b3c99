// Bitsliced AES S-box, 115 XOR/AND gates, computing S(x) ^ 0x63 on eight
// bit planes (x[k] = bit k of 32 bytes, LSB first), in place.
//
// GENERATED by tools/gen_sbox_bp_cuh.py from the gate list of
// c_lwe_snarks_tpu_torch/ops/sbox_bp.py; do not edit by hand.
#pragma once

#include <cstdint>

namespace cls {

constexpr int kSboxBpGates = 115;

__device__ __forceinline__ void sbox_bp(uint32_t* __restrict__ x) {
  const uint32_t r0 = x[0];
  const uint32_t r1 = x[1];
  const uint32_t r2 = x[2];
  const uint32_t r3 = x[3];
  const uint32_t r4 = x[4];
  const uint32_t r5 = x[5];
  const uint32_t r6 = x[6];
  const uint32_t r7 = x[7];
  const uint32_t r8 = r4 ^ r2;
  const uint32_t r9 = r7 ^ r1;
  const uint32_t r10 = r7 ^ r4;
  const uint32_t r11 = r7 ^ r2;
  const uint32_t r12 = r6 ^ r5;
  const uint32_t r13 = r12 ^ r0;
  const uint32_t r14 = r13 ^ r4;
  const uint32_t r15 = r9 ^ r8;
  const uint32_t r16 = r13 ^ r7;
  const uint32_t r17 = r13 ^ r1;
  const uint32_t r18 = r17 ^ r11;
  const uint32_t r19 = r3 ^ r15;
  const uint32_t r20 = r19 ^ r2;
  const uint32_t r21 = r19 ^ r6;
  const uint32_t r22 = r20 ^ r0;
  const uint32_t r23 = r20 ^ r12;
  const uint32_t r24 = r21 ^ r10;
  const uint32_t r25 = r0 ^ r24;
  const uint32_t r26 = r23 ^ r24;
  const uint32_t r27 = r23 ^ r11;
  const uint32_t r28 = r12 ^ r24;
  const uint32_t r29 = r9 ^ r28;
  const uint32_t r30 = r7 ^ r28;
  const uint32_t r31 = r15 & r20;
  const uint32_t r32 = r18 & r22;
  const uint32_t r33 = r32 ^ r31;
  const uint32_t r34 = r14 & r0;
  const uint32_t r35 = r34 ^ r31;
  const uint32_t r36 = r9 & r28;
  const uint32_t r37 = r17 & r13;
  const uint32_t r38 = r37 ^ r36;
  const uint32_t r39 = r16 & r25;
  const uint32_t r40 = r39 ^ r36;
  const uint32_t r41 = r10 & r24;
  const uint32_t r42 = r8 & r26;
  const uint32_t r43 = r42 ^ r41;
  const uint32_t r44 = r11 & r23;
  const uint32_t r45 = r44 ^ r41;
  const uint32_t r46 = r33 ^ r43;
  const uint32_t r47 = r35 ^ r45;
  const uint32_t r48 = r38 ^ r43;
  const uint32_t r49 = r40 ^ r45;
  const uint32_t r50 = r46 ^ r21;
  const uint32_t r51 = r47 ^ r27;
  const uint32_t r52 = r48 ^ r29;
  const uint32_t r53 = r49 ^ r30;
  const uint32_t r54 = r50 ^ r51;
  const uint32_t r55 = r50 & r52;
  const uint32_t r56 = r53 ^ r55;
  const uint32_t r57 = r54 & r56;
  const uint32_t r58 = r57 ^ r51;
  const uint32_t r59 = r52 ^ r53;
  const uint32_t r60 = r51 ^ r55;
  const uint32_t r61 = r60 & r59;
  const uint32_t r62 = r61 ^ r53;
  const uint32_t r63 = r52 ^ r62;
  const uint32_t r64 = r56 ^ r62;
  const uint32_t r65 = r53 & r64;
  const uint32_t r66 = r65 ^ r63;
  const uint32_t r67 = r56 ^ r65;
  const uint32_t r68 = r58 & r67;
  const uint32_t r69 = r54 ^ r68;
  const uint32_t r70 = r69 ^ r66;
  const uint32_t r71 = r58 ^ r62;
  const uint32_t r72 = r58 ^ r69;
  const uint32_t r73 = r62 ^ r66;
  const uint32_t r74 = r71 ^ r70;
  const uint32_t r75 = r73 & r20;
  const uint32_t r76 = r66 & r22;
  const uint32_t r77 = r62 & r0;
  const uint32_t r78 = r72 & r28;
  const uint32_t r79 = r69 & r13;
  const uint32_t r80 = r58 & r25;
  const uint32_t r81 = r71 & r24;
  const uint32_t r82 = r74 & r26;
  const uint32_t r83 = r70 & r23;
  const uint32_t r84 = r73 & r15;
  const uint32_t r85 = r66 & r18;
  const uint32_t r86 = r62 & r14;
  const uint32_t r87 = r72 & r9;
  const uint32_t r88 = r69 & r17;
  const uint32_t r89 = r58 & r16;
  const uint32_t r90 = r71 & r10;
  const uint32_t r91 = r74 & r8;
  const uint32_t r92 = r70 & r11;
  const uint32_t r93 = r90 ^ r91;
  const uint32_t r94 = r79 ^ r93;
  const uint32_t r95 = r84 ^ r85;
  const uint32_t r96 = r94 ^ r95;
  const uint32_t r97 = r76 ^ r96;
  const uint32_t r98 = r75 ^ r78;
  const uint32_t r99 = r77 ^ r87;
  const uint32_t r100 = r81 ^ r82;
  const uint32_t r101 = r80 ^ r88;
  const uint32_t r102 = r98 ^ r99;
  const uint32_t r103 = r83 ^ r94;
  const uint32_t r104 = r82 ^ r103;
  const uint32_t r105 = r89 ^ r102;
  const uint32_t r106 = r97 ^ r98;
  const uint32_t r107 = r78 ^ r100;
  const uint32_t r108 = r79 ^ r107;
  const uint32_t r109 = r104 ^ r105;
  const uint32_t r110 = r106 ^ r108;
  const uint32_t r111 = r96 ^ r107;
  const uint32_t r112 = r101 ^ r104;
  const uint32_t r113 = r87 ^ r112;
  const uint32_t r114 = r86 ^ r109;
  const uint32_t r115 = r85 ^ r114;
  const uint32_t r116 = r101 ^ r102;
  const uint32_t r117 = r93 ^ r116;
  const uint32_t r118 = r77 ^ r97;
  const uint32_t r119 = r80 ^ r118;
  const uint32_t r120 = r108 ^ r109;
  const uint32_t r121 = r91 ^ r92;
  const uint32_t r122 = r120 ^ r121;
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
