// mma.sync.m16n8k32 on unsigned bytes (s32 += u8 * u8), shared by K3 and K4
// (eval_fused.cu) and K7's many-witness form (rowsum.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cls {

// s32 [16 x 8] += u8 [16 x 32] (row-major) * u8 [32 x 8] (column-major).
// Lane = 4 * g + t: a0/a2 = row g, k = 4t.. and 16 + 4t..; a1/a3 = row g + 8;
// b0/b1 = column g, k = 4t.. and 16 + 4t..; d0, d1 = row g, columns 2t, 2t + 1;
// d2, d3 = row g + 8.  The lowest byte of a register is the lowest k.
__device__ __forceinline__ void mma_u8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace cls
