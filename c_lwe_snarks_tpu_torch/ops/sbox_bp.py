"""Boyar-Peralta-class bitsliced AES S-box, affine constant folded out.

The port's own copy of the gate list of ``c_lwe_snarks_tpu/ops/sbox_bp.py``
(the two packages share no module): a 115-gate XOR/AND-only circuit built
from the Boyar-Peralta shared-middle structure (Boyar-Peralta 2011, "A
depth-16 circuit for the AES S-box"):

* top linear: 23 XOR producing the y-signals from the input bits;
* shared nonlinear middle: 30 XOR + 32 AND computing the GF(2^4)-tower
  inversion products z0..z17;
* bottom linear: 30 XOR, the frozen straight-line program that
  ``tools/sbox_bp_derive.py`` solved and minimized for the JAX package.

The circuit computes S(x) ^ 0x63: the affine constant is folded into the
cipher's round keys instead (``ops/aes.make_key``).  ShiftRows permutes an
all-0x63 error state to itself and MixColumns preserves it (column weights
2^3^1^1 = 1 in GF(2^8)), so XORing the 0x63 bit planes into round keys
1..14 cancels the constant exactly and the circuit needs no NOT gate.

``GATES`` is the one gate list of the port: ``sbox_bits_bp`` runs
it on tensors (the plain keystream version 1), and
``tools/gen_sbox_bp_cuh.py`` prints it as ``csrc/sbox_bp_gates.cuh`` for
the CUDA kernel.  Nothing is searched or checked at import; ``check``
runs the exhaustive comparison with the table S-box (the tests call it).
"""

from __future__ import annotations

AFFINE_CONST = 0x63  # folded into round keys; this circuit omits it

# Bottom linear layer, solved over GF(2) by tools/sbox_bp_derive.py:
# BP output S_k (S0 = MSB) = XOR of these z indices (constant-free for
# the folded S(x) ^ 0x63 variant).
_BOTTOM = (
    (3, 4, 6, 7, 9, 10, 15, 16),        # S0
    (0, 1, 6, 7, 9, 10, 15, 16),        # S1
    (0, 2, 6, 8, 12, 14, 15, 17),       # S2
    (0, 1, 3, 4, 9, 10, 15, 16),        # S3
    (1, 2, 4, 5, 9, 10, 15, 16),        # S4
    (0, 2, 3, 4, 7, 8, 10, 11, 12, 14, 15, 16),  # S5
    (4, 5, 7, 8, 12, 13, 15, 16),       # S6
    (0, 2, 3, 5, 12, 13, 15, 16),       # S7
)

# Frozen bottom-layer SLP (30 XOR): the winner of the exact-distance
# Boyar-Peralta heuristic over GF(2)^18 (tools/sbox_bp_derive.py --slp;
# vectorized-BFS distances, norm tie-break, 40 restarts).  Each pair
# (i, j) XORs base elements (base 0..17 = z0..z17, new results append);
# _BOTTOM_OUT[k] is the base index holding BP output S_k.
_BOTTOM_PROG = (
    (15, 16), (4, 18), (9, 10), (19, 20), (1, 21), (0, 3), (2, 12),
    (6, 7), (5, 13), (23, 24), (8, 19), (7, 28), (14, 27), (22, 23),
    (3, 25), (4, 32), (29, 30), (31, 33), (21, 32), (26, 29), (12, 37),
    (11, 34), (10, 39), (26, 27), (18, 41), (2, 22), (5, 43), (33, 34),
    (16, 17), (45, 46),
)
_BOTTOM_OUT = (36, 35, 47, 31, 44, 40, 38, 42)


def _build():
    """Emit the circuit as (op, dst, a, b) gates over registers.

    Registers 0..7 are the input planes, LSB first (plane k = bit k, the
    framework convention); BP's U_i (U0 = MSB) is register 7 - i, and
    BP's S_k lands in output slot 7 - k.
    """
    gates: list[tuple] = []
    next_reg = [8]

    def emit(op, a, b):
        r = next_reg[0]
        next_reg[0] += 1
        gates.append((op, r, a, b))
        return r

    def x(a, b):
        return emit("xor", a, b)

    def a(p, q):
        return emit("and", p, q)

    U = [7 - i for i in range(8)]  # BP U_i -> input register
    U0, U1, U2, U3, U4, U5, U6, U7 = U

    # ---- top linear (23 XOR) -------------------------------------------
    y14 = x(U3, U5)
    y13 = x(U0, U6)
    y9 = x(U0, U3)
    y8 = x(U0, U5)
    t0 = x(U1, U2)
    y1 = x(t0, U7)
    y4 = x(y1, U3)
    y12 = x(y13, y14)
    y2 = x(y1, U0)
    y5 = x(y1, U6)
    y3 = x(y5, y8)
    t1 = x(U4, y12)
    y15 = x(t1, U5)
    y20 = x(t1, U1)
    y6 = x(y15, U7)
    y10 = x(y15, t0)
    y11 = x(y20, y9)
    y7 = x(U7, y11)
    y17 = x(y10, y11)
    y19 = x(y10, y8)
    y16 = x(t0, y11)
    y21 = x(y13, y16)
    y18 = x(U0, y16)

    # ---- shared nonlinear middle (30 XOR + 32 AND) ---------------------
    t2 = a(y12, y15)
    t3 = a(y3, y6)
    t4 = x(t3, t2)
    t5 = a(y4, U7)
    t6 = x(t5, t2)
    t7 = a(y13, y16)
    t8 = a(y5, y1)
    t9 = x(t8, t7)
    t10 = a(y2, y7)
    t11 = x(t10, t7)
    t12 = a(y9, y11)
    t13 = a(y14, y17)
    t14 = x(t13, t12)
    t15 = a(y8, y10)
    t16 = x(t15, t12)
    t17 = x(t4, t14)
    t18 = x(t6, t16)
    t19 = x(t9, t14)
    t20 = x(t11, t16)
    t21 = x(t17, y20)
    t22 = x(t18, y19)
    t23 = x(t19, y21)
    t24 = x(t20, y18)
    t25 = x(t21, t22)
    t26 = a(t21, t23)
    t27 = x(t24, t26)
    t28 = a(t25, t27)
    t29 = x(t28, t22)
    t30 = x(t23, t24)
    t31 = x(t22, t26)
    t32 = a(t31, t30)
    t33 = x(t32, t24)
    t34 = x(t23, t33)
    t35 = x(t27, t33)
    t36 = a(t24, t35)
    t37 = x(t36, t34)
    t38 = x(t27, t36)
    t39 = a(t29, t38)
    t40 = x(t25, t39)
    t41 = x(t40, t37)
    t42 = x(t29, t33)
    t43 = x(t29, t40)
    t44 = x(t33, t37)
    t45 = x(t42, t41)
    z = [
        a(t44, y15), a(t37, y6), a(t33, U7), a(t43, y16),
        a(t40, y1), a(t29, y7), a(t42, y11), a(t45, y17),
        a(t41, y10), a(t44, y12), a(t37, y3), a(t33, y4),
        a(t43, y13), a(t40, y5), a(t29, y2), a(t42, y9),
        a(t45, y14), a(t41, y8),
    ]

    # ---- bottom linear: replay the frozen 30-XOR SLP -------------------
    base = list(z)
    for i, j in _BOTTOM_PROG:
        base.append(x(base[i], base[j]))
    s_regs = [base[b] for b in _BOTTOM_OUT]

    # the frozen program must produce exactly the solved sets
    masks = [1 << i for i in range(18)]
    for i, j in _BOTTOM_PROG:
        masks.append(masks[i] ^ masks[j])
    for k, out_idx in enumerate(_BOTTOM_OUT):
        want = sum(1 << i for i in _BOTTOM[k])
        assert masks[out_idx] == want, (k, masks[out_idx], want)

    # BP S_k (S0 = MSB) -> framework plane 7 - k
    out_regs = [s_regs[7 - k] for k in range(8)]
    return gates, out_regs, next_reg[0]


GATES, OUT_REGS, NREGS = _build()
GATE_COUNT = len(GATES)


def sbox_bits_bp(x):
    """Folded bitsliced S-box: 8 planes in -> 8 planes of S(x) ^ 0x63.

    Planes are indexed by bit, LSB first; any type with ``^`` and ``&``
    works (torch tensors, python ints).  Callers pair this with
    0x63-folded round keys (``ops/aes.make_key``).
    """
    regs = list(x) + [None] * (NREGS - 8)
    for op, dst, a, b in GATES:
        regs[dst] = (regs[a] ^ regs[b]) if op == "xor" else (regs[a] & regs[b])
    return [regs[r] for r in OUT_REGS]


def check() -> bool:
    """Exhaustive check against the table S-box ^ 0x63, bitsliced over
    python-int masks (bit j of plane k = bit k of input byte j)."""
    from ..utils import aes_host

    planes = [sum(((j >> k) & 1) << j for j in range(256)) for k in range(8)]
    out = sbox_bits_bp(planes)
    sb = aes_host.sbox()
    return all(
        sum(((out[k] >> j) & 1) << k for k in range(8)) == (int(sb[j]) ^ AFFINE_CONST)
        for j in range(256)
    )
