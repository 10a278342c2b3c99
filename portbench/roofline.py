"""The yardstick of the roofline metrics: the card's published peaks and the
work of the kernels the metrics time, counted from the configuration's
shapes and never from what the program launched.

Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet): 3.35 TB/s
of HBM, 1,979 TOP/s of int8 on the tensor cores.  The sheet gives no
integer ALU rate: its 67 TFLOP/s of float32 is 2 flops on 128 lanes an SM,
and half of those lanes also do 32-bit integer and logic operations, one a
clock, so the integer peak is a quarter of it.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # bytes/s
PEAK_INT32 = 67e12 / 4  # 32-bit integer operations/s
PEAK_INT8 = 1979e12  # int8 tensor-core operations/s

# 32-bit operations the program's AES core spends on one 16-byte block:
# 4 to swap and whiten the counter words, then 14 rounds of 4 words x 8
# (four byte permutes that are the lookup addresses, and a rotation and
# three XORs, or in the last round three byte merges and an XOR); its
# shared-memory loads are not counted.  Frozen: a later core that needs
# fewer operations a block lowers it here, in a benchmark change.
OPS_PER_BLOCK = 4 + 14 * 4 * 8  # 452


def bound_ms(nbytes: float, int32_ops: float, int8_ops: float = 0.0) -> float:
    """The least milliseconds the card could take: the larger of the bytes
    over the memory rate and the operations over their peak."""
    return 1e3 * max(nbytes / PEAK_BYTES, int32_ops / PEAK_INT32, int8_ops / PEAK_INT8)


def terms(cfg: dict) -> int:
    """CRS terms (s^i, alpha s^i, beta t(s), beta v_i(s) for i >= 1)."""
    return 2 * int(cfg["d"]) + int(cfg["m"])


def stream_blocks(cfg: dict) -> int:
    """AES blocks of the a-vectors of every CRS term: 92-byte draws, n a term."""
    return -(-terms(cfg) * int(cfg["n"]) * (int(cfg["logq"]) // 8) // 16)


def eval_bound_ms(cfg: dict, lanes: int = 5) -> float:
    """The prover's keystream -> MAC sweep (K3) over every term with ``lanes``
    coefficient rows: the stream's blocks, the coefficient-byte MACs (two
    operations each) and int64 planes [4, lanes, n, 88] written once."""
    n, digits = int(cfg["n"]), 88
    return bound_ms(8 * lanes * terms(cfg) + 8 * 4 * lanes * n * digits,
                    OPS_PER_BLOCK * stream_blocks(cfg), 2 * 4 * lanes * terms(cfg) * n * digits)


def encrypt_bound_ms(cfg: dict) -> float:
    """Setup's keystream -> encrypt sweep (K4) over every term: the stream's
    blocks, the nibble products of <a, sk> below 2^704 (two operations each,
    two nibble planes) and sk read and two int32 planes [terms, 88] written."""
    n, digits = int(cfg["n"]), 88
    return bound_ms(n * digits + 8 * terms(cfg) * digits, OPS_PER_BLOCK * stream_blocks(cfg),
                    2 * 2 * terms(cfg) * n * (digits * (digits + 1) // 2))


def rowsum_bound_ms(cfg: dict, clients: int = 1) -> float:
    """The prover's gated row-sums (K7) of ``clients`` (C) statements with
    independent half-dense witnesses, over v[1:]: the expected union of their
    gated rows, (m - 1)(1 - 2^-C) rows of d uint32 words, read once, and the
    C (m - 1) gate bytes."""
    rows = int(cfg["m"]) - 1
    return bound_ms(rows * (1 - 0.5**clients) * 4 * int(cfg["d"]) + clients * rows, 0)
