"""Bit-slicing: the SWAR 32x32 bit-matrix transpose on torch tensors.

Port of ``c_lwe_snarks_tpu/ops/bitslice.py``.  The bitsliced cipher
(keystream version 1, ``ops/aes.py``) keeps each of the 128 state bit
positions as a plane of 32-bit words, one bit per block of a 32-block
group; converting between per-block words and bit planes is a 32x32
binary-matrix transpose, done with the classic five-stage
mask/shift/xor network.  Words are int64 tensors holding [0, 2^32), as
everywhere in the port; the CUDA kernel (``csrc/keystream_bitsliced.cu``)
runs the same network in registers.
"""

from __future__ import annotations

import torch

# stage j swaps row k's high-column bits with row (k + j)'s low-column bits
MASKS = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333, 1: 0x55555555}


def transpose32(a: torch.Tensor) -> torch.Tensor:
    """Transpose a 32x32 bit matrix, vectorized over trailing axes.

    a: int64 words [32, ...] where bit j of a[i] is matrix entry M[i, j]
    (LSB first).  Returns int64 [32, ...] where bit i of out[j] is M[i, j].
    No intermediate leaves [0, 2^32): each mask clears the bits a left
    shift by j would push out.
    """
    assert a.shape[0] == 32 and a.dtype == torch.int64
    shape = a.shape
    for j, m in MASKS.items():
        a4 = a.reshape((32 // (2 * j), 2, j) + shape[1:])
        lo, hi = a4[:, 0], a4[:, 1]
        t = ((lo >> j) ^ hi) & m
        a = torch.stack([lo ^ (t << j), hi ^ t], dim=1).reshape(shape)
    return a


def bytes_to_planes(words: torch.Tensor) -> torch.Tensor:
    """Per-block words -> bit planes: words[b] (int64 [32, ...]) belongs to
    block b of a 32-block group; planes[k] has bit b = bit k of block b's
    word.  The same 32x32 transpose as the inverse."""
    return transpose32(words)


def planes_to_bytes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of ``bytes_to_planes`` (the transpose is an involution)."""
    return transpose32(planes)
