"""Keystream -> digit-tensor sampling: the PRG/bignum bridge.

Port of ``c_lwe_snarks_tpu/ops/sampling.py``.  A batch of PRG draws is
``keystream[offset : offset + count * draw_bytes]`` reshaped to
``[count, draw_bytes]``; the mod-2^704 layer keeps the low 88 digits.
Byte offsets may have any alignment: the helpers generate from the
enclosing AES block and slice.  Stream positions are python ints: the
64-bit block counter travels as one int (``split_offset``,
``offset_parts`` and ``advance_ctr`` give the JAX package's (lo, hi) word
form).  Keys live on the card unless the caller names another device.
"""

from __future__ import annotations

import torch

from . import aes


class PRGKey:
    """AES-256-CTR key material on one device.

    seed = 8 nonce bytes (LE) || 32 key bytes, as in the reference's
    ``rseed_t``.
    """

    def __init__(self, seed: bytes, device="cuda"):
        assert len(seed) == 40
        self.seed = bytes(seed)
        self.aes = aes.make_key(self.seed, device)

    @property
    def device(self) -> torch.device:
        return self.aes.device


def split_offset(byte_offset: int):
    """Byte offset -> (skip, (ctr_lo, ctr_hi)) as python ints."""
    blk = byte_offset // 16
    return byte_offset % 16, (blk & 0xFFFFFFFF, blk >> 32)


def offset_parts(byte_offset: int) -> tuple[int, int, int]:
    """Byte offset -> (skip, ctr_lo, ctr_hi): the flat form of ``split_offset``."""
    skip, (lo, hi) = split_offset(byte_offset)
    return skip, lo, hi


def parts_to_offset(parts):
    """(skip, ctr_lo, ctr_hi) -> (skip, (ctr_lo, ctr_hi))."""
    return parts[0], (parts[1], parts[2])


def advance_ctr(lo: int, hi: int, nblocks: int):
    """64-bit counter addition on a (lo, hi) pair of words."""
    c = (lo | (hi << 32)) + nblocks
    return c & 0xFFFFFFFF, (c >> 32) & 0xFFFFFFFF


def keystream_words(key: PRGKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """int64 [4 * nblocks] LE stream words for counters [start, start+n) (K1)."""
    return aes.keystream_words(key.aes, start_ctr, nblocks)


def keystream_blocks(key: PRGKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """uint8 [nblocks, 16] keystream bytes for counters [start, start+n) (K1)."""
    return aes.keystream_blocks(key.aes, start_ctr, nblocks)


def keystream_fold_p(
    key: PRGKey, start_ctr: int, npairs: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """int64 [npairs]: (word[2k+1] * 2^32 + word[2k]) mod p (K2), written
    into ``out`` if given (``aes.check_fold_out``)."""
    return aes.keystream_fold_p(key.aes, start_ctr, npairs, out)


def keystream_bytes(key: PRGKey, byte_offset: int, nbytes: int) -> torch.Tensor:
    """uint8 keystream bytes [byte_offset, byte_offset + nbytes): a slice
    of the enclosing AES blocks (K1)."""
    skip = byte_offset % 16
    nblocks = -(-(skip + nbytes) // 16)
    return keystream_blocks(key, byte_offset // 16, nblocks).reshape(-1)[skip : skip + nbytes]


def sample_digit_rows(
    key: PRGKey,
    byte_offset: int,
    count: int,
    *,
    draw_bytes: int = 92,
    ndigits: int = 88,
) -> torch.Tensor:
    """``count`` sequential PRG draws as uint8 digit rows [count, ndigits].

    Each draw consumes exactly ``draw_bytes`` stream bytes (the
    reference's floor-byte discipline) and keeps its low ``ndigits``: the
    stream's bytes sliced and reshaped, at any alignment.
    """
    rows = keystream_bytes(key, byte_offset, count * draw_bytes).reshape(count, draw_bytes)
    return rows[:, :ndigits].contiguous()


def expand_a(
    key: PRGKey,
    byte_offset: int,
    count: int,
    n: int,
    *,
    draw_bytes: int = 92,
    ndigits: int = 88,
) -> torch.Tensor:
    """a-matrices of ``count`` sequential ciphertexts: uint8 [count, n, ndigits].

    One ciphertext consumes n * draw_bytes = CTR_CT stream bytes.
    """
    rows = sample_digit_rows(
        key, byte_offset, count * n, draw_bytes=draw_bytes, ndigits=ndigits)
    return rows.reshape(count, n, ndigits)

