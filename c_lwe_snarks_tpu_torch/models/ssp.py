"""SSP instances as uint32 coefficient tensors: t [d], v [m, d], all < p.

Port of ``c_lwe_snarks_tpu/models/ssp.py``, which holds them as uint32
too.  ``random_ssp`` reproduces the reference's draw order from a seeded
entropy stream: floor(m/8) witness bytes padded to an AES block, then 8d
bytes per v_i read as uint64-LE words reduced mod p (kernel K2), and
t = v_0 + sum_{witness bit i-1} v_i - 1.  The mod-p glue computes in
int64 words (``ops/modp.py``); a stage that needs t or v_0 as words
widens them itself.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import modp, sampling
from ..utils.params import Params


@dataclasses.dataclass
class SSP:
    """An SSP instance on one device: t uint32 [d], v uint32 [m, d].

    Under a mesh v may hold one rank's rows only: rows [row0, row0 + len(v))
    (``parallel.mesh.random_ssp_sharded``)."""

    t: torch.Tensor
    v: torch.Tensor
    row0: int = 0


def witness_pad_bytes(params: Params) -> tuple[int, int]:
    """(witness draw bytes, pad to the next AES-block boundary)."""
    wb = params.m // 8
    return wb, (-wb) % 16


def entropy_bytes_random_ssp(params: Params) -> int:
    """Entropy stream bytes consumed by random_ssp (witness + m polys)."""
    wb, pad = witness_pad_bytes(params)
    return wb + pad + params.m * 8 * params.d


def witness_bits(w_bytes: torch.Tensor, m: int) -> torch.Tensor:
    """uint8 [m//8] LE bytes -> uint8 bit vector [m] (LSB first).

    The draw is floor(m/8) bytes, so the top m % 8 bits are zero.
    """
    bits = torch.zeros(m, dtype=torch.uint8, device=w_bytes.device)
    nb = 8 * w_bytes.shape[0]
    shifts = torch.arange(8, device=w_bytes.device, dtype=torch.uint8)
    bits[:nb] = ((w_bytes[:, None] >> shifts) & 1).reshape(-1)
    return bits


TILE = 1024  # rows per K2 launch: 2^25 folds at d = 2^15, 128 MiB of uint32 v


def gen_v(
    key: sampling.PRGKey, ctr0: int, mask: torch.Tensor, d: int, *, tile: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """v-polynomials from block counter ``ctr0`` and their masked sum.

    mask: 0/1 [rows] t-gate per row.  Returns (v uint32 [rows, d], the
    mod-p sum of the gated rows int64 [d]; ``finish_t`` makes t of it).
    A row is 8d stream bytes = d/2 AES blocks, so row i of a section
    starts at block ctr0 + i * d/2: a rank of a mesh passes the counter
    of its first row.  Each ``tile``
    of rows (default ``TILE``) is one K2 launch, which writes the tile
    into v where it lives.
    """
    rows = mask.shape[0]
    tile = TILE if tile is None else tile
    assert d % 2 == 0, d
    v = torch.empty(rows, d, dtype=torch.uint32, device=key.device)
    t = torch.zeros(d, dtype=torch.int64, device=key.device)
    for lo in range(0, rows, tile):
        hi = min(rows, lo + tile)
        sampling.keystream_fold_p(
            key, ctr0 + lo * (d // 2), (hi - lo) * d, out=v[lo:hi].view(-1))
        t = (t + modp.gated_rowsum_mod_p(v[lo:hi], mask[lo:hi])) % modp.P
    return v, t


def finish_t(gated_sum: torch.Tensor) -> torch.Tensor:
    """t = (the gated rows' sum) - 1 mod p as uint32 [d], from that sum
    mod p (int64 [d], changed in place)."""
    gated_sum[0] = modp.submod_p(gated_sum[0], 1)
    return gated_sum.to(torch.uint32)


def witness_and_mask(
    key: sampling.PRGKey, byte_offset: int, params: Params
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(witness bits uint8 [m], t-gate mask [m], block counter of v_0).

    The mask gates v_0 always and v_i by witness bit i-1."""
    m = params.m
    wb, pad = witness_pad_bytes(params)
    assert byte_offset % 16 == 0, "random_ssp section must be block-aligned"
    wits = witness_bits(sampling.keystream_bytes(key, byte_offset, wb), m)
    mask = torch.cat([torch.ones(1, dtype=torch.uint8, device=key.device), wits[: m - 1]])
    return wits, mask, (byte_offset + wb + pad) // 16


def random_ssp(
    key: sampling.PRGKey, byte_offset: int, params: Params, *, tile: int | None = None
) -> tuple[torch.Tensor, SSP]:
    """(witness bits uint8 [m], SSP) from the entropy stream at byte_offset;
    ``tile`` rows of v a K2 launch (``gen_v``)."""
    wits, mask, ctr0 = witness_and_mask(key, byte_offset, params)
    v, t = gen_v(key, ctr0, mask, params.d, tile=tile)
    return wits, SSP(t=finish_t(t), v=v)
