"""SSP instances as int64 coefficient tensors: t [d], v [m, d], all < p.

Port of ``c_lwe_snarks_tpu/models/ssp.py``.  ``random_ssp`` reproduces
the reference's draw order from a seeded entropy stream: floor(m/8)
witness bytes padded to an AES block, then 8d bytes per v_i read as
uint64-LE words reduced mod p (kernel K2), and
t = v_0 + sum_{witness bit i-1} v_i - 1.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import modp, sampling
from ..utils.params import Params


@dataclasses.dataclass
class SSP:
    """An SSP instance on one device: t int64 [d], v int64 [m, d]."""

    t: torch.Tensor
    v: torch.Tensor


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


TILE = 1024  # rows per K2 launch: 2^25 folds at d = 2^15, 256 MiB of int64 v


def gen_v(
    key: sampling.PRGKey, ctr0: int, mask: torch.Tensor, d: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """v-polynomials from block counter ``ctr0`` and their masked sum.

    mask: 0/1 [rows] t-gate per row.  Returns (v int64 [rows, d], the
    mod-p sum of the gated rows int64 [d]).  A row is 8d stream bytes =
    d/2 AES blocks; each tile of rows is one K2 launch.
    """
    rows = mask.shape[0]
    assert d % 2 == 0, d
    v = torch.empty(rows, d, dtype=torch.int64, device=key.device)
    t = torch.zeros(d, dtype=torch.int64, device=key.device)
    for lo in range(0, rows, TILE):
        hi = min(rows, lo + TILE)
        vi = sampling.keystream_fold_p(key, ctr0 + lo * (d // 2), (hi - lo) * d)
        v[lo:hi] = vi.reshape(hi - lo, d)
        t = (t + modp.gated_rowsum_mod_p(v[lo:hi], mask[lo:hi])) % modp.P
    return v, t


def random_ssp(
    key: sampling.PRGKey, byte_offset: int, params: Params
) -> tuple[torch.Tensor, SSP]:
    """(witness bits uint8 [m], SSP) from the entropy stream at byte_offset."""
    m, d = params.m, params.d
    wb, pad = witness_pad_bytes(params)
    assert byte_offset % 16 == 0, "random_ssp section must be block-aligned"
    wits = witness_bits(sampling.keystream_bytes(key, byte_offset, wb), m)
    mask = torch.cat([torch.ones(1, dtype=torch.uint8, device=key.device), wits[: m - 1]])
    v, t = gen_v(key, (byte_offset + wb + pad) // 16, mask, d)
    t[0] = modp.submod_p(t[0], 1)
    return wits, SSP(t=t, v=v)
