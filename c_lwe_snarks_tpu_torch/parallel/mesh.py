"""Sharded protocol sections over a 1-D mesh of ranks (torch.distributed).

Port of ``c_lwe_snarks_tpu/parallel/mesh.py``.  A mesh is the 1-D
``DeviceMesh`` of ``multihost.global_mesh``: one process a device.  Every
primitive comes as two functions:

* ``*_part(rank, world, ...)``: the rank's own work, which returns its
  part (the counterpart of the JAX package's ``shard_fn``); a caller can
  run every rank's part one after another on one device;
* ``*_sharded(..., mesh)``: the part at this rank plus the collective
  that makes the result whole on every rank.

Rank r owns items [r * chunk, min((r + 1) * chunk, total)) with chunk =
ceil(total / world) (``multihost.chunk_bounds``).  Its stream position is
an exact Python int: ``section_offset + lo * CTR_CT`` bytes for CRS terms,
``ctr0 + lo * d / 2`` blocks for rows of v.  K2, K3 and K4 take any byte
offset and any count, so no chunk is rounded to a grid or to an AES
block: the JAX package's ``_chunk_align`` (its kernels need one static
lead) has no counterpart, and an odd n or a ragged chunk needs nothing.

The collectives, and the bound each keeps:

* evaluation: a rank's part is carry-folded to digits <= 255, so one
  int32 ``all_reduce`` (positions <= 255 * world) and one ``carry_fold``;
* random_ssp's t: partial column sums < p, one int64 ``all_reduce``, ``% p``;
* setup's rows and v_i(s): one ``all_gather`` of the parts, each padded
  to the chunk for it and trimmed after.

Rows of the SSP (uint32, as in the JAX package) ride every collective as
their int32 view, the same bytes: gloo has no uint32 (``_wire``).

Every rank issues the same collectives in the same order, and no rank
branches on its own data before one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..models import lwe as tlwe
from ..models import ssp as tssp
from ..ops import digits as dg
from ..ops import modp, sampling
from ..utils.params import Params
from ..utils.spans import span
from .multihost import chunk_bounds, global_mesh, initialize


def make_mesh(n_devices: int, device="cuda") -> DeviceMesh:
    """The mesh over a world of ``n_devices`` ranks.

    Starts the process group if none is up (``multihost.initialize``):
    under torchrun its world, otherwise a world of 1."""
    initialize(device)
    world = dist.get_world_size()
    if n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} ranks needs a world of {n_devices} processes, this one has "
            f"{world}: run under torchrun --nproc-per-node {n_devices}")
    return global_mesh()


def axis(mesh: DeviceMesh) -> tuple:
    """(process group, this rank's index in it, world size) of a 1-D mesh."""
    return mesh.get_group(), mesh.get_local_rank(), mesh.size()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as a collective carries it: a uint32 tensor as its int32 view (the
    same bytes; gloo refuses uint32), any other as it is."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def gather_rows(part: torch.Tensor, total: int, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's rows of a [total, ...] tensor split by the chunk rule,
    concatenated on every rank: one ``all_gather`` of the parts padded to
    the chunk."""
    group, _, world = axis(mesh)
    chunk = -(-total // world)
    tail = tuple(part.shape[1:])
    wire = _wire(part)
    padded = F.pad(wire, (0, 0) * len(tail) + (0, chunk - part.shape[0])).contiguous()
    out = torch.empty((world, chunk) + tail, dtype=wire.dtype, device=part.device)
    dist.all_gather(list(out.unbind(0)), padded, group=group)
    return out.reshape((world * chunk,) + tail)[:total].view(part.dtype)


def row_zero(ssp: tssp.SSP, mesh: DeviceMesh) -> torch.Tensor:
    """v_0 (uint32 [d]) of a row-sharded SSP on every rank, broadcast from
    rank 0, which holds row 0 by the chunk rule."""
    group, rank, _ = axis(mesh)
    v0 = ssp.v[0].clone() if rank == 0 else torch.empty_like(ssp.t)
    dist.broadcast(_wire(v0), src=dist.get_global_rank(group, 0), group=group)
    return v0


# --------------------------------------------------------------------------
# random_ssp and v_i(s)
# --------------------------------------------------------------------------


def random_ssp_part(
    rank: int, world: int, key: sampling.PRGKey, byte_offset: int, params: Params
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The rank's rows of random_ssp: (witness bits uint8 [m], v rows [lo, hi)
    uint32 [hi - lo, d], their gated mod-p column sum int64 [d], lo).

    Row i of v is 8d stream bytes from block ``ctr0 + i * d / 2``; the
    rank's K2 launches start at its first row (``ssp.gen_v``)."""
    wits, mask, ctr0 = tssp.witness_and_mask(key, byte_offset, params)
    lo, hi = chunk_bounds(params.m, rank, world)
    v, t = tssp.gen_v(key, ctr0 + lo * (params.d // 2), mask[lo:hi], params.d)
    return wits, v, t, lo


def random_ssp_sharded(
    key: sampling.PRGKey, byte_offset: int, params: Params, mesh: DeviceMesh
) -> tuple[torch.Tensor, tssp.SSP]:
    """random_ssp with the m rows of v split over the ranks.

    Returns the witness bits and an SSP whose t is whole on every rank and
    whose v holds the rank's rows, starting at ``row0``.  The partial
    column sums are < p each: one int64 ``all_reduce``, ``% p``, then
    ``ssp.finish_t``."""
    group, rank, world = axis(mesh)
    with span("lwe.random_ssp"):
        wits, v, t, lo = random_ssp_part(rank, world, key, byte_offset, params)
        dist.all_reduce(t, group=group)
        return wits, tssp.SSP(t=tssp.finish_t(t % modp.P), v=v, row0=lo)


def v_at_s_sharded(
    v: torch.Tensor, powers: torch.Tensor, mesh: DeviceMesh, total: int
) -> torch.Tensor:
    """v_i(s) for all ``total`` polynomials, on every rank.

    v: the rank's rows of the [total, d] matrix by the chunk rule.  A
    rank's part is the mod-p matvec of its rows (``modp.matvec_mod_p``:
    K8 on the card), then one ``all_gather`` of the values."""
    return gather_rows(modp.matvec_mod_p(v, powers), total, mesh)


def gated_rowsum_sharded(ssp: tssp.SSP, gate: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """sum_{i : gate_i} v[i, :] mod p over a row-sharded SSP, on every rank.

    gate: 0/1 [m] over all rows.  A rank sums its rows (< p), then one
    int64 ``all_reduce`` and a ``% p``."""
    group, _, _ = axis(mesh)
    rows = ssp.v.shape[0]
    part = modp.gated_rowsum_mod_p(ssp.v, gate[ssp.row0 : ssp.row0 + rows])
    dist.all_reduce(part, group=group)
    return part % modp.P


# --------------------------------------------------------------------------
# encryptions and evaluations over CRS terms
# --------------------------------------------------------------------------


def encrypt_section_part(
    rank: int, world: int, key: sampling.PRGKey, section_offset: int, sk: torch.Tensor,
    msgs: torch.Tensor, errs: torch.Tensor, params: Params,
) -> torch.Tensor:
    """The rank's b-rows [hi - lo, 88] of ``lwe.encrypt_section`` over the
    len(msgs) terms: its encryptions from byte section_offset + lo * CTR_CT.

    msgs: int64 words of all terms [total]; errs: the error rows of the
    rank's own terms only, uint8 [hi - lo, 88], so a rank draws nothing
    but its own."""
    lo, hi = chunk_bounds(msgs.shape[0], rank, world)
    if errs.shape[0] != hi - lo:
        raise ValueError(f"rank {rank} of {world} owns {hi - lo} terms, got {errs.shape[0]} errors")
    return tlwe.encrypt_section(
        key, section_offset + lo * params.ctr_ct, sk, msgs[lo:hi], errs, params)


def encrypt_section_sharded(
    key: sampling.PRGKey, section_offset: int, sk: torch.Tensor, msgs: torch.Tensor,
    errs: torch.Tensor, params: Params, mesh: DeviceMesh,
) -> torch.Tensor:
    """Compressed b-rows [total, 88] of ``lwe.encrypt_section``, the terms
    split over the ranks, on every rank (one ``all_gather``).  errs: the
    rank's own error rows (``encrypt_section_part``)."""
    _, rank, world = axis(mesh)
    rows = encrypt_section_part(rank, world, key, section_offset, sk, msgs, errs, params)
    return gather_rows(rows, msgs.shape[0], mesh)


def eval_poly_multi_part(
    rank: int, world: int, key: sampling.PRGKey, section_offset: int, b_rows: torch.Tensor,
    coeffs: torch.Tensor, params: Params,
) -> torch.Tensor:
    """The rank's share of ``lwe.eval_poly_multi``: its terms [lo, hi) of
    the d, from byte section_offset + lo * CTR_CT, as normalized digits
    uint8 [k, n+1, 88] (zeros for an empty share).  The shares sum to the
    whole mod 2^704: truncation is a ring homomorphism."""
    k, d = coeffs.shape
    lo, hi = chunk_bounds(d, rank, world)
    if hi == lo:
        return torch.zeros(k, params.n + 1, dg.DIGITS, dtype=torch.uint8, device=coeffs.device)
    return tlwe.eval_poly_multi(
        key, section_offset + lo * params.ctr_ct, b_rows[lo:hi],
        coeffs[:, lo:hi].contiguous(), params)


def eval_poly_multi_sharded(
    key: sampling.PRGKey, section_offset: int, b_rows: torch.Tensor, coeffs: torch.Tensor,
    params: Params, mesh: DeviceMesh,
) -> torch.Tensor:
    """k homomorphic evaluations, the degree axis split over the ranks:
    uint8 [k, n+1, 88] on every rank, equal to ``lwe.eval_poly_multi``.

    Each rank's share is digits <= 255, so one int32 ``all_reduce`` keeps
    every position <= 255 * world, and one ``carry_fold`` normalizes (K10
    on the card, which reads the int32 sums as they are)."""
    group, rank, world = axis(mesh)
    part = eval_poly_multi_part(rank, world, key, section_offset, b_rows, coeffs, params)
    part = part.to(torch.int32)
    dist.all_reduce(part, group=group)
    return dg.carry_fold(part)


def eval_poly_sharded(
    key: sampling.PRGKey, section_offset: int, b_rows: torch.Tensor, coeffs: torch.Tensor,
    params: Params, mesh: DeviceMesh,
) -> torch.Tensor:
    """Single-polynomial wrapper: uint8 [n+1, 88]."""
    return eval_poly_multi_sharded(key, section_offset, b_rows, coeffs[None], params, mesh)[0]
