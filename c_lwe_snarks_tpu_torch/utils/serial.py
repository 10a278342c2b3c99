"""Byte formats of CRS, VRS, proof and SSP, byte-identical to
``c_lwe_snarks_tpu/utils/serial.py`` in both directions.

* CRS = 40-byte seed || s-section (d x 92) || as-section (d x 92) || t (92)
  || v-section ((m-1) x 92).
* VRS = alpha, beta, s as 8-byte LE words || sk (n x 92); the reader
  holds the scalars as uint32 (each < p), as the JAX package does.
* Proof = 5 full ciphertexts h, hat_h, hat_v, v_w, b_w, each (n+1) x 92.
* SSP buffer = t then v_0..v_{m-1}, each d uint64-LE coefficients; the
  readers narrow them to the SSP's uint32 after checking each is < p, and
  the writers widen them back, so the bytes are the reference's.

Stored rows are the 88 live digits zero-padded to 92 bytes.  The padding
is made and taken off on the device that holds the digits: a writer lays
its rows into one zeroed [rows, 92] table there (the VRS's scalars as
words in front of it), and the table crosses to the host in one copy into
a host buffer that is page-locked where the device is a card; a reader
copies the blob once into such a buffer, sends the whole table to the
device in one non-blocking copy and strips it there into one contiguous
[..., 88] tensor, whose slices are the artifact's fields.  So each whole
artifact makes one staged copy (``spans.staged``) and at most one host
sync: a writer's copy to the host (``spans.sync``), none in a reader.  The
host buffers come from torch's caching host allocator for each call, which
does not hand a pinned block out again while a copy from it may still be
in flight.  The readers put their tensors on the card unless the caller
names another device.  Each reader and writer of a whole artifact is a
span (``lwe.serial.<name>``).
The ``*_stream`` functions move release-scale files (the release SSP
buffer is 8 * 2^15 * 21846 bytes = 5.33 GiB) in row chunks, so the extra
host memory is one chunk.  ``crs_local_section_rows`` and
``crs_local_slice`` are the write and read halves of per-host CRS IO in a
multi-process run: each host writes and reads only its own rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import snark as tsnark
from ..models import ssp as tssp
from ..parallel import mesh as pmesh
from ..parallel import multihost
from . import spans
from .params import Params
from .spans import span


def _host_buffer(nbytes: int, device) -> tuple[torch.Tensor, bool]:
    """(uint8 [nbytes] host buffer, pinned): page-locked where ``device`` is
    a card."""
    pinned = torch.device(device).type == "cuda"
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned), pinned


def _stored(sections, params: Params, site: str, *, head: bytes = b"",
            words=()) -> torch.Tensor:
    """``head`` || ``words`` as 8-byte LE words || the uint8 [rows, <= 88]
    digit rows of ``sections`` as stored 92-byte rows: a uint8 host tensor.

    ``words`` are uint32 scalar tensors on the rows' device.  The words and
    the padded rows are laid out on that device, then cross to the host in
    one blocking copy behind ``head``, which the host writes itself."""
    device, cb = sections[0].device, params.ct_bytes
    nrows = sum(r.shape[0] for r in sections)
    dev = torch.zeros(8 * len(words) + nrows * cb, dtype=torch.uint8, device=device)
    low = dev[: 8 * len(words)].view(torch.uint32)[0::2]  # an 8-byte word's low half
    for i, w in enumerate(words):
        low[i] = w
    table, lo = dev[8 * len(words) :].view(nrows, cb), 0
    for r in sections:
        table[lo : lo + r.shape[0], : r.shape[-1]] = r
        lo += r.shape[0]
    host, pinned = _host_buffer(len(head) + dev.numel(), device)
    host.numpy()[: len(head)] = np.frombuffer(head, dtype=np.uint8)
    spans.sync(site, device)
    host[len(head) :].copy_(dev)
    spans.staged(site, host, pinned)
    return host


def _expect_len(buf, expect: int, what: str) -> None:
    if len(buf) != expect:
        raise ValueError(f"{what}: {len(buf)} bytes, expected {expect}")


def _staged_in(buf, offset: int, rows: tuple, params: Params, device, site: str,
               *, head: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(uint8 [head] bytes, uint8 digit rows [*rows, 88]) on ``device`` of
    ``buf`` from ``offset`` on: ``head`` bytes, then stored 92-byte rows.

    One host copy into a host buffer, one non-blocking copy of it to the
    device, and the strip there into one contiguous tensor."""
    host, pinned = _host_buffer(len(buf) - offset, device)
    host.numpy()[:] = np.frombuffer(buf, dtype=np.uint8, offset=offset)
    dev = host.to(device, non_blocking=True)
    spans.staged(site, host, pinned)
    table = dev[head:].view(*rows, params.ct_bytes)
    return dev[:head], table[..., :88].contiguous()


# --------------------------------------------------------------------------
# CRS
# --------------------------------------------------------------------------


def crs_to_bytes(crs: tsnark.CRS, params: Params) -> bytes:
    with span("lwe.serial.crs_to_bytes"):
        return _stored((crs.b_s, crs.b_as, crs.b_t[None], crs.b_v), params,
                       "serial.crs_to_bytes", head=bytes(crs.seed)).numpy().tobytes()


def crs_from_bytes(buf: bytes, params: Params, device="cuda") -> tsnark.CRS:
    d, cb = params.d, params.ct_bytes
    _expect_len(buf, 40 + cb * params.crs_num_cts, "CRS")
    with span("lwe.serial.crs_from_bytes"):
        _, rows = _staged_in(buf, 40, (params.crs_num_cts,), params, device,
                             "serial.crs_from_bytes")
        return tsnark.CRS(seed=bytes(buf[:40]), b_s=rows[:d], b_as=rows[d : 2 * d],
                          b_t=rows[2 * d], b_v=rows[2 * d + 1 :])


# --------------------------------------------------------------------------
# VRS (the trapdoor: keep this file designated-verifier-private)
# --------------------------------------------------------------------------


def vrs_to_bytes(vrs: tsnark.VRS, params: Params) -> bytes:
    with span("lwe.serial.vrs_to_bytes"):
        return _stored((vrs.sk,), params, "serial.vrs_to_bytes",
                       words=(vrs.alpha, vrs.beta, vrs.s)).numpy().tobytes()


def vrs_from_bytes(buf: bytes, params: Params, device="cuda") -> tsnark.VRS:
    n, cb = params.n, params.ct_bytes
    _expect_len(buf, 24 + n * cb, "VRS")
    words = [int.from_bytes(buf[8 * i : 8 * i + 8], "little") for i in range(3)]
    if max(words) >= params.p:
        raise ValueError("VRS scalars must be reduced mod p")
    with span("lwe.serial.vrs_from_bytes"):
        head, sk = _staged_in(buf, 0, (n,), params, device, "serial.vrs_from_bytes", head=24)
        alpha, beta, s = head.view(torch.uint32)[0::2]  # the words' low halves
        return tsnark.VRS(alpha=alpha, beta=beta, s=s, sk=sk)


# --------------------------------------------------------------------------
# Proof
# --------------------------------------------------------------------------


def proof_to_bytes(pi: tsnark.Proof, params: Params) -> bytes:
    with span("lwe.serial.proof_to_bytes"):
        return _stored((pi.h, pi.hat_h, pi.hat_v, pi.v_w, pi.b_w), params,
                       "serial.proof_to_bytes").numpy().tobytes()


def proof_from_bytes(buf: bytes, params: Params, device="cuda") -> tsnark.Proof:
    n, cb = params.n, params.ct_bytes
    _expect_len(buf, 5 * (n + 1) * cb, "proof")
    with span("lwe.serial.proof_from_bytes"):
        _, cts = _staged_in(buf, 0, (5, n + 1), params, device, "serial.proof_from_bytes")
        return tsnark.Proof(h=cts[0], hat_h=cts[1], hat_v=cts[2], v_w=cts[3], b_w=cts[4])


# --------------------------------------------------------------------------
# SSP flat buffer (reference src/ssp.h:6-9 layout)
# --------------------------------------------------------------------------


def _check_whole(ssp: tssp.SSP, params: Params) -> None:
    if ssp.row0 or ssp.v.shape[0] != params.m:
        raise ValueError("the SSP holds a rank's rows of v: gather them first (mesh.gather_rows)")


def ssp_to_buffer(ssp: tssp.SSP, params: Params) -> bytes:
    """t then v_0..v_{m-1}, each d uint64-LE coefficients (< p)."""
    _check_whole(ssp, params)
    with span("lwe.serial.ssp_to_buffer"):
        spans.sync("serial.ssp_to_buffer", ssp.t.device, 2)  # t's and v's copies to the host
        t = ssp.t.cpu().numpy().astype("<u8")
        v = ssp.v.cpu().numpy().astype("<u8")
        return t.tobytes() + v.tobytes()


def _reduced_words(words: np.ndarray, params: Params) -> np.ndarray:
    """uint64 file words -> uint32 (the SSP's type), refusing a coefficient
    >= p."""
    if (words >= params.p).any():
        raise ValueError("SSP coefficients must be reduced mod p")
    return words.astype(np.uint32)


def ssp_from_buffer(buf: bytes, params: Params, device="cuda") -> tssp.SSP:
    d, m = params.d, params.m
    _expect_len(buf, 8 * d * (m + 1), "SSP buffer")
    with span("lwe.serial.ssp_from_buffer"):
        words = _reduced_words(np.frombuffer(buf, dtype="<u8").reshape(m + 1, d), params)
        spans.sync("serial.ssp_from_buffer", device, 2)  # t's and v's copies to the device
        return tssp.SSP(t=torch.tensor(words[0], device=device),
                        v=torch.tensor(words[1:], device=device))


# --------------------------------------------------------------------------
# Streaming / mmap IO: release-scale files without whole-blob staging
# --------------------------------------------------------------------------


def ssp_write_stream(
    path: str, ssp: tssp.SSP, params: Params, *, rows_per_chunk: int = 256
) -> None:
    """Write the flat SSP layout chunk-wise; byte-identical to
    ``save(path, ssp_to_buffer(...))``."""
    _check_whole(ssp, params)
    with open(path, "wb") as f:
        f.write(ssp.t.cpu().numpy().astype("<u8").tobytes())
        for lo in range(0, ssp.v.shape[0], rows_per_chunk):
            f.write(ssp.v[lo : lo + rows_per_chunk].cpu().numpy().astype("<u8").tobytes())


def ssp_read_stream(
    path: str, params: Params, device="cuda", *, rows_per_chunk: int = 256
) -> tssp.SSP:
    """Load an SSP buffer through np.memmap, chunk-wise onto the device.

    Each chunk of rows is validated (< p) and copied into the device
    tensors; the host holds one chunk at a time."""
    d, m = params.d, params.m
    words = np.memmap(path, dtype="<u8", mode="r", shape=(m + 1, d))
    rows = torch.empty(m + 1, d, dtype=torch.uint32, device=device)
    for lo in range(0, m + 1, rows_per_chunk):
        chunk = _reduced_words(np.asarray(words[lo : lo + rows_per_chunk]), params)
        rows[lo : lo + chunk.shape[0]] = torch.from_numpy(chunk).to(device)
    return tssp.SSP(t=rows[0], v=rows[1:])


def crs_write_stream(
    path: str, crs: tsnark.CRS, params: Params, *, rows_per_chunk: int = 4096
) -> None:
    """Write the CRS file (seed || 92-byte row table) chunk-wise."""
    with open(path, "wb") as f:
        f.write(bytes(crs.seed))
        for rows in (crs.b_s, crs.b_as, crs.b_t[None], crs.b_v):
            for lo in range(0, rows.shape[0], rows_per_chunk):
                f.write(_stored((rows[lo : lo + rows_per_chunk],), params,
                                "serial.crs_write_stream").numpy().tobytes())


def crs_row_table(path: str, params: Params) -> tuple[bytes, np.ndarray]:
    """(seed, read-only memmap [crs_num_cts, 92]) over a CRS file.

    Rows [0, d) are b_s, [d, 2d) b_as, row 2d is b_t, [2d+1, ...) b_v, as
    in ``crs_from_bytes``.  Slicing the mapping reads only the touched
    pages."""
    with open(path, "rb") as f:
        seed = f.read(40)
    rows = np.memmap(path, dtype=np.uint8, mode="r", offset=40,
                     shape=(params.crs_num_cts, params.ct_bytes))
    return seed, rows


def _section_rows(rows, params: Params) -> np.ndarray:
    return _stored((rows,), params, "serial.crs_local_section_rows").numpy().reshape(
        -1, params.ct_bytes)


def crs_local_section_rows(
    crs: tsnark.CRS, params: Params, mesh
) -> dict[str, tuple[int, np.ndarray]]:
    """This rank's rows of each CRS section in the stored 92-byte form.

    The write half of per-host CRS IO: each section is split over the
    ranks by the chunk rule (``multihost.chunk_bounds``), so every host
    writes only its own rows, and the file stitched from them in rank
    order equals ``crs_to_bytes``.  Returns {"s" | "as" | "v": (first row,
    uint8 [rows, 92]), "t": (0, [1, 92])}; "t" is whole on every rank, so
    callers pick one writer."""
    _, rank, world = pmesh.axis(mesh)
    out = {}
    for name, rows in (("s", crs.b_s), ("as", crs.b_as), ("v", crs.b_v)):
        lo, hi = multihost.chunk_bounds(rows.shape[0], rank, world)
        out[name] = (lo, _section_rows(rows[lo:hi], params))
    out["t"] = (0, _section_rows(crs.b_t[None], params))
    return out


def crs_local_slice(path: str, params: Params) -> tuple[bytes, int, np.ndarray]:
    """(seed, first row, rows [hi - lo, 88]) of this host's CRS rows.

    The read half of per-host CRS IO: rows [lo, hi) of the whole
    2d+1+(m-1) row table by ``multihost.local_shard_bounds``, read through
    ``crs_row_table``'s memmap, so a host touches only its own pages."""
    seed, table = crs_row_table(path, params)
    lo, hi = multihost.local_shard_bounds(params.crs_num_cts)
    return seed, lo, np.asarray(table[lo:hi, :88])


# --------------------------------------------------------------------------
# File helpers
# --------------------------------------------------------------------------


def save(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
