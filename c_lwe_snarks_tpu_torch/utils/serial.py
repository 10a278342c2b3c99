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

Stored rows are the 88 live digits zero-padded to 92 bytes.  The readers
put their tensors on the card unless the caller names another device.
Each reader and writer of a whole artifact is a span
(``lwe.serial.<name>``), and each copy between the host and the device a
counted host sync (``utils.spans``).
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


def _rows92(rows, params: Params) -> np.ndarray:
    """uint8 [..., 88] rows -> [..., 92] numpy (stored format)."""
    spans.sync("serial._rows92", rows.device)
    r = rows.cpu().numpy().astype(np.uint8)
    pad = params.ct_bytes - r.shape[-1]
    return np.pad(r, [(0, 0)] * (r.ndim - 1) + [(0, pad)]) if pad else r


def _expect_len(buf, expect: int, what: str) -> None:
    if len(buf) != expect:
        raise ValueError(f"{what}: {len(buf)} bytes, expected {expect}")


def _rows88(arr: np.ndarray, device) -> torch.Tensor:
    """Stored [..., 92] rows -> uint8 digit tensor [..., 88] on the device."""
    spans.sync("serial._rows88", device)
    return torch.tensor(np.ascontiguousarray(arr[..., :88]), device=device)


# --------------------------------------------------------------------------
# CRS
# --------------------------------------------------------------------------


def crs_to_bytes(crs: tsnark.CRS, params: Params) -> bytes:
    with span("lwe.serial.crs_to_bytes"):
        parts = [bytes(crs.seed)]
        for rows in (crs.b_s, crs.b_as, crs.b_t[None], crs.b_v):
            parts.append(_rows92(rows, params).tobytes())
        return b"".join(parts)


def crs_from_bytes(buf: bytes, params: Params, device="cuda") -> tsnark.CRS:
    d, cb = params.d, params.ct_bytes
    _expect_len(buf, 40 + cb * params.crs_num_cts, "CRS")
    with span("lwe.serial.crs_from_bytes"):
        arr = np.frombuffer(buf, dtype=np.uint8, offset=40).reshape(-1, cb)
        return tsnark.CRS(
            seed=bytes(buf[:40]), b_s=_rows88(arr[:d], device),
            b_as=_rows88(arr[d : 2 * d], device), b_t=_rows88(arr[2 * d], device),
            b_v=_rows88(arr[2 * d + 1 :], device))


# --------------------------------------------------------------------------
# VRS (the trapdoor: keep this file designated-verifier-private)
# --------------------------------------------------------------------------


def vrs_to_bytes(vrs: tsnark.VRS, params: Params) -> bytes:
    with span("lwe.serial.vrs_to_bytes"):
        spans.sync("serial.vrs_to_bytes", vrs.alpha.device, 3)  # int() of each scalar
        scalars = b"".join(int(x).to_bytes(8, "little") for x in (vrs.alpha, vrs.beta, vrs.s))
        return scalars + _rows92(vrs.sk, params).tobytes()


def vrs_from_bytes(buf: bytes, params: Params, device="cuda") -> tsnark.VRS:
    n, cb = params.n, params.ct_bytes
    _expect_len(buf, 24 + n * cb, "VRS")
    words = [int.from_bytes(buf[8 * i : 8 * i + 8], "little") for i in range(3)]
    if max(words) >= params.p:
        raise ValueError("VRS scalars must be reduced mod p")
    with span("lwe.serial.vrs_from_bytes"):
        spans.sync("serial.vrs_from_bytes", device, 3)  # each scalar's copy to the device
        alpha, beta, s = (torch.tensor(w, dtype=torch.uint32, device=device) for w in words)
        sk = np.frombuffer(buf, dtype=np.uint8, offset=24).reshape(n, cb)
        return tsnark.VRS(alpha=alpha, beta=beta, s=s, sk=_rows88(sk, device))


# --------------------------------------------------------------------------
# Proof
# --------------------------------------------------------------------------


def proof_to_bytes(pi: tsnark.Proof, params: Params) -> bytes:
    with span("lwe.serial.proof_to_bytes"):
        return _rows92(pi.stack(), params).tobytes()


def proof_from_bytes(buf: bytes, params: Params, device="cuda") -> tsnark.Proof:
    n, cb = params.n, params.ct_bytes
    _expect_len(buf, 5 * (n + 1) * cb, "proof")
    with span("lwe.serial.proof_from_bytes"):
        cts = _rows88(np.frombuffer(buf, dtype=np.uint8).reshape(5, n + 1, cb), device)
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
                f.write(_rows92(rows[lo : lo + rows_per_chunk], params).tobytes())


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
        out[name] = (lo, _rows92(rows[lo:hi], params))
    out["t"] = (0, _rows92(crs.b_t[None], params))
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
