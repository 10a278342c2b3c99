"""K7, the gated row-sum kernel (c_lwe_snarks_tpu_torch/csrc/rowsum.cu):
its plain version and a torch model of its chunked partial sums against
the JAX package's gated_rowsum_mod_p on the same uint32 rows, tolerance 0.

The model follows the kernel with the .cu's own chunk size: each chunk of
kChunkRows rows keeps only its gated rows (the compaction), sums them per
column in 64 bits, the chunks' partials are added in chunk order and the
sum is folded mod p with 2^32 = 5 (mod p).  The kernel itself is held
against the plain version on a GPU in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.ops import modp as jmodp
from c_lwe_snarks_tpu_torch.ops import modp as tmodp

torch.set_num_threads(1)

P = (1 << 32) - 5
SOURCE = (pathlib.Path(tmodp.__file__).resolve().parent.parent / "csrc" / "rowsum.cu").read_text()
_jrowsum = jax.jit(jmodp.gated_rowsum_mod_p)


def constant(name: str) -> int:
    """An integer constexpr of rowsum.cu."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


CHUNK = constant("kChunkRows")


def k7_model(v: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: per-chunk int64 sums of the gated rows,
    chunk-order total (< 2^53), then reduce53_mod_p."""
    partials = []
    for r0 in range(0, v.shape[0], CHUNK):
        idx = torch.nonzero(gate[r0 : r0 + CHUNK]).flatten()  # the compacted row list
        partials.append(v[r0 + idx].to(torch.int64).sum(0))
    total = torch.stack(partials).sum(0)
    assert int(total.max()) < 1 << 53
    r = 5 * (total >> 32) + (total & 0xFFFFFFFF)
    for _ in range(2):
        r = torch.where(r >= P, r - P, r)
    return r


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_k7_refuses_rows_that_are_not_uint32(dtype):
    """No quiet conversion on any device: an int64 v (the type before the
    SSP was uint32) raises on the CPU as it does on the card."""
    v = torch.zeros(3, 8, dtype=dtype)
    with pytest.raises(ValueError, match="uint32"):
        tmodp.gated_rowsum_mod_p(v, torch.ones(3, dtype=torch.uint8))


def test_k7_constants():
    """The wrapper sizes the partials by the kernel's chunk; one row a
    thread in the compaction."""
    assert CHUNK == tmodp.ROWSUM_CHUNK_ROWS == constant("kThreads")


@pytest.mark.parametrize("rows,d,gate_kind", [
    (2 * CHUNK + 3, 37, "ones_max"),  # the largest sum, a ragged last chunk
    (CHUNK + 1, 40, "zero"),
    (CHUNK, 33, "random"),
    (3 * CHUNK + 17, 129, "random"),
    (5, 3, "ones_max"),
])
def test_k7_rowsum_matches_jax(rows, d, gate_kind):
    rng = np.random.default_rng(rows + d)
    if gate_kind == "ones_max":
        v = np.full((rows, d), P - 1, np.uint32)
    else:
        v = rng.integers(0, P, size=(rows, d), dtype=np.uint64).astype(np.uint32)
    gate = {"ones_max": np.ones(rows, np.uint8), "zero": np.zeros(rows, np.uint8),
            "random": rng.integers(0, 2, size=rows, dtype=np.uint8)}[gate_kind]
    want = np.asarray(_jrowsum(jnp.asarray(v), jnp.asarray(gate))).astype(np.int64)
    tv, tg = torch.from_numpy(v), torch.from_numpy(gate)
    for got in (tmodp.gated_rowsum_plain(tv, tg), tmodp.gated_rowsum_mod_p(tv, tg),
                tmodp.gated_rowsum_mod_p(tv, tg.bool()), k7_model(tv, tg)):
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# K7's many-witness form: the B row-sums of one v in one launch
# --------------------------------------------------------------------------

MANY_CHUNK = constant("kManyChunkRows")


def reduce53(total: torch.Tensor) -> torch.Tensor:
    assert int(total.max()) < 1 << 53
    r = 5 * (total >> 32) + (total & 0xFFFFFFFF)
    for _ in range(2):
        r = torch.where(r >= P, r - P, r)
    return r


def k7_many_model(v, rows, stride, k, m, d, partial, done, out):
    """The many-witness kernel's arithmetic, with the launcher's arguments:
    per chunk of rows, the rows some statement gates (the compaction), each
    byte plane's gate-weighted sums (the int32 MMA accumulators, checked
    < 2^31), combined as sum_p acc_p 2^(8p) into the chunk's partial; the
    partials added in chunk order and reduced as reduce53_mod_p."""
    assert rows.shape == (k, m) and rows.stride() == (stride, 1) and 1 <= k <= 16
    chunk = MANY_CHUNK
    chunks = -(-m // chunk)
    partial = partial.view(chunks, k, d)
    for c in range(chunks):
        g = rows[:, c * chunk : (c + 1) * chunk] != 0
        keep = torch.nonzero(g.any(0)).flatten()
        a = g[:, keep].to(torch.int64)
        words = v[c * chunk + keep].to(torch.int64)
        acc = [a @ ((words >> (8 * p)) & 255) for p in range(4)]
        assert all(int(x.max()) < 1 << 31 for x in acc)
        partial[c] = sum(x << (8 * p) for p, x in enumerate(acc))
    out.copy_(reduce53(partial.sum(0)))


def _many_case(rows: int, d: int, b: int, kind: str):
    """v uint32 [rows, d] and gates uint8 [b, rows + 1] (the batch's witnesses;
    the row-sums take the first rows columns).  "ones_max": every entry p - 1,
    every gate 1; "random": random bits, row 5 gated by no statement and row 7
    by every one."""
    rng = np.random.default_rng(rows + d + b)
    if kind == "ones_max":
        v = np.full((rows, d), P - 1, np.uint32)
        wits = np.ones((b, rows + 1), np.uint8)
    else:
        v = rng.integers(0, P, size=(rows, d), dtype=np.uint64).astype(np.uint32)
        wits = rng.integers(0, 2, size=(b, rows + 1), dtype=np.uint8)
        wits[:, 5], wits[:, 7] = 0, 1
    return v, wits


@pytest.mark.parametrize("b", [1, 2, 10, 17])
@pytest.mark.parametrize("rows,d,kind", [(2 * MANY_CHUNK + 37, 37, "random"), (300, 33, "ones_max")])
def test_k7_many_rowsums_match_single_rowsums(monkeypatch, rows, d, b, kind):
    """gated_rowsums_mod_p's plain path and a model of its launches (several
    chunks of rows and a ragged last one; one launch a group
    of 16 statements, the gates a column slice read in place) give, row by
    row, B gated_rowsum_plain calls and the JAX package's gated_rowsum_mod_p."""
    v, wits = _many_case(rows, d, b, kind)
    tv = torch.from_numpy(v)
    gates = torch.from_numpy(wits)[:, :rows]  # a column slice, as the prover passes it
    assert gates.stride() == (rows + 1, 1)
    want = np.stack([np.asarray(_jrowsum(jnp.asarray(v), jnp.asarray(w[:rows]))) for w in wits])
    singles = torch.stack([tmodp.gated_rowsum_plain(tv, g) for g in gates])
    np.testing.assert_array_equal(singles.numpy(), want.astype(np.int64))
    monkeypatch.setattr(tmodp._build, "launch", lambda name, *args: k7_many_model(*args))
    before = tmodp.LAUNCHES["gated_rowsums_p"]
    modelled = tmodp._rowsums_launch(tv, gates)
    assert tmodp.LAUNCHES["gated_rowsums_p"] - before == -(-b // 16)
    for got in (tmodp.gated_rowsums_plain(tv, gates), tmodp.gated_rowsums_mod_p(tv, gates),
                tmodp.gated_rowsums_mod_p(tv, gates.bool()), modelled):
        assert got.dtype == torch.int64 and got.shape == (b, d)
        assert torch.equal(got, singles)


def test_k7_many_constants():
    """The wrapper's constants are the .cu's; the staged gates' row stride
    makes the A fragments' loads conflict-free (4 words apart a statement)."""
    assert tmodp.ROWSUMS_STATEMENTS == constant("kStatements") == 16
    assert tmodp.ROWSUMS_COLS == constant("kManyCols")
    assert tmodp.ROWSUMS_CHUNK_ROWS == MANY_CHUNK and 255 * MANY_CHUNK < 1 << 31
    assert MANY_CHUNK % constant("kManyThreads") == 0
    assert "kGateStride = kManyChunkRows + 16;" in SOURCE and (MANY_CHUNK + 16) // 4 % 32 == 4


@pytest.mark.parametrize("bad", ["gates_int64", "gates_1d", "gates_cols", "gates_device", "v_int64"])
def test_k7_many_refuses_what_it_cannot_read(bad):
    """Shape, type and device errors raise ValueError on the CPU too."""
    v = torch.zeros(6, 8, dtype=torch.uint32)
    gates = torch.ones(3, 6, dtype=torch.uint8)
    case = {"gates_int64": (v, gates.to(torch.int64)), "gates_1d": (v, gates[0]),
            "gates_cols": (v, torch.ones(3, 7, dtype=torch.uint8)),
            "gates_device": (v, gates.to("meta")), "v_int64": (v.to(torch.int64), gates)}[bad]
    with pytest.raises(ValueError):
        tmodp.gated_rowsums_mod_p(*case)
