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
