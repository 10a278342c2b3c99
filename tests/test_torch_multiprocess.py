"""The port's CLI under ``--mesh`` in gloo worlds of 2 and 4 processes on the
CPU (``tests/_torch_dist_worker.py cli``; no child loads jax), against a
one-rank run of the same protocol.

Rank 0 prints ``verified: True`` and writes ``--save-dir``; every rank
writes its rows of each CRS section (``serial.crs_local_section_rows``),
rank 0 stitches them, and every rank reads its own rows of the stitched
file back (``serial.crs_local_slice``, bounds ``local_shard_bounds``).
The stitched file and the CLI's crs.bin equal ``crs_to_bytes`` of the
one-rank run, the slices tile its row table, and proof.bin, vrs.bin and
ssp.bin equal the one-rank run's.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from c_lwe_snarks_tpu_torch.__main__ import run_protocol
from c_lwe_snarks_tpu_torch.utils import params as params_mod
from c_lwe_snarks_tpu_torch.utils import serial

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)

WORLDS = (2, 4)
P = params_mod.custom(d=16, m=8)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return worker.run_worlds("cli", WORLDS, tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def one_rank():
    run = run_protocol(P, "cpu", worker.CRS_SEED, worker.ENT_SEED)
    assert run.verified
    return {"crs.bin": serial.crs_to_bytes(run.crs, P), "vrs.bin": serial.vrs_to_bytes(run.vrs, P),
            "proof.bin": serial.proof_to_bytes(run.proof, P),
            "ssp.bin": serial.ssp_to_buffer(run.ssp, P)}


@pytest.mark.parametrize("world", WORLDS)
def test_rank0_prints_verified(worlds, world):
    outs = [(worlds[world] / f"stdout_{r}.txt").read_text() for r in range(world)]
    assert "verified: True" in outs[0]
    assert not any("verified:" in out for out in outs[1:])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["crs.bin", "vrs.bin", "proof.bin", "ssp.bin"])
def test_saved_artifacts_equal_one_rank(worlds, one_rank, world, name):
    assert (worlds[world] / name).read_bytes() == one_rank[name]


@pytest.mark.parametrize("world", WORLDS)
def test_stitched_crs_equals_crs_to_bytes(worlds, one_rank, world):
    assert (worlds[world] / "crs_stitched.bin").read_bytes() == one_rank["crs.bin"]


@pytest.mark.parametrize("world", WORLDS)
def test_local_slices_tile_the_row_table(worlds, one_rank, world):
    table = np.frombuffer(one_rank["crs.bin"][40:], np.uint8).reshape(P.crs_num_cts, 92)[:, :88]
    slices = [np.load(worlds[world] / f"crs_local_slice_{r}.npy") for r in range(world)]
    chunk = -(-P.crs_num_cts // world)
    assert [s.shape[0] for s in slices[:-1]] == [chunk] * (world - 1)
    np.testing.assert_array_equal(np.concatenate(slices), table)
