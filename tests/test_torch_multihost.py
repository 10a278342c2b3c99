"""The port's process-group helpers (parallel/multihost.py) in one process:
a world of 1 without a launcher, its mesh, and the chunk rule that every
sharded primitive and per-host read uses (as tests/test_multihost.py
checks the JAX package's)."""

import pytest
import torch.distributed as dist

from c_lwe_snarks_tpu_torch.parallel import mesh as pmesh
from c_lwe_snarks_tpu_torch.parallel import multihost


@pytest.fixture
def world_of_one(monkeypatch):
    """No torchrun environment: initialize() starts a world of 1 on gloo;
    the group is torn down after the test."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    multihost.initialize("cpu")
    yield
    dist.destroy_process_group()


def test_initialize_starts_a_world_of_one(world_of_one):
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    assert dist.get_backend() == "gloo"
    group = dist.group.WORLD
    multihost.initialize("cpu")  # a second call is a no-op
    assert dist.group.WORLD is group


def test_global_mesh_has_one_rank_named_shard(world_of_one):
    mesh = multihost.global_mesh()
    assert mesh.mesh_dim_names == ("shard",)
    assert mesh.size() == 1 and mesh.device_type == "cpu"
    assert pmesh.axis(mesh)[1:] == (0, 1)
    assert pmesh.make_mesh(1, "cpu").size() == 1


def test_make_mesh_names_torchrun_past_the_world(world_of_one):
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        pmesh.make_mesh(4, "cpu")


def test_local_shard_bounds(world_of_one):
    assert multihost.local_shard_bounds(100) == (0, 100)
    assert multihost.local_shard_bounds(0) == (0, 0)


def test_local_shard_bounds_without_a_group():
    assert not dist.is_initialized()
    assert multihost.local_shard_bounds(7) == (0, 7)


def test_cuda_world_needs_a_card(monkeypatch):
    """Nothing falls back: a cuda world without a card raises."""
    monkeypatch.setattr(multihost.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        multihost.initialize("cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("total,world,sizes", [
    (87_381, 4, [21_846, 21_846, 21_846, 21_843]),  # the prover's terms at release
    (21_845, 3, [7_282, 7_282, 7_281]),  # random_ssp's rows at release
    (16, 3, [6, 6, 4]),
    (7, 4, [2, 2, 2, 1]),
    (5, 4, [2, 2, 1, 0]),  # a rank may own nothing
    (1, 2, [1, 0]),
])
def test_chunk_bounds(total, world, sizes):
    """chunk = ceil(total / world): contiguous chunks that tile [0, total)."""
    bounds = [multihost.chunk_bounds(total, r, world) for r in range(world)]
    assert [hi - lo for lo, hi in bounds] == sizes
    assert bounds[0][0] == 0 and bounds[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_a_rank_rows_ssp_is_refused_where_the_whole_one_is_needed(tmp_path):
    """An SSP that holds a rank's rows of v is not written as the whole SSP
    and not given to the verifier, which reads v_0."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.utils import serial
    from c_lwe_snarks_tpu_torch.utils.params import Params

    P = Params(d=16, m=8, n=32)
    part = tssp.SSP(t=torch.zeros(16, dtype=torch.int64),
                    v=torch.zeros(4, 16, dtype=torch.int64), row0=4)
    for write in (lambda: serial.ssp_to_buffer(part, P),
                  lambda: serial.ssp_write_stream(str(tmp_path / "ssp.bin"), part, P)):
        with pytest.raises(ValueError, match="rank's rows"):
            write()
    with pytest.raises(ValueError, match="v_0"):
        tsnark.verifier(None, part, None, P)
