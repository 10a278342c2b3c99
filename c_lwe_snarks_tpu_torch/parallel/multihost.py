"""Process group and mesh of a multi-GPU run: one process a device.

Port of ``c_lwe_snarks_tpu/parallel/multihost.py`` in torch's idiom.
JAX runs one controller over many devices; here every GPU has its own
process (SPMD), started by ``torchrun``, and the mesh is a 1-D
``DeviceMesh`` named ``"shard"`` over the default process group.  NCCL
carries the collectives of ``cuda`` tensors and gloo those of ``cpu``
tensors; a rank's device is ``cuda:LOCAL_RANK``.  The enabling property is
the one ``mesh.py`` uses: AES-CTR seeks in O(1), so every rank
regenerates its own slice of the CRS or entropy stream from (seed, byte
offset) and no keystream crosses the wire, only the compressed 88-byte
rows, the evaluation planes and the NTT's transposes.

A world of 1 needs no launcher: with none of torchrun's environment
``initialize`` starts one on an in-process ``HashStore`` (no port, no
network).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS = "shard"
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(device="cuda") -> None:
    """Start the default process group; a no-op if one is up.

    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) names the world; without it a world
    of 1 starts on a ``HashStore``.  NCCL for ``cuda``, whose rank device
    becomes ``cuda:LOCAL_RANK`` (without a card this raises, as the
    single-device entry point does), gloo for ``cpu``.  A caller that
    starts the group itself (e.g. on a ``file://`` store) does so first.
    """
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda world needs a CUDA device; none is available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if all(v in os.environ for v in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def global_mesh() -> DeviceMesh:
    """1-D mesh named ``"shard"`` over every rank of the default group
    (``initialize`` first)."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(AXIS,))


def chunk_bounds(total: int, rank: int, world: int) -> tuple[int, int]:
    """[lo, hi) of rank's contiguous chunk of ``total`` items: chunk =
    ceil(total / world), the last chunks ragged or empty."""
    chunk = -(-total // world)
    lo = min(rank * chunk, total)
    return lo, min(lo + chunk, total)


def local_shard_bounds(total: int) -> tuple[int, int]:
    """[lo, hi) of this process's chunk of ``total`` items (``chunk_bounds``
    at this rank; the whole range without a process group).  Used for
    per-host IO, e.g. reading this host's rows of a CRS file."""
    if not dist.is_initialized():
        return 0, total
    return chunk_bounds(total, dist.get_rank(), dist.get_world_size())
