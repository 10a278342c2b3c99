"""Command-line entry point: run the full protocol end to end.

    python -m c_lwe_snarks_tpu_torch [--profile toy|release] [--d D --m M]
        [--device cuda|cpu] [--save-dir DIR] [--probe] [--mesh N]

Runs random_ssp -> setup -> prover -> verifier with the same seeds and
stream layout as ``python -m c_lwe_snarks_tpu``, prints each stage's
time, optionally runs the designated-verifier decrypt-probes after setup
and prove, optionally writes the CRS/VRS/proof/SSP byte formats, and
prints ``verified: True`` when the verifier accepts.  ``--device cuda``
runs the CUDA kernels and fails without a GPU.

``--mesh N`` shards the protocol over a world of N processes, one a
device (NCCL for cuda, gloo for cpu):

    torchrun --nproc-per-node N -m c_lwe_snarks_tpu_torch --mesh N --device cuda

Without torchrun, ``--mesh 1`` starts a world of 1.  Every rank ends with
the whole CRS and proof; rank 0 prints ``verified:`` and writes
``--save-dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from .models import snark as tsnark
from .models import ssp as tssp
from .ops import sampling
from .parallel import mesh as pmesh
from .utils import obs, serial
from .utils import params as params_mod


@dataclasses.dataclass
class Run:
    """Artifacts and stage times (seconds) of one protocol run."""

    witness: torch.Tensor
    ssp: tssp.SSP
    crs: tsnark.CRS
    vrs: tsnark.VRS
    proof: tsnark.Proof
    verified: bool
    times: dict


def _run_probe(name: str, checks: dict, file) -> None:
    """Print the probe's boolean checks; raise if one is false."""
    flags = {k: bool(v) for k, v in checks.items() if v.dtype == torch.bool}
    print(f"{name} probe: {flags}", file=file)
    if not all(flags.values()):
        raise RuntimeError(f"{name} probe failed: {flags}")


def run_protocol(
    P, device, crs_seed: bytes, ent_seed: bytes, *, probe: bool = False, mesh=None,
    file=sys.stderr,
) -> Run:
    """random_ssp -> setup -> prover -> verifier, timed per stage.

    With ``probe`` the decrypt-probes run after setup (``obs.probe_crs``)
    and after prove (``obs.probe_proof``), outside the stage timers, and a
    false check raises.  With ``mesh`` every stage but the verifier splits
    over the ranks (``parallel.mesh``): the run's SSP holds the rank's rows
    of v, its CRS and proof are whole."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; none is available")
    crs_key = sampling.PRGKey(crs_seed, device)
    ent_key = sampling.PRGKey(ent_seed, device)
    off_setup = tssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + tsnark.setup_entropy_bytes(P)
    times: dict = {}
    with obs.timeit("random_ssp", device, out=times, file=file):
        if mesh is None:
            wits, inst = tssp.random_ssp(ent_key, 0, P)
        else:
            wits, inst = pmesh.random_ssp_sharded(ent_key, 0, P, mesh)
    with obs.timeit("setup", device, out=times, file=file):
        crs, vrs = tsnark.setup(crs_key, ent_key, off_setup, inst, P, mesh=mesh)
    if probe:
        _run_probe("crs", obs.probe_crs(crs, vrs, P), file)
    with obs.timeit("prover", device, out=times, file=file):
        pi = tsnark.prover(crs_key, ent_key, off_prove, crs, inst, wits, P, mesh=mesh)
    if probe:
        _run_probe("proof", obs.probe_proof(pi, vrs, P), file)
    # the verifier reads t and v_0, which a rank past 0 gets from rank 0
    v_inst = inst if mesh is None else tssp.SSP(t=inst.t, v=pmesh.row_zero(inst, mesh)[None])
    with obs.timeit("verifier", device, out=times, file=file):
        ok = bool(tsnark.verifier(vrs, v_inst, pi, P))
    return Run(wits, inst, crs, vrs, pi, ok, times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="c_lwe_snarks_tpu_torch")
    ap.add_argument("--profile", default="toy", choices=["toy", "release"])
    ap.add_argument("--d", type=int)
    ap.add_argument("--m", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain torch)")
    ap.add_argument("--save-dir", help="persist crs/vrs/proof/ssp here")
    ap.add_argument("--probe", action="store_true",
                    help="run decrypt-probes after setup and prove")
    ap.add_argument("--crs-seed", default="00" * 40, help="40-byte hex")
    ap.add_argument("--ent-seed", default="01" * 40, help="40-byte hex")
    ap.add_argument("--mesh", type=int,
                    help="shard over a world of N ranks (torchrun --nproc-per-node N)")
    args = ap.parse_args(argv)

    P = (params_mod.custom(d=args.d, m=args.m) if args.d and args.m
         else getattr(params_mod, args.profile)())
    print(f"params: {P}", file=sys.stderr)
    mesh, owns_group = None, False
    if args.mesh:
        owns_group = not dist.is_initialized()
        mesh = pmesh.make_mesh(args.mesh, args.device)
        print(f"mesh: rank {dist.get_rank()} of {args.mesh} ({dist.get_backend()})",
              file=sys.stderr)
    try:
        run = run_protocol(P, args.device, bytes.fromhex(args.crs_seed),
                           bytes.fromhex(args.ent_seed), probe=args.probe, mesh=mesh)
        lead = mesh is None or dist.get_rank() == 0
        if args.save_dir:
            ssp = run.ssp
            if mesh is not None:  # every rank's rows of v, for rank 0 to write
                ssp = tssp.SSP(t=ssp.t, v=pmesh.gather_rows(ssp.v, P.m, mesh))
            if lead:
                _save(args.save_dir, run, ssp, P)
        if lead:
            print(f"verified: {run.verified}")
    finally:
        if owns_group:
            dist.destroy_process_group()
    return 0 if run.verified else 1


def _save(save_dir: str, run: Run, ssp: tssp.SSP, P) -> None:
    os.makedirs(save_dir, exist_ok=True)
    for name, blob in (
        ("crs.bin", serial.crs_to_bytes(run.crs, P)),
        ("vrs.bin", serial.vrs_to_bytes(run.vrs, P)),
        ("proof.bin", serial.proof_to_bytes(run.proof, P)),
    ):
        serial.save(os.path.join(save_dir, name), blob)
    serial.ssp_write_stream(os.path.join(save_dir, "ssp.bin"), ssp, P)
    print(f"artifacts saved to {save_dir}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
