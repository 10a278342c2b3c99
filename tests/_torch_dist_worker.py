"""One rank of a gloo world on the CPU, for the port's multi-process tests.

    python tests/_torch_dist_worker.py primitives|cli <rank> <world> <outdir>

The world starts on a file store in ``outdir`` (no port).  The process
blocks jax, jaxlib and the JAX package before it imports the port.

* ``primitives`` (tests/test_torch_parallel.py): every sharded primitive
  of ``parallel.mesh``, the 4-step NTT and the protocol at the tiny
  parameters, on the inputs of ``case_inputs``; rank 0 writes each whole
  result to ``<outdir>/<case>.npz``, every rank its protocol digests.
* ``cli`` (tests/test_torch_multiprocess.py): ``python -m
  c_lwe_snarks_tpu_torch --mesh <world>``, then the per-host CRS IO: each
  rank writes its ``serial.crs_local_section_rows``, rank 0 stitches them
  into ``crs_stitched.bin``, and each rank reads its rows back with
  ``serial.crs_local_slice``.

This module's top level imports numpy only: the tests import it for
``CASES``, ``case_inputs`` and ``run_worlds``.
"""

import hashlib
import json
import os
import subprocess
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_MOD = (1 << 32) - 5
CRS_SEED = bytes(range(40, 80))
ENT_SEED = bytes(range(40))
TINY = {"d": 16, "m": 8, "n": 32}
MIN_SHARD_N = 64  # the 4-step NTT's threshold, lowered to reach it at n = 64

# case -> (kind, parameters); the cases of tests/test_parallel.py
CASES = {
    **{f"encrypt_n{n}_count{c}": ("encrypt", {"n": n, "count": c, "off": 0})
       for n in (32, 3, 5) for c in (16, 7)},
    "encrypt_lead8_n6_count37": ("encrypt", {"n": 6, "count": 37, "off": 40}),
    **{f"eval_n{n}_k2": ("eval", {"n": n, "d": 16, "k": 2, "off": 0}) for n in (32, 3, 5)},
    "eval_lead8_n6_d256": ("eval", {"n": 6, "d": 256, "k": 2, "off": 40}),
    "eval_poly_n5_d13": ("eval", {"n": 5, "d": 13, "k": 1, "off": 8}),
    **{f"random_ssp_m{m}": ("random_ssp", {"m": m}) for m in (8, 13, 24)},
    **{f"v_at_s_m{m}": ("v_at_s", {"m": m}) for m in (8, 13)},
    **{f"ntt_{op}_{n}": (op, {"n": n}) for op in ("mul", "inv", "div") for n in (64, 1024)},
    "ntt_div_shift_64": ("div_shift", {"n": 64}),
}


def _words(rng, *shape):
    return rng.integers(0, P_MOD, size=shape, dtype=np.uint64).astype(np.int64)


def _poly_mul_np(a, b):
    """Exact product mod p of int64 coefficient arrays (Python ints)."""
    return (np.convolve(a.astype(object), b.astype(object)) % P_MOD).astype(np.int64)


def case_inputs(case: str) -> dict:
    """Numpy inputs of a case, made from a seed of its name."""
    kind, p = CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if kind == "encrypt":
        return {"sk": rng.integers(0, 256, (p["n"], 88), dtype=np.uint8),
                "msgs": _words(rng, p["count"]),
                "errs": rng.integers(0, 256, (p["count"], 88), dtype=np.uint8)}
    if kind == "eval":
        return {"b_rows": rng.integers(0, 256, (p["d"], 88), dtype=np.uint8),
                "coeffs": _words(rng, p["k"], p["d"])}
    if kind == "v_at_s":
        return {"v": _words(rng, p["m"], 16).astype(np.uint32), "s": np.int64(0x12345678)}
    if kind == "random_ssp":
        return {}
    n = p["n"]
    if kind == "mul":
        return {"a": _words(rng, n // 2), "b": _words(rng, n // 2)}
    if kind == "inv":
        t = _words(rng, n)
        t[0] |= 1  # invertible constant term
        return {"t": t}
    den, quot = _words(rng, n // 2), _words(rng, n // 2)
    den[-1] = 0 if kind == "div_shift" else den[-1] | 1
    den[-2] |= 1
    return {"num": _poly_mul_np(den, quot), "den": den, "quot_len": n // 2, "quot": quot}


def run_worlds(mode: str, worlds, root) -> dict:
    """Start one gloo world of each size at once; {world: its directory}."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    dirs, procs = {}, []
    for world in worlds:
        dirs[world] = root / f"world{world}"
        dirs[world].mkdir()
        procs += [(world, rank, subprocess.Popen(
            [sys.executable, __file__, mode, str(rank), str(world), str(dirs[world])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env))
            for rank in range(world)]
    outs = []
    try:
        for world, rank, proc in procs:
            outs.append((world, rank, proc.communicate(timeout=300)[0].decode(errors="replace")))
    finally:
        for _, _, proc in procs:  # kill exact PIDs, never by pattern
            if proc.poll() is None:
                proc.kill()
    for (world, rank, proc), (_, _, out) in zip(procs, outs):
        assert proc.returncode == 0, f"rank {rank} of {world} failed:\n{out}"
        dirs[world].joinpath(f"stdout_{rank}.txt").write_text(out)
    return dirs


def _run_case(case, mesh, rank, world):
    import torch

    from c_lwe_snarks_tpu_torch.ops import modp, ntt, sampling
    from c_lwe_snarks_tpu_torch.parallel import mesh as pmesh
    from c_lwe_snarks_tpu_torch.parallel.multihost import chunk_bounds
    from c_lwe_snarks_tpu_torch.utils.params import Params

    kind, p = CASES[case]
    x = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
         for k, v in case_inputs(case).items()}
    crs_key, ent_key = sampling.PRGKey(CRS_SEED, "cpu"), sampling.PRGKey(ENT_SEED, "cpu")
    if kind == "encrypt":
        P = Params(d=16, m=8, n=p["n"])
        lo, hi = chunk_bounds(p["count"], rank, world)
        out = pmesh.encrypt_section_sharded(
            crs_key, p["off"], x["sk"], x["msgs"], x["errs"][lo:hi], P, mesh)
        return {"out": out}
    if kind == "eval":
        P = Params(d=p["d"], m=8, n=p["n"])
        if p["k"] == 1:  # the single-polynomial wrapper
            return {"out": pmesh.eval_poly_sharded(
                crs_key, p["off"], x["b_rows"], x["coeffs"][0], P, mesh)[None]}
        return {"out": pmesh.eval_poly_multi_sharded(
            crs_key, p["off"], x["b_rows"], x["coeffs"], P, mesh)}
    if kind == "random_ssp":
        P = Params(d=16, m=p["m"], n=32)
        wits, inst = pmesh.random_ssp_sharded(ent_key, 0, P, mesh)
        return {"wits": wits, "t": inst.t, "v": pmesh.gather_rows(inst.v, P.m, mesh),
                "row0": torch.tensor(inst.row0)}
    if kind == "v_at_s":
        m = p["m"]
        lo, hi = chunk_bounds(m, rank, world)
        powers = modp.powers_mod_p(torch.tensor(int(x["s"])), 16)
        return {"out": pmesh.v_at_s_sharded(x["v"][lo:hi], powers, mesh, m)}
    n = p["n"]
    kw = {"mesh": mesh, "min_shard_n": MIN_SHARD_N}
    if kind == "mul":
        out = ntt.poly_mul_mod_p(x["a"], x["b"], **kw)
    elif kind == "inv":
        out = ntt.poly_inv_series_mod_p(x["t"], n, **kw)
    else:
        out = ntt.poly_div_exact_mod_p(x["num"], x["den"], x["quot_len"], **kw)
    one_d = torch.zeros(1)
    return {"out": out, "sharded": torch.tensor(ntt._shardable(n, one_d, one_d, mesh, MIN_SHARD_N))}


def primitives(rank: int, world: int, outdir: str) -> None:
    import torch

    from c_lwe_snarks_tpu_torch.__main__ import run_protocol
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import sampling
    from c_lwe_snarks_tpu_torch.parallel import mesh as pmesh
    from c_lwe_snarks_tpu_torch.utils import serial
    from c_lwe_snarks_tpu_torch.utils.params import Params

    mesh = pmesh.make_mesh(world, "cpu")
    for case in CASES:
        res = _run_case(case, mesh, rank, world)
        if rank == 0:
            np.savez(os.path.join(outdir, f"{case}.npz"),
                     **{k: v.numpy() for k, v in res.items()})
    P = Params(**TINY)
    run = run_protocol(P, "cpu", CRS_SEED, ENT_SEED, probe=True, mesh=mesh)
    ssp = tssp.SSP(t=run.ssp.t, v=pmesh.gather_rows(run.ssp.v, P.m, mesh))
    blobs = {"ssp": serial.ssp_to_buffer(ssp, P), "crs": serial.crs_to_bytes(run.crs, P),
             "vrs": serial.vrs_to_bytes(run.vrs, P), "proof": serial.proof_to_bytes(run.proof, P)}
    # the scan setup and the stage-wise prover under the mesh (tile 8)
    crs_key, ent_key = sampling.PRGKey(CRS_SEED, "cpu"), sampling.PRGKey(ENT_SEED, "cpu")
    off_setup = tssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + tsnark.setup_entropy_bytes(P)
    crs, _ = tsnark.setup(crs_key, ent_key, off_setup, run.ssp, P, tile=8, mesh=mesh)
    blobs["crs_scan"] = serial.crs_to_bytes(crs, P)
    blobs["proof_stagewise"] = serial.proof_to_bytes(tsnark.prover(
        crs_key, ent_key, off_prove, run.crs, run.ssp, run.witness, P, tile=8, mesh=mesh), P)
    with open(os.path.join(outdir, f"protocol_{rank}.json"), "w") as f:
        json.dump({"verified": run.verified, "row0": run.ssp.row0,
                   "sha256": {k: hashlib.sha256(b).hexdigest() for k, b in blobs.items()}}, f)
    assert torch.distributed.get_world_size() == world


def cli(rank: int, world: int, outdir: str) -> None:
    import torch.distributed as dist

    from c_lwe_snarks_tpu_torch.__main__ import main
    from c_lwe_snarks_tpu_torch.parallel import mesh as pmesh
    from c_lwe_snarks_tpu_torch.parallel import multihost
    from c_lwe_snarks_tpu_torch.utils import params as params_mod
    from c_lwe_snarks_tpu_torch.utils import serial

    P = params_mod.custom(d=16, m=8)
    rc = main(["--d", "16", "--m", "8", "--device", "cpu", "--mesh", str(world), "--probe",
               "--save-dir", outdir, "--crs-seed", CRS_SEED.hex(), "--ent-seed", ENT_SEED.hex()])
    assert rc == 0, rc
    dist.barrier()  # rank 0 has written the files
    mesh = pmesh.make_mesh(world, "cpu")
    crs = serial.crs_from_bytes(serial.load(os.path.join(outdir, "crs.bin")), P, "cpu")
    secs = serial.crs_local_section_rows(crs, P, mesh)
    np.savez(os.path.join(outdir, f"crs_rows_{rank}.npz"),
             **{f"{k}_start": np.int64(v[0]) for k, v in secs.items()},
             **{f"{k}_rows": v[1] for k, v in secs.items()})
    dist.barrier()
    stitched = os.path.join(outdir, "crs_stitched.bin")
    if rank == 0:  # seed || s || as || t || v from every rank's rows
        parts = [np.load(os.path.join(outdir, f"crs_rows_{r}.npz")) for r in range(world)]
        with open(stitched, "wb") as f:
            f.write(crs.seed)
            for k in ("s", "as"):
                for z in sorted(parts, key=lambda z: int(z[f"{k}_start"])):
                    f.write(z[f"{k}_rows"].tobytes())
            f.write(secs["t"][1].tobytes())
            for z in sorted(parts, key=lambda z: int(z["v_start"])):
                f.write(z["v_rows"].tobytes())
    dist.barrier()
    seed, lo, rows = serial.crs_local_slice(stitched, P)
    assert seed == crs.seed
    assert (lo, lo + rows.shape[0]) == multihost.local_shard_bounds(P.crs_num_cts), (lo, rows.shape)
    np.save(os.path.join(outdir, f"crs_local_slice_{rank}.npy"), rows)


def main() -> None:
    for name in ("jax", "jaxlib", "c_lwe_snarks_tpu"):
        sys.modules[name] = None  # the port must not need them
    mode, rank, world, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
                            world_size=world, rank=rank)
    try:
        {"primitives": primitives, "cli": cli}[mode](rank, world, outdir)
    finally:
        dist.destroy_process_group()
    loaded = [k for k, v in sys.modules.items() if v and k.split(".")[0] in ("jax", "jaxlib")]
    assert not loaded, loaded
    print(f"[rank {rank} of {world}] {mode} done", flush=True)


if __name__ == "__main__":
    main()
