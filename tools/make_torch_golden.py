"""Write the golden files of tests/golden/ from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [--profiles tiny toy]
    python tools/make_torch_golden.py --keystream
    JAX_PLATFORMS=cpu python tools/make_torch_golden.py --batch

``torch_port_digests.json``: for each profile, runs random_ssp -> setup ->
prover with the seeds of tests/test_snark_tpu.py and records the sha256 of
the SSP buffer and of the CRS, VRS and proof bytes
(c_lwe_snarks_tpu/utils/serial.py).  The toy profile takes several minutes
on the CPU.

``torch_port_keystream.json`` (``--keystream``): AES-256-CTR keystream
windows from the JAX package's host oracle (c_lwe_snarks_tpu/oracle/aes.py,
the generated-table numpy cipher, cross-checked against its OpenSSL path):
a plain window, one across the low-word counter wrap and one at a counter
above 2^32.

The PyTorch port is held to both files on the GPU, where no JAX exists
(chip_smoke.py), so its keystream kernels are checked against bytes that
did not come from the port's own host cipher.

``torch_port_batch_proofs.json`` (``--batch``): the circuit of
tests/test_torch_prover_batch.py (d = 64, m = 16, n = 32; random_ssp's
witness and two more statements of random bits) proved by the JAX
package's ``prover`` at six entropy offsets, each statement at each: the
sha256 of every proof's bytes, and the statements' bits.  The port's
``snark.prover_batch`` is held to them on the CPU, where a JAX prover
compiled once an offset would take minutes.  Several minutes on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CRS_SEED = bytes(range(40, 80))
ENT_SEED = bytes(range(40))
GOLDEN = ROOT / "tests" / "golden" / "torch_port_digests.json"
GOLDEN_KEYSTREAM = ROOT / "tests" / "golden" / "torch_port_keystream.json"
KEYSTREAM_SEED = bytes(range(40))
KEYSTREAM_WINDOWS = [(12345, 96), ((1 << 32) - 3, 64), ((1 << 32) + 98765, 64)]
PROFILES = {"tiny": dict(d=16, m=8, n=32), "toy": dict(d=256, m=64, n=1470)}
GOLDEN_BATCH = ROOT / "tests" / "golden" / "torch_port_batch_proofs.json"
BATCH = dict(d=64, m=16, n=32)
BATCH_CRS_SEED, BATCH_ENT_SEED = bytes(range(40)), bytes(range(40, 80))
BATCH_OFFSETS = 6  # proof i at the prover's offset + i * prover_entropy_bytes


def jax_digests(d: int, m: int, n: int) -> dict:
    """sha256 of the JAX package's SSP/CRS/VRS/proof bytes at (d, m, n)."""
    import jax

    from c_lwe_snarks_tpu.models import snark as tsnark
    from c_lwe_snarks_tpu.models import ssp as tssp
    from c_lwe_snarks_tpu.ops import sampling
    from c_lwe_snarks_tpu.utils import serial
    from c_lwe_snarks_tpu.utils.params import Params

    P = Params(d=d, m=m, n=n)
    crs_key, ent_key = sampling.PRGKey(CRS_SEED), sampling.PRGKey(ENT_SEED)
    off_setup = tssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + tsnark.setup_entropy_bytes(P)

    @jax.jit
    def run():
        wits, inst = tssp.random_ssp(ent_key, 0, P)
        crs, vrs = tsnark.setup(crs_key, ent_key, off_setup, inst, P)
        pi = tsnark.prover(crs_key, ent_key, off_prove, crs, inst, wits, P)
        return inst, crs, vrs, pi, tsnark.verifier(vrs, inst, pi, P)

    inst, crs, vrs, pi, ok = run()
    assert bool(ok)
    blobs = {
        "ssp": serial.ssp_to_buffer(inst, P),
        "crs": serial.crs_to_bytes(crs, P),
        "vrs": serial.vrs_to_bytes(vrs, P),
        "proof": serial.proof_to_bytes(pi, P),
    }
    return {k: hashlib.sha256(v).hexdigest() for k, v in blobs.items()}


def jax_batch_proofs() -> dict:
    """sha256 of the JAX package's proof of each statement at each offset."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from c_lwe_snarks_tpu.models import snark as tsnark
    from c_lwe_snarks_tpu.models import ssp as tssp
    from c_lwe_snarks_tpu.ops import sampling
    from c_lwe_snarks_tpu.utils import serial
    from c_lwe_snarks_tpu.utils.params import Params

    P = Params(**BATCH)
    crs_key, ent_key = sampling.PRGKey(BATCH_CRS_SEED), sampling.PRGKey(BATCH_ENT_SEED)
    off_setup = tssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + tsnark.setup_entropy_bytes(P)

    @jax.jit
    def circuit():
        wits, inst = tssp.random_ssp(ent_key, 0, P)
        crs, _ = tsnark.setup(crs_key, ent_key, off_setup, inst, P)
        return wits, inst, crs

    wits, inst, crs = circuit()
    others = np.random.default_rng(5).integers(0, 2, (2, P.m), dtype=np.uint8)
    statements = [np.asarray(wits, dtype=np.uint8), *others]
    proofs = {}
    for i in range(BATCH_OFFSETS):
        off = off_prove + i * tsnark.prover_entropy_bytes(P)
        prove = jax.jit(lambda w, off=off: tsnark.prover(crs_key, ent_key, off, crs, inst, w, P))
        for j, w in enumerate(statements):
            proofs[f"{i},{j}"] = hashlib.sha256(
                serial.proof_to_bytes(prove(jnp.asarray(w)), P)).hexdigest()
        print(f"offset {i} done", flush=True)
    return {"crs_seed": BATCH_CRS_SEED.hex(), "ent_seed": BATCH_ENT_SEED.hex(), "params": BATCH,
            "statements": ["".join(map(str, w.tolist())) for w in statements],
            "proof_sha256": proofs}


def oracle_keystream() -> dict:
    """Keystream windows (hex) from the JAX package's host oracle."""
    import numpy as np

    from c_lwe_snarks_tpu.oracle import aes as host_aes

    key, nonce = KEYSTREAM_SEED[8:], int.from_bytes(KEYSTREAM_SEED[:8], "little")
    windows = []
    for start, nblocks in KEYSTREAM_WINDOWS:
        ks = host_aes.ctr_keystream_numpy(key, nonce, start, nblocks)
        assert np.array_equal(ks, host_aes.ctr_keystream(key, nonce, start, nblocks))
        windows.append({"start": start, "nblocks": nblocks, "bytes": ks.tobytes().hex()})
    return {"seed": KEYSTREAM_SEED.hex(), "windows": windows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles", nargs="+", default=list(PROFILES), choices=list(PROFILES))
    ap.add_argument("--keystream", action="store_true",
                    help="write the keystream windows instead of the digests")
    ap.add_argument("--batch", action="store_true",
                    help="write the batch test's proof digests instead of the digests")
    args = ap.parse_args()
    if args.batch:
        GOLDEN_BATCH.write_text(json.dumps(jax_batch_proofs(), indent=1, sort_keys=True) + "\n")
        print(f"wrote {GOLDEN_BATCH.relative_to(ROOT)}")
        return 0
    if args.keystream:
        GOLDEN_KEYSTREAM.write_text(json.dumps(oracle_keystream(), indent=1) + "\n")
        print(f"wrote {GOLDEN_KEYSTREAM.relative_to(ROOT)}")
        return 0
    out = {"crs_seed": CRS_SEED.hex(), "ent_seed": ENT_SEED.hex(), "profiles": {}}
    if GOLDEN.exists():
        out["profiles"] = json.loads(GOLDEN.read_text())["profiles"]
    for name in args.profiles:
        shape = PROFILES[name]
        out["profiles"][name] = {"params": shape, "sha256": jax_digests(**shape)}
        print(name, out["profiles"][name], flush=True)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
