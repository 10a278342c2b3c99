"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, agrees with its references and runs the protocol.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure raises and exits
non-zero, and only a full pass prints the final JSON line):

1. build the CUDA kernels from c_lwe_snarks_tpu_torch/csrc with nvcc;
2. hold each kernel (K1..K5) against its plain torch version on the card,
   bit-exact, at small shapes (AES-block leads 0 and 8, a counter
   low-word wrap, a counter above 2^32, ragged counts, k = 5 lanes) and at
   the largest shape the release main path gives it, where both are timed
   with CUDA events; K1 and K5 also against each other, against the host
   AES cipher and against the committed keystream windows of the JAX
   package's oracle; K3 against the scan path at d = 2^16;
3. run the protocol at the tiny and toy parameters on the card and hold
   the SSP/CRS/VRS/proof sha256 digests against the committed golden
   file (made from the JAX package); stream the toy SSP to a file and back;
4. run the protocol at release parameters through the package's own
   entry point with every launch counter reset just before, check that
   the verifier accepts, that a tampered proof is rejected, that two CRS
   terms decrypt to 1 and alpha, and that K1..K4 ran;
5. walk the stage-wise path at release parameters with the counters reset
   again: write CRS, VRS and proof to files, read them back, probe the
   reloaded CRS and proof, prove stage by stage from the reloaded CRS
   (tile 256) and require the one-pass proof's bytes, verify from the
   reloaded VRS, hold the scan evaluation against the fused one over the
   whole s section, and regenerate one scan tile's a-slab with the
   bitsliced keystream (K5) against the T-table one (K1).

Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "torch_port_digests.json"
GOLDEN_KEYSTREAM = ROOT / "tests" / "golden" / "torch_port_keystream.json"
SEED = bytes(range(40))
CRS_SEED, ENT_SEED = bytes(40), bytes([1] * 40)  # the CLI's default seeds
DEVICE = "cuda"
TILE = 256  # ciphertexts per tile of the stage-wise / scan path
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "keystream_words": ("c_lwe_snarks_tpu_torch/csrc/keystream.cu",
                        "c_lwe_snarks_tpu/ops/aes_pallas.py:253"),
    "keystream_fold_p": ("c_lwe_snarks_tpu_torch/csrc/keystream.cu",
                         "c_lwe_snarks_tpu/ops/aes_pallas.py:262"),
    "eval_mac_planes": ("c_lwe_snarks_tpu_torch/csrc/eval_fused.cu",
                        "c_lwe_snarks_tpu/ops/eval_fused.py:181"),
    "encrypt_b_fused": ("c_lwe_snarks_tpu_torch/csrc/eval_fused.cu",
                        "c_lwe_snarks_tpu/ops/eval_fused.py:335"),
    "keystream_blocks_v1": ("c_lwe_snarks_tpu_torch/csrc/keystream_bitsliced.cu",
                            "c_lwe_snarks_tpu/ops/aes_pallas.py:73"),
}
# kernels each path must launch at least once
RELEASE_PATH = ("keystream_words", "keystream_fold_p", "eval_mac_planes", "encrypt_b_fused")
STAGEWISE_PATH = ("keystream_words", "eval_mac_planes", "keystream_blocks_v1")

# Published peaks of one H100 SXM (NVIDIA's data sheet) for the bounds.  The
# sheet gives no integer ALU rate: 67 TFLOP/s of float32 is 2 flops on 128
# lanes an SM, and half of those lanes also do 32-bit integer and logic
# operations, one a clock, so the integer peak is a quarter of it.
PEAK_BYTES = 3.35e12
PEAK_INT32 = 67e12 / 4
PEAK_INT8 = 1979e12
# 32-bit operations per 16-byte AES block.  T-table core (aes_core.cuh): 8 to
# swap and whiten the input, 13 rounds of 4 words x (6 to extract the index
# bytes + 4 XORs), a last round of 4 x (6 + 3 shifts + 4 XORs) and 4 swaps
# out; its 284 shared-memory loads are not counted.  Bitsliced core
# (keystream_bitsliced.cu): 1,169.5 two-input gates a block (S-box 115 x 16
# x 14 / 32, MixColumns 132 x 4 x 13 / 32, AddRoundKey 128 x 15 / 32, six
# transposes of 480), of which a three-input LOP3 can take two at a time.
TTABLE_OPS = 8 + 13 * 40 + 52 + 4
BITSLICED_OPS = (115 * 16 * 14 + 132 * 4 * 13 + 128 * 15 + 6 * 480) / 32 / 2


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_abs_err(a, b) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(b.device).long() - b.long()).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of reps calls of fn, between two CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), milliseconds of that one call between two CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, int32_ops: float, int8_ops: float = 0.0) -> dict:
    """The least milliseconds the card could take: the larger of bytes over
    the memory rate and operations over their peak rate."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = max(int32_ops / PEAK_INT32, int8_ops / PEAK_INT8) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def reset_counters() -> tuple:
    from c_lwe_snarks_tpu_torch.ops import aes, eval_fused

    counters = (aes.LAUNCHES, eval_fused.LAUNCHES)
    for c in counters:
        for name in c:
            c[name] = 0
    return counters


def read_counters(counters) -> dict:
    return {name: c[name] for c in counters for name in c}


def phase_kernels(results: dict) -> None:
    """K1..K5 against their plain versions, the host cipher and the golden
    keystream windows."""
    import numpy as np
    import torch

    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import aes, eval_fused, sampling
    from c_lwe_snarks_tpu_torch.utils import aes_host
    from c_lwe_snarks_tpu_torch.utils.params import Params, release

    key = sampling.PRGKey(SEED, DEVICE)
    k = key.aes
    errs = {name: 0 for name in KERNELS}

    def worse(name, err):
        errs[name] = max(errs[name], err)

    # K1: counter low-word wrap, then the host cipher on one window
    start = (1 << 32) - 3
    worse("keystream_words", max_abs_err(
        aes.keystream_words(k, start, 1000), aes.keystream_words_plain(k, start, 1000)))
    worse("keystream_words", max_abs_err(
        sampling.keystream_bytes(key, 16 * 12345, 16 * 96).cpu(),
        torch.from_numpy(aes_host.ctr_keystream_numpy(
            SEED[8:], int.from_bytes(SEED[:8], "little"), 12345, 96).copy())))
    # K5: the same windows, ragged counts and a start above 2^32, against
    # its plain version and against K1's bytes
    for start5, count in ((12345, 96), ((1 << 32) - 3, 1000), (5, 33), (7, 1),
                          ((1 << 33) + 11, 4097)):
        got = aes.keystream_blocks(k, start5, count, version=1)
        worse("keystream_blocks_v1", max_abs_err(got, aes.keystream_blocks_v1_plain(k, start5, count)))
        worse("keystream_blocks_v1", max_abs_err(got, aes.keystream_blocks(k, start5, count)))
    # K1 and K5 against the keystream windows of the JAX package's oracle
    golden = json.loads(GOLDEN_KEYSTREAM.read_text())
    gkey = aes.make_key(bytes.fromhex(golden["seed"]), DEVICE)
    check(len(golden["windows"]) == 3, "golden keystream windows")
    for w in golden["windows"]:
        want = torch.from_numpy(np.frombuffer(bytes.fromhex(w["bytes"]), np.uint8).copy())
        want = want.reshape(w["nblocks"], 16)
        worse("keystream_words", max_abs_err(
            aes.keystream_blocks(gkey, w["start"], w["nblocks"]).cpu(), want))
        worse("keystream_blocks_v1", max_abs_err(
            aes.keystream_blocks(gkey, w["start"], w["nblocks"], version=1).cpu(), want))
    # K2: odd pair count across the wrap
    worse("keystream_fold_p", max_abs_err(
        aes.keystream_fold_p(k, (1 << 32) - 5, 2001), aes.keystream_fold_p_plain(k, (1 << 32) - 5, 2001)))
    # K3: k = 5 lanes, offsets with lead 0, 8 and a block-aligned one
    gen = torch.Generator().manual_seed(3)
    n = 6
    coeffs = torch.randint(0, 1 << 32, (5, 300), generator=gen).to(DEVICE)
    for off in (0, 40, 16 * 7 + 8):
        worse("eval_mac_planes", max_abs_err(
            eval_fused.eval_mac_planes(key, off, coeffs, n, 92 * n),
            eval_fused.eval_mac_planes_plain(key, off, coeffs, n, 92 * n)))
    # K4: leads 0 and 8, odd and even counts
    sk = torch.randint(0, 256, (n, 88), generator=gen, dtype=torch.uint8).to(DEVICE)
    for off, count in ((48, 257), (56, 300), (8, 9)):
        worse("encrypt_b_fused", max_abs_err(
            eval_fused.encrypt_b_fused(key, off, sk, count, n, 92 * n),
            eval_fused.encrypt_b_fused_plain(key, off, sk, count, n, 92 * n)))
    for name, e in errs.items():
        print(f"phase kernels: {name} small shapes max_abs_err={e} (tolerance 0)")

    # K3 past the TPU kernel's d * 255^2 < 2^31 bound: d = 2^16 at n = 2,
    # the fused evaluation against the scan path (K1 tiles + exact matmuls)
    P16 = Params(d=1 << 16, m=8, n=2)
    c16 = torch.randint(0, P16.p, (2, P16.d), generator=gen).to(DEVICE)
    c16[1] = P16.p - 1  # the largest coefficient in every term of lane 1
    b16 = torch.randint(0, 256, (P16.d, 88), generator=gen, dtype=torch.uint8).to(DEVICE)
    fused16 = tlwe.eval_poly_multi(key, P16.ctr_ct, b16, c16, P16, impl="fused")
    scan16 = tlwe.eval_poly_multi(key, P16.ctr_ct, b16, c16, P16, impl="scan", tile=TILE)
    planes16 = eval_fused.eval_mac_planes(key, P16.ctr_ct, c16, P16.n, P16.ctr_ct)
    err16 = max_abs_err(fused16, scan16)
    worse("eval_mac_planes", err16)
    print(f"phase kernels: eval_mac_planes d=2^16 n=2 fused vs scan max_abs_err={err16} "
          f"(tolerance 0); largest plane entry {int(planes16.max())}, "
          f"{int((planes16 >= 1 << 31).sum())} of {planes16.numel()} entries >= 2^31")

    # the release main path's largest call of each kernel, compared once
    # with the plain version (that one plain call is timed), then the kernel
    # timed as the mean of reps launches
    P = release()
    crs_key, ent_key = sampling.PRGKey(CRS_SEED, DEVICE), sampling.PRGKey(ENT_SEED, DEVICE)
    n, d, terms = P.n, P.d, 2 * P.d + P.m
    wb, pad = tssp.witness_pad_bytes(P)
    e_base = tssp.entropy_bytes_random_ssp(P) + 24 + P.logq_bytes * n  # setup's error draws
    e_blocks = -(-(e_base % 16 + terms * tsnark.enc_entropy_bytes(P)) // 16)
    tile_blocks = TILE * P.ctr_ct // 16  # one scan tile's a-slab
    stream_blocks = -(-terms * P.ctr_ct // 16)  # the CRS stream K3 and K4 regenerate
    coeffs = torch.randint(0, 1 << 32, (5, terms), generator=gen).to(DEVICE)
    sk = torch.randint(0, 256, (n, 88), generator=gen, dtype=torch.uint8).to(DEVICE)
    folds = tssp.TILE * d
    cases = {  # name -> [(shape, reps, kernel, plain, bound), ...]; the last case is reported
        "keystream_words": [(
            f"setup's error draws: {e_blocks} blocks", 10,
            lambda: aes.keystream_words(ent_key.aes, e_base // 16, e_blocks),
            lambda: aes.keystream_words_plain(ent_key.aes, e_base // 16, e_blocks),
            bound(32 * e_blocks, TTABLE_OPS * e_blocks))],
        "keystream_fold_p": [(
            f"random_ssp's first tile: {tssp.TILE} rows x d={d}", 10,
            lambda: aes.keystream_fold_p(ent_key.aes, (wb + pad) // 16, folds),
            lambda: aes.keystream_fold_p_plain(ent_key.aes, (wb + pad) // 16, folds),
            bound(8 * folds, TTABLE_OPS * folds / 2))],
        "eval_mac_planes": [(
            f"the prover's sweep: k=5 x {terms} terms, n={n}", 5,
            lambda: eval_fused.eval_mac_planes(crs_key, P.ctr_s, coeffs, n, P.ctr_ct),
            lambda: eval_fused.eval_mac_planes_plain(crs_key, P.ctr_s, coeffs, n, P.ctr_ct),
            bound(8 * coeffs.numel() + 8 * 4 * 5 * n * 88, TTABLE_OPS * stream_blocks,
                  2 * 4 * 5 * terms * n * 88))],
        "encrypt_b_fused": [(
            f"setup's section: {terms} encryptions, n={n}", 3,
            lambda: eval_fused.encrypt_b_fused(crs_key, P.ctr_s, sk, terms, n, P.ctr_ct),
            lambda: eval_fused.encrypt_b_fused_plain(crs_key, P.ctr_s, sk, terms, n, P.ctr_ct),
            bound(sk.numel() + 8 * terms * 88, TTABLE_OPS * stream_blocks,
                  2 * 2 * terms * n * (88 * 89 // 2)))],
        "keystream_blocks_v1": [
            (f"setup's error draws: {e_blocks} blocks", 10,
             lambda: aes.keystream_blocks_v1(ent_key.aes, e_base // 16, e_blocks),
             lambda: aes.keystream_blocks_v1_plain(ent_key.aes, e_base // 16, e_blocks),
             bound(16 * e_blocks, BITSLICED_OPS * e_blocks)),
            (f"one scan tile's a-slab: {TILE} ciphertexts, {tile_blocks} blocks", 10,
             lambda: aes.keystream_blocks_v1(crs_key.aes, 0, tile_blocks),
             lambda: aes.keystream_blocks_v1_plain(crs_key.aes, 0, tile_blocks),
             bound(16 * tile_blocks, BITSLICED_OPS * tile_blocks))],
    }
    for name, shapes in cases.items():
        for shape, reps, kern, plain, bnd in shapes:
            want, plain_ms = timed(plain)
            err = max_abs_err(kern(), want)
            del want
            ms = cuda_ms(kern, reps)
            worse(name, err)
            results[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, **bnd,
                             "library_ms": None}
            print(f"phase kernels: {name} [{shape}] max_abs_err={err} (tolerance 0); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
                  f"by {bnd['bound_by']}")
    for name, e in errs.items():
        check(e == 0, f"{name} disagrees with a reference (max_abs_err={e})")


def digests(run, P) -> dict:
    from c_lwe_snarks_tpu_torch.utils import serial

    blobs = {
        "ssp": serial.ssp_to_buffer(run.ssp, P),
        "crs": serial.crs_to_bytes(run.crs, P),
        "vrs": serial.vrs_to_bytes(run.vrs, P),
        "proof": serial.proof_to_bytes(run.proof, P),
    }
    return {name: hashlib.sha256(b).hexdigest() for name, b in blobs.items()}


def phase_golden() -> None:
    import torch

    from c_lwe_snarks_tpu_torch.__main__ import run_protocol
    from c_lwe_snarks_tpu_torch.utils import serial
    from c_lwe_snarks_tpu_torch.utils.params import Params

    golden = json.loads(GOLDEN.read_text())
    crs_seed, ent_seed = bytes.fromhex(golden["crs_seed"]), bytes.fromhex(golden["ent_seed"])
    for name in ("tiny", "toy"):
        entry = golden["profiles"][name]
        P = Params(**entry["params"])
        run = run_protocol(P, DEVICE, crs_seed, ent_seed, probe=True)
        got = digests(run, P)
        same = got == entry["sha256"]
        print(f"phase golden: {name} {entry['params']} verified={run.verified} "
              f"digests {'equal' if same else 'DIFFER'} to the golden file")
        check(run.verified, f"{name}: verifier rejected")
        check(same, f"{name}: digests {got} != golden {entry['sha256']}")
    # the toy SSP through the streaming writer and reader
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "ssp.bin")
        serial.ssp_write_stream(path, run.ssp, P)
        sha = hashlib.sha256(serial.load(path)).hexdigest()
        back = serial.ssp_read_stream(path, P, DEVICE)
    same = torch.equal(back.t, run.ssp.t) and torch.equal(back.v, run.ssp.v)
    print(f"phase golden: toy SSP streamed to a file and back: tensors equal={same}, "
          f"file sha256 equal to golden={sha == entry['sha256']['ssp']}")
    check(same and back.v.is_cuda, "toy: streamed SSP differs")
    check(sha == entry["sha256"]["ssp"], "toy: streamed SSP file digest != golden")


def phase_release(label: str):
    import torch

    from c_lwe_snarks_tpu_torch.__main__ import run_protocol
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.ops import sampling
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    run = run_protocol(P, DEVICE, CRS_SEED, ENT_SEED)
    launches = read_counters(counters)
    peak = torch.cuda.max_memory_allocated()

    for stage, sec in run.times.items():
        print(f"phase release: {stage} {sec:.3f} s [{label}]")
    print(f"phase release: peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    check(run.verified, "release: the verifier rejected an honest proof")
    pi = run.proof
    check(pi.stack().shape == (5, P.n + 1, 88) and pi.stack().dtype == torch.uint8,
          "release: proof shape")
    bad_h = pi.h.clone()
    bad_h[P.n, 0] ^= 1
    bad = tsnark.Proof(h=bad_h, hat_h=pi.hat_h, hat_v=pi.hat_v, v_w=pi.v_w, b_w=pi.b_w)
    rejected = not bool(tsnark.verifier(run.vrs, run.ssp, bad, P))
    key = sampling.PRGKey(run.crs.seed, DEVICE)
    dec_s0 = int(tlwe.decrypt(tlwe.ct_import(key, P.ctr_s, run.crs.b_s[:1], P), run.vrs.sk, P)[0])
    dec_as0 = int(tlwe.decrypt(tlwe.ct_import(key, P.ctr_as, run.crs.b_as[:1], P), run.vrs.sk, P)[0])
    print(f"phase release: verified={run.verified} tampered_rejected={rejected} "
          f"Dec(s_0)={dec_s0} Dec(as_0)==alpha: {dec_as0 == int(run.vrs.alpha)}")
    check(rejected, "release: a tampered proof was accepted")
    check(dec_s0 == 1 and dec_as0 == int(run.vrs.alpha), "release: CRS decrypt probe")
    for name in RELEASE_PATH:
        check(launches[name] > 0, f"release: kernel {name} was not launched on the main path")
    return run, launches


def phase_stagewise(run, label: str) -> dict:
    """Setup's files -> a prover that loads the CRS and proves stage by stage
    -> the designated verifier that loads VRS and proof, probes and verifies."""
    import torch

    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import aes, sampling
    from c_lwe_snarks_tpu_torch.utils import obs, serial
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    times: dict = {}

    def flags(checks: dict) -> dict:
        return {k: bool(v) for k, v in checks.items() if v.dtype == torch.bool}

    counters = reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: str(pathlib.Path(tmp) / f"{name}.bin") for name in ("crs", "vrs", "proof")}
        with obs.timeit("write crs/vrs/proof files", out=times):
            serial.crs_write_stream(paths["crs"], run.crs, P)
            serial.save(paths["vrs"], serial.vrs_to_bytes(run.vrs, P))
            serial.save(paths["proof"], serial.proof_to_bytes(run.proof, P))
        sizes = {name: pathlib.Path(p).stat().st_size for name, p in paths.items()}
        with obs.timeit("read crs/vrs/proof files", out=times):
            crs = serial.crs_from_bytes(serial.load(paths["crs"]), P)
            vrs = serial.vrs_from_bytes(serial.load(paths["vrs"]), P)
            proof = serial.proof_from_bytes(serial.load(paths["proof"]), P)
        seed, table = serial.crs_row_table(paths["crs"], P)
        table_ok = seed == run.crs.seed and table.shape == (P.crs_num_cts, 92) and bool(
            (torch.from_numpy(table[2 * P.d : 2 * P.d + 2, :88].copy())
             == torch.stack([run.crs.b_t, run.crs.b_v[0]]).cpu()).all())
        del table
    round_trip = (
        crs.b_s.is_cuda and serial.crs_to_bytes(crs, P) == serial.crs_to_bytes(run.crs, P)
        and serial.vrs_to_bytes(vrs, P) == serial.vrs_to_bytes(run.vrs, P)
        and torch.equal(proof.stack(), run.proof.stack()))
    print(f"phase stagewise: files {sizes} bytes written and read back on the card: "
          f"round trip equal={round_trip}, row table ok={table_ok}")
    check(round_trip and table_ok, "stagewise: artifacts did not round-trip through the files")

    with obs.timeit("probe_crs + probe_crs_range(256) + probe_proof", out=times):
        probes = {f"{name}.{k}": v for name, checks in (
            ("crs", obs.probe_crs(crs, vrs, P)),
            ("crs_range", obs.probe_crs_range(crs, vrs, P, count=TILE)),
            ("proof", obs.probe_proof(proof, vrs, P))) for k, v in flags(checks).items()}
    print(f"phase stagewise: probes on the reloaded CRS/VRS/proof: {probes}")
    check(len(probes) == 11 and all(probes.values()), "stagewise: a decrypt-probe failed")

    crs_key, ent_key = sampling.PRGKey(crs.seed), sampling.PRGKey(ENT_SEED)
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    before = read_counters(counters)["eval_mac_planes"]
    with obs.timeit(f"prover(tile={TILE}) stage-wise", out=times):
        pi = tsnark.prover(crs_key, ent_key, off_prove, crs, run.ssp, run.witness, P, tile=TILE)
    k3_launches = read_counters(counters)["eval_mac_planes"] - before
    same_proof = serial.proof_to_bytes(pi, P) == serial.proof_to_bytes(run.proof, P)
    with obs.timeit("verifier from the reloaded VRS", out=times):
        ok = bool(tsnark.verifier(vrs, run.ssp, pi, P))
    bad_bw = pi.b_w.clone()
    bad_bw[0, 0] ^= 1
    bad = tsnark.Proof(h=pi.h, hat_h=pi.hat_h, hat_v=pi.hat_v, v_w=pi.v_w, b_w=bad_bw)
    rejected = not bool(tsnark.verifier(vrs, run.ssp, bad, P))
    print(f"phase stagewise: stage-wise proof bytes equal the one-pass proof's={same_proof} "
          f"({k3_launches} K3 launches), verified={ok}, tampered_rejected={rejected}")
    check(same_proof, "stagewise: the stage-wise proof differs from the one-pass proof")
    check(k3_launches == 3, f"stagewise: expected 3 K3 launches, saw {k3_launches}")
    check(ok and rejected, "stagewise: verifier")

    # the scan evaluation (K1 per tile + exact matmuls) against the fused one
    # (K3) over the whole s section, k = 2 lanes
    gen = torch.Generator().manual_seed(5)
    coeffs = torch.randint(0, P.p, (2, P.d), generator=gen).to(DEVICE)
    with obs.timeit(f"eval_poly_multi(impl=scan, tile={TILE}) over the s section", out=times):
        scan = tlwe.eval_poly_multi(crs_key, P.ctr_s, crs.b_s, coeffs, P, impl="scan", tile=TILE)
    with obs.timeit("eval_poly_multi(impl=fused) over the s section", out=times):
        fused = tlwe.eval_poly_multi(crs_key, P.ctr_s, crs.b_s, coeffs, P, impl="fused")
    scan_err = max_abs_err(scan, fused)
    print(f"phase stagewise: scan vs fused eval over the s section (d={P.d}, k=2) "
          f"max_abs_err={scan_err} (tolerance 0)")
    check(scan_err == 0, "stagewise: scan and fused evaluations differ")

    # one scan tile's a-slab from the bitsliced keystream (K5) against the
    # T-table one (K1, through expand_a)
    with obs.timeit("a-slab of one tile from keystream_blocks(version=1)", out=times):
        ks = aes.keystream_blocks(
            crs_key.aes, P.ctr_s // 16, TILE * P.ctr_ct // 16, version=1)
        slab5 = ks.reshape(TILE, P.n, 92)[..., :88]
    slab1 = sampling.expand_a(crs_key, P.ctr_s, TILE, P.n)
    slab_err = max_abs_err(slab5, slab1)
    print(f"phase stagewise: a-slab of {TILE} ciphertexts, bitsliced (K5) vs T-table (K1) "
          f"keystream max_abs_err={slab_err} (tolerance 0)")
    check(slab_err == 0, "stagewise: K5 and K1 a-slabs differ")

    launches = read_counters(counters)
    for step, sec in times.items():
        print(f"phase stagewise: {step} {sec:.3f} s [{label}]")
    print(f"phase stagewise: launches {launches}")
    for name in STAGEWISE_PATH:
        check(launches[name] > 0, f"stagewise: kernel {name} was not launched on this path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from c_lwe_snarks_tpu_torch.ops import _build

    t_start = time.perf_counter()
    label = gpu_label()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {label}")

    t0 = time.perf_counter()
    _build.library()
    built = time.perf_counter() - t0
    print(f"phase build: {built:.1f} s (nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s) "
          f"-> {_build.BUILD_INFO['path']}")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    results: dict = {}
    phase_kernels(results)
    phase_golden()
    run, release_launches = phase_release(label)
    stagewise_launches = phase_stagewise(run, label)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": release_launches[name] if name in RELEASE_PATH else stagewise_launches[name],
         "launches_by_path": {"release": release_launches[name],
                              "stagewise": stagewise_launches[name]},
         **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    for kern in kernels:
        check(kern["launches"] > 0, f"kernel {kern['name']} was launched on no path")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu_label())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
