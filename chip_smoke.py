"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port builds, agrees with its references and runs the protocol.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure raises and exits
non-zero, and only a full pass prints the final JSON line):

1. build the CUDA kernels from c_lwe_snarks_tpu_torch/csrc with nvcc;
2. hold each kernel (K1..K10) against its plain torch version on the card,
   bit-exact, at small shapes (AES-block leads 0 and 8, a counter
   low-word wrap, a counter above 2^32, ragged counts, k = 5 lanes) and at
   the largest shape the release main path gives it, where both are timed
   with CUDA events; K3's many-lane form at the shape ``prover_batch``
   gives it at release (k = 50 over ``onepass_sections``' three sections)
   against its form of 8 lanes on random and on all-0xFFFFFFFF
   coefficients, and against the plain version on row slices across its
   segments' edges, timed; K1 (as bytes, at 1, 2 and 171 blocks too) and K5 also
   against each other, against the host AES cipher and against the
   committed keystream windows of the JAX package's oracle; K5 at counts
   around its quad's group (32 blocks), a warp's tile (256) and a CUDA
   block's tiles (1,024), over more than one grid-stride pass, and at the
   main path's two shapes against K1, its time also against K1's
   operation count; K2 with
   ``out=`` into a slice guarded by sentinels; K3 against the scan path at
   d = 2^16; K3 and K4 at the shapes that stress their tensor-core tiling
   (ragged row and ciphertext counts, a single ciphertext, odd byte
   offsets, odd n, sums at their signed 32-bit bound); the two cipher
   cores (K1's table core, K5's bitsliced one) timed on 2^24 blocks; K3
   also at k = 1 beside k = 5; K1 also at a scan tile's size beside
   setup's error draws; one ``torch.profiler`` pass over random_ssp at
   release parameters and over K1's and K5's launches (device-side
   durations); K6 and K7 at the prover's shapes; K8 (the mod-p matvec,
   and its at-s form), K9 (the powers of s, and its messages form) and K10
   (the carry fold in its planes, b-row, MAC-plane and smudge forms) at
   their edges (d < 8 and past 2^21, s = 0, 1, p - 1, the worst carry
   ripple and ripples stopped at every position, planes at 2^63 - 1, 1,
   31, 33 and 7,355 rows, every sign pattern of the smudging, s = 0 and
   2^640 - 1, against Python ints) and at setup's, the verifier's and the
   prover's shapes, timed and device-side; the host's time to issue one
   launch; the release prover, setup and verifier under the profiler
   (tools/profile_prover.py, tools/profile_stage.py);
3. run the protocol at the tiny and toy parameters on the card and hold
   the SSP/CRS/VRS/proof sha256 digests against the committed golden
   file (made from the JAX package); stream the toy SSP to a file and back;
4. run the protocol at release parameters through the package's own
   entry point with every launch counter reset just before, check that
   the verifier accepts, that a tampered proof is rejected, that two CRS
   terms decrypt to 1 and alpha, and that every kernel of the path ran
   (K1..K4, K6..K10) as often as planned (K8 3, K9 1, K10 5); run setup's
   message schedule, the prover's evaluations and smudging and the
   verifier once more under ``torch.cuda.set_sync_debug_mode("error")``
   (no host sync); check that the SSP is uint32 on the card, as in the JAX
   package, and print the peak device memory beside the int64 SSP's;
   then the same run five more times for the spread of the stage walls;
   then ``prover_batch`` over ten statements of the release circuit with
   the counters reset just before (``phase_batch``): each proof is
   ``snark.prover``'s bytes, the satisfying statement's verifies, and K3
   runs once, in its many-lane form;
   then one run at d = 2^16, m = 43,690 (``phase_d16``, the counters and
   the peak-memory counter reset): it verifies and rejects a tampered h;
5. walk the files path at release parameters with the counters reset
   again (``phase_files``): write CRS, VRS and proof to files, read them
   back, probe the reloaded CRS and proof, prove from the reloaded CRS
   (one K3 launch) and require the release run's proof bytes, verify from
   the reloaded VRS, hold the scan evaluation against the fused one over
   the whole s section, and regenerate one scan tile's a-slab with the
   bitsliced keystream (K5) against the T-table one (K1);
6. the multi-device layer (``phase_sharded``): every rank's part at
   W = 4 and W = 3, one after another on the card, combined as the
   collectives would and held byte for byte against the release run, with
   the counters reset again (K1, K2, K3 and K4 at every rank's stream
   offset, K7 and K8 over a rank's rows of v, K10 on the int32 sum of the
   parts, K11 verifying the combined proof), then the CLI under torchrun in
   a world of 1 over NCCL.

Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
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
TILE = 256  # ciphertexts per tile of the scan path
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "keystream_words": ("c_lwe_snarks_tpu_torch/csrc/keystream.cu",
                        "c_lwe_snarks_tpu/ops/aes_pallas.py:253"),
    "keystream_fold_p": ("c_lwe_snarks_tpu_torch/csrc/keystream.cu",
                         "c_lwe_snarks_tpu/ops/aes_pallas.py:262"),
    "eval_mac_planes": ("c_lwe_snarks_tpu_torch/csrc/eval_fused.cu",
                        "c_lwe_snarks_tpu/ops/eval_fused.py:181"),
    # K3's many-lane form (lanes::eval_mac_kernel): prover_batch's one sweep
    "eval_mac_lanes": ("c_lwe_snarks_tpu_torch/csrc/eval_fused.cu",
                       "c_lwe_snarks_tpu/ops/eval_fused.py:181"),
    "encrypt_b_fused": ("c_lwe_snarks_tpu_torch/csrc/eval_fused.cu",
                        "c_lwe_snarks_tpu/ops/eval_fused.py:335"),
    "keystream_blocks_v1": ("c_lwe_snarks_tpu_torch/csrc/keystream_bitsliced.cu",
                            "c_lwe_snarks_tpu/ops/aes_pallas.py:73"),
    # K6 and K7 port jnp code the JAX package compiles into its programs
    "ntt": ("c_lwe_snarks_tpu_torch/csrc/ntt.cu", "c_lwe_snarks_tpu/ops/ntt.py:266"),
    "gated_rowsum_p": ("c_lwe_snarks_tpu_torch/csrc/rowsum.cu", "c_lwe_snarks_tpu/ops/modp.py:162"),
    # K7's many-witness form: prover_batch's row-sums, one read of v
    "gated_rowsums_p": ("c_lwe_snarks_tpu_torch/csrc/rowsum.cu", "c_lwe_snarks_tpu/ops/modp.py:162"),
    # K8..K10: setup's message schedule, polynomials at s (K8's at-s form),
    # the digit carry fold (jnp code too)
    "matvec_mod_p": ("c_lwe_snarks_tpu_torch/csrc/modp.cu", "c_lwe_snarks_tpu/ops/modp.py:186"),
    "powers_mod_p": ("c_lwe_snarks_tpu_torch/csrc/modp.cu", "c_lwe_snarks_tpu/ops/modp.py:139"),
    "carry_fold": ("c_lwe_snarks_tpu_torch/csrc/digits.cu", "c_lwe_snarks_tpu/ops/digits.py:73"),
    # K11: the verifier's jnp glue (five decrypts, t(s), v_0(s), the
    # relations, test_error_ok) in one launch, and its decrypt form
    "verify": ("c_lwe_snarks_tpu_torch/csrc/verify.cu", "c_lwe_snarks_tpu/models/snark.py:441"),
}
# kernels each path must launch at least once
RELEASE_PATH = ("keystream_words", "keystream_fold_p", "eval_mac_planes", "encrypt_b_fused", "ntt",
                "gated_rowsum_p", "matvec_mod_p", "powers_mod_p", "carry_fold", "verify")
FILES_PATH = ("keystream_words", "eval_mac_planes", "keystream_blocks_v1", "ntt",
              "gated_rowsum_p", "carry_fold", "verify")
# the sharded phase's parts: random_ssp's tiles reach K7; the 4-step NTT
# needs W > 1 processes, so K6 runs there only over gloo (CPU tests)
SHARDED_PATH = ("keystream_words", "keystream_fold_p", "eval_mac_planes", "encrypt_b_fused",
                "gated_rowsum_p", "matvec_mod_p", "carry_fold", "verify")
# prover_batch: K1 (delta), K6, K7's many-witness form, K3's many-lane form, K10
BATCH_PATH = ("keystream_words", "eval_mac_lanes", "ntt", "gated_rowsums_p", "carry_fold")
BATCH = 10  # statements of the batch (the benchmark's release.prove_batch10)
SHARDED_WORLDS = (4, 3)  # ranks simulated on the one card; 3 splits the release rows raggedly
# launches of one release run, by design: K8 t(s) and v at setup; K9
# setup's messages; K10 setup's b-rows, the prover's epilogue and its five
# smudges; K11 the whole verifier
RELEASE_LAUNCHES = {"matvec_mod_p": 2, "powers_mod_p": 1, "carry_fold": 3, "verify": 1}
# the release verifier's kernel launches under the profiler (108 before K11:
# the byte products, folds, mod_p and comparisons as torch ops)
VERIFIER_MAX_LAUNCHES = 4
# the release run's peak device memory with the SSP held as int64, as
# PERF.md section 5 records it (NVIDIA H100 80GB HBM3); uint32 halves v,
# 5.33 -> 2.67 GiB
INT64_SSP_PEAK_GIB = 6.36
D16 = {"d": 1 << 16, "m": 43690}  # m = floor(2d / 3), the release profile's ratio

# Published peaks of one H100 SXM (NVIDIA's data sheet) for the bounds.  The
# sheet gives no integer ALU rate: 67 TFLOP/s of float32 is 2 flops on 128
# lanes an SM, and half of those lanes also do 32-bit integer and logic
# operations, one a clock, so the integer peak is a quarter of it.
PEAK_BYTES = 3.35e12
PEAK_INT32 = 67e12 / 4
PEAK_INT8 = 1979e12
# 32-bit operations per 16-byte AES block.  Bitsliced core of K5
# (keystream_bitsliced.cu), the two-input gates its layout needs, two to a
# LOP3, for a group of 32 blocks: the S-box's 115 gates on 16 bytes in 14
# rounds; MixColumns in 13 rounds on the 4 columns, 108 gates a column (the
# 32 XORs of u_r = a_r ^ a_{r+1}, then a row's 8 output planes
# a_{r+1} ^ u_{r+2} ^ xtime(u_r) in 19: two a plane and the three x7 taps);
# AddRoundKey 128 planes in 15 rounds; four transposes of 480 (one a lane
# after the rounds; the counter planes are funnel shifts of two words, no
# transpose): (115 x 16 x 14 + 108 x 4 x 13 + 128 x 15 + 4 x 480) / 32 / 2
# = 550.25.  The shipped SASS issues more, 778.125 logic operations a block
# (tools/k5_sass.py), and 42 shuffles and 20 shared-memory accesses beside
# them, none counted.  K5's time is also printed against K1's count, the
# fastest way this card is known to make the same bytes.
# Conflict-free core of K1..K4 (aes_core_cf.cuh): 4 to swap and whiten the
# counter words (the nonce words are the same for every block), then 14
# rounds of 4 words x 8: four byte permutes that are the lookup addresses, and
# in a middle round one rotation and three XORs, in the last round three byte
# merges and one XOR; its 224 shared-memory loads are not counted.
# K2's fold (aes_core.cuh:fold64_mod_p), per 8-byte draw, 7: the wide
# multiply-add t = 5 * hi + lo (counted 2: it fills both result words), the
# multiply-add r = tl + 5 * th, a carry test and a conditional + 5, a
# compare with p and a conditional - p.
CF_OPS = 4 + 14 * 4 * 8
FOLD_OPS = 2 + 1 + 2 + 2
BITSLICED_OPS = (115 * 16 * 14 + 108 * 4 * 13 + 128 * 15 + 4 * 480) / 32 / 2
# K6 (ntt.cu), 32-bit operations: a radix-2 butterfly 16 (Shoup's multiply
# 9: the high product, the two 64-bit products x w and qhat q of 2 each, a
# 64-bit subtraction of 2, a compare-select of 2; the add mod q with its
# wrap test 4; the subtraction mod q 3); an element of the pointwise
# (Montgomery) product 8 and of the n^-1 scale 9 a prime; the CRT 40 an
# output (five Shoup multiplies' worth and the subtractions and adds).  The
# four-step's twiddles and reductions of the inputs are the design's, not
# counted.  K7 (rowsum.cu): one 64-bit add (2) a gated entry read; its
# many-witness form: two int8 operations a statement, byte plane and entry of
# a row some statement gates (its PRMTs are the design's, not counted).
BUTTERFLY_OPS = 16
POINTWISE_OPS = 8 + 9
CRT_OPS = 40
# K8 (modp.cu), an entry: the 32 x 32 -> 64 bit product (2), its fold to
# < 2^35 (one wide multiply-add, 2), the 64-bit add (2); its at-s form adds
# one mulmod a column for w.  K9, a mulmod: the product (2) and
# aes_core.cuh's fold64_mod_p (7); its bound counts one mulmod a word
# written (s^i from s^(i-1), alpha s^i from s^i), the function's need, not
# the design's square and multiply.  K10 (digits.cu), a position: the 64-bit
# add of the carry (2), the digit's mask and the carry's shift (2); in the
# b-row form lo + 16 hi (3), four byte products of p and the errors (8)
# and the message byte (3); in the MAC-plane form, for each of the four
# planes, the low byte (1), the high part (2) and two 64-bit adds (4); in
# the smudge form, for each draw on the row, the four byte products of p
# (8), the sign's select and the negative's constant (3) and the add (2).
# The rounds' shuffles and ballots are a few operations a lane, not counted.
MATVEC_OPS = 6
MULMOD_OPS = 2 + 7
# K11 (verify.cu): the byte products of its dots (those at digit 88 and
# above are not needed: 88 * 89 / 2 a row), four to an integer-pipe
# operation, as its route takes them (__dp4a); its at-s columns as K8's at-s
# form; the folds, mod p and the relations are a few hundred operations a
# ciphertext, not counted.
VERIFY_DP4A_PER_ROW = 88 * 89 // 2 // 4
FOLD_POS_OPS = 4
BROW_POS_OPS = 4 + 3 + 8 + 3
MAC_POS_OPS = 4 + 4 * (1 + 2 + 4)
SMUDGE_DRAW_OPS = 8 + 3 + 2


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def same_words(a, b) -> bool:
    """Bit-equal tensors of one type and shape (uint32 compared as its int32
    view: torch's uint32 is a storage type)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def max_abs_err(a, b) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(b.device).long() - b.long()).abs().max())


SENTINEL = (1 << 32) - 7  # a uint32 word >= p: no fold of K2 takes it
QUEUE_CYCLES = 50_000_000  # ~25-28 ms of the card's clock: the host queues the timed launches meanwhile


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call of reps calls of fn issued back to back,
    between two CUDA events (a kernel shorter than the host's issue of its
    launch, ~25-45 us through a wrapper (host_issue), is timed at the
    host's pace).

    queued: the stream first runs a wait kernel (torch.cuda._sleep), so the
    host has queued every launch before the start event runs and the events
    hold the kernels back to back, not the host's time to issue them."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
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
    from c_lwe_snarks_tpu_torch.ops import aes, digits, eval_fused, modp, ntt, verify

    counters = (aes.LAUNCHES, eval_fused.LAUNCHES, ntt.LAUNCHES, modp.LAUNCHES, digits.LAUNCHES,
                verify.LAUNCHES)
    for c in counters:
        for name in c:
            c[name] = 0
    return counters


def read_counters(counters) -> dict:
    return {name: c[name] for c in counters for name in c}


def product_bound(la: int, lb: int, n: int, rows: int = 1, square: bool = False) -> tuple:
    """(bytes, operations) of K6's cyclic product at length n of rows pairs
    of int64 operands of la and lb entries (a square reads one)."""
    transforms = 3 * rows * (2 if square else 3)
    ops = (transforms * n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS
           + rows * n * (3 * POINTWISE_OPS + CRT_OPS))
    return 8 * rows * (la + (0 if square else lb) + n), ops


def transform_ops(n: int, transforms: int) -> int:
    """Operations of `transforms` radix-2 transforms of length n, one prime each."""
    return transforms * n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS


def newton_ops(levels) -> int:
    """Operations of Newton levels as K6 runs them: at each level (n, k2 =
    2k kept) five transforms a prime (s's forward once, t's, 2 - ts's, two
    inverses), two pointwise products and scales, 2 k2 CRT outputs."""
    return sum(transform_ops(n, 3 * 5) + 2 * (3 * n * POINTWISE_OPS + 2 * k * CRT_OPS)
               for k, n in levels)


def division_bound(ln: int, ld: int) -> dict:
    """The bound of poly_div_exact_mod_p(num [ln], den [ld]) with den's last
    entry nonzero, for the work the K6 design does: its Newton levels
    (``newton_ops``) and the quotient's product (three transforms a prime,
    ql outputs); bytes: num and den read once, the quotient written once."""
    from c_lwe_snarks_tpu_torch.ops import ntt

    ql = max(ln - ld + 1, 1)
    n = 1 << (2 * ql - 2).bit_length()
    ops = (newton_ops(ntt._inv_levels(ql)) + transform_ops(n, 3 * 3)
           + 3 * n * POINTWISE_OPS + ql * CRT_OPS)
    return bound(8 * (ln + ld + ql), ops)


def division_bound_products(ln: int, ld: int) -> dict:
    """The same division counted product by product: each Newton level's two
    products whole (s's forward transform twice), then the quotient's."""
    ql = max(ln - ld + 1, 1)
    nbytes = ops = 0
    k = 1
    while k < ql:
        k2 = min(2 * k, 1 << (ql - 1).bit_length())
        for la, lb in ((k2, k), (k, k2)):
            b, o = product_bound(la, lb, 1 << (la + lb - 2).bit_length())
            nbytes, ops = nbytes + b, ops + o
        k = k2
    b, o = product_bound(ql, ql, 1 << (2 * ql - 2).bit_length())
    return bound(nbytes + b, ops + o)


def k6_division_launches(ql: int) -> int:
    """K6 launches of a division with quotient length ql on the card: one
    Newton launch, six a level above NEWTON_N, the quotient's product."""
    from c_lwe_snarks_tpu_torch.ops import ntt

    above = sum(n > ntt.NEWTON_N for _, n in ntt._inv_levels(ql))
    n = 1 << (2 * ql - 2).bit_length()
    return 1 + 6 * above + (2 if n <= ntt.SMEM_N else 3)


@contextlib.contextmanager
def plain_k6():
    """Every K6 wrapper by its plain version, on whatever device its
    operands are (the yardstick of K6's calls)."""
    from c_lwe_snarks_tpu_torch.ops import ntt

    k6 = ntt._plain
    ntt._plain = lambda x: True
    try:
        yield
    finally:
        ntt._plain = k6


def poly_cases(P, ent_key) -> dict:
    """K6's and K7's cases at the release main path's shapes (the case
    format of phase_kernels; the last case of each is reported): the
    prover's own v, t and witness from a release random_ssp."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import modp, ntt

    d, m = P.d, P.m
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    wits, ssp = tssp.random_ssp(ent_key, 0, P)
    mask = torch.cat([torch.ones(1, dtype=torch.uint8, device=DEVICE), wits[: m - 1]])
    v = tsnark.prover_polys(ent_key, off_prove, ssp, wits, P)[2]
    num = ntt.poly_mul_mod_p(v, v)
    num[0] = modp.submod_p(num[0], 1)
    t = ssp.t.to(torch.int64)  # the division's words, as the prover widens them
    degree, lead = ntt.poly_degree_and_lead(t)
    check(degree == d - 1, f"release t has degree {degree}")
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    qs = torch.tensor(ntt.NTT_PRIMES, device=DEVICE).reshape(3, 1, 1)
    x = (torch.randint(0, 1 << 31, (3, 64, 256), generator=gen, device=DEVICE) % qs).contiguous()
    q_max = (qs - 1).expand(3, 2, d).contiguous()
    p_max = torch.full((d,), modp.P - 1, dtype=torch.int64, device=DEVICE)
    t_rev = torch.flip(t, (0,))
    s_quarter = torch.randint(0, modp.P, (d // 4,), generator=gen, device=DEVICE)
    all_max = torch.full((tssp.TILE, d), modp.P - 1, dtype=torch.uint32).to(DEVICE)
    ones = torch.ones(tssp.TILE, dtype=torch.uint8, device=DEVICE)
    n16, n15 = 2 * d, d

    def k7_bound(gate, cols):  # the gated uint32 rows and the gates in, int64 sums out
        gated = int(gate.sum())
        return bound(4 * gated * cols + gate.numel() + 8 * cols, 2 * gated * cols)

    def k7_many_bound(gates, cols):  # the union of the gated rows, read once
        union, b = int(gates.any(0).sum()), gates.shape[0]
        return bound(4 * union * cols + gates.numel() + 8 * b * cols, 0, 2 * 4 * b * union * cols)

    gen_w = torch.Generator(device=DEVICE).manual_seed(BATCH)
    batch_gates = torch.stack([wits] + [torch.randint(0, 2, (m,), generator=gen_w, device=DEVICE,
                                                      dtype=torch.uint8) for _ in range(BATCH - 1)])
    batch_gates = batch_gates[:, : m - 1]  # a column slice, as prover_polys_batch passes it
    many_bound = k7_many_bound(batch_gates, d)
    singles_bound = {"bound_ms": sum(k7_bound(g, d)["bound_ms"] for g in batch_gates),
                     "bound_by": "bytes"}

    def div(k6: bool):
        with contextlib.nullcontext() if k6 else plain_k6():
            return ntt.poly_div_exact_mod_p(num, t, d, den_degree=degree, den_lead=lead)

    # the Newton launch at the release levels: 2 k = 2,048 of t's reversed
    # entries, levels n = 2 ... 4,096; one release level above it, n = 2^16
    levels = ntt._inv_levels(ntt.NEWTON_N // 2)
    t_top = t_rev[None, : ntt.NEWTON_N // 2].contiguous()
    seed = pow(lead, modp.P - 2, modp.P)
    seed_t = torch.full((1, 1), seed, dtype=torch.int64, device=DEVICE)
    top = [ntt._inv_levels(d)[-1]]
    s_top = torch.randint(0, modp.P, (1, d // 2), generator=gen, device=DEVICE)
    ws = torch.empty(11 * top[0][1], dtype=torch.int32, device=DEVICE)
    newton_case = [
        (f"the Newton launch: {len(levels)} levels, n = 2 ... {levels[-1][1]}, of t's "
         f"{t_top.shape[-1]} reversed entries", 20,
         lambda: ntt._k6_newton(t_top, None, seed, len(levels), levels[-1][1]),
         lambda: ntt._newton_plain(t_top, seed_t, levels),
         bound(8 * 2 * t_top.shape[-1], newton_ops(levels))),
        (f"a Newton level above it: k = {top[0][0]}, n = {top[0][1]} (two fused products)", 20,
         lambda: ntt._k6_levels(t_rev[None], s_top, top, ws),
         lambda: ntt._newton_plain(t_rev[None], s_top, top),
         bound(8 * (2 * top[0][0] + top[0][0] + 2 * top[0][0]), newton_ops(top)))]
    old = division_bound_products(num.numel(), d)
    print(f"phase kernels: ntt [the release division] bound counted product by product (s's "
          f"forward transform twice a level, bytes a product): {old['bound_ms']:.4f} ms by "
          f"{old['bound_by']}")

    return {
        "ntt": [
            ("a batched transform: [3, 64, 256] residues", 20,
             lambda: ntt._transform(x, False), lambda: ntt._transform_plain(x, False),
             bound(2 * 8 * x.numel(), x.numel() // 2 * 8 * BUTTERFLY_OPS)),
            (f"the wrap: inverse transforms of [3, 2, {d}] residues, each q - 1", 20,
             lambda: ntt._transform(q_max, True), lambda: ntt._transform_plain(q_max, True),
             bound(2 * 8 * q_max.numel(), q_max.numel() // 2 * (d.bit_length() - 1) * BUTTERFLY_OPS)),
            (f"the wrap: product of two {d}-entry operands, each p - 1, n = {n16}", 20,
             lambda: ntt._poly_mul_cyclic(p_max, p_max.clone(), n16),
             lambda: ntt._poly_mul_plain(ntt._fit_len(p_max, n16), ntt._fit_len(p_max, n16)),
             bound(*product_bound(d, d, n16))),
            (f"a Newton level's product: t's {d // 2} reversed entries x s's {d // 4}, n = {n15}", 20,
             lambda: ntt._poly_mul_cyclic(t_rev[: d // 2], s_quarter, n15),
             lambda: ntt._poly_mul_plain(ntt._fit_len(t_rev[: d // 2], n15), ntt._fit_len(s_quarter, n15)),
             bound(*product_bound(d // 2, d // 4, n15))),
            *newton_case,
            (f"the release division h = (v^2 - 1) / t end to end: num [{num.numel()}], t [{d}]", 5,
             lambda: div(True), lambda: div(False), division_bound(num.numel(), d)),
            (f"the prover's v^2: v [{d}] squared, n = {n16}", 20,
             lambda: ntt._poly_mul_cyclic(v, None, n16),
             lambda: ntt._poly_mul_plain(ntt._fit_len(v, n16), None),
             bound(*product_bound(d, d, n16, square=True)))],
        "gated_rowsum_p": [
            (f"a random_ssp tile: v [{tssp.TILE}, {d}], the t-gate", 10,
             lambda: modp.gated_rowsum_mod_p(ssp.v[: tssp.TILE], mask[: tssp.TILE]),
             lambda: modp.gated_rowsum_plain(ssp.v[: tssp.TILE], mask[: tssp.TILE]),
             k7_bound(mask[: tssp.TILE], d)),
            (f"the largest sum: [{tssp.TILE}, {d}], every gate 1 and every entry p - 1", 10,
             lambda: modp.gated_rowsum_mod_p(all_max, ones),
             lambda: modp.gated_rowsum_plain(all_max, ones), k7_bound(ones, d)),
            (f"the prover's w: v[1:] [{m - 1}, {d}], the witness", 5,
             lambda: modp.gated_rowsum_mod_p(ssp.v[1:], wits[: m - 1]),
             lambda: modp.gated_rowsum_plain(ssp.v[1:], wits[: m - 1]),
             k7_bound(wits[: m - 1], d))],
        # the ten single launches first, the many-witness form last (reported)
        "gated_rowsums_p": [
            (f"the batch's ten w's by K7, a launch a witness: v[1:] [{m - 1}, {d}]", 5,
             lambda: torch.stack([modp.gated_rowsum_mod_p(ssp.v[1:], g) for g in batch_gates]),
             lambda: modp.gated_rowsums_plain(ssp.v[1:], batch_gates), singles_bound),
            (f"the batch's ten w's in one launch: v[1:] [{m - 1}, {d}], {BATCH} witnesses", 5,
             lambda: modp.gated_rowsums_mod_p(ssp.v[1:], batch_gates),
             lambda: modp.gated_rowsums_plain(ssp.v[1:], batch_gates), many_bound)],
    }


def python_fold(acc, ndigits: int):
    """uint8 [rows, ndigits]: sum_t acc[r, t] * 256^t mod 256^ndigits of
    each row of a CPU int64 tensor, by Python ints (K10's reference where
    its plain version's 2^47 range ends)."""
    import numpy as np
    import torch

    out = []
    for row in acc.tolist():
        x = sum(v << (8 * t) for t, v in enumerate(row)) % (1 << (8 * ndigits))
        out.append(np.frombuffer(x.to_bytes(ndigits, "little"), np.uint8))
    return torch.from_numpy(np.stack(out))


L2_BYTES = 50 << 20  # the H100's L2


def rotating(fn, first: tuple, make, nbytes: int):
    """A call of fn on the next of several input sets (first, then sets
    made by make()) of nbytes each, as many as read more than L2_BYTES
    together, so no timed call finds its inputs in L2."""
    sets = [first] + [make() for _ in range(L2_BYTES // nbytes + 1)]
    order = itertools.cycle(sets)
    return lambda: fn(*next(order))


def at_s_ops(rows: int, d: int) -> int:
    """K8's at-s form: the matvec's entries and one mulmod a column for w
    (each thread's start by square and multiply is the design's, not counted)."""
    return MATVEC_OPS * rows * d + MULMOD_OPS * d


def b_rows_bytes(rows: int) -> int:
    """What K10's b-row form moves for rows encryptions: two int32 planes,
    the error bytes and the digits out, 88 positions each, and the message
    words."""
    return rows * (88 * (4 + 4 + 1 + 1) + 8)


def copy_floor(nbytes: int) -> dict:
    """A device copy that moves nbytes (half read, half written), timed as
    the kernels are: the rate the card's memory gives a plain stream of that
    size, beside the bytes' bound."""
    import torch

    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms, queued_ms = cuda_ms(lambda: dst.copy_(src), 20), cuda_ms(lambda: dst.copy_(src), 20, True)
    return {"ms": ms, "queued_ms": queued_ms, **bound(2 * src.numel(), 0)}


def planes_set(gen, n: int) -> tuple:
    """(int64 planes [5, n+1, 88] < 2^26,): K10's planes form at the
    sharded path's shape."""
    import torch

    return (torch.randint(0, 1 << 26, (5, n + 1, 88), generator=gen, device=DEVICE),)


def mac_set(gen, n: int) -> tuple:
    """(acc_a int64 [4, 5, n, 88], acc_b [4, 5, 88]), both < 2^40: K10's
    MAC-plane form at the prover's shape."""
    import torch

    return (torch.randint(0, 1 << 40, (4, 5, n, 88), generator=gen, device=DEVICE),
            torch.randint(0, 1 << 40, (4, 5, 88), generator=gen, device=DEVICE))


def smudge_case(P, ent_key):
    """The prover's smudging at release: five evaluations [5, n+1, 88] and
    the five draws as smudge_proof samples them."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import sampling

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    evals = torch.randint(0, 256, (5, P.n + 1, 88), generator=gen, device=DEVICE, dtype=torch.uint8)
    off = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P) + 8
    width = tsnark.smudge_entropy_bytes(P)
    draws = sampling.sample_digit_rows(ent_key, off, 5, draw_bytes=width, ndigits=width)
    return evals, draws


def schedule_cases(P, crs_key, ent_key) -> dict:
    """K8's, K9's and K10's cases at the release main path's shapes (the
    case format of phase_kernels; the last case of each is the main path's
    largest call and is reported): setup's v, t and powers of s from a
    release random_ssp, setup's b-rows from K4's planes with the release
    errors and messages, t and v_0 at s, the prover's MAC planes
    and smudging, and the sharded path's planes."""
    import torch

    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import digits as dg
    from c_lwe_snarks_tpu_torch.ops import eval_fused, modp, sampling

    d, m, n = P.d, P.m, P.n
    off_setup = tssp.entropy_bytes_random_ssp(P)
    _, ssp = tssp.random_ssp(ent_key, 0, P)
    scalars = sampling.keystream_bytes(ent_key, off_setup, 24).reshape(3, 8)
    alpha, beta, s = (modp.bytes_to_u64_mod_p(scalars[i]) for i in range(3))
    powers = modp.powers_mod_p(s, d)
    t_row = ssp.t[None, :]
    rows2 = torch.stack([ssp.t, ssp.v[0]])
    n_enc = 2 * d + m
    msgs = tsnark.setup_messages(
        alpha, beta, s, ssp.t, lambda pw: modp.matvec_mod_p(ssp.v, pw), d, m)
    errs = tsnark.setup_errs(ent_key, off_setup, 0, n_enc, P)
    sk = tlwe.key_gen(ent_key, off_setup + 24, P)
    v_lo, v_hi = eval_fused.encrypt_b_planes(crs_key, P.ctr_s, sk, n_enc, n, P.ctr_ct)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    (planes,), (acc_a, acc_b) = planes_set(gen, n), mac_set(gen, n)
    planes_sets = rotating(dg.carry_fold, (planes,), lambda: planes_set(gen, n),
                           8 * planes.numel())
    mac_sets = rotating(dg.fold_mac_planes, (acc_a, acc_b), lambda: mac_set(gen, n),
                        8 * (acc_a.numel() + acc_b.numel()))
    evals, draws = smudge_case(P, ent_key)
    return {
        "matvec_mod_p": [
            (f"t(s) at setup: [1, {d}]", 20,
             lambda: modp.matvec_mod_p(t_row, powers), lambda: modp.matvec_plain(t_row, powers),
             bound(4 * d + 8 * (d + 1), MATVEC_OPS * d)),
            (f"the at-s form, poly_eval_mod_p at t and v_0: [2, {d}] (launch-bound)", 20,
             lambda: modp.poly_eval_mod_p(rows2, s), lambda: modp.poly_eval_plain(rows2, s),
             bound(4 * 2 * d + 8 * (1 + 2), at_s_ops(2, d))),
            (f"setup's v_i(s): v [{m}, {d}]", 10,
             lambda: modp.matvec_mod_p(ssp.v, powers), lambda: modp.matvec_plain(ssp.v, powers),
             bound(4 * m * d + 8 * (d + m), MATVEC_OPS * m * d))],
        "powers_mod_p": [
            (f"powers_mod_p: count {d} (launch-bound)", 20,
             lambda: modp.powers_mod_p(s, d), lambda: modp.powers_plain(s, d),
             bound(8 * (d + 1), MULMOD_OPS * d)),
            (f"the messages form, setup's s^i and alpha s^i: count {d} (launch-bound)", 20,
             lambda: modp.message_powers(s, alpha, d, out=msgs[: 2 * d]),
             lambda: modp.message_powers_plain(s, alpha, d),
             bound(8 * (2 * d + 2), MULMOD_OPS * 2 * d))],
        "carry_fold": [
            (f"the planes form, the sharded evaluation: [5, {n + 1}, 88] int64", 20,
             lambda: dg.carry_fold(planes), lambda: dg.carry_fold_plain(planes),
             bound(9 * planes.numel(), FOLD_POS_OPS * planes.numel()), planes_sets),
            ("the smudge form, the prover's five draws on four b rows (launch-bound)", 20,
             lambda: dg.smudge_draws(evals, draws, tsnark.SMUDGE_TARGETS),
             lambda: dg.smudge_draws_plain(evals.clone(), draws, tsnark.SMUDGE_TARGETS),
             bound(2 * 4 * 88 + draws.numel(), (FOLD_POS_OPS + 2 * SMUDGE_DRAW_OPS) * 4 * 88)),
            (f"the MAC-plane form, the prover's epilogue: [4, 5, {n}, 88] + [4, 5, 88]", 20,
             lambda: dg.fold_mac_planes(acc_a, acc_b), lambda: dg.fold_mac_planes_plain(acc_a, acc_b),
             bound(8 * (acc_a.numel() + acc_b.numel()) + 5 * (n + 1) * 88,
                   MAC_POS_OPS * 5 * (n + 1) * 88), mac_sets),
            (f"the b-row form, setup's b-rows: {n_enc} rows of K4's planes, errors and messages", 20,
             lambda: dg.carry_fold_b_rows(v_lo, v_hi, errs, msgs),
             lambda: dg.b_rows_plain(v_lo, v_hi, errs, msgs),
             bound(b_rows_bytes(n_enc), BROW_POS_OPS * n_enc * 88))],
    }


def release_proof(P, crs_key, ent_key) -> tuple:
    """(crs, vrs, ssp, proof) of one release run through the package's entry
    points (random_ssp, setup, the one-pass prover)."""
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp

    off_setup = tssp.entropy_bytes_random_ssp(P)
    wits, ssp = tssp.random_ssp(ent_key, 0, P)
    crs, vrs = tsnark.setup(crs_key, ent_key, off_setup, ssp, P)
    proof = tsnark.prover(crs_key, ent_key, off_setup + tsnark.setup_entropy_bytes(P), crs, ssp,
                          wits, P)
    return crs, vrs, ssp, proof


def verify_bound(k: int, n: int, d: int = 0) -> dict:
    """K11's bound: k ciphertexts [n+1, 88] and sk read once, the decrypts
    written once, a dp4a for four byte products of the dots; with d (the
    verifier form) t and v_0 (uint32) and the three scalars read, the eight
    words and the verdict written, and K8's at-s count for the two rows."""
    nbytes = k * (n + 1) * 88 + n * 88 + 8 * k
    ops = k * n * VERIFY_DP4A_PER_ROW
    if d:
        nbytes += 2 * 4 * d + 3 * 4 + 8 * (8 - k) + 1
        ops += at_s_ops(2, d)
    return bound(nbytes, ops)


def verify_cases(P, crs_key, ent_key, worse) -> dict:
    """K11's cases (the case format of phase_kernels; the verifier form last,
    the release main path's call) after its edges on a release proof, each
    against its plain version on the same inputs: the honest proof
    accepted; each field's b row and one a row tampered, and a wrong alpha,
    rejected, with the eight words equal; decrypts at k = 1, 5 and 7 with b
    < <a, sk>, every byte 255, and the probes' 256 CRS terms."""
    import torch

    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.ops import sampling, verify

    n, d = P.n, P.d
    crs, vrs, ssp, proof = release_proof(P, crs_key, ent_key)
    cts = (proof.h, proof.hat_h, proof.hat_v, proof.v_w, proof.b_w)
    args = (vrs.sk, ssp.t, ssp.v[0], vrs.s, vrs.alpha, vrs.beta, P.log_smudging // 8)
    wrong = ((vrs.alpha.to(torch.int64) + 1) % P.p).to(torch.uint32)
    variants = [("honest", cts, args, True)]
    for e, name in enumerate(("h", "hat_h", "hat_v", "v_w", "b_w")):
        for row in (n, 11):
            bad = list(cts)
            bad[e] = cts[e].clone()
            bad[e][row, 5] ^= 1
            variants.append((f"{name}[{row}] tampered", tuple(bad), args, False))
    variants.append(("alpha + 1", cts, (*args[:4], wrong, *args[5:]), False))
    verdicts = []
    for label, c, a, accept in variants:
        ok, words = verify.verify(c, *a)
        want_ok, want_words = verify.verify_plain(c, *a)
        worse("verify", max_abs_err(words, want_words))
        worse("verify", int(bool(ok) != bool(want_ok)) + int(bool(ok) != accept))
        verdicts.append(f"{label} {'accepted' if bool(ok) else 'rejected'}")
    print(f"phase kernels: verify on a release proof: {'; '.join(verdicts)}")
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    for k in (1, 5, 7):
        ct = torch.randint(0, 256, (k, n + 1, 88), generator=gen, device=DEVICE, dtype=torch.uint8)
        ct[0, n, 1:] = 0  # b < 256 <= <a, sk>
        if k > 1:
            ct[-1] = 255
        worse("verify", max_abs_err(verify.decrypt(ct, vrs.sk), verify.decrypt_plain(ct, vrs.sk)))
    probe = tlwe.ct_import(sampling.PRGKey(crs.seed, DEVICE), P.ctr_s, crs.b_s[:TILE], P)
    return {"verify": [
        (f"the decrypt form, the probes' {TILE} CRS terms: [{TILE}, {n + 1}, 88]", 20,
         lambda: verify.decrypt(probe, vrs.sk), lambda: verify.decrypt_plain(probe, vrs.sk),
         verify_bound(TILE, n)),
        (f"the verifier form, a release proof: 5 x [{n + 1}, 88], t and v_0 [{d}]", 20,
         lambda: verify.verify(cts, *args)[1], lambda: verify.verify_plain(cts, *args)[1],
         verify_bound(5, n, d))]}


I64_MAX = (1 << 63) - 1


def python_mac(acc_a, acc_b):
    """uint8 [k, n+1, 88]: sum_c plane_c * 256^c mod 2^704 of the MAC
    planes (CPU int64 tensors), by Python ints (K10's MAC-plane form)."""
    import numpy as np
    import torch

    planes = torch.cat([acc_a, acc_b[:, :, None, :]], dim=2).tolist()
    k, rows = len(planes[0]), len(planes[0][0])
    out = np.zeros((k, rows, 88), np.uint8)
    for kk in range(k):
        for i in range(rows):
            v = sum(x << (8 * (t + c)) for c in range(4) for t, x in enumerate(planes[c][kk][i]))
            out[kk, i] = np.frombuffer((v % (1 << 704)).to_bytes(88, "little"), np.uint8)
    return torch.from_numpy(out)


def python_smudge(b_rows, draws, targets):
    """uint8 [E, 88]: the b rows (CPU uint8) after b += -+p * s mod 2^704
    for each draw (uint8 [S, 81]: 80 digit bytes, the sign byte, low bit 0
    positive) on row targets[i], by Python ints (K10's smudge form)."""
    import numpy as np
    import torch

    p = (1 << 32) - 5
    b = [int.from_bytes(bytes(r), "little") for r in b_rows.tolist()]
    for i, e in enumerate(targets):
        row = draws[i].tolist()
        sp = int.from_bytes(bytes(row[:-1]), "little") * p
        b[e] = (b[e] + (-sp if row[-1] & 1 else sp)) % (1 << 704)
    return torch.from_numpy(np.stack([np.frombuffer(x.to_bytes(88, "little"), np.uint8) for x in b]))


def redesign_edges(worse, gen) -> None:
    """K8's, K9's and K10's new forms at their edges, each against its
    plain version and Python ints: K9's two forms at s = 0, 1, p - 1 and
    random, counts 1, 2, 3 and 2^15 + 1; K8's at-s form at d < 8, 2^15 and
    past 2^21; K10's planes form at 1, 31, 33 and 7,355 rows (int64 planes
    at 2^63 - 1, the worst ripple and ripples stopped at every position,
    int32 at 2^31 - 1, K short of and past ndigits, two passes); its
    MAC-plane form at k = 1 and 5, odd n, planes at 2^63 - 1; its smudge
    form under every sign pattern, s = 0, 2^640 - 1 and random."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.ops import digits as dg
    from c_lwe_snarks_tpu_torch.ops import modp

    pm1 = modp.P - 1
    alpha = torch.tensor(2718281828, device=DEVICE)
    for s9 in (0, 1, pm1, 3141592653):
        st = torch.tensor(s9, dtype=torch.int64, device=DEVICE)
        for count in (1, 2, 3, (1 << 15) + 1):
            got = modp.message_powers(st, alpha, count)
            worse("powers_mod_p", max_abs_err(got, modp.message_powers_plain(st, alpha, count)))
            worse("powers_mod_p", max_abs_err(modp.powers_mod_p(st, count), got[:count]))
            want = [pow(s9, i, modp.P) for i in range(count)]
            want += [w * 2718281828 % modp.P for w in want]
            worse("powers_mod_p", max_abs_err(got.cpu(), torch.tensor(want)))
        for rows, d8 in ((2, 1), (2, 7), (2, 1 << 15), (1, (1 << 21) + 8)):
            v8 = torch.randint(0, modp.P, (rows, d8), generator=gen)
            v8[0] = pm1
            v8 = v8.to(torch.uint32).to(DEVICE)
            got = modp.poly_eval_mod_p(v8, st)
            worse("matvec_mod_p", max_abs_err(got, modp.poly_eval_plain(v8, st)))
            if d8 < 8:
                want = [sum(c * pow(s9, i, modp.P) for i, c in enumerate(r)) % modp.P
                        for r in v8.tolist()]
                worse("matvec_mod_p", max_abs_err(got.cpu(), torch.tensor(want)))
    for rows in (1, 31, 33, 7355):
        ripples = torch.full((rows, 88), 255, dtype=torch.int64)
        ripples[:, 0] = 256
        ripples[torch.arange(1, rows), torch.arange(1, rows) % 87 + 1] = 254  # row 0: the worst ripple
        edges = [(torch.full((rows, 88), I64_MAX), 88), (ripples, 88),
                 (torch.full((rows, 88), (1 << 31) - 1, dtype=torch.int32), 88),
                 (torch.randint(0, I64_MAX, (rows, 61), generator=gen), 88),
                 (torch.randint(0, I64_MAX, (rows, 120), generator=gen), 88),
                 (torch.randint(0, I64_MAX, (rows, 150), generator=gen), 140)]
        for acc, nd in edges:
            got = dg.carry_fold(acc.to(DEVICE), nd)
            worse("carry_fold", max_abs_err(got, dg.carry_fold_plain(acc, nd)))
            if rows <= 33:
                worse("carry_fold", max_abs_err(got.cpu(), python_fold(acc.long(), nd)))
    for k, n, top in ((1, 3, I64_MAX), (5, 7, I64_MAX), (5, 1, 1 << 40), (2, 0, I64_MAX)):
        acc_a = torch.randint(0, top, (4, k, n, 88), generator=gen)
        acc_b = torch.randint(0, top, (4, k, 88), generator=gen)
        acc_a[:, :, : min(n, 2)] = top  # planes at their largest
        acc_b[:, 0] = top
        got = dg.fold_mac_planes(acc_a.to(DEVICE), acc_b.to(DEVICE))
        worse("carry_fold", max_abs_err(got, dg.fold_mac_planes_plain(acc_a, acc_b)))
        worse("carry_fold", max_abs_err(got.cpu(), python_mac(acc_a, acc_b)))
    n = 3
    for kind in ("random", "zero", "max"):
        for signs in range(32):
            evals = torch.randint(0, 256, (5, n + 1, 88), generator=gen, dtype=torch.uint8)
            evals[1, n], evals[2, n] = 255, 0  # b at 2^704 - 1 and at 0
            draws = torch.randint(0, 256, (5, 81), generator=gen, dtype=torch.uint8)
            if kind != "random":
                draws[:, :80] = 0 if kind == "zero" else 255  # s = 0 or 2^640 - 1
            draws[:, 80] = (draws[:, 80] & 0xFE) | ((signs >> torch.arange(5)) & 1).to(torch.uint8)
            want = python_smudge(evals[:, n], draws, tsnark.SMUDGE_TARGETS)
            plain = dg.smudge_draws_plain(evals.clone(), draws, tsnark.SMUDGE_TARGETS)
            got = dg.smudge_draws(evals.clone().to(DEVICE), draws.to(DEVICE), tsnark.SMUDGE_TARGETS)
            worse("carry_fold", max_abs_err(got[:, n].cpu(), want))
            worse("carry_fold", max_abs_err(got[:, :n].cpu(), evals[:, :n]))
            worse("carry_fold", max_abs_err(got, plain))


def phase_kernels(results: dict) -> None:
    """Every kernel against its plain version (K1 and K5 also against the
    host cipher and the golden keystream windows), at small shapes and
    edges, then at the release main path's shapes, timed."""
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

    def host_bytes(start, nblocks):
        return torch.from_numpy(aes_host.ctr_keystream_numpy(
            SEED[8:], int.from_bytes(SEED[:8], "little"), start, nblocks).copy())

    # K1 as bytes: one CUDA block's worth and less (1, 2, 171 blocks), the
    # counter low-word wrap and a start above 2^33, against the plain version
    # and the host cipher; its word view; then any-alignment slices
    for start, count in ((7, 1), ((1 << 32) - 1, 2), ((1 << 32) - 3, 171),
                         ((1 << 32) - 3, 1000), ((1 << 33) + 11, 4097)):
        got = aes.keystream_blocks(k, start, count)
        check(got.dtype == torch.uint8 and got.shape == (count, 16), "K1 writes uint8 [n, 16]")
        worse("keystream_words", max_abs_err(
            got.reshape(-1), aes.keystream_bytes_plain(k, 16 * start, 16 * count)))
        worse("keystream_words", max_abs_err(got.reshape(-1).cpu(), host_bytes(start, count)))
        worse("keystream_words", max_abs_err(
            aes.keystream_words(k, start, count), aes.keystream_words_plain(k, start, count)))
    worse("keystream_words", max_abs_err(
        sampling.keystream_bytes(key, 16 * 12345, 16 * 96).cpu(), host_bytes(12345, 96)))
    worse("keystream_words", max_abs_err(
        sampling.keystream_bytes(key, 16 * 12345 + 13, 301).cpu(),
        host_bytes(12345, 20)[13 : 13 + 301]))
    # K5: the same windows, ragged counts around a quad's group (32 blocks),
    # a warp's tile (256) and a CUDA block's tiles (1,024), the low-word wrap
    # inside a group, a start above 2^32 and more than one grid-stride pass,
    # against its plain version, K1's bytes and the host cipher; the main
    # path's two shapes against K1
    for start5, count in ((12345, 96), ((1 << 32) - 3, 1000), (5, 31), (5, 32), (5, 33), (7, 1),
                          ((1 << 32) - 67, 255), ((1 << 32) - 3, 256), ((1 << 32) - 303, 257),
                          (7, 1023), (7, 1024), ((1 << 32) + 9, 1025), ((1 << 33) + 11, 4097),
                          (3, 528 * 1024 + 33)):
        got = aes.keystream_blocks(k, start5, count, version=1)
        worse("keystream_blocks_v1", max_abs_err(got, aes.keystream_blocks_v1_plain(k, start5, count)))
        worse("keystream_blocks_v1", max_abs_err(got, aes.keystream_blocks(k, start5, count)))
        if count <= 4097:
            worse("keystream_blocks_v1", max_abs_err(got.reshape(-1).cpu(), host_bytes(start5, count)))
    for start5, count in ((6_000_123, 382_292), (1 << 20, 2_163_840)):
        worse("keystream_blocks_v1", max_abs_err(
            aes.keystream_blocks(k, start5, count, version=1), aes.keystream_blocks(k, start5, count)))
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
    # K2: 1, 2 and an odd count of pairs across the wrap and above 2^32, into
    # its own tensor and, with out=, into a slice between sentinels
    for start, npairs in ((3, 1), ((1 << 32) - 1, 2), ((1 << 32) - 5, 2001), ((1 << 32) + 9, 2001)):
        want = aes.keystream_fold_p_plain(k, start, npairs)
        got = aes.keystream_fold_p(k, start, npairs)
        check(got.dtype == want.dtype == torch.uint32, "K2 writes uint32 folds")
        worse("keystream_fold_p", max_abs_err(got, want))
        guarded = torch.full((npairs + 4,), SENTINEL, dtype=torch.uint32).to(DEVICE)
        got = aes.keystream_fold_p(k, start, npairs, out=guarded[2 : 2 + npairs])
        check(got.data_ptr() == guarded[2:].data_ptr(), "K2 returns the out= tensor")
        worse("keystream_fold_p", max_abs_err(guarded[2 : 2 + npairs], want))
        ends = guarded.cpu().tolist()
        check(ends[:2] == ends[2 + npairs:] == [SENTINEL] * 2,
              f"K2 wrote outside out= (npairs={npairs})")
    refused = 0
    for bad in (torch.empty(9, dtype=torch.uint32, device=DEVICE)[1:],  # 4 bytes off an 8-byte line
                torch.empty(8, dtype=torch.int32, device=DEVICE),
                torch.empty(8, dtype=torch.int64, device=DEVICE),
                torch.empty(16, dtype=torch.uint32, device=DEVICE)[::2]):
        try:
            aes.keystream_fold_p(k, 0, 8, out=bad)
        except ValueError:
            refused += 1
    check(refused == 4, "K2 took a misaligned, wrongly typed (int64) or strided out=")
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
    # K3's tiles: d not a multiple of 4, 32 or 128, one row, k = 8, odd offsets and n
    for n3, k3, d3, off in ((6, 1, 1, 3), (5, 8, 131, 16 * 7 + 8), (7, 3, 1030, 5), (2, 2, 4099, 184)):
        c3 = torch.randint(0, 1 << 32, (k3, d3), generator=gen).to(DEVICE)
        worse("eval_mac_planes", max_abs_err(
            eval_fused.eval_mac_planes(key, off, c3, n3, 92 * n3),
            eval_fused.eval_mac_planes_plain(key, off, c3, n3, 92 * n3)))
    # K4's tiles: counts off the block's 128 ciphertexts, one ciphertext,
    # offsets 0 / 8 / odd / 16 * 7 + 8, n = 6 and odd n (a ragged last tile of draws)
    for n4, count, off in ((6, 1, 0), (6, 130, 8), (7, 129, 13), (2, 5, 16 * 7 + 8),
                           (19, 257, 8), (33, 3, 1)):
        sk4 = torch.randint(0, 256, (n4, 88), generator=gen, dtype=torch.uint8).to(DEVICE)
        worse("encrypt_b_fused", max_abs_err(
            eval_fused.encrypt_b_fused(key, off, sk4, count, n4, 92 * n4),
            eval_fused.encrypt_b_fused_plain(key, off, sk4, count, n4, 92 * n4)))
    # both at the release width with every operand at its largest: the
    # signed 32-bit sums at their bound
    REL = release()
    sk_max = torch.full((REL.n, 88), 255, dtype=torch.uint8, device=DEVICE)
    worse("encrypt_b_fused", max_abs_err(
        eval_fused.encrypt_b_fused(key, REL.ctr_s, sk_max, 130, REL.n, REL.ctr_ct),
        eval_fused.encrypt_b_fused_plain(key, REL.ctr_s, sk_max, 130, REL.n, REL.ctr_ct)))
    c_max = torch.full((5, 700), (1 << 32) - 1, dtype=torch.int64, device=DEVICE)
    worse("eval_mac_planes", max_abs_err(
        eval_fused.eval_mac_planes(key, REL.ctr_s, c_max, REL.n, REL.ctr_ct),
        eval_fused.eval_mac_planes_plain(key, REL.ctr_s, c_max, REL.n, REL.ctr_ct)))
    # K8 at d < 8, 8, 32,768, 32,769 and past 2^21 (the repaired fault),
    # every entry p - 1, one row split over blocks, a ragged row group;
    # K9 at s = 0, 1, p - 1 and random, counts 1, 2, 3, 1,000, 2^15 + 1;
    # K10 on random int64 and int32 planes, the worst ripple (256, then 87
    # positions of 255), K past and short of ndigits, planes near 2^62
    # (against Python ints), its b-row form at the nibble planes' bound
    from c_lwe_snarks_tpu_torch.ops import digits as dg
    from c_lwe_snarks_tpu_torch.ops import modp

    pm1 = modp.P - 1
    for rows, d8 in ((1, 1), (3, 7), (5, 8), (2, 33), (21, 1 << 15), (1, (1 << 15) + 1),
                     (1, (1 << 21) + 8), (9, 40000), (4229, 16)):
        v8 = torch.full((rows, d8), pm1, dtype=torch.uint32).to(DEVICE)
        for w8 in (torch.full((d8,), pm1, dtype=torch.int64, device=DEVICE),
                   torch.randint(0, modp.P, (d8,), generator=gen).to(DEVICE)):
            worse("matvec_mod_p", max_abs_err(modp.matvec_mod_p(v8, w8), modp.matvec_plain(v8, w8)))
        v8 = torch.randint(0, modp.P, (rows, d8), generator=gen).to(torch.uint32).to(DEVICE)
        worse("matvec_mod_p", max_abs_err(modp.matvec_mod_p(v8, w8), modp.matvec_plain(v8, w8)))
    for s9 in (0, 1, pm1, 3141592653):
        for count in (1, 2, 3, 1000, (1 << 15) + 1):
            st = torch.tensor(s9, dtype=torch.int64, device=DEVICE)
            worse("powers_mod_p", max_abs_err(modp.powers_mod_p(st, count), modp.powers_plain(st, count)))
    ripple = torch.full((88, 88), 255, dtype=torch.int64)
    ripple[:, 0] = 256
    ripple[torch.arange(1, 88), torch.arange(1, 88)] = 254
    folds = [(torch.randint(0, 1 << 47, (300, 88), generator=gen), 88),
             (torch.randint(0, 1 << 31, (129, 88), generator=gen).int(), 88), (ripple, 88),
             (torch.randint(0, 1 << 40, (33, 100), generator=gen), 88),
             (torch.randint(0, 1 << 47, (33, 70), generator=gen), 88),
             (torch.randint(0, 4 * 255 + 1, (5, 33, 88), generator=gen).int(), 88)]
    for acc, nd in folds:
        got = dg.carry_fold(acc.to(DEVICE), nd)
        worse("carry_fold", max_abs_err(got, dg.carry_fold_plain(acc, nd)))
        worse("carry_fold", max_abs_err(got.reshape(-1, nd).cpu(), python_fold(acc.reshape(-1, acc.shape[-1]).long(), nd)))
    wide = torch.randint(0, 1 << 62, (65, 88), generator=gen)
    worse("carry_fold", max_abs_err(dg.carry_fold(wide.to(DEVICE)).cpu(), python_fold(wide, 88)))
    for top in (False, True):
        B = 1000
        lo = torch.randint(0, 1 << 31, (B, 88), generator=gen).int()
        hi = torch.randint(0, 1 << 31, (B, 88), generator=gen).int()
        e10 = torch.randint(0, 256, (B, 88), generator=gen, dtype=torch.uint8)
        m10 = torch.randint(0, 1 << 32, (B,), generator=gen)
        if top:  # every nibble plane, error byte and message at its largest
            for t, x in ((lo, (1 << 31) - 1), (hi, (1 << 31) - 1), (e10, 255), (m10, (1 << 32) - 1)):
                t.fill_(x)
        worse("carry_fold", max_abs_err(
            dg.carry_fold_b_rows(lo.to(DEVICE), hi.to(DEVICE), e10.to(DEVICE), m10.to(DEVICE)),
            dg.b_rows_plain(lo, hi, e10, m10)))
    redesign_edges(worse, gen)
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
    fold_out = torch.empty(folds, dtype=torch.uint32, device=DEVICE)  # a tile of v
    cases = {  # name -> [(shape, reps, kernel, plain, bound), ...]; the last case is reported
        "keystream_words": [
            (f"setup's error draws: {e_blocks} blocks", 20,
             lambda: aes.keystream_blocks(ent_key.aes, e_base // 16, e_blocks),
             lambda: aes.keystream_bytes_plain(
                 ent_key.aes, e_base // 16 * 16, 16 * e_blocks).reshape(e_blocks, 16),
             bound(16 * e_blocks, CF_OPS * e_blocks)),
            (f"one scan tile's a-slab: {TILE} ciphertexts, {tile_blocks} blocks", 20,
             lambda: aes.keystream_blocks(crs_key.aes, P.ctr_s // 16, tile_blocks),
             lambda: aes.keystream_bytes_plain(
                 crs_key.aes, P.ctr_s // 16 * 16, 16 * tile_blocks).reshape(tile_blocks, 16),
             bound(16 * tile_blocks, CF_OPS * tile_blocks))],
        "keystream_fold_p": [(
            f"random_ssp's first tile: {tssp.TILE} rows x d={d}, out= a tile of v", 10,
            lambda: aes.keystream_fold_p(ent_key.aes, (wb + pad) // 16, folds, out=fold_out),
            lambda: aes.keystream_fold_p_plain(ent_key.aes, (wb + pad) // 16, folds),
            bound(4 * folds, (CF_OPS + 2 * FOLD_OPS) * folds / 2))],
        "eval_mac_planes": [(
            f"one lane of the prover's sweep: k=1 x {terms} terms, n={n}", 5,
            lambda: eval_fused.eval_mac_planes(crs_key, P.ctr_s, coeffs[:1], n, P.ctr_ct),
            lambda: eval_fused.eval_mac_planes_plain(crs_key, P.ctr_s, coeffs[:1], n, P.ctr_ct),
            bound(8 * terms + 8 * 4 * n * 88, CF_OPS * stream_blocks,
                  2 * 4 * terms * n * 88)), (
            f"the prover's sweep: k=5 x {terms} terms, n={n}", 5,
            lambda: eval_fused.eval_mac_planes(crs_key, P.ctr_s, coeffs, n, P.ctr_ct),
            lambda: eval_fused.eval_mac_planes_plain(crs_key, P.ctr_s, coeffs, n, P.ctr_ct),
            bound(8 * coeffs.numel() + 8 * 4 * 5 * n * 88, CF_OPS * stream_blocks,
                  2 * 4 * 5 * terms * n * 88))],
        "encrypt_b_fused": [(
            f"setup's section: {terms} encryptions, n={n}", 3,
            lambda: eval_fused.encrypt_b_fused(crs_key, P.ctr_s, sk, terms, n, P.ctr_ct),
            lambda: eval_fused.encrypt_b_fused_plain(crs_key, P.ctr_s, sk, terms, n, P.ctr_ct),
            bound(sk.numel() + 8 * terms * 88, CF_OPS * stream_blocks,
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
    cases.update(poly_cases(P, ent_key))
    cases.update(schedule_cases(P, crs_key, ent_key))
    cases.update(verify_cases(P, crs_key, ent_key, worse))
    for name, shapes in cases.items():
        for shape, reps, kern, plain, bnd, *sets in shapes:
            want, plain_ms = timed(plain)
            err = max_abs_err(kern(), want)
            del want
            run = sets[0] if sets else kern  # timed on input sets that do not fit in L2
            ms = cuda_ms(run, reps)
            queued_ms = cuda_ms(run, reps, queued=True)
            worse(name, err)
            # every shape of this kernel keeps its numbers beside the last one's
            earlier = results[name]["cases"] if name in results else []
            case = {"shape": shape, "ms": ms, "queued_ms": queued_ms, "plain_ms": plain_ms, **bnd}
            results[name] = {"max_abs_err": errs[name], "ms": ms, "queued_ms": queued_ms,
                             "plain_ms": plain_ms, **bnd, "library_ms": None,
                             "cases": earlier + [case]}
            print(f"phase kernels: {name} [{shape}] max_abs_err={err} (tolerance 0); "
                  f"kernel {ms:.4f} ms issued back to back ({100 * bnd['bound_ms'] / ms:.1f} % of "
                  f"the bound; {queued_ms:.4f} ms queued behind a device wait: "
                  f"{100 * bnd['bound_ms'] / queued_ms:.1f} %), plain {plain_ms:.3f} ms, bound "
                  f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
            if name == "keystream_blocks_v1":  # at K1's count
                at = bnd["bound_ms"] * CF_OPS / BITSLICED_OPS
                print(f"phase kernels: {name} [{shape}] at K1's {CF_OPS} operations a block: "
                      f"{at:.4f} ms ({100 * at / ms:.1f} %)")
    lanes_err, lanes_result = lanes_case(P, crs_key, gen)
    worse("eval_mac_lanes", lanes_err)
    results["eval_mac_lanes"] = {"max_abs_err": errs["eval_mac_lanes"], **lanes_result}
    copy = copy_floor(b_rows_bytes(2 * P.d + P.m))
    results["carry_fold"]["b_rows_copy"] = copy
    print(f"phase kernels: carry_fold [a device copy of the b-row form's bytes] {copy['ms']:.4f} "
          f"ms issued back to back ({copy['queued_ms']:.4f} ms queued), bound "
          f"{copy['bound_ms']:.4f} ms ({100 * copy['bound_ms'] / copy['queued_ms']:.1f} % queued)")
    for name, e in errs.items():
        check(e == 0, f"{name} disagrees with a reference (max_abs_err={e})")


def lanes_case(P, crs_key, gen) -> tuple[int, dict]:
    """K3's many-lane form at the shape ``prover_batch`` gives it at release
    for ``BATCH`` statements: k = 5 B lanes over the three sections of
    ``onepass_sections`` (segments of ~11,000 rows).  Held exactly against
    the form of at most 8 lanes on the same lanes (held to the plain
    version above), on random and on all-0xFFFFFFFF coefficients inside
    the sections (its signed 32-bit sums at their largest), and against the
    plain version on 256-row slices across each segment's end; then timed.
    Returns (max_abs_err, the kernels line's fields)."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.ops import eval_fused

    n, terms, k = P.n, 2 * P.d + P.m, 5 * BATCH
    sections = tsnark.onepass_sections(P, BATCH)
    inside = torch.zeros(k, terms, dtype=torch.int64, device=DEVICE)
    for r0, r1, l0, l1 in sections:
        inside[l0:l1, r0:r1] = 1
    segs = eval_fused.lane_segments(terms, n, sections)

    def lanes(c):
        return eval_fused.eval_mac_planes(crs_key, P.ctr_s, c, n, P.ctr_ct, sections=sections)

    def runs_of_8(c):
        return torch.cat([eval_fused.eval_mac_planes(crs_key, P.ctr_s, c[lo : lo + 8], n, P.ctr_ct)
                          for lo in range(0, k, 8)], dim=1)

    rand = torch.randint(0, 1 << 32, (k, terms), generator=gen).to(DEVICE) * inside
    top = ((1 << 32) - 1) * inside
    err = max(max_abs_err(lanes(c), runs_of_8(c)) for c in (rand, top))
    before = eval_fused.LAUNCHES["eval_mac_lanes"]
    sliced_rows = torch.zeros(terms, dtype=torch.int64, device=DEVICE)
    slices = []  # disjoint, in row order
    for e in sorted({r1 for _, r1, _, _ in segs}):
        slices.append((max(slices[-1][1] if slices else 0, e - 128), min(terms, e + 128)))
    for lo, hi in slices:
        sliced_rows[lo:hi] = 1
    sliced = rand * sliced_rows
    got = lanes(sliced)
    launches = eval_fused.LAUNCHES["eval_mac_lanes"] - before
    want, plain_ms = torch.zeros_like(got), 0.0
    for lo, hi in slices:
        part, ms = timed(lambda: eval_fused.eval_mac_planes_plain(
            crs_key, P.ctr_s + lo * P.ctr_ct, sliced[:, lo:hi], n, P.ctr_ct))
        want += part
        plain_ms += ms
    err = max(err, max_abs_err(got, want))
    del got, want
    stream_blocks = -(-terms * P.ctr_ct // 16)
    bnd = bound(8 * k * terms + 8 * 4 * k * n * 88, CF_OPS * stream_blocks,
                2 * 4 * int(inside.sum()) * n * 88)
    ms = cuda_ms(lambda: lanes(rand), 5)
    queued_ms = cuda_ms(lambda: lanes(rand), 5, queued=True)
    shape = (f"prover_batch's sweep at B={BATCH}: k={k} x {terms} terms over 3 sections, n={n}, "
             f"{len(segs)} segments")
    print(f"phase kernels: eval_mac_lanes [{shape}] max_abs_err={err} (tolerance 0; against the "
          f"form of 8 lanes, and the plain version over {sum(hi - lo for lo, hi in slices)} rows "
          f"across {len(slices)} segment ends); {launches} launch; kernel {ms:.4f} ms issued back "
          f"to back ({100 * bnd['bound_ms'] / ms:.1f} % of the bound; {queued_ms:.4f} ms queued "
          f"behind a device wait: {100 * bnd['bound_ms'] / queued_ms:.1f} %), plain over the "
          f"slices {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
    check(launches == 1, f"eval_mac_lanes: {launches} launches for one sweep at B={BATCH}")
    case = {"shape": shape, "ms": ms, "queued_ms": queued_ms, "plain_ms": plain_ms, **bnd}
    return err, {"ms": ms, "queued_ms": queued_ms, "plain_ms": plain_ms, **bnd,
                 "library_ms": None, "cases": [case]}


def phase_cores(label: str) -> None:
    """The two cipher cores of the port, each on 2^24 blocks, writing the 16
    bytes of every block: the conflict-free table core (K1's kernel; K2, K3
    and K4 run the same core) and the bitsliced register core (K5's kernel)."""
    import torch

    from c_lwe_snarks_tpu_torch.ops import _build, sampling

    k, nb = sampling.PRGKey(SEED, DEVICE).aes, 1 << 24
    out8 = torch.empty(nb, 16, dtype=torch.uint8, device=DEVICE)
    cores = {  # name -> (launch, operations a block of its bound)
        "conflict-free table core (aes_core_cf.cuh, K1's kernel)": (lambda: _build.launch(
            "cls_keystream_blocks", k.tables32, k.rk_param, k.nonce_lo, k.nonce_hi, 0, nb, out8),
            CF_OPS),
        "bitsliced register core (K5's kernel)": (lambda: _build.launch(
            "cls_keystream_blocks_v1", k.rk_planes32, k.nonce_lo, k.nonce_hi, 0, nb, out8),
            BITSLICED_OPS),
    }
    for name, (fn, ops) in cores.items():
        fn()
        ms = cuda_ms(fn, 10)
        at = bound(16 * nb, ops * nb)["bound_ms"]
        print(f"phase cores: {name}: {ms:.4f} ms for 2^24 blocks, {nb * 16 / ms / 1e6:.1f} GB/s, "
              f"bound {at:.4f} ms at {ops} operations a block ({100 * at / ms:.1f} %) [{label}]")


PROFILER_SETTLE_S = 0.01


def device_times(fn) -> tuple[dict, float]:
    """({kernel or copy name: (device microseconds, count)}, host seconds) of
    one call of fn under torch.profiler, synchronized.

    fn starts PROFILER_SETTLE_S after the profiler, as the benchmark
    harness's requests do (``portbench/harness.py``'s 10 ms ``SETTLE_S``):
    the trace holds every host-side launch call from the start, but
    kernels launched in about the first millisecond can be missing from
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_SETTLE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    items = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA:  # kernels and copies, not the ops above them
            items[ev.key] = (us, ev.count)
    return items, wall


def profiled_line(tag: str, kernel: str, counter: str, fn, reps: int, label: str,
                  launches: dict | None = None) -> float | None:
    """One profiled line: the device-side time a launch of ``kernel`` over
    ``reps`` calls of fn, printed only when the trace holds every launch the
    wrapper counted (``launches[counter]`` over the same calls, default
    ``aes.LAUNCHES``); else "traced X of Y launches: not measured", with the
    trace's device items.  Returns the microseconds a launch, or None."""
    from c_lwe_snarks_tpu_torch.ops import aes

    launches = aes.LAUNCHES if launches is None else launches
    before = launches[counter]
    items, wall = device_times(fn)
    launched = launches[counter] - before
    us = sum(us for name, (us, c) in items.items() if kernel in name)
    count = sum(c for name, (us, c) in items.items() if kernel in name)
    if count != launched or count == 0:
        print(f"phase profile: {tag}: traced {count} of {launched} launches: not measured "
              f"(host {wall / reps * 1e6:.1f} us a call) [{label}]")
        for name, (us_i, c) in sorted(items.items(), key=lambda kv: -kv[1][1])[:6]:
            print(f"phase profile:   trace item x{c} {us_i:.3f} us {name[:90]}")
        return None
    print(f"phase profile: {tag}: {count} launches traced, device-side {us / count:.3f} us a "
          f"launch, host {wall / reps * 1e6:.1f} us a call under the profiler [{label}]")
    return us / count


def host_issue(label: str, calls: int = 2000) -> None:
    """The host's time to issue one kernel launch at the smallest shape
    (K9, one power), by host clock over many calls, and its parts: the
    whole wrapper (its checks, the output's allocation, _build.launch),
    _build.launch alone on a ready output, the current stream's handle,
    an empty tensor's allocation, and the bare ctypes call."""
    import torch

    from c_lwe_snarks_tpu_torch.ops import _build, modp

    s = torch.tensor([5], dtype=torch.int64, device=DEVICE)
    out = torch.empty(1, dtype=torch.int64, device=DEVICE)
    fn = _build.library().cls_powers_mod_p
    ptr_s, ptr_o = s.data_ptr(), out.data_ptr()
    parts = {
        "the wrapper powers_mod_p(s, 1)": lambda: modp.powers_mod_p(s, 1),
        "_build.launch on a ready output": lambda: _build.launch("cls_powers_mod_p", s, s, 0, 1, out),
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "torch.empty(1, int64) on the card": lambda: torch.empty(1, dtype=torch.int64, device=DEVICE),
        "the bare ctypes call": lambda: fn(ptr_s, ptr_s, 0, 1, ptr_o,
                                           torch.cuda.current_stream().cuda_stream),
    }
    for name, call in parts.items():
        for _ in range(50):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        host = (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        print(f"phase profile: host issue, {name}: {host * 1e6:.2f} us a call ({calls} calls) "
              f"[{label}]")


def phase_profile(label: str) -> None:
    """What the device does during random_ssp at release parameters, by
    kernel, and the device-side durations of K1 at three sizes and of K5 at
    the main path's two (a CUDA-event time of back-to-back short launches
    also holds the host's time to launch them); then one release prover:
    its wall, device-busy share and copies, and the launches of its
    polynomial stage by kernel name.  A reading, not a check: a
    profiler that traces no device activity is reported as such."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import aes, eval_fused, modp, sampling
    from c_lwe_snarks_tpu_torch.ops import digits as dg
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    ent_key = sampling.PRGKey(ENT_SEED, DEVICE)
    _, ssp = tssp.random_ssp(ent_key, 0, P)  # warm
    before = aes.LAUNCHES["keystream_fold_p"]
    items, wall = device_times(lambda: tssp.random_ssp(ent_key, 0, P))
    launched = aes.LAUNCHES["keystream_fold_p"] - before
    traced = sum(c for name, (us, c) in items.items() if "keystream_fold_p_kernel" in name)
    if traced != launched:
        print(f"phase profile: random_ssp: traced {traced} of {launched} K2 launches: not measured")
        return
    busy = sum(us for us, _ in items.values())
    print(f"phase profile: random_ssp under the profiler {wall:.6f} s, device busy "
          f"{busy / 1e3:.3f} ms ({busy / 1e4 / wall:.1f} %) [{label}]")
    for name, (us, count) in sorted(items.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"phase profile:   {us / 1e3:9.3f} ms  x{count:<5d} {name[:100]}")
    reps = 20
    for tag, kernel, counter, version, sizes in (
            ("K1", "keystream_blocks_kernel", "keystream_words", 2, (1, 382292, 2163840)),
            ("K5", "keystream_blocks_v1_kernel", "keystream_blocks_v1", 1, (382292, 2163840))):
        for nblocks in sizes:
            profiled_line(f"{tag} at {nblocks} blocks", kernel, counter, lambda: [
                aes.keystream_blocks(ent_key.aes, 0, nblocks, version=version)
                for _ in range(reps)], reps, label)
    # K8, K9 and K10 device-side at the main path's shapes: setup's v [m, d]
    # and its messages form at d, t and v_0 at s, the b-rows
    # of 2d + m encryptions (K4's planes made once, outside), the prover's
    # MAC planes and smudging, the sharded path's planes
    s = torch.tensor(123456789, dtype=torch.int64, device=DEVICE)
    alpha = torch.tensor(987654321, dtype=torch.int64, device=DEVICE)
    powers = modp.powers_mod_p(s, P.d)
    rows2 = torch.stack([ssp.t, ssp.v[0]])
    n_enc = 2 * P.d + P.m
    sk = torch.randint(0, 256, (P.n, 88), dtype=torch.uint8, device=DEVICE)
    v_lo, v_hi = eval_fused.encrypt_b_planes(ent_key, P.ctr_s, sk, n_enc, P.n, P.ctr_ct)
    errs = torch.randint(0, 256, (n_enc, 88), dtype=torch.uint8, device=DEVICE)
    msgs = torch.randint(0, modp.P, (n_enc,), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    mac_sets = rotating(dg.fold_mac_planes, mac_set(gen, P.n), lambda: mac_set(gen, P.n),
                        8 * 4 * 5 * (P.n + 1) * 88)
    planes_sets = rotating(dg.carry_fold, planes_set(gen, P.n), lambda: planes_set(gen, P.n),
                           8 * 5 * (P.n + 1) * 88)
    evals, draws = smudge_case(P, ent_key)
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.ops import verify

    crs, vrs, _, proof = release_proof(P, sampling.PRGKey(CRS_SEED, DEVICE), ent_key)
    cts = (proof.h, proof.hat_h, proof.hat_v, proof.v_w, proof.b_w)
    probe = tlwe.ct_import(sampling.PRGKey(crs.seed, DEVICE), P.ctr_s, crs.b_s[: TILE], P)
    for tag, kernel, counter, fn, launches in (
            (f"K8 at setup's v [{P.m}, {P.d}]", "matvec_kernel", "matvec_mod_p",
             lambda: modp.matvec_mod_p(ssp.v, powers), modp.LAUNCHES),
            (f"K8's at-s form at t and v_0 [2, {P.d}]", "matvec_kernel", "matvec_mod_p",
             lambda: modp.poly_eval_mod_p(rows2, s), modp.LAUNCHES),
            (f"K9 at {P.d} powers", "powers_kernel", "powers_mod_p",
             lambda: modp.powers_mod_p(s, P.d), modp.LAUNCHES),
            (f"K9's messages form at d = {P.d}", "powers_kernel", "powers_mod_p",
             lambda: modp.message_powers(s, alpha, P.d), modp.LAUNCHES),
            (f"K10's b-row form at {n_enc} rows", "carry_fold_kernel", "carry_fold",
             lambda: dg.carry_fold_b_rows(v_lo, v_hi, errs, msgs), dg.LAUNCHES),
            (f"K10's MAC-plane form at [4, 5, {P.n}, 88], input sets over L2", "carry_fold_kernel",
             "carry_fold", mac_sets, dg.LAUNCHES),
            ("K10's smudge form, five draws on four rows", "carry_fold_kernel", "carry_fold",
             lambda: dg.smudge_draws(evals, draws, tsnark.SMUDGE_TARGETS), dg.LAUNCHES),
            (f"K10's planes form at [5, {P.n + 1}, 88] int64, input sets over L2",
             "carry_fold_kernel", "carry_fold", planes_sets, dg.LAUNCHES),
            ("K11's verifier form on a release proof", "verify_kernel", "verify",
             lambda: verify.verify(cts, vrs.sk, ssp.t, ssp.v[0], vrs.s, vrs.alpha, vrs.beta,
                                   P.log_smudging // 8), verify.LAUNCHES),
            (f"K11's decrypt form at the probes' {TILE} CRS terms", "verify_kernel", "verify",
             lambda: verify.decrypt(probe, vrs.sk), verify.LAUNCHES)):
        fn()
        profiled_line(tag, kernel, counter, lambda: [fn() for _ in range(reps)], reps, label,
                      launches)
    # K7 device-side at the batch's row-sums: its many-witness form against its
    # bound (the union of the gated rows of v[1:], read once) and K7 a witness
    gen_w = torch.Generator(device=DEVICE).manual_seed(BATCH)
    gates = torch.randint(0, 2, (BATCH, P.m), generator=gen_w, device=DEVICE,
                          dtype=torch.uint8)[:, : P.m - 1]
    union = int(gates.any(0).sum())
    many_bound = 4 * union * P.d / PEAK_BYTES * 1e3
    for tag, kernel, counter, fn, bound_ms in (
            (f"K7's many-witness form at v[1:] [{P.m - 1}, {P.d}], {BATCH} witnesses",
             "gated_rowsums_kernel", "gated_rowsums_p",
             lambda: modp.gated_rowsums_mod_p(ssp.v[1:], gates), many_bound),
            (f"K7 at v[1:] [{P.m - 1}, {P.d}], one witness ({BATCH} launches a batch)",
             "gated_rowsum_kernel", "gated_rowsum_p",
             lambda: modp.gated_rowsum_mod_p(ssp.v[1:], gates[0]),
             4 * int(gates[0].sum()) * P.d / PEAK_BYTES * 1e3)):
        fn()
        us = profiled_line(tag, kernel, counter, lambda: [fn() for _ in range(reps)], reps, label,
                           modp.LAUNCHES)
        if us is not None:
            print(f"phase profile:   {tag}: bound {bound_ms:.4f} ms by bytes, device-side "
                  f"{100 * bound_ms / (us / 1e3):.1f} % of it [{label}]")
    del ssp, v_lo, v_hi, mac_sets, planes_sets, crs, vrs, proof, cts, probe
    host_issue(label)
    # the release prover after a warm call, and what its polynomial stage
    # launches by kernel name (tools/profile_prover.py); then setup and
    # the verifier, each traced once (tools/profile_stage.py)
    sys.path.insert(0, str(ROOT / "tools"))
    import profile_prover
    import profile_stage

    profile_prover.run(label)
    stages = profile_stage.run(("setup", "verifier"), label)
    traced = stages["verifier"]["kernel_launches"]
    print(f"phase profile: the release verifier traced {traced} kernel launches (at most "
          f"{VERIFIER_MAX_LAUNCHES}; 108 before K11) [{label}]")
    check(0 < traced <= VERIFIER_MAX_LAUNCHES, f"the release verifier launched {traced} kernels")


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
    same = same_words(back.t, run.ssp.t) and same_words(back.v, run.ssp.v)
    print(f"phase golden: toy SSP streamed to a file and back: tensors equal={same}, "
          f"file sha256 equal to golden={sha == entry['sha256']['ssp']}")
    check(same and back.v.is_cuda, "toy: streamed SSP differs")
    check(sha == entry["sha256"]["ssp"], "toy: streamed SSP file digest != golden")


def phase_release(label: str):
    import torch

    from c_lwe_snarks_tpu_torch.__main__ import run_protocol
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import modp, sampling
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
    print(f"phase release: peak device memory {peak / 2**30:.2f} GiB (int64 SSP: "
          f"{INT64_SSP_PEAK_GIB:.2f} GiB, PERF.md); launches {launches}")
    ssp_types = (run.ssp.t.dtype, run.ssp.v.dtype, run.ssp.v.device.type)
    print(f"phase release: SSP t {ssp_types[0]}, v {ssp_types[1]} {tuple(run.ssp.v.shape)} on "
          f"{ssp_types[2]}")
    check(ssp_types == (torch.uint32, torch.uint32, "cuda"),
          "release: the SSP is not uint32 on the card")
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
    # setup's message schedule (K9, K8), the prover's evaluations and
    # smudging (K3, K10's MAC-plane and smudge forms) and the verifier
    # (K11), each once with any host sync an error, up to the
    # verifier's bool tensor; the prover's polynomials come first, outside
    vrs, ssp = run.vrs, run.ssp
    crs_key, ent_key = sampling.PRGKey(CRS_SEED, DEVICE), sampling.PRGKey(ENT_SEED, DEVICE)
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    delta, w, v, h = tsnark.prover_polys(ent_key, off_prove, ssp, run.witness, P)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        msgs = tsnark.setup_messages(vrs.alpha, vrs.beta, vrs.s, ssp.t,
                                     lambda powers: modp.matvec_mod_p(ssp.v, powers), P.d, P.m)
        proof, = tsnark._evaluate_and_smudge(crs_key, ent_key, [off_prove], run.crs, delta, w, v,
                                             h, run.witness, P)
        accepted = tsnark.verifier(vrs, ssp, proof, P)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same_s = int(msgs[1]) == int(vrs.s) and int(msgs[P.d]) == int(vrs.alpha)
    same_proof = torch.equal(proof.stack(), run.proof.stack())
    print(f"phase release: setup's message schedule, the prover's evaluations and smudging and "
          f"the verifier under set_sync_debug_mode('error'): no host sync, "
          f"verified={bool(accepted)}, s and alpha in the schedule={same_s}, "
          f"proof equal to the run's={same_proof}")
    check(bool(accepted) and same_s and same_proof,
          "release: the schedule, the smudging or the verifier without host sync")
    for name in RELEASE_PATH:
        check(launches[name] > 0, f"release: kernel {name} was not launched on the main path")
    tiles = -(-P.m // tssp.TILE)  # K2 a tile of v; K7 a tile's t-gate, then the prover's w
    for name, planned in {**RELEASE_LAUNCHES, "keystream_fold_p": tiles,
                          "gated_rowsum_p": tiles + 1}.items():
        check(launches[name] == planned,
              f"release: {launches[name]} launches of {name}, planned {planned}")
    k6_plan = k6_division_launches(P.d) + 3  # the division and v^2
    check(launches["ntt"] == k6_plan, f"release: {launches['ntt']} K6 launches, planned {k6_plan}")
    # the spread of the stage walls: the same run five more times
    walls: dict = {}
    for _ in range(5):
        again = run_protocol(P, DEVICE, CRS_SEED, ENT_SEED)
        check(again.verified, "release: a repeat did not verify")
        for stage, sec in again.times.items():
            walls.setdefault(stage, []).append(sec)
        del again
    for stage, secs in walls.items():
        print(f"phase release: {stage} 5 repeats {', '.join(f'{x:.6f}' for x in secs)} s [{label}]")
    return run, launches


def phase_batch(run, label: str) -> dict:
    """``prover_batch`` over ``BATCH`` statements of the release circuit
    (its witness and others of random bits), with every launch counter
    reset just before: each proof is ``snark.prover``'s bytes for its
    offset and witness, the first is the release run's, the satisfying
    statement's verifies, and the batch launches K3's many-lane form once,
    its form of 8 lanes never, K10 once and once a proof's smudges.  Its
    polynomial stage (``prover_polys_batch``) is each statement's
    ``prover_polys`` row for row in one statement's K6 launches (one Newton
    launch in the trace); its ms a batch, by CUDA events and device-side, is
    printed beside the sweep's."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import sampling
    from c_lwe_snarks_tpu_torch.utils import serial
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    crs_key, ent_key = sampling.PRGKey(CRS_SEED, DEVICE), sampling.PRGKey(ENT_SEED, DEVICE)
    off0 = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    offsets = [off0 + i * tsnark.prover_entropy_bytes(P) for i in range(BATCH)]
    gen = torch.Generator(device=DEVICE).manual_seed(BATCH)
    wits = [run.witness] + [torch.randint(0, 2, (P.m,), generator=gen, device=DEVICE,
                                          dtype=torch.uint8) for _ in range(BATCH - 1)]

    def singles():
        return [serial.proof_to_bytes(tsnark.prover(crs_key, ent_key, off, run.crs, run.ssp, w, P), P)
                for off, w in zip(offsets, wits)]

    counters = reset_counters()
    want, singles_ms = timed(singles)
    one = {name: x // BATCH for name, x in read_counters(counters).items()}
    counters = reset_counters()
    proofs, batch_ms = timed(lambda: tsnark.prover_batch(
        crs_key, ent_key, offsets, run.crs, run.ssp, wits, P))
    launches = read_counters(counters)
    got = [serial.proof_to_bytes(pi, P) for pi in proofs]
    same = sum(g == w for g, w in zip(got, want))
    first = got[0] == serial.proof_to_bytes(run.proof, P)
    verified = bool(tsnark.verifier(run.vrs, run.ssp, proofs[0], P))
    print(f"phase batch: prover_batch over {BATCH} statements {batch_ms:.3f} ms, {BATCH} provers "
          f"{singles_ms:.3f} ms (one call each, CUDA events) [{label}]; {same} of {BATCH} proofs "
          f"snark.prover's bytes, the first the release run's: {first}, verified={verified}; "
          f"launches {launches}")
    check(same == BATCH and first, "batch: a proof differs from snark.prover's")
    check(verified, "batch: the verifier rejected the satisfying statement's proof")
    for name in BATCH_PATH:
        check(launches[name] > 0, f"batch: kernel {name} was not launched")
    planned = {"eval_mac_lanes": 1, "eval_mac_planes": 0,
               "carry_fold": 1 + BATCH * (one["carry_fold"] - 1)}
    for name, want_n in planned.items():
        check(launches[name] == want_n, f"batch: {launches[name]} launches of {name}, planned {want_n}")
    phase_batch_stage(crs_key, ent_key, offsets, run, wits, one, label)
    return launches


def phase_batch_stage(crs_key, ent_key, offsets, run, wits, one: dict, label: str) -> None:
    """``prover_polys_batch`` over the batch's statements against their
    ``prover_polys``, its launches against one statement's (``one``), and
    its ms by CUDA events and device-side beside the batch's sweep (K3)."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    stmts = torch.stack(wits)

    def stage():
        return tsnark.prover_polys_batch(ent_key, offsets, run.ssp, stmts, P)

    def singles():
        return [tsnark.prover_polys(ent_key, off, run.ssp, w, P) for off, w in zip(offsets, wits)]

    want, singles_ms = timed(singles)
    counters = reset_counters()
    got, stage_ms = timed(stage)
    launches = read_counters(counters)
    same = sum(all(torch.equal(g[j], w) for g, w in zip(got, want[j])) for j in range(BATCH))
    # the device's items: kernels and copies, not the port's spans, which the trace
    # also lists with a device time
    items = {k: x for k, x in device_times(stage)[0].items() if not k.startswith("lwe.")}
    dev_ms = {k: sum(us for name, (us, _) in items.items() if k in name) / 1e3
              for k in ("ntt_", "gated_rowsum", "keystream")}
    newton = sum(c for name, (_, c) in items.items() if "ntt_newton" in name)
    stage_dev = sum(us for us, _ in items.values()) / 1e3
    sweep_items, _ = device_times(lambda: tsnark.prover_batch(
        crs_key, ent_key, offsets, run.crs, run.ssp, wits, P))
    sweep_dev = sum(us for name, (us, _) in sweep_items.items() if "eval_mac" in name) / 1e3
    print(f"phase batch: prover_polys_batch over {BATCH} statements {stage_ms:.3f} ms (CUDA events), "
          f"device-side {stage_dev:.3f} ms (K6 {dev_ms['ntt_']:.3f}, K7's many-witness form "
          f"{dev_ms['gated_rowsum']:.3f}, "
          f"K1 {dev_ms['keystream']:.3f}); {BATCH} prover_polys {singles_ms:.3f} ms; the batch's "
          f"sweep (K3) device-side {sweep_dev:.3f} ms [{label}]; {same} of {BATCH} rows equal; "
          f"launches: K6 {launches['ntt']} (one statement's {one['ntt']}), Newton {newton} traced, "
          f"K7 {launches['gated_rowsum_p']}, its many-witness form {launches['gated_rowsums_p']}, "
          f"K1 {launches['keystream_words']}")
    check(same == BATCH, "batch: a row of prover_polys_batch differs from prover_polys")
    check(launches["ntt"] == one["ntt"] and newton == 1,
          f"batch: the stage made {launches['ntt']} K6 launches ({newton} Newton), one "
          f"statement's {one['ntt']}")
    check(launches["gated_rowsums_p"] == 1 and launches["gated_rowsum_p"] == 0,
          "batch: the stage's row-sums are not one launch of K7's many-witness form")
    check(launches["keystream_words"] == BATCH, "batch: the stage's K1 launches are not one a statement")


def phase_d16(label: str) -> dict:
    """One run of the protocol at d = 2^16, m = 43,690 (n = 1,470) through
    the package's entry point, with the launch counters and the peak-memory
    counter reset just before: it must verify, reject a tampered h and
    launch every kernel of the release path; prints the four stage walls,
    the peak device memory and the launches."""
    import torch

    from c_lwe_snarks_tpu_torch.__main__ import run_protocol
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.utils.params import Params

    P = Params(**D16)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the release run's state, still alive
    counters = reset_counters()
    run = run_protocol(P, DEVICE, CRS_SEED, ENT_SEED)
    launches = read_counters(counters)
    peak = torch.cuda.max_memory_allocated()
    pi = run.proof
    bad_h = pi.h.clone()
    bad_h[P.n, 0] ^= 1
    bad = tsnark.Proof(h=bad_h, hat_h=pi.hat_h, hat_v=pi.hat_v, v_w=pi.v_w, b_w=pi.b_w)
    rejected = not bool(tsnark.verifier(run.vrs, run.ssp, bad, P))
    walls = ", ".join(f"{stage} {sec:.6f} s" for stage, sec in run.times.items())
    print(f"phase d16: d={P.d} m={P.m} n={P.n}: {walls} [{label}]")
    print(f"phase d16: peak device memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB of it "
          f"held before the run); SSP v {run.ssp.v.dtype} "
          f"{tuple(run.ssp.v.shape)}; verified={run.verified} tampered_rejected={rejected}; "
          f"launches {launches}; phase {time.perf_counter() - t0:.1f} s")
    check(run.verified, "d16: the verifier rejected an honest proof")
    check(rejected, "d16: a tampered proof was accepted")
    check(run.ssp.v.dtype == torch.uint32, "d16: the SSP is not uint32")
    for name in RELEASE_PATH:
        check(launches[name] > 0, f"d16: kernel {name} was not launched")
    return launches


def phase_files(run, label: str) -> dict:
    """Setup's files -> a prover that loads the CRS and proves -> the
    designated verifier that loads VRS and proof, probes and verifies."""
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
    print(f"phase files: files {sizes} bytes written and read back on the card: "
          f"round trip equal={round_trip}, row table ok={table_ok}")
    check(round_trip and table_ok, "files: artifacts did not round-trip through the files")

    with obs.timeit("probe_crs + probe_crs_range(256) + probe_proof", out=times):
        probes = {f"{name}.{k}": v for name, checks in (
            ("crs", obs.probe_crs(crs, vrs, P)),
            ("crs_range", obs.probe_crs_range(crs, vrs, P, count=TILE)),
            ("proof", obs.probe_proof(proof, vrs, P))) for k, v in flags(checks).items()}
    print(f"phase files: probes on the reloaded CRS/VRS/proof: {probes}")
    check(len(probes) == 11 and all(probes.values()), "files: a decrypt-probe failed")

    crs_key, ent_key = sampling.PRGKey(crs.seed), sampling.PRGKey(ENT_SEED)
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    before = read_counters(counters)["eval_mac_planes"]
    with obs.timeit("prover from the reloaded CRS", out=times):
        pi = tsnark.prover(crs_key, ent_key, off_prove, crs, run.ssp, run.witness, P)
    k3_launches = read_counters(counters)["eval_mac_planes"] - before
    same_proof = serial.proof_to_bytes(pi, P) == serial.proof_to_bytes(run.proof, P)
    with obs.timeit("verifier from the reloaded VRS", out=times):
        ok = bool(tsnark.verifier(vrs, run.ssp, pi, P))
    bad_bw = pi.b_w.clone()
    bad_bw[0, 0] ^= 1
    bad = tsnark.Proof(h=pi.h, hat_h=pi.hat_h, hat_v=pi.hat_v, v_w=pi.v_w, b_w=bad_bw)
    rejected = not bool(tsnark.verifier(vrs, run.ssp, bad, P))
    print(f"phase files: proof from the reloaded CRS equal to the release run's={same_proof} "
          f"({k3_launches} K3 launches), verified={ok}, tampered_rejected={rejected}")
    check(same_proof, "files: the proof from the reloaded CRS differs from the release run's")
    check(k3_launches == 1, f"files: expected 1 K3 launch, saw {k3_launches}")
    check(ok and rejected, "files: verifier")

    # the scan evaluation (K1 per tile + exact matmuls) against the fused one
    # (K3) over the whole s section, k = 2 lanes
    gen = torch.Generator().manual_seed(5)
    coeffs = torch.randint(0, P.p, (2, P.d), generator=gen).to(DEVICE)
    with obs.timeit(f"eval_poly_multi(impl=scan, tile={TILE}) over the s section", out=times):
        scan = tlwe.eval_poly_multi(crs_key, P.ctr_s, crs.b_s, coeffs, P, impl="scan", tile=TILE)
    with obs.timeit("eval_poly_multi(impl=fused) over the s section", out=times):
        fused = tlwe.eval_poly_multi(crs_key, P.ctr_s, crs.b_s, coeffs, P, impl="fused")
    scan_err = max_abs_err(scan, fused)
    print(f"phase files: scan vs fused eval over the s section (d={P.d}, k=2) "
          f"max_abs_err={scan_err} (tolerance 0)")
    check(scan_err == 0, "files: scan and fused evaluations differ")

    # one scan tile's a-slab from the bitsliced keystream (K5) against the
    # T-table one (K1, through expand_a)
    with obs.timeit("a-slab of one tile from keystream_blocks(version=1)", out=times):
        ks = aes.keystream_blocks(
            crs_key.aes, P.ctr_s // 16, TILE * P.ctr_ct // 16, version=1)
        slab5 = ks.reshape(TILE, P.n, 92)[..., :88]
    with obs.timeit("a-slab of one tile from expand_a (K1)", out=times):
        slab1 = sampling.expand_a(crs_key, P.ctr_s, TILE, P.n)
    slab_err = max_abs_err(slab5, slab1)
    print(f"phase files: a-slab of {TILE} ciphertexts, bitsliced (K5) vs T-table (K1) "
          f"keystream max_abs_err={slab_err} (tolerance 0)")
    check(slab_err == 0, "files: K5 and K1 a-slabs differ")

    launches = read_counters(counters)
    for step, sec in times.items():
        print(f"phase files: {step} {sec:.3f} s [{label}]")
    print(f"phase files: launches {launches}")
    for name in FILES_PATH:
        check(launches[name] > 0, f"files: kernel {name} was not launched on this path")
    return launches


def cli_run(args: list, label: str, what: str) -> subprocess.CompletedProcess:
    """Run ``python <args>`` from the checkout; print its wall, stage walls and
    verdict; raise unless it exits 0 and prints ``verified: True``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    walls = [line.split("] ", 1)[1] for line in proc.stderr.splitlines() if "[timeit]" in line]
    verified = "verified: True" in proc.stdout
    print(f"phase sharded: {what} in a fresh process, {wall:.1f} s: verified={verified}; "
          f"stage walls {'; '.join(walls)} [{label}]")
    check(verified, f"{what}: the verifier did not accept")
    return proc


def phase_sharded(run, label: str) -> dict:
    """The multi-device layer at release width on the one card.

    1. For W = 4 and W = 3 (ragged: 21,845 rows of v split 7,282, 7,282,
       7,281), every rank's part of ``parallel.mesh`` runs one after
       another: random_ssp's rows of v (K2) and their partial t, v_i(s) of
       those rows, setup's chunk of the terms (the rank's own error draws by
       K1, its encryptions by K4) and the prover's one sweep over its chunk
       of the 87,381 terms (one K3 launch a rank).  The parts are combined as
       the collectives would (concatenation; a sum and % p; an int32 sum and
       carry_fold, then the smudging) and held byte for byte against the
       release run's SSP, CRS and proof.  Then each rank's K2, K3 and K4 call
       is timed with CUDA events beside the one-device call.
    2. The CLI under torchrun, ``--mesh 1`` over NCCL in a world of 1: it
       must print ``verified: True``, and its crs.bin and proof.bin must
       equal the release run's; the one-device CLI runs beside it, each in
       a fresh process.

    The 4-step NTT needs a world of W > 1 ranks with W dividing n1 = n2 =
    256 at release; one card cannot hold such a world, so the CPU tests
    cover it over gloo (tests/test_torch_parallel.py)."""
    import torch

    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import digits as dg
    from c_lwe_snarks_tpu_torch.ops import aes, eval_fused, modp, sampling
    from c_lwe_snarks_tpu_torch.parallel import mesh as pmesh
    from c_lwe_snarks_tpu_torch.parallel.multihost import chunk_bounds
    from c_lwe_snarks_tpu_torch.utils import serial
    from c_lwe_snarks_tpu_torch.utils.params import release

    t_phase = time.perf_counter()
    P = release()
    d, m, n = P.d, P.m, P.n
    crs_key, ent_key = sampling.PRGKey(CRS_SEED, DEVICE), sampling.PRGKey(ENT_SEED, DEVICE)
    off_setup = tssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + tsnark.setup_entropy_bytes(P)
    n_enc = 2 * d + m
    vrs, ssp = run.vrs, run.ssp
    crs_rows = torch.cat([run.crs.b_s, run.crs.b_as, run.crs.b_t[None], run.crs.b_v])
    powers = modp.powers_mod_p(vrs.s, d)
    # the prover's polynomials on one device: the sweep's inputs
    delta, w, v, h = tsnark.prover_polys(ent_key, off_prove, ssp, run.witness, P)
    b_all, coeffs = tsnark.onepass_terms(run.crs, w, h, v, delta, run.witness, P)

    counters = reset_counters()
    for world in SHARDED_WORLDS:
        t_sum = torch.zeros(d, dtype=torch.int64, device=DEVICE)
        v_s, same_v = [], True
        for r in range(world):
            wits, v_r, t_r, lo = pmesh.random_ssp_part(r, world, ent_key, 0, P)
            same_v &= same_words(v_r, ssp.v[lo : lo + v_r.shape[0]]) and torch.equal(
                wits, run.witness)
            t_sum += t_r
            v_s.append(modp.matvec_mod_p(v_r, powers))
            del v_r
        same_t = same_words(tssp.finish_t(t_sum % modp.P), ssp.t)
        msgs = tsnark.setup_messages(vrs.alpha, vrs.beta, vrs.s, ssp.t, lambda _: torch.cat(v_s),
                                     d, m)
        same_rows = True
        for r in range(world):
            lo, hi = chunk_bounds(n_enc, r, world)
            errs = tsnark.setup_errs(ent_key, off_setup, lo, hi, P)
            rows = pmesh.encrypt_section_part(r, world, crs_key, P.ctr_s, vrs.sk, msgs, errs, P)
            same_rows &= torch.equal(rows, crs_rows[lo:hi])
        acc = torch.zeros(5, n + 1, 88, dtype=torch.int32, device=DEVICE)
        for r in range(world):
            acc += pmesh.eval_poly_multi_part(r, world, crs_key, P.ctr_s, b_all, coeffs, P).int()
        proof = tsnark.smudge_proof(ent_key, off_prove, dg.carry_fold(acc), P)
        same_proof = serial.proof_to_bytes(proof, P) == serial.proof_to_bytes(run.proof, P)
        accepted = bool(tsnark.verifier(vrs, ssp, proof, P))
        print(f"phase sharded: W={world}, every rank's part on the card, combined: v rows equal="
              f"{same_v}, t equal={same_t}, CRS rows equal={same_rows}, proof bytes equal="
              f"{same_proof} to the one-device run (tolerance 0), verified={accepted}")
        check(same_v and same_t and same_rows and same_proof and accepted,
              f"sharded: W={world} parts differ from the one-device run")
    launches = read_counters(counters)
    print(f"phase sharded: launches {launches}")
    for name in SHARDED_PATH:
        check(launches[name] > 0, f"sharded: kernel {name} was not launched on this path")

    # each rank's kernel call beside the one-device call, CUDA events
    fold_out = torch.empty(-(-m // min(SHARDED_WORLDS)) * d, dtype=torch.uint32, device=DEVICE)
    ctr0 = tssp.witness_and_mask(ent_key, 0, P)[2]
    calls = {
        "keystream_fold_p": (m, lambda lo, hi: aes.keystream_fold_p(
            ent_key.aes, ctr0 + lo * (d // 2), (hi - lo) * d, out=fold_out[: (hi - lo) * d])),
        "encrypt_b_fused": (n_enc, lambda lo, hi: eval_fused.encrypt_b_fused(
            crs_key, P.ctr_s + lo * P.ctr_ct, vrs.sk, hi - lo, n, P.ctr_ct)),
        "eval_mac_planes": (n_enc, lambda lo, hi: eval_fused.eval_mac_planes(
            crs_key, P.ctr_s + lo * P.ctr_ct, coeffs[:, lo:hi].contiguous(), n, P.ctr_ct)),
    }
    for name, (total, call) in calls.items():
        if name == "keystream_fold_p":  # one device: every row of v, as random_ssp does
            whole = timed(lambda: tssp.random_ssp(ent_key, 0, P))[1]
            what = f"random_ssp's {m} rows, {-(-m // tssp.TILE)} launches"
        else:
            call(0, total)
            whole = cuda_ms(lambda: call(0, total), 3)
            what = f"{total} terms, 1 launch"
        for world in SHARDED_WORLDS:
            ms = []
            for r in range(world):
                lo, hi = chunk_bounds(total, r, world)
                call(lo, hi)
                ms.append(cuda_ms(lambda: call(lo, hi), 3))
            print(f"phase sharded: {name} W={world}: a rank's call "
                  f"{', '.join(f'{x:.4f}' for x in ms)} ms; one device ({what}) {whole:.4f} ms "
                  f"[{label}]")
    del fold_out

    # the CLI under torchrun, a world of 1 over NCCL, beside the one-device
    # CLI: each a fresh process, so the stage walls hold its first calls
    cli = ["-m", "c_lwe_snarks_tpu_torch", "--profile", "release", "--probe"]
    with tempfile.TemporaryDirectory() as tmp:
        cli_run(cli, label, "one device")
        world1 = cli_run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1"]
                         + cli + ["--mesh", "1", "--save-dir", tmp], label, "torchrun --mesh 1")
        same_crs = (pathlib.Path(tmp) / "crs.bin").read_bytes() == serial.crs_to_bytes(run.crs, P)
        same_proof = (pathlib.Path(tmp) / "proof.bin").read_bytes() == serial.proof_to_bytes(
            run.proof, P)
    mesh_line = [line for line in world1.stderr.splitlines() if line.startswith("mesh:")]
    print(f"phase sharded: torchrun --mesh 1: {'; '.join(mesh_line)}; crs.bin equal={same_crs}, "
          f"proof.bin equal={same_proof} to the release run")
    check(mesh_line == ["mesh: rank 0 of 1 (nccl)"], "sharded: the world of 1 is not an NCCL world")
    check(same_crs and same_proof, "sharded: the world of 1 differs from the one-device run")
    print(f"phase sharded: {time.perf_counter() - t_phase:.1f} s")
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
    from c_lwe_snarks_tpu_torch.ops import ntt

    # K6's dynamic shared memory (csrc/ntt.cu's launchers): the Newton CTA
    # holds the stage table, S and X of N words, P of N / 2 and 192 words of
    # scales; the CRT pass at n <= SMEM_N a transform and its stage table
    # of each prime
    print(f"phase build: K6 dynamic shared memory: Newton CTA {(7 * ntt.NEWTON_N // 2 + 192) * 4} B "
          f"at N_c = {ntt.NEWTON_N}; one-pass CRT block {3 * 2 * ntt.SMEM_N * 4} B at n = {ntt.SMEM_N}")

    results: dict = {}
    phase_kernels(results)
    phase_cores(label)
    phase_profile(label)
    phase_golden()
    run, release_launches = phase_release(label)
    batch_launches = phase_batch(run, label)
    d16_launches = phase_d16(label)
    files_launches = phase_files(run, label)
    sharded_launches = phase_sharded(run, label)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": (release_launches if name in RELEASE_PATH else batch_launches
                      if name in BATCH_PATH else files_launches)[name],
         "launches_by_path": {"release": release_launches[name],
                              "batch": batch_launches[name],
                              "d16": d16_launches[name],
                              "files": files_launches[name],
                              "sharded": sharded_launches[name]},
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
