"""The port's CUDA kernels (K1..K7) against their plain torch versions, and
the protocol on the GPU (one-pass and stage-wise) against the committed
golden digests.

Needs a CUDA device: every test skips without one.  This file imports no
jax, so on a machine with a GPU and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from c_lwe_snarks_tpu_torch.__main__ import run_protocol
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.models import ssp as tssp
from c_lwe_snarks_tpu_torch.ops import aes, eval_fused, modp, ntt, sampling
from c_lwe_snarks_tpu_torch.utils import obs, serial
from c_lwe_snarks_tpu_torch.utils.params import Params

SEED = bytes(range(40))
WRAP = (1 << 32) - 3  # counter low word wraps after 3 blocks
GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port_digests.json"

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eq(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.cpu().long(), want.cpu().long())


@pytest.mark.gpu
@pytest.mark.parametrize("start,nblocks", [
    (0, 1), (7, 2), (WRAP, 171), (WRAP, 5000), ((1 << 33) + 11, 4097), (12345, 1 << 16),
    (3, 132 * 1024 + 7)])
def test_k1_keystream_words(cuda, start, nblocks):
    """K1 writes the stream's bytes: one block, less than one CUDA block,
    the low-word wrap, a start above 2^33, more than one grid-stride pass;
    the words are the same memory."""
    key = aes.make_key(SEED, cuda)
    before = aes.LAUNCHES["keystream_words"]
    got = aes.keystream_blocks(key, start, nblocks)
    assert aes.LAUNCHES["keystream_words"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == (nblocks, 16)
    _eq(got.reshape(-1), aes.keystream_bytes_plain(key, 16 * start, 16 * nblocks))
    _eq(aes.keystream_words(key, start, nblocks), aes.keystream_words_plain(key, start, nblocks))


@pytest.mark.gpu
@pytest.mark.parametrize("start,npairs", [
    (0, 1), (5, 2), (WRAP, 4001), ((1 << 32) + 9, 2001), (99, 1 << 17), (3, 2 * (132 * 1024) + 13)])
def test_k2_keystream_fold_p(cuda, start, npairs):
    """K2 writes int64 words, into its own tensor and into the middle of the
    caller's: the odd tail ends on the last pair."""
    key = aes.make_key(SEED, cuda)
    want = aes.keystream_fold_p_plain(key, start, npairs)
    got = aes.keystream_fold_p(key, start, npairs)
    assert got.dtype == torch.int64
    _eq(got, want)
    guarded = torch.full((npairs + 4,), -7, dtype=torch.int64, device=cuda)
    before = aes.LAUNCHES["keystream_fold_p"]
    out = aes.keystream_fold_p(key, start, npairs, out=guarded[2 : 2 + npairs])
    assert aes.LAUNCHES["keystream_fold_p"] == before + 1
    assert out.data_ptr() == guarded[2:].data_ptr()
    _eq(guarded[2 : 2 + npairs], want)
    assert bool((guarded[:2] == -7).all()) and bool((guarded[2 + npairs :] == -7).all())


@pytest.mark.gpu
def test_k2_refuses_an_out_it_cannot_write(cuda):
    """No quiet copy and no fallback: a misaligned, wrongly typed, short,
    strided or CPU out= raises."""
    key = aes.make_key(SEED, cuda)
    for bad in (torch.empty(9, dtype=torch.int64, device=cuda)[1:],
                torch.empty(8, dtype=torch.int32, device=cuda),
                torch.empty(6, dtype=torch.int64, device=cuda),
                torch.empty(16, dtype=torch.int64, device=cuda)[::2],
                torch.empty(8, dtype=torch.int64)):
        with pytest.raises(ValueError, match="out:"):
            aes.keystream_fold_p(key, 0, 8, out=bad)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 5])
def test_k3_eval_mac_planes(cuda, k):
    key = sampling.PRGKey(SEED, cuda)
    n = 6
    rng = np.random.default_rng(k)
    c = torch.from_numpy(rng.integers(0, 1 << 32, size=(k, 700), dtype=np.int64)).to(cuda)
    for off in (0, 40, 16 * 9 + 8):
        _eq(eval_fused.eval_mac_planes(key, off, c, n, 92 * n),
            eval_fused.eval_mac_planes_plain(key, off, c, n, 92 * n))


@pytest.mark.gpu
def test_k4_encrypt_b_fused(cuda):
    key = sampling.PRGKey(SEED, cuda)
    n = 6
    rng = np.random.default_rng(2)
    sk = torch.from_numpy(rng.integers(0, 256, size=(n, 88), dtype=np.uint8)).to(cuda)
    for off, count in ((48, 257), (56, 300), (8, 1)):
        _eq(eval_fused.encrypt_b_fused(key, off, sk, count, n, 92 * n),
            eval_fused.encrypt_b_fused_plain(key, off, sk, count, n, 92 * n))


@pytest.mark.gpu
def test_encrypt_auto_past_k4_bound(cuda):
    """At n = 6,380 K4 refuses, and encrypt_section(impl="auto") returns the
    scan path's ciphertexts without launching it."""
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe

    P = Params(d=16, m=8, n=6380)
    key = sampling.PRGKey(SEED, cuda)
    rng = np.random.default_rng(7)
    sk = torch.from_numpy(rng.integers(0, 256, size=(P.n, 88), dtype=np.uint8)).to(cuda)
    msgs = torch.from_numpy(rng.integers(0, P.p, size=3).astype(np.int64)).to(cuda)
    errs = torch.from_numpy(rng.integers(0, 256, size=(3, 88), dtype=np.uint8)).to(cuda)
    before = eval_fused.LAUNCHES["encrypt_b_fused"]
    auto = tlwe.encrypt_section(key, 8, sk, msgs, errs, P, impl="auto")
    assert eval_fused.LAUNCHES["encrypt_b_fused"] == before
    _eq(auto, tlwe.encrypt_section(key, 8, sk, msgs, errs, P, impl="scan"))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d,off", [
    (6, 1, 1, 3), (5, 8, 131, 16 * 7 + 8), (7, 3, 1030, 5), (2, 2, 4099, 184)])
def test_k3_ragged_tiles(cuda, n, k, d, off):
    """d not a multiple of 4, 32 or 128, one row, k = 8 planes, odd offsets and n."""
    key = sampling.PRGKey(SEED, cuda)
    rng = np.random.default_rng(d)
    c = torch.from_numpy(rng.integers(0, 1 << 32, size=(k, d), dtype=np.int64)).to(cuda)
    _eq(eval_fused.eval_mac_planes(key, off, c, n, 92 * n),
        eval_fused.eval_mac_planes_plain(key, off, c, n, 92 * n))


@pytest.mark.gpu
@pytest.mark.parametrize("n,count,off", [
    (6, 1, 0), (6, 130, 8), (7, 129, 13), (2, 5, 16 * 7 + 8), (19, 257, 8), (33, 3, 1)])
def test_k4_ragged_tiles(cuda, n, count, off):
    """Counts off the block's 128 ciphertexts, one ciphertext, offsets 0 / 8 /
    odd / 16 * 7 + 8, n = 6 and odd n (a ragged last tile of draws)."""
    key = sampling.PRGKey(SEED, cuda)
    rng = np.random.default_rng(count)
    sk = torch.from_numpy(rng.integers(0, 256, size=(n, 88), dtype=np.uint8)).to(cuda)
    _eq(eval_fused.encrypt_b_fused(key, off, sk, count, n, 92 * n),
        eval_fused.encrypt_b_fused_plain(key, off, sk, count, n, 92 * n))


@pytest.mark.gpu
def test_k3_k4_sums_at_the_signed_bound(cuda):
    """Release width, every operand at its largest: K4's per-digit sums reach
    1470 * 88 * 255 * 15 and K3's 700 * 255^2, inside signed 32 bits; K4
    refuses the first n whose sums would not be."""
    key = sampling.PRGKey(SEED, cuda)
    n = 1470
    sk = torch.full((n, 88), 255, dtype=torch.uint8, device=cuda)
    _eq(eval_fused.encrypt_b_fused(key, 8, sk, 130, n, 92 * n),
        eval_fused.encrypt_b_fused_plain(key, 8, sk, 130, n, 92 * n))
    c = torch.full((5, 700), 0xFFFFFFFF, dtype=torch.int64, device=cuda)
    _eq(eval_fused.eval_mac_planes(key, 8, c, n, 92 * n),
        eval_fused.eval_mac_planes_plain(key, 8, c, n, 92 * n))
    big = torch.zeros((6380, 88), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="signed 32-bit"):
        eval_fused.encrypt_b_fused(key, 0, big, 1, 6380, 92 * 6380)


@pytest.mark.gpu
def test_protocol_matches_golden(cuda):
    golden = json.loads(GOLDEN.read_text())
    entry = golden["profiles"]["tiny"]
    P = Params(**entry["params"])
    run = run_protocol(P, cuda, bytes.fromhex(golden["crs_seed"]), bytes.fromhex(golden["ent_seed"]))
    assert run.verified
    blobs = {
        "ssp": serial.ssp_to_buffer(run.ssp, P),
        "crs": serial.crs_to_bytes(run.crs, P),
        "vrs": serial.vrs_to_bytes(run.vrs, P),
        "proof": serial.proof_to_bytes(run.proof, P),
    }
    assert {k: hashlib.sha256(v).hexdigest() for k, v in blobs.items()} == entry["sha256"]


@pytest.mark.gpu
def test_k3_beyond_the_int32_bound(cuda):
    """150,000 all-0xFFFFFFFF terms (d > 2^17): the sums reach ~150000 * 255 *
    127.5 > 2^32, past the TPU kernel's d * 255^2 < 2^31 bound; the kernel's
    signed 32-bit row segments (32768 rows at most) add into int64 exactly."""
    key = sampling.PRGKey(SEED, cuda)
    n = 2
    c = torch.full((1, 150000), 0xFFFFFFFF, dtype=torch.int64, device=cuda)
    got = eval_fused.eval_mac_planes(key, 8, c, n, 92 * n)
    _eq(got, eval_fused.eval_mac_planes_plain(key, 8, c, n, 92 * n))
    assert int(got.max()) > 1 << 32


@pytest.mark.gpu
def test_k5_keystream_blocks_v1(cuda):
    """The bitsliced kernel against its plain version and against K1: ragged
    counts around a quad's group (32 blocks), a warp's tile (256) and a CUDA
    block's tiles (4 warps, 1,024 blocks), the low-word wrap inside a group,
    a start above 2^32, more than one grid-stride pass (528 CUDA blocks x
    1,024 blocks), and the main path's two shapes against K1 alone."""
    key = aes.make_key(SEED, cuda)
    for start, nblocks in ((0, 1), (5, 31), (5, 32), (5, 33), (WRAP - 64, 255), (WRAP, 256),
                           (WRAP - 300, 257), (7, 1023), (7, 1024), ((1 << 32) + 9, 1025),
                           (WRAP, 5000), ((1 << 33) + 11, 4097), (12345, 1 << 16),
                           (3, 528 * 1024 + 33)):
        before = aes.LAUNCHES["keystream_blocks_v1"]
        got = aes.keystream_blocks(key, start, nblocks, version=1)
        assert aes.LAUNCHES["keystream_blocks_v1"] == before + 1
        assert got.dtype == torch.uint8 and got.shape == (nblocks, 16)
        _eq(got, aes.keystream_blocks_v1_plain(key, start, nblocks))
        _eq(got, aes.keystream_blocks(key, start, nblocks))
    for start, nblocks in ((6_000_123, 382_292), (1 << 20, 2_163_840)):
        _eq(aes.keystream_blocks(key, start, nblocks, version=1), aes.keystream_blocks(key, start, nblocks))
    _eq(aes.keystream_bytes(key, 16 * 77, 301),
        aes.keystream_blocks(key, 77, 19, version=1).reshape(-1)[:301])


@pytest.mark.gpu
def test_stagewise_prover_equals_onepass(cuda):
    """prover(tile=...) on the card: three K3 launches, the one-pass proof's
    bytes, probes true on the artifacts reloaded through the byte formats."""
    golden = json.loads(GOLDEN.read_text())
    P = Params(**golden["profiles"]["tiny"]["params"])
    crs_seed, ent_seed = bytes.fromhex(golden["crs_seed"]), bytes.fromhex(golden["ent_seed"])
    run = run_protocol(P, cuda, crs_seed, ent_seed, probe=True)
    crs = serial.crs_from_bytes(serial.crs_to_bytes(run.crs, P), P)
    vrs = serial.vrs_from_bytes(serial.vrs_to_bytes(run.vrs, P), P)
    assert crs.b_s.is_cuda and vrs.sk.is_cuda
    off_prove = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    before = eval_fused.LAUNCHES["eval_mac_planes"]
    pi = tsnark.prover(sampling.PRGKey(crs.seed), sampling.PRGKey(ent_seed), off_prove, crs,
                       run.ssp, run.witness, P, tile=4)
    assert eval_fused.LAUNCHES["eval_mac_planes"] == before + 3
    assert serial.proof_to_bytes(pi, P) == serial.proof_to_bytes(run.proof, P)
    assert bool(tsnark.verifier(vrs, run.ssp, pi, P))
    assert all(bool(v) for v in obs.probe_crs_range(crs, vrs, P).values())
    assert bool(obs.probe_proof(serial.proof_from_bytes(serial.proof_to_bytes(pi, P), P), vrs, P)["pke_h"])


PM1 = (1 << 32) - 6  # p - 1


@pytest.mark.gpu
@pytest.mark.parametrize("la,lb,n", [
    (1, 1, 2), (3, 2, 4), (300, 129, 512), (2049, 2048, 4096), (4000, 4193, 8192),
    (2, 16384, 32768), (32768, 32768, 65536)])
def test_k6_ntt_product(cuda, la, lb, n):
    """K6's product and square against the plain version: two launches up to
    ntt.SMEM_N, three above (the four-step's column passes and the fused
    row pass); entries of p - 1 (the 32-bit wrap of the residue adds mod
    q3)."""
    rng = np.random.default_rng(n + la)
    a = torch.from_numpy(rng.integers(0, PM1 + 1, size=la, dtype=np.int64)).to(cuda)
    b = torch.from_numpy(rng.integers(0, PM1 + 1, size=lb, dtype=np.int64)).to(cuda)
    a[-1] = PM1
    b[: lb // 2] = PM1
    pad = lambda x: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    before = ntt.LAUNCHES["ntt"]
    got, sq = ntt._poly_mul_cyclic(a, b, n), ntt._poly_mul_cyclic(a, None, n)
    assert ntt.LAUNCHES["ntt"] - before == 2 * (2 if n <= ntt.SMEM_N else 3)
    _eq(got, ntt._poly_mul_plain(pad(a), pad(b)))
    _eq(sq, ntt._poly_mul_plain(pad(a), None))


@pytest.mark.gpu
def test_k6_transforms_and_batches(cuda):
    """The raw transforms (the public ntt_forward / ntt_inverse and the
    4-step's local ones) and a batched, broadcast product against the CPU."""
    rng = np.random.default_rng(6)
    for n in (2, 256, 2 * ntt.SMEM_N):
        x = np.stack([rng.integers(0, q, size=(2, n), dtype=np.int64) for q in ntt.NTT_PRIMES])
        x[:, :, -1] = np.array(ntt.NTT_PRIMES).reshape(3, 1) - 1
        xt = torch.from_numpy(x)
        for inverse in (False, True):
            _eq(ntt._transform(xt.to(cuda), inverse), ntt._transform(xt, inverse))
        for i, q in enumerate(ntt.NTT_PRIMES):
            _eq(ntt.ntt_forward(xt[i].to(cuda), q), ntt.ntt_forward(xt[i], q))
            _eq(ntt.ntt_inverse(xt[i].to(cuda), q), ntt.ntt_inverse(xt[i], q))
    a = torch.from_numpy(rng.integers(0, PM1 + 1, size=(3, 64, 100), dtype=np.int64))
    b = torch.from_numpy(rng.integers(0, PM1 + 1, size=(1, 64, 156), dtype=np.int64))
    _eq(ntt.poly_mul_mod_p(a.to(cuda), b.to(cuda)), ntt.poly_mul_mod_p(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("newton_n", [4096, 8192, 16384])
@pytest.mark.parametrize("shape,out_len", [
    ((40,), 2), ((40,), 5), ((1100,), 1025), ((3, 300), 257), ((2100,), 2049), ((8200,), 8193)])
def test_k6_newton_launch(cuda, monkeypatch, newton_n, shape, out_len):
    """The series inverse on the card against the plain path on the CPU,
    across the crossover N_c = newton_n: the levels of n <= N_c are one
    launch, each level above six (two three-launch products); batched rows
    are one cluster each; t's last entries and a row are p - 1."""
    rng = np.random.default_rng(out_len + len(shape))
    t = rng.integers(1, PM1 + 1, size=shape, dtype=np.int64)
    t[..., -7:] = PM1
    t.reshape(-1, shape[-1])[-1] = PM1
    tt = torch.from_numpy(t)
    monkeypatch.setattr(ntt, "NEWTON_N", newton_n)
    levels = ntt._inv_levels(out_len)
    above = sum(n > newton_n for _, n in levels)
    for seed in (None, pow(PM1, PM1 - 1, PM1 + 1)) if len(shape) == 1 else (None,):
        if seed is not None:
            tt = tt.clone()
            tt[0] = PM1
        before = ntt.LAUNCHES["ntt"]
        got = ntt.poly_inv_series_mod_p(tt.to(cuda), out_len, seed=seed)
        assert ntt.LAUNCHES["ntt"] - before == 1 + 6 * above
        _eq(got, ntt.poly_inv_series_mod_p(tt, out_len, seed=seed))
        s0 = modp.invmod_p(tt.reshape(-1, shape[-1])[:, :1])
        low = len(levels) - above
        _eq(ntt._k6_newton(tt.reshape(-1, shape[-1]).to(cuda), s0.to(cuda), None, low,
                           max(levels[low - 1][1], 4)),
            ntt._newton_plain(tt.reshape(-1, shape[-1]), s0, levels[:low]))


@pytest.mark.gpu
def test_k6_newton_refuses_what_it_cannot_hold(cuda, monkeypatch):
    """The rule is on shapes, in the wrapper: no N_c past the CTA's shared
    memory, and more rows than a grid's y dimension raise instead of
    falling back; levels above N_c take the product path."""
    t = torch.ones(70000, 4, dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="cls_ntt_newton"):
        ntt.poly_inv_series_mod_p(t, 4)
    with monkeypatch.context() as m:
        m.setattr(ntt, "NEWTON_N", 2 * ntt.NEWTON_MAX_N)
        with pytest.raises(AssertionError):
            ntt.poly_inv_series_mod_p(t[:2], 4)
    before = ntt.LAUNCHES["ntt"]
    got = ntt.poly_inv_series_mod_p(torch.ones(2, 4100, dtype=torch.int64, device=cuda), 4097)
    assert ntt.LAUNCHES["ntt"] - before == 1 + 6 * 2
    want = torch.zeros(2, 4097, dtype=torch.int64)
    want[:, 0], want[:, 1] = 1, PM1  # 1 / (1 + x + x^2 + ...) = 1 - x
    _eq(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,gate_kind", [
    (1, 1, "ones_max"), (300, 37, "random"), (513, 300, "ones_max"), (257, 256, "zero"),
    (1024, 1 << 15, "random"), (21844, 1 << 10, "random")])
def test_k7_gated_rowsum(cuda, rows, d, gate_kind):
    """K7 against the plain version: ragged chunks and column groups, the
    largest sum (every gate 1, every entry p - 1), a zero gate, a
    random_ssp tile and the prover's row count."""
    rng = np.random.default_rng(rows + d)
    if gate_kind == "ones_max":
        v = torch.full((rows, d), PM1, dtype=torch.int64, device=cuda)
    else:
        v = torch.from_numpy(rng.integers(0, PM1 + 1, size=(rows, d), dtype=np.int64)).to(cuda)
    gate = {"ones_max": np.ones(rows, np.uint8), "zero": np.zeros(rows, np.uint8),
            "random": rng.integers(0, 2, size=rows, dtype=np.uint8)}[gate_kind]
    gate = torch.from_numpy(gate).to(cuda)
    before = modp.LAUNCHES["gated_rowsum_p"]
    got = modp.gated_rowsum_mod_p(v, gate)
    assert modp.LAUNCHES["gated_rowsum_p"] == before + 1
    _eq(got, modp.gated_rowsum_plain(v, gate))
    _eq(modp.gated_rowsum_mod_p(v, gate.bool()), got)


@pytest.mark.gpu
def test_k7_refuses_a_v_it_cannot_read(cuda):
    """No quiet copy: a strided or wrongly typed v raises."""
    v = torch.zeros(8, 16, dtype=torch.int64, device=cuda)
    gate = torch.ones(8, dtype=torch.uint8, device=cuda)
    for bad in (v[:, ::2], v.T[:8, :8], v.int()):
        with pytest.raises(ValueError, match="v:"):
            modp.gated_rowsum_mod_p(bad, gate[: bad.shape[0]])


@pytest.mark.gpu
def test_k6_k7_prover_polys_without_host_sync(cuda):
    """Once t's degree and leading coefficient are read, the row-sum (K7),
    v^2 and the division (K6) run with no device-to-host sync; the result
    equals prover_polys and the plain path on the CPU."""
    P = Params(d=1 << 12, m=64, n=32)
    key = sampling.PRGKey(SEED, cuda)
    wits, ssp = tssp.random_ssp(key, 0, P)
    want = tsnark.prover_polys(key, 4096, ssp, wits, P)  # warm: the library and the tables
    cpu_ssp = tssp.SSP(t=ssp.t.cpu(), v=ssp.v.cpu())
    plain = tsnark.prover_polys(sampling.PRGKey(SEED, "cpu"), 4096, cpu_ssp, wits.cpu(), P)
    for g, w in zip(want, plain):
        _eq(g, w)
    degree, lead = ntt.poly_degree_and_lead(ssp.t)
    delta = want[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w = modp.addmod_p(modp.mulmod_p(delta, ssp.t),
                          modp.gated_rowsum_mod_p(ssp.v[1:], wits[: P.m - 1]))
        v = modp.addmod_p(ssp.v[0], w)
        num = ntt.poly_mul_mod_p(v, v)
        num[0] = modp.submod_p(num[0], 1)
        h = ntt.poly_div_exact_mod_p(num, ssp.t, P.d, den_degree=degree, den_lead=lead)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, x in zip((w, v, h), want[1:]):
        _eq(g, x)
