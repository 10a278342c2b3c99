"""The port's CUDA kernels (K1..K10) against their plain torch versions, and
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
SENTINEL = (1 << 32) - 7  # a uint32 word >= p: no fold takes it
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
    """K2 writes uint32 words, into its own tensor and into the middle of the
    caller's: the odd tail ends on the last pair."""
    key = aes.make_key(SEED, cuda)
    want = aes.keystream_fold_p_plain(key, start, npairs)
    got = aes.keystream_fold_p(key, start, npairs)
    assert got.dtype == want.dtype == torch.uint32
    _eq(got, want)
    guarded = torch.full((npairs + 4,), SENTINEL, dtype=torch.uint32).to(cuda)
    before = aes.LAUNCHES["keystream_fold_p"]
    out = aes.keystream_fold_p(key, start, npairs, out=guarded[2 : 2 + npairs])
    assert aes.LAUNCHES["keystream_fold_p"] == before + 1
    assert out.data_ptr() == guarded[2:].data_ptr()
    _eq(guarded[2 : 2 + npairs], want)
    ends = guarded.cpu()
    assert ends[:2].tolist() == [SENTINEL] * 2 and ends[2 + npairs :].tolist() == [SENTINEL] * 2


@pytest.mark.gpu
def test_k2_refuses_an_out_it_cannot_write(cuda):
    """No quiet copy and no fallback: a misaligned, wrongly typed (int64,
    the type before v was uint32, too), short, strided or CPU out= raises."""
    key = aes.make_key(SEED, cuda)
    for bad in (torch.empty(9, dtype=torch.uint32, device=cuda)[1:],
                torch.empty(8, dtype=torch.int32, device=cuda),
                torch.empty(8, dtype=torch.int64, device=cuda),
                torch.empty(6, dtype=torch.uint32, device=cuda),
                torch.empty(16, dtype=torch.uint32, device=cuda)[::2],
                torch.empty(8, dtype=torch.uint32)):
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
@pytest.mark.parametrize("k,sectioned", [(9, False), (50, False), (50, True)])
def test_k3_many_lanes_at_release_width(cuda, k, sectioned):
    """K3's many-lane form (k > 8) at release n on 700 rows: every lane over
    every row (windows of 20, 20 and 10 lanes at k = 50), or three sections
    each read with its own lanes alone (the prover's batch layout); one
    launch, the plain version's planes, at offsets with lead 0 and 8."""
    key = sampling.PRGKey(SEED, cuda)
    n, d = 1470, 700
    rng = np.random.default_rng(k + sectioned)
    c = torch.from_numpy(rng.integers(0, 1 << 32, size=(k, d), dtype=np.int64)).to(cuda)
    sections = ((0, d, 0, k),)
    if sectioned:
        sections = ((0, 300, 0, 20), (300, 600, 20, 40), (600, d, 40, k))
        for r0, r1, l0, l1 in sections:
            c[l0:l1, :r0] = 0
            c[l0:l1, r1:] = 0
    for off in (16 * 9 + 8, 1 << 20):
        before = dict(eval_fused.LAUNCHES)
        got = eval_fused.eval_mac_planes(key, off, c, n, 92 * n, sections=sections)
        assert eval_fused.LAUNCHES["eval_mac_lanes"] == before["eval_mac_lanes"] + 1
        assert eval_fused.LAUNCHES["eval_mac_planes"] == before["eval_mac_planes"]
        _eq(got, eval_fused.eval_mac_planes_plain(key, off, c, n, 92 * n, sections=sections))


@pytest.mark.gpu
def test_k3_many_lanes_beyond_the_int32_bound(cuda):
    """24 lanes (windows of 20 and 4) of 150,000 all-0xFFFFFFFF terms: each
    segment's signed 32-bit sums stay exact, and the segments (over several
    launches: more than 128 of them) add into int64 past 2^32."""
    key = sampling.PRGKey(SEED, cuda)
    n = 2
    c = torch.full((24, 150000), 0xFFFFFFFF, dtype=torch.int64, device=cuda)
    got = eval_fused.eval_mac_planes(key, 8, c, n, 92 * n, sections=((0, 150000, 0, 24),))
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
def test_prover_from_reloaded_artifacts(cuda):
    """The prover on the card from a CRS reloaded through the byte formats:
    one K3 launch, the run's proof bytes, probes true on the artifacts."""
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
                       run.ssp, run.witness, P)
    assert eval_fused.LAUNCHES["eval_mac_planes"] == before + 1
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
        v = torch.full((rows, d), PM1, dtype=torch.uint32).to(cuda)
    else:
        v = torch.from_numpy(rng.integers(0, PM1 + 1, size=(rows, d), dtype=np.uint32)).to(cuda)
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
    """No quiet copy: a strided or wrongly typed (int64 too) v raises."""
    v = torch.zeros(8, 16, dtype=torch.uint32, device=cuda)
    gate = torch.ones(8, dtype=torch.uint8, device=cuda)
    wide = torch.zeros(8, 16, dtype=torch.int64, device=cuda)
    for bad in (v[:, ::2], v.T[:8, :8], v.view(torch.int32), wide):
        with pytest.raises(ValueError, match="v:"):
            modp.gated_rowsum_mod_p(bad, gate[: bad.shape[0]])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,b,kind", [
    (21844, 1 << 15, 10, "random"), (1000, 300, 2, "random"), (2100, 1030, 16, "random"),
    (2100, 1030, 17, "random"), (513, 256, 17, "ones_max"), (300, 37, 16, "ones_max")])
def test_k7_many_rowsums(cuda, rows, d, b, kind):
    """K7's many-witness form against its plain version and against B launches
    of K7, bit for bit: the prover's v[1:] at release with 10 witnesses,
    ragged chunks and column groups (d not a multiple of 256, nor of 4: the
    unvectorized loads), 16 statements (one launch) and 17 (two), the
    largest sums (every gate 1, every entry p - 1); the gates a column slice
    of the witnesses, a row no statement gates and one every statement
    gates."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d + b)
    if kind == "ones_max":
        v = torch.full((rows, d), PM1, dtype=torch.uint32).to(cuda)
        wits = torch.ones(b, rows + 1, dtype=torch.uint8, device=cuda)
    else:
        v = torch.randint(0, PM1 + 1, (rows, d), generator=gen, device=cuda).to(torch.uint32)
        wits = torch.randint(0, 2, (b, rows + 1), generator=gen, device=cuda, dtype=torch.uint8)
        wits[:, 5], wits[:, 7] = 0, 1
    gates = wits[:, :rows]
    before = dict(modp.LAUNCHES)
    got = modp.gated_rowsums_mod_p(v, gates)
    assert modp.LAUNCHES["gated_rowsums_p"] - before["gated_rowsums_p"] == -(-b // 16)
    assert modp.LAUNCHES["gated_rowsum_p"] == before["gated_rowsum_p"]
    assert got.dtype == torch.int64 and got.shape == (b, d)
    _eq(got, modp.gated_rowsums_plain(v, gates))
    _eq(got, torch.stack([modp.gated_rowsum_mod_p(v, g) for g in gates]))
    _eq(modp.gated_rowsums_mod_p(v, gates.bool()), got)


@pytest.mark.gpu
def test_k7_many_refuses_what_it_cannot_read(cuda):
    """A strided v, gates on another device or of another type raise."""
    v = torch.zeros(8, 16, dtype=torch.uint32, device=cuda)
    gates = torch.ones(2, 8, dtype=torch.uint8, device=cuda)
    for args in ((v[:, ::2], gates), (v, gates.cpu()), (v, gates.int()), (v, gates[:, :7])):
        with pytest.raises(ValueError):
            modp.gated_rowsums_mod_p(*args)


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
    assert ssp.t.dtype == ssp.v.dtype == torch.uint32
    t = ssp.t.to(torch.int64)
    degree, lead = ntt.poly_degree_and_lead(t)
    delta = want[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w = modp.addmod_p(modp.mulmod_p(delta, t),
                          modp.gated_rowsum_mod_p(ssp.v[1:], wits[: P.m - 1]))
        v = modp.addmod_p(ssp.v[0].to(torch.int64), w)
        num = ntt.poly_mul_mod_p(v, v)
        num[0] = modp.submod_p(num[0], 1)
        h = ntt.poly_div_exact_mod_p(num, t, P.d, den_degree=degree, den_lead=lead)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, x in zip((w, v, h), want[1:]):
        _eq(g, x)


# --------------------------------------------------------------------------
# K8 (matvec_mod_p and its at-s form), K9 (powers_mod_p and its messages
# form), K10 (carry_fold: the planes, b-row, MAC-plane and smudge forms)
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,kind", [
    (1, 1, "max"), (3, 7, "max"), (5, 8, "max"), (2, 33, "max"), (21, 1 << 15, "max"),
    (1, (1 << 15) + 1, "max"), (1, (1 << 21) + 8, "random"), (9, 40000, "random"),
    (1027, 1 << 15, "random"), (1, 1 << 15, "random"), (4, 1, "random")])
def test_k8_matvec_mod_p(cuda, rows, d, kind):
    """K8 against its plain version: d below 8, above 32,768 and past 2^21
    (the repaired fault), every entry p - 1, one row split over blocks, a
    ragged last row group, setup's row length."""
    rng = np.random.default_rng(rows * 7 + d)
    if kind == "max":
        v = torch.full((rows, d), PM1, dtype=torch.uint32).to(cuda)
        w = torch.full((d,), PM1, dtype=torch.int64, device=cuda)
    else:
        v = torch.from_numpy(rng.integers(0, PM1 + 1, size=(rows, d), dtype=np.uint32)).to(cuda)
        w = torch.from_numpy(rng.integers(0, PM1 + 1, size=d, dtype=np.int64)).to(cuda)
    before = modp.LAUNCHES["matvec_mod_p"]
    got = modp.matvec_mod_p(v, w)
    assert modp.LAUNCHES["matvec_mod_p"] == before + 1
    assert got.shape == (rows,) and got.dtype == torch.int64
    _eq(got, modp.matvec_plain(v, w))
    if rows >= 1026:  # batch dimensions
        _eq(modp.matvec_mod_p(v[:1026].reshape(2, 513, d), w).reshape(-1), got[:1026])


@pytest.mark.gpu
def test_k8_refuses_a_v_it_cannot_read(cuda):
    """No quiet copy: a strided or wrongly typed (an int64 v too) v or w
    raises."""
    v = torch.zeros(8, 16, dtype=torch.uint32, device=cuda)
    w = torch.zeros(16, dtype=torch.int64, device=cuda)
    for bad in (v[:, ::2], v.T, v.view(torch.int32), torch.zeros(8, 16, dtype=torch.int64, device=cuda)):
        with pytest.raises(ValueError, match="v:"):
            modp.matvec_mod_p(bad, w[: bad.shape[-1]])
    for bad in (w.int(), torch.zeros(32, dtype=torch.int64, device=cuda)[::2], w[:8]):
        with pytest.raises(ValueError, match="w:"):
            modp.matvec_mod_p(v, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [0, 1, PM1, 123456789, 3141592653])
def test_k9_powers_mod_p(cuda, s):
    """K9 against its plain version: s in {0, 1, p - 1, random}, counts 1,
    2, 3, 1,000 and 2^15 + 1, s as a 0-d and as a [1] tensor."""
    for count in (1, 2, 3, 1000, (1 << 15) + 1):
        for st in (torch.tensor(s, device=cuda), torch.tensor([s], device=cuda)):
            before = modp.LAUNCHES["powers_mod_p"]
            got = modp.powers_mod_p(st, count)
            assert modp.LAUNCHES["powers_mod_p"] == before + 1
            _eq(got, modp.powers_plain(st, count))
    with pytest.raises(ValueError, match="s:"):
        modp.powers_mod_p(torch.tensor([1, 2], device=cuda), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [0, 1, PM1, 3141592653])
def test_k9_message_powers(cuda, s):
    """K9's messages form against its plain version: s in {0, 1, p - 1,
    random}, counts 1, 2, 3 and 2^15 + 1, into its own tensor and with out=
    into the head of a buffer between sentinels."""
    alpha = torch.tensor(2718281828, device=cuda)
    st = torch.tensor(s, device=cuda)
    for count in (1, 2, 3, (1 << 15) + 1):
        before = modp.LAUNCHES["powers_mod_p"]
        got = modp.message_powers(st, alpha, count)
        assert modp.LAUNCHES["powers_mod_p"] == before + 1
        want = modp.message_powers_plain(st, alpha, count)
        _eq(got, want)
        buf = torch.full((2 * count + 2,), -7, dtype=torch.int64, device=cuda)
        modp.message_powers(st, alpha, count, out=buf[: 2 * count])
        _eq(buf[: 2 * count], want)
        assert bool((buf[2 * count :] == -7).all())
    with pytest.raises(ValueError, match="out:"):
        modp.message_powers(st, alpha, 4, out=torch.empty(16, dtype=torch.int64, device=cuda)[::2])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(2, 1), (2, 7), (1, 8), (2, 1 << 15), (1, (1 << 21) + 8),
                                    (9, 40000)])
def test_k8_poly_eval_at_s(cuda, rows, d):
    """K8's at-s form (w = s^i made in the block) against its plain
    version, at d < 8, 2^15 and past 2^21, s in {0, 1, p - 1, random}, every
    coefficient p - 1 in the first row; one launch, no K9."""
    rng = np.random.default_rng(rows + d)
    v = rng.integers(0, PM1 + 1, size=(rows, d), dtype=np.uint32)
    v[0] = PM1
    v = torch.from_numpy(v).to(cuda)
    for s in (0, 1, PM1, 123456789):
        st = torch.tensor(s, device=cuda)
        before = {**modp.LAUNCHES}
        got = modp.poly_eval_mod_p(v, st)
        assert modp.LAUNCHES["matvec_mod_p"] == before["matvec_mod_p"] + 1
        assert modp.LAUNCHES["powers_mod_p"] == before["powers_mod_p"]
        _eq(got, modp.poly_eval_plain(v, st))
    for bad in (v.view(torch.int32), v.to(torch.int64)):
        with pytest.raises(ValueError, match="v:"):
            modp.poly_eval_mod_p(bad, st)


def _fold_ref(acc: np.ndarray, ndigits: int) -> np.ndarray:
    """Python ints: sum_t acc[..., t] * 256^t mod 256^ndigits as digits."""
    flat = acc.reshape(-1, acc.shape[-1])
    out = np.zeros((flat.shape[0], ndigits), np.uint8)
    for i, row in enumerate(flat):
        x = sum(int(v) << (8 * t) for t, v in enumerate(row)) % (1 << (8 * ndigits))
        out[i] = np.frombuffer(x.to_bytes(ndigits, "little"), np.uint8)
    return out.reshape(*acc.shape[:-1], ndigits)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random47", "int32", "ripple", "truncate", "pad", "wide",
                                  "prover", "mesh", "int64max", "int32max", "two_passes",
                                  "one_row", "warp_short", "warp_over"])
def test_k10_carry_fold(cuda, case):
    """K10's planes form against its plain version (and Python ints):
    planes up to 2^47, int32 planes, the worst ripple (256 then 87
    positions of 255) and ripples stopped at every position, K past and
    short of ndigits, planes near 2^62 and at 2^63 - 1, int32 at 2^31 - 1,
    ndigits past one pass, 1, 31 and 33 rows, the prover's [5, 1471, 88]
    and the mesh's int32 sums."""
    from c_lwe_snarks_tpu_torch.ops import digits as dg

    rng = np.random.default_rng(len(case))
    nd = 88
    if case == "random47":
        acc = rng.integers(0, 1 << 47, size=(300, 88), dtype=np.int64)
    elif case == "int32":
        acc = rng.integers(0, 1 << 31, size=(129, 88), dtype=np.int64).astype(np.int32)
    elif case == "ripple":
        acc = np.full((40, 88), 255, np.int64)
        acc[:, 0] = 256  # row 0: 256, then 87 positions of 255
        acc[np.arange(1, 40), np.arange(1, 40)] = 254  # row i: the ripple stops at i
    elif case == "truncate":
        acc = rng.integers(0, 1 << 40, size=(33, 100), dtype=np.int64)
    elif case == "pad":
        acc = rng.integers(0, 1 << 47, size=(33, 70), dtype=np.int64)
    elif case == "wide":
        acc = rng.integers(0, 1 << 62, size=(65, 88), dtype=np.int64)
    elif case == "prover":
        acc = rng.integers(0, 1 << 40, size=(5, 1471, 88), dtype=np.int64)
    elif case == "mesh":
        acc = rng.integers(0, 4 * 255 + 1, size=(5, 33, 88), dtype=np.int64).astype(np.int32)
    elif case == "int64max":
        acc = np.full((33, 88), (1 << 63) - 1, np.int64)
    elif case == "int32max":
        acc = np.full((31, 88), (1 << 31) - 1, np.int32)
    elif case == "two_passes":
        acc = rng.integers(0, 1 << 63, size=(33, 150), dtype=np.int64)
        nd = 140
    else:
        rows = {"one_row": 1, "warp_short": 31, "warp_over": 33}[case]
        acc = rng.integers(0, 1 << 63, size=(rows, 88), dtype=np.int64)
        acc[0] = 255
        acc[0, 0] = 256
    x = torch.from_numpy(acc).to(cuda)
    before = dg.LAUNCHES["carry_fold"]
    got = dg.carry_fold(x, nd)
    assert dg.LAUNCHES["carry_fold"] == before + 1
    assert got.dtype == torch.uint8 and got.shape == (*acc.shape[:-1], nd)
    _eq(got, dg.carry_fold_plain(x, nd))
    if case not in ("random47", "int32", "prover"):
        _eq(got, torch.from_numpy(_fold_ref(acc, nd)))


def _mac_ref(acc_a: np.ndarray, acc_b: np.ndarray) -> np.ndarray:
    """sum_c plane_c * 256^c mod 2^704 at every (evaluation, coordinate), Python ints."""
    planes = np.concatenate([acc_a, acc_b[:, :, None, :]], axis=2)
    out = np.zeros(planes.shape[1:], np.uint8)
    for kk in range(planes.shape[1]):
        for i in range(planes.shape[2]):
            v = sum(int(x) << (8 * (t + c)) for c in range(4) for t, x in enumerate(planes[c, kk, i]))
            out[kk, i] = np.frombuffer((v % (1 << 704)).to_bytes(88, "little"), np.uint8)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,top", [(1, 3, 1 << 63), (5, 7, 1 << 63), (5, 1470, 1 << 40),
                                     (1, 1, 1 << 20), (2, 0, 1 << 63)])
def test_k10_mac_planes(cuda, k, n, top):
    """K10's MAC-plane form against its plain version (and Python ints on
    the small shapes): k = 1 and 5, odd n, the release shape, planes at
    2^63 - 1; it refuses a strided or wrongly typed plane array."""
    from c_lwe_snarks_tpu_torch.ops import digits as dg

    rng = np.random.default_rng(k * n + 1)
    acc_a = rng.integers(0, top, size=(4, k, n, 88), dtype=np.int64)
    acc_b = rng.integers(0, top, size=(4, k, 88), dtype=np.int64)
    acc_a[:, :, : min(n, 2)] = top - 1
    acc_b[:, 0] = top - 1
    a, b = torch.from_numpy(acc_a).to(cuda), torch.from_numpy(acc_b).to(cuda)
    before = dg.LAUNCHES["carry_fold"]
    got = dg.fold_mac_planes(a, b)
    assert dg.LAUNCHES["carry_fold"] == before + 1 and got.shape == (k, n + 1, 88)
    _eq(got, dg.fold_mac_planes_plain(a, b))
    if n < 10:
        _eq(got, torch.from_numpy(_mac_ref(acc_a, acc_b)))
    strided = torch.zeros(4, k, 2 * 88, dtype=torch.int64, device=cuda)[..., ::2]
    shifted = torch.zeros(4 * k * 88 + 1, dtype=torch.int64, device=cuda)[1:].view(4, k, 88)
    for bad_a, bad_b, name in ((a.int(), b, "acc_a"), (a, strided, "acc_b"), (a, b[:, :, :80], "acc_b"),
                               (a, shifted, "acc_b")):
        with pytest.raises(ValueError, match=name):
            dg.fold_mac_planes(bad_a, bad_b)


@pytest.mark.gpu
@pytest.mark.parametrize("s_kind", ["random", "zero", "max"])
def test_k10_smudge(cuda, s_kind):
    """K10's smudge form against its plain version under every sign
    pattern of the five draws, s random, 0 and 2^640 - 1, b rows at 0 and
    at 2^704 - 1; the one-row case (lwe.smudge) on a batch; the refusals."""
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.ops import digits as dg

    n = 1470 if s_kind == "random" else 5
    rng = np.random.default_rng(len(s_kind))
    base = torch.from_numpy(rng.integers(0, 256, size=(5, n + 1, 88), dtype=np.uint8)).to(cuda)
    base[1, n] = 255
    base[2, n] = 0
    for signs in range(32):
        draws = torch.from_numpy(rng.integers(0, 256, size=(5, 81), dtype=np.uint8)).to(cuda)
        if s_kind != "random":
            draws[:, :80] = 0 if s_kind == "zero" else 255
        draws[:, 80] = torch.tensor([(draws[i, 80].item() & 0xFE) | (signs >> i & 1)
                                     for i in range(5)], dtype=torch.uint8)
        before = dg.LAUNCHES["carry_fold"]
        got = dg.smudge_draws(base.clone(), draws, tsnark.SMUDGE_TARGETS)
        assert dg.LAUNCHES["carry_fold"] == before + 1
        _eq(got, dg.smudge_draws_plain(base.cpu().clone(), draws.cpu(), tsnark.SMUDGE_TARGETS))
    s = draws[0, :88 if s_kind == "max" else 80]
    s88 = torch.nn.functional.pad(s, (0, 88 - s.shape[0]))
    for positive in (True, False):
        sign = torch.tensor(positive, device=cuda)
        P = Params(d=16, m=8, n=n)
        got = tlwe.smudge(base, s88, sign, P)
        _eq(got, tlwe.smudge(base.cpu(), s88.cpu(), sign.cpu(), P))
    with pytest.raises(ValueError, match="draws"):
        dg.smudge_draws(base.clone(), draws[:, ::2], tsnark.SMUDGE_TARGETS)
    with pytest.raises(ValueError):
        dg.smudge_draws(base.clone(), draws, (0, 1, 2, 3, 16))



@pytest.mark.gpu
def test_k10_b_rows(cuda):
    """K10's b-row form against its plain version on random nibble planes
    at their bound, and on K4's own planes against encrypt_section's
    plain path (K4's planes, then b_rows_plain on the CPU)."""
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.ops import digits as dg

    rng = np.random.default_rng(10)
    B = 1000
    v_lo = torch.from_numpy(rng.integers(0, 1 << 31, size=(B, 88), dtype=np.int64).astype(np.int32))
    v_hi = torch.from_numpy(rng.integers(0, 1 << 31, size=(B, 88), dtype=np.int64).astype(np.int32))
    errs = torch.from_numpy(rng.integers(0, 256, size=(B, 88), dtype=np.uint8))
    msgs = torch.from_numpy(rng.integers(0, 1 << 32, size=B, dtype=np.int64))
    errs[:3] = 255
    msgs[:3] = (1 << 32) - 1
    before = dg.LAUNCHES["carry_fold"]
    got = dg.carry_fold_b_rows(v_lo.to(cuda), v_hi.to(cuda), errs.to(cuda), msgs.to(cuda))
    assert dg.LAUNCHES["carry_fold"] == before + 1
    _eq(got, dg.b_rows_plain(v_lo, v_hi, errs, msgs))
    with pytest.raises(ValueError, match="v_lo:"):
        dg.carry_fold_b_rows(v_lo.to(cuda).long(), v_hi.to(cuda), errs.to(cuda), msgs.to(cuda))
    shifted = torch.empty(B * 88 + 1, dtype=torch.int32, device=cuda)[1:].view(B, 88)
    with pytest.raises(ValueError, match="v_hi: expected a start aligned"):  # no pair load there
        dg.carry_fold_b_rows(v_lo.to(cuda), shifted, errs.to(cuda), msgs.to(cuda))

    P = Params(d=16, m=8, n=19)
    key = sampling.PRGKey(SEED, cuda)
    sk = torch.from_numpy(rng.integers(0, 256, size=(P.n, 88), dtype=np.uint8))
    msgs, errs = msgs[:257], errs[:257]
    got = tlwe.encrypt_section(key, 8, sk.to(cuda), msgs.to(cuda), errs.to(cuda), P, impl="fused")
    cpu = tlwe.encrypt_section(sampling.PRGKey(SEED, "cpu"), 8, sk, msgs, errs, P, impl="fused")
    _eq(got, cpu)


@pytest.mark.gpu
def test_k8_k9_k10_setup_schedule_and_verifier_without_host_sync(cuda):
    """Setup's message schedule (K9's messages form, K8), the prover's
    evaluations and smudging (K3, K10's MAC-plane and smudge forms) and the
    verifier (K11's verifier form) make no host sync, after one warm run;
    K9 launches once, K8 twice (t(s) and v), K10 twice (the epilogue, the
    five smudges), K11 once; the results equal the plain path's."""
    P = Params(d=1 << 12, m=64, n=32)
    key = sampling.PRGKey(SEED, cuda)
    ent = sampling.PRGKey(bytes([1] * 40), cuda)
    run = run_protocol(P, cuda, SEED, bytes([1] * 40))  # warm: the library, cached constants
    assert run.verified
    vrs, ssp = run.vrs, run.ssp
    off_setup = tssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + tsnark.setup_entropy_bytes(P)
    scalars = sampling.keystream_bytes(ent, off_setup, 24).reshape(3, 8)
    alpha, beta, s = (modp.bytes_to_u64_mod_p(scalars[i]) for i in range(3))
    delta, w, v, h = tsnark.prover_polys(ent, off_prove, ssp, run.witness, P)
    from c_lwe_snarks_tpu_torch.ops import digits as dg

    from c_lwe_snarks_tpu_torch.ops import verify

    counters = {**modp.LAUNCHES, **dg.LAUNCHES, **verify.LAUNCHES}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        msgs = tsnark.setup_messages(
            alpha, beta, s, ssp.t, lambda powers: modp.matvec_mod_p(ssp.v, powers), P.d, P.m)
        proof, = tsnark._evaluate_and_smudge(key, ent, [off_prove], run.crs, delta, w, v, h,
                                             run.witness, P)
        ok = tsnark.verifier(vrs, ssp, proof, P)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert modp.LAUNCHES["powers_mod_p"] - counters["powers_mod_p"] == 1
    assert modp.LAUNCHES["matvec_mod_p"] - counters["matvec_mod_p"] == 2
    assert dg.LAUNCHES["carry_fold"] - counters["carry_fold"] == 2
    assert verify.LAUNCHES["verify"] - counters["verify"] == 1
    assert bool(ok)
    _eq(proof.stack(), run.proof.stack())
    cpu_ssp = tssp.SSP(t=ssp.t.cpu(), v=ssp.v.cpu())
    want = tsnark.setup_messages(alpha.cpu(), beta.cpu(), s.cpu(), cpu_ssp.t,
                                 lambda powers: modp.matvec_mod_p(cpu_ssp.v, powers), P.d, P.m)
    _eq(msgs, want)
    assert int(msgs[1]) == int(vrs.s) and int(msgs[P.d]) == int(vrs.alpha)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(200, 1 << 12), (1470, 3000)])
def test_k11_verify(cuda, n, d):
    """K11's verifier form against its plain version on the CPU (the verdict
    and the eight words, tolerance 0): the honest proof, each field's b row
    and one a row tampered, a wrong alpha; one launch each and no host sync;
    a ragged last slice of rows (n = 200) and of columns (d = 3000)."""
    from c_lwe_snarks_tpu_torch.ops import verify

    P = Params(d=d, m=64, n=n)
    run = run_protocol(P, cuda, SEED, bytes([1] * 40))
    assert run.verified
    vrs, ssp = run.vrs, run.ssp
    assert vrs.alpha.dtype == vrs.beta.dtype == vrs.s.dtype == torch.uint32
    cases = [("honest", run.proof.stack(), vrs.alpha)]
    for e, name in enumerate(("h", "hat_h", "hat_v", "v_w", "b_w")):
        for row in (n, 5):
            bad = run.proof.stack().clone()
            bad[e, row, 3] ^= 1
            cases.append((f"{name}[{row}]", bad, vrs.alpha))
    wrong = ((vrs.alpha.to(torch.int64) + 1) % modp.P).to(torch.uint32)
    cases.append(("alpha + 1", run.proof.stack(), wrong))
    for label, cts, alpha in cases:
        args = (vrs.sk, ssp.t, ssp.v[0], vrs.s, alpha, vrs.beta, P.log_smudging // 8)
        before = verify.LAUNCHES["verify"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ok, words = verify.verify(tuple(cts.unbind()), *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert verify.LAUNCHES["verify"] == before + 1
        want_ok, want_words = verify.verify_plain(
            tuple(cts.cpu().unbind()), *(x.cpu() if isinstance(x, torch.Tensor) else x for x in args))
        _eq(words, want_words)
        assert bool(ok) == bool(want_ok) == (label == "honest"), label
    with pytest.raises(ValueError, match="t:"):
        verify.verify(tuple(run.proof.stack().unbind()), vrs.sk, ssp.t.to(torch.int64), ssp.v[0],
                      vrs.s, vrs.alpha, vrs.beta, P.log_smudging // 8)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(1, 1), (5, 32), (7, 33), (300, 1470)])
def test_k11_decrypt(cuda, k, n):
    """K11's decrypt form against its plain version: k ciphertexts in one
    launch, one with b < <a, sk>, one at every byte 255, ragged slices."""
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.ops import verify

    rng = np.random.default_rng(k)
    ct = torch.from_numpy(rng.integers(0, 256, size=(k, n + 1, 88), dtype=np.uint8))
    sk = torch.from_numpy(rng.integers(0, 256, size=(n, 88), dtype=np.uint8))
    ct[0, n, 1:] = 0  # b < 256
    if k > 1:
        ct[-1] = 255
    before = verify.LAUNCHES["verify"]
    got = verify.decrypt(ct.to(cuda), sk.to(cuda))
    assert verify.LAUNCHES["verify"] == before + 1
    _eq(got, verify.decrypt_plain(ct, sk))
    _eq(tlwe.decrypt(ct[0].to(cuda), sk.to(cuda), Params(d=16, m=8, n=n)),
        verify.decrypt_plain(ct[0], sk))
    shifted = torch.empty(ct.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(ct.shape)
    with pytest.raises(ValueError, match="aligned"):  # rows are staged a word a load
        verify.decrypt(shifted, sk.to(cuda))



@pytest.mark.gpu
def test_host_syncs_are_the_synchronizing_calls_torch_warns_of(cuda):
    """A request of each benchmark cell at release, warm, under the recorder
    and ``set_sync_debug_mode("warn")``: the port's host-sync counter equals
    the synchronizing calls torch warns of from the port's code (every call
    a request makes is inside a span), and the spans' launches add up to the
    ``LAUNCHES`` counters' growth.  (Switching the mode on warns once
    itself, from torch's code.)"""
    import warnings

    from c_lwe_snarks_tpu_torch.ops import digits, verify
    from c_lwe_snarks_tpu_torch.utils import spans
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    port = pathlib.Path(tsnark.__file__).parents[1]
    crs_key, ent_key = sampling.PRGKey(SEED, cuda), sampling.PRGKey(bytes(range(40, 80)), cuda)
    off_setup = tssp.entropy_bytes_random_ssp(P)
    state = {}

    def setup():
        state["wits"], state["ssp"] = tssp.random_ssp(ent_key, 0, P)
        state["crs"], state["vrs"] = tsnark.setup(crs_key, ent_key, off_setup, state["ssp"], P)
        serial.crs_to_bytes(state["crs"], P)
        serial.vrs_to_bytes(state["vrs"], P)

    def prove():
        pi = tsnark.prover(crs_key, ent_key, off_setup + tsnark.setup_entropy_bytes(P),
                           state["crs"], state["ssp"], state["wits"], P)
        state["blob"] = serial.proof_to_bytes(pi, P)

    def verify_():
        proof = serial.proof_from_bytes(state["blob"], P, cuda)
        state["ok"] = tsnark.verifier(state["vrs"], state["ssp"], proof, P)

    def launched():
        return sum(sum(c.values()) for c in (aes.LAUNCHES, eval_fused.LAUNCHES, ntt.LAUNCHES,
                                            modp.LAUNCHES, digits.LAUNCHES, verify.LAUNCHES))

    for request in (setup, prove, verify_):  # warm: builds, one-time tables
        request()
    found = {}
    for name, request in (("setup", setup), ("prove", prove), ("verify", verify_)):
        spans.reset()
        torch.cuda.synchronize()
        before = launched()
        with warnings.catch_warnings(record=True) as caught, spans.recording():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                request()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        top = [r for r in spans.records() if r.parent < 0]
        warned = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
                  if "synchroniz" in str(w.message) and f"{port}/" in w.filename]
        found[name] = (sum(r.syncs for r in top), len(warned), spans.sync_sites(), warned)
        assert sum(r.launches for r in top) == launched() - before > 0, name
        if name == "prove":  # the proof's bytes wait for its evaluation sweep (K3)
            assert [r.waited > 0 for r in top if r.name == "lwe.serial.proof_to_bytes"] == [True]
    for name, (counted, warned, sites, where) in found.items():
        print(f"{name}: {counted} counted {sites}, {warned} warned at {where}")
    assert bool(state["ok"])
    assert all(counted == warned for counted, warned, _, _ in found.values())


@pytest.fixture(scope="module")
def release_circuit():
    """A release circuit set up on the card: (P, ssp, crs, vrs, prove)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from c_lwe_snarks_tpu_torch.utils.params import release

    P, dev = release(), torch.device("cuda")
    crs_key, ent_key = sampling.PRGKey(SEED, dev), sampling.PRGKey(bytes(range(40, 80)), dev)
    off_setup = tssp.entropy_bytes_random_ssp(P)
    wits, ssp = tssp.random_ssp(ent_key, 0, P)
    crs, vrs = tsnark.setup(crs_key, ent_key, off_setup, ssp, P)

    def prove():
        return tsnark.prover(crs_key, ent_key, off_setup + tsnark.setup_entropy_bytes(P),
                             crs, ssp, wits, P)

    return P, ssp, crs, vrs, prove


def _fields(obj) -> dict:
    return {k: v for k, v in vars(obj).items() if isinstance(v, torch.Tensor)}


@pytest.mark.gpu
def test_prover_batch_at_release_equals_prover(release_circuit):
    """Ten statements of the release circuit (random witness bits) in one
    ``prover_batch``: each proof is ``snark.prover``'s bytes for its offset
    and witness; one many-lane K3 launch and one host sync (t's degree) for
    the batch, none of K3's form of 8 lanes.  The batch's and the ten
    provers' walls are printed."""
    import time

    from c_lwe_snarks_tpu_torch.utils import spans

    P, ssp, crs, _, _ = release_circuit
    dev = torch.device("cuda")
    crs_key, ent_key = sampling.PRGKey(SEED, dev), sampling.PRGKey(bytes(range(40, 80)), dev)
    off0 = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    offsets = [off0 + i * tsnark.prover_entropy_bytes(P) for i in range(10)]
    gen = torch.Generator(device=dev).manual_seed(10)
    wits = [torch.randint(0, 2, (P.m,), generator=gen, device=dev, dtype=torch.uint8)
            for _ in offsets]

    def batch():
        return [serial.proof_to_bytes(pi, P) for pi in
                tsnark.prover_batch(crs_key, ent_key, offsets, crs, ssp, wits, P)]

    def singles():
        return [serial.proof_to_bytes(tsnark.prover(crs_key, ent_key, off, crs, ssp, w, P), P)
                for off, w in zip(offsets, wits)]

    want, got = singles(), batch()  # warm
    assert got == want
    walls = {}
    for name, run in (("batch", batch), ("singles", singles)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assert run() == want
        walls[name] = time.perf_counter() - t0
    print(f"prover_batch at release, 10 statements: {walls['batch']:.4f} s; ten provers "
          f"{walls['singles']:.4f} s")
    spans.reset()
    before = dict(eval_fused.LAUNCHES)
    with spans.recording():
        tsnark.prover_batch(crs_key, ent_key, offsets, crs, ssp, wits, P)
    assert spans.sync_sites() == {"ntt.poly_degree_and_lead": 1}
    assert eval_fused.LAUNCHES["eval_mac_lanes"] == before["eval_mac_lanes"] + 1
    assert eval_fused.LAUNCHES["eval_mac_planes"] == before["eval_mac_planes"]
    spans.reset()


@pytest.mark.gpu
def test_prover_polys_batch_at_release_equals_prover_polys(release_circuit):
    """Ten statements' polynomial stage at release in one
    ``prover_polys_batch``: row j is ``prover_polys`` of statement j; it
    makes one host sync (t's degree, as one statement's stage does), a K1
    launch a statement, one launch of K7's many-witness form and none of K7
    (one read of v for the ten row-sums), and one statement's 31 K6 launches
    (t's series inverse once).  The stage's and the ten single stages' walls are
    printed."""
    import time

    from c_lwe_snarks_tpu_torch.utils import spans

    P, ssp, _, _, _ = release_circuit
    dev = torch.device("cuda")
    ent_key = sampling.PRGKey(bytes(range(40, 80)), dev)
    off0 = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    offsets = [off0 + i * tsnark.prover_entropy_bytes(P) for i in range(10)]
    gen = torch.Generator(device=dev).manual_seed(20)
    wits = torch.randint(0, 2, (10, P.m), generator=gen, device=dev, dtype=torch.uint8)
    wits[1] = 0
    wits[2] = 1

    def singles():
        return [tsnark.prover_polys(ent_key, off, ssp, w, P) for off, w in zip(offsets, wits)]

    def batch():
        return tsnark.prover_polys_batch(ent_key, offsets, ssp, wits, P)

    want, got = singles(), batch()  # warm
    for j in range(10):
        for g, w in zip(got, want[j]):
            _eq(g[j], w)
    walls = {}
    for name, run in (("batch", batch), ("singles", singles)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    print(f"prover_polys_batch at release, 10 statements: {walls['batch'] * 1e3:.3f} ms; ten "
          f"prover_polys {walls['singles'] * 1e3:.3f} ms")
    before = (dict(aes.LAUNCHES), dict(modp.LAUNCHES), ntt.LAUNCHES["ntt"])
    spans.reset()
    with spans.recording():
        again = batch()
    assert spans.sync_sites() == {"ntt.poly_degree_and_lead": 1}
    spans.reset()
    assert aes.LAUNCHES["keystream_words"] - before[0]["keystream_words"] == 10
    assert modp.LAUNCHES["gated_rowsum_p"] - before[1]["gated_rowsum_p"] == 0
    assert modp.LAUNCHES["gated_rowsums_p"] - before[1]["gated_rowsums_p"] == 1
    assert ntt.LAUNCHES["ntt"] - before[2] == 31
    for g, x in zip(again, got):
        _eq(g, x)


@pytest.mark.gpu
def test_release_prover_makes_one_k7_launch(release_circuit):
    """One statement's proof at release keeps K7's one-witness form: one
    gated_rowsum_p launch, none of the many-witness form."""
    _, _, _, _, prove = release_circuit
    before = dict(modp.LAUNCHES)
    prove()
    assert modp.LAUNCHES["gated_rowsum_p"] - before["gated_rowsum_p"] == 1
    assert modp.LAUNCHES["gated_rowsums_p"] == before["gated_rowsums_p"]


@pytest.mark.gpu
def test_staged_artifacts_are_the_cpu_paths_bytes(release_circuit):
    """At release, each writer on the card gives the bytes the same writer
    gives on the CPU from the same digits; each reader on the card gives the
    CPU reader's tensors, and they write back the same bytes."""
    P, _, crs, vrs, prove = release_circuit
    arts = {"crs": crs, "vrs": vrs, "proof": prove()}
    writers = {"crs": serial.crs_to_bytes, "vrs": serial.vrs_to_bytes,
               "proof": serial.proof_to_bytes}
    readers = {"crs": serial.crs_from_bytes, "vrs": serial.vrs_from_bytes,
               "proof": serial.proof_from_bytes}
    for name, art in arts.items():
        blob = writers[name](art, P)
        on_cpu = type(art)(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                              for k, v in vars(art).items()})
        assert blob == writers[name](on_cpu, P), name
        got, want = readers[name](blob, P, "cuda"), readers[name](blob, P, "cpu")
        for k, v in _fields(want).items():
            g = _fields(got)[k]
            assert g.device.type == "cuda" and g.dtype == v.dtype, (name, k)
            assert torch.equal(g.cpu(), v), (name, k)
        assert writers[name](got, P) == blob, name


@pytest.mark.gpu
def test_proofs_read_back_to_back_keep_their_bytes(release_circuit):
    """Eight reads of two different proofs with no sync between them: each
    host buffer is freed while its copy to the card may still run, and no
    later read overwrites it.  The verdicts and every byte are each proof's."""
    P, ssp, _, vrs, prove = release_circuit
    honest = serial.proof_to_bytes(prove(), P)
    bad = bytearray(honest)
    bad[P.n * P.ct_bytes] ^= 1  # h's b row
    blobs = [honest, bytes(bad)] * 4
    torch.cuda.synchronize()
    proofs = [serial.proof_from_bytes(b, P, "cuda") for b in blobs]
    oks = [tsnark.verifier(vrs, ssp, pi, P) for pi in proofs]
    assert [bool(ok) for ok in oks] == [True, False] * 4
    for blob, pi in zip(blobs, proofs):
        assert torch.equal(pi.stack().cpu(), serial.proof_from_bytes(blob, P, "cpu").stack())


@pytest.mark.gpu
def test_steady_state_stages_one_copy_an_artifact_and_pins_nothing_new(release_circuit):
    """Warm, three requests of each kind: one staged copy an artifact and no
    new pinned buffer, by the port's counter and, where torch reports it,
    by the caching host allocator's own count."""
    from c_lwe_snarks_tpu_torch.utils import spans

    P, ssp, crs, vrs, prove = release_circuit
    pi = prove()
    blob = serial.proof_to_bytes(pi, P)

    def requests():
        serial.crs_to_bytes(crs, P)
        serial.vrs_to_bytes(vrs, P)
        serial.proof_to_bytes(pi, P)
        assert bool(tsnark.verifier(vrs, ssp, serial.proof_from_bytes(blob, P, "cuda"), P))

    requests()  # warm: the first pinned buffers
    stats = getattr(torch.cuda, "host_memory_stats", None)
    allocs = stats().get("num_host_alloc") if stats else None
    spans.reset()
    with spans.recording():
        for _ in range(3):
            requests()
    sites = spans.staged_sites()
    spans.reset()
    names = ("crs_to_bytes", "vrs_to_bytes", "proof_to_bytes", "proof_from_bytes")
    assert sites == {f"serial.{f}": {"copies": 3, "pinned_new": 0} for f in names}
    if allocs is not None:
        assert stats().get("num_host_alloc") == allocs
