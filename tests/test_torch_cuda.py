"""The port's CUDA kernels (K1..K5) against their plain torch versions, and
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
from c_lwe_snarks_tpu_torch.ops import aes, eval_fused, sampling
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
def test_k1_keystream_words(cuda):
    key = aes.make_key(SEED, cuda)
    for start, nblocks in ((0, 1), (WRAP, 5000), (12345, 1 << 16)):
        _eq(aes.keystream_words(key, start, nblocks), aes.keystream_words_plain(key, start, nblocks))


@pytest.mark.gpu
def test_k2_keystream_fold_p(cuda):
    key = aes.make_key(SEED, cuda)
    for start, npairs in ((0, 1), (WRAP, 4001), (99, 1 << 17)):
        _eq(aes.keystream_fold_p(key, start, npairs), aes.keystream_fold_p_plain(key, start, npairs))


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
    uint32 row segments add into int64 exactly."""
    key = sampling.PRGKey(SEED, cuda)
    n = 2
    c = torch.full((1, 150000), 0xFFFFFFFF, dtype=torch.int64, device=cuda)
    got = eval_fused.eval_mac_planes(key, 8, c, n, 92 * n)
    _eq(got, eval_fused.eval_mac_planes_plain(key, 8, c, n, 92 * n))
    assert int(got.max()) > 1 << 32


@pytest.mark.gpu
def test_k5_keystream_blocks_v1(cuda):
    """The bitsliced kernel against its plain version and against K1: ragged
    counts, the low-word wrap, a start above 2^32."""
    key = aes.make_key(SEED, cuda)
    for start, nblocks in ((0, 1), (5, 33), (WRAP, 5000), ((1 << 33) + 11, 4097), (12345, 1 << 16)):
        before = aes.LAUNCHES["keystream_blocks_v1"]
        got = aes.keystream_blocks(key, start, nblocks, version=1)
        assert aes.LAUNCHES["keystream_blocks_v1"] == before + 1
        assert got.dtype == torch.uint8 and got.shape == (nblocks, 16)
        _eq(got, aes.keystream_blocks_v1_plain(key, start, nblocks))
        _eq(got, aes.keystream_blocks(key, start, nblocks))
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
