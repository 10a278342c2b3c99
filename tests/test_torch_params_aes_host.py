"""The PyTorch port's own copies against the JAX package's originals.

The port imports nothing of ``c_lwe_snarks_tpu``; it keeps its own
``utils/params.py`` and ``utils/aes_host.py`` (the host AES key schedule
and referee).  Every property of ``Params`` and the AES host functions
must equal the originals'.  Also here: the port's host-data entry points
put their tensors on the card by default and raise without one.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from c_lwe_snarks_tpu.oracle import aes as jaes
from c_lwe_snarks_tpu.utils import params as jparams
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.utils import aes_host, convert, obs, serial
from c_lwe_snarks_tpu_torch.utils import params as tparams

SEED = bytes(range(40))
KEY32, NONCE = SEED[8:], int.from_bytes(SEED[:8], "little")
PROFILES = {"toy": lambda mod: mod.toy(), "release": lambda mod: mod.release(),
            "custom": lambda mod: mod.custom(16, 8)}


def _properties(cls):
    return sorted(k for k, v in vars(cls).items() if isinstance(v, property))


@pytest.mark.parametrize("profile", list(PROFILES))
def test_params_copy_equals_original(profile):
    tp, jp = PROFILES[profile](tparams), PROFILES[profile](jparams)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    names = _properties(jparams.Params)
    assert names == _properties(tparams.Params) and len(names) >= 11
    for name in names:
        assert getattr(tp, name) == getattr(jp, name), name


def test_params_copy_is_not_the_original():
    assert tparams.Params is not jparams.Params
    assert "c_lwe_snarks_tpu." not in tparams.Params.__module__ + "."
    with pytest.raises(NotImplementedError):
        tparams.Params(d=16, m=8, logq=512)
    with pytest.raises(ValueError):
        tparams.Params(d=16, m=8, log_smudging=641)


def test_sbox_copy_equals_original():
    np.testing.assert_array_equal(aes_host.sbox(), jaes.sbox())


@pytest.mark.parametrize("key", [KEY32, bytes(32), bytes([0xFF] * 32)], ids=["seed", "zero", "ones"])
def test_key_expansion_copy_equals_original(key):
    np.testing.assert_array_equal(aes_host.key_expansion(key), jaes.key_expansion(key))


@pytest.mark.parametrize("start", [12345, (1 << 32) - 3, (1 << 32) + 98765])
def test_ctr_keystream_copy_equals_original(start):
    """64 blocks: the copy == the original numpy cipher == its OpenSSL path."""
    got = aes_host.ctr_keystream_numpy(KEY32, NONCE, start, 64)
    np.testing.assert_array_equal(got, jaes.ctr_keystream_numpy(KEY32, NONCE, start, 64))
    np.testing.assert_array_equal(got, jaes.ctr_keystream(KEY32, NONCE, start, 64))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")


DEFAULT_DEVICE_CALLS = {
    "PRGKey": lambda: tsam.PRGKey(SEED),
    "ssp_from_numpy": lambda: convert.ssp_from_numpy(np.zeros(4), np.zeros((2, 4))),
    "crs_from_numpy": lambda: convert.crs_from_numpy(
        SEED, np.zeros((4, 88)), np.zeros((4, 88)), np.zeros(88), np.zeros((1, 88))),
    "vrs_from_numpy": lambda: convert.vrs_from_numpy(1, 2, 3, np.zeros((2, 88))),
    "crs_from_bytes": lambda: serial.crs_from_bytes(
        bytes(40 + 92 * tparams.custom(2, 2, 2).crs_num_cts), tparams.custom(2, 2, 2)),
    "vrs_from_bytes": lambda: serial.vrs_from_bytes(bytes(24 + 2 * 92), tparams.custom(2, 2, 2)),
    "proof_from_bytes": lambda: serial.proof_from_bytes(bytes(5 * 3 * 92), tparams.custom(2, 2, 2)),
    "ssp_from_buffer": lambda: serial.ssp_from_buffer(bytes(8 * 2 * 3), tparams.custom(2, 2, 2)),
}


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_CALLS))
def test_default_device_is_the_card(name):
    """Without a device argument the entry points ask for cuda and raise
    where there is no card; nothing carries on on the CPU."""
    _no_card()
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        DEFAULT_DEVICE_CALLS[name]()


def test_timeit_and_stream_reader_default_to_the_card(tmp_path):
    _no_card()
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        with obs.timeit("stage", file=sys.stderr):
            pass
    P = tparams.custom(2, 2, 2)
    path = tmp_path / "ssp.bin"
    path.write_bytes(bytes(8 * 2 * 3))
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        serial.ssp_read_stream(str(path), P)
