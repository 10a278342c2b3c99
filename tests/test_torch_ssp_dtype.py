"""The SSP's type in the port against the JAX package's: uint32 coefficients.

The JAX package holds t [d] and v [m, d] as uint32 (``SSPDev``), its
fused keystream kernel ``_kernel_v2_fold`` returns uint32 folds, and its
file readers narrow the uint64-LE words to uint32.  Every way the port
makes or loads an SSP must give the same type and the same values, bit
for bit (tolerance 0): random_ssp at the tiny profile over ragged tiles,
the flat-buffer and streaming readers on the JAX package's bytes, the
numpy bridge from the JAX package's arrays, and K2's plain version
against the Pallas kernel in interpret mode.  The other tests compare
values only (after ``.numpy()`` or ``.astype``), so a port that held the
SSP as int64 passed them all.
"""

import numpy as np
import pytest
import torch

import jax

from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import aes_pallas
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.utils import serial as jserial
from c_lwe_snarks_tpu_torch.models import ssp as tssp
from c_lwe_snarks_tpu_torch.ops import aes as taes
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.utils import convert, serial
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

SEED = bytes(range(40))
TINY = Params(d=16, m=8, n=32)
WRAP = (1 << 32) - 3  # counter low word wraps after 3 blocks


@pytest.fixture(scope="module")
def jax_ssp():
    wits, inst = jax.jit(lambda: jssp.random_ssp(jsam.PRGKey(SEED), 0, TINY))()
    return inst


def _same(got: torch.Tensor, want) -> None:
    """got is uint32 on the CPU, of the JAX array's type, shape and values."""
    want = np.asarray(want)
    assert got.dtype == torch.uint32 and got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)


def _port_ssp(how: str, jax_ssp, monkeypatch, tmp_path) -> tssp.SSP:
    if how.startswith("random_ssp"):
        monkeypatch.setattr(tssp, "TILE", int(how.rsplit("_", 1)[1]))
        return tssp.random_ssp(tsam.PRGKey(SEED, "cpu"), 0, TINY)[1]
    if how == "ssp_from_numpy":
        return convert.ssp_from_numpy(np.asarray(jax_ssp.t), np.asarray(jax_ssp.v), "cpu")
    blob = jserial.ssp_to_buffer(jax_ssp, TINY)
    if how == "ssp_from_buffer":
        return serial.ssp_from_buffer(blob, TINY, "cpu")
    path = str(tmp_path / "ssp.bin")
    serial.save(path, blob)
    return serial.ssp_read_stream(path, TINY, "cpu", rows_per_chunk=3)


@pytest.mark.parametrize("how", [
    "random_ssp_tile_3", "random_ssp_tile_5", "random_ssp_tile_1024",
    "ssp_from_buffer", "ssp_read_stream", "ssp_from_numpy", "keystream_fold_p_plain"])
def test_ssp_is_uint32_as_in_jax(jax_ssp, monkeypatch, tmp_path, how):
    if how == "keystream_fold_p_plain":  # K2's output: a tile of v
        key = taes.make_key(SEED, "cpu")
        for npairs in (2 * 64 + 16, 2 * 64 + 17):
            want = aes_pallas.keystream_fold_p(
                aes_pallas.make_key_pallas(SEED), WRAP, npairs, tile_w=2, interpret=True)
            _same(taes.keystream_fold_p_plain(key, WRAP, npairs), want)
        return
    inst = _port_ssp(how, jax_ssp, monkeypatch, tmp_path)
    _same(inst.t, jax_ssp.t)
    _same(inst.v, jax_ssp.v)
    # the file format is the reference's, byte for byte
    assert serial.ssp_to_buffer(inst, TINY) == jserial.ssp_to_buffer(jax_ssp, TINY)
