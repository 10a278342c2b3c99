"""PyTorch port vs the JAX package: the bitsliced keystream (K5, version 1).

The port's ``keystream_blocks(version=1)`` on the CPU runs the plain
version of kernel K5: the same bitsliced circuit on tensors.  It is held,
bit for bit, against the JAX Pallas kernel ``aes_pallas._kernel`` in
interpret mode, against version 2 of both packages and against the host
oracle; the bit transpose and the S-box circuit against the JAX ones on
random words; and the generated CUDA header against the generator.  The
CUDA kernel itself is held against the plain version on a GPU in
tests/test_torch_cuda.py.
"""

import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.ops import aes_pallas
from c_lwe_snarks_tpu.ops import bitslice as jbitslice
from c_lwe_snarks_tpu.ops import sbox_bp as jsbox
from c_lwe_snarks_tpu.oracle import aes as host_aes
from c_lwe_snarks_tpu_torch.ops import aes as taes
from c_lwe_snarks_tpu_torch.ops import bitslice as tbitslice
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.ops import sbox_bp as tsbox

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = bytes(range(40))
KEY32, NONCE = SEED[8:], int.from_bytes(SEED[:8], "little")
WRAP = (1 << 32) - 3  # counter low word wraps after 3 blocks


@pytest.fixture(scope="module")
def tkey():
    return taes.make_key(SEED, "cpu")


@pytest.fixture(scope="module")
def jkey():
    return aes_pallas.make_key_pallas(SEED)


def _eq(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start,nblocks,tile_w", [(12345, 96, 8), (WRAP, 32, 1)])
def test_v1_vs_pallas_v1_interpret(tkey, jkey, start, nblocks, tile_w):
    got = taes.keystream_blocks(tkey, start, nblocks, version=1)
    want = aes_pallas.keystream_blocks(
        jkey, start, nblocks, tile_w=tile_w, interpret=True, version=1)
    assert got.shape == (nblocks, 16)
    _eq(got, want)


@pytest.mark.parametrize("start,nblocks", [(12345, 96), (WRAP, 32)])
def test_v1_vs_v2_both_packages(tkey, jkey, start, nblocks):
    got = taes.keystream_blocks(tkey, start, nblocks, version=1)
    _eq(got, taes.keystream_blocks(tkey, start, nblocks).numpy())
    _eq(got, aes_pallas.keystream_blocks(jkey, start, nblocks, tile_w=1, interpret=True))


@pytest.mark.parametrize("start,nblocks", [
    (12345, 96), (WRAP, 1000), (7, 1), (5, 33), ((1 << 32) + 98765, 77), (0, 0)])
def test_v1_vs_oracle(tkey, start, nblocks):
    """Ragged counts, the low-word wrap, a counter above 2^32, no blocks."""
    got = taes.keystream_blocks(tkey, start, nblocks, version=1)
    _eq(got, host_aes.ctr_keystream(KEY32, NONCE, start, nblocks).reshape(nblocks, 16))


def test_v1_vs_golden_windows(tkey):
    """The committed oracle windows that the GPU run holds K1 and K5 to."""
    golden = json.loads((ROOT / "tests" / "golden" / "torch_port_keystream.json").read_text())
    assert bytes.fromhex(golden["seed"]) == SEED and len(golden["windows"]) == 3
    for w in golden["windows"]:
        want = np.frombuffer(bytes.fromhex(w["bytes"]), np.uint8).reshape(w["nblocks"], 16)
        np.testing.assert_array_equal(
            want.reshape(-1), host_aes.ctr_keystream_numpy(KEY32, NONCE, w["start"], w["nblocks"]))
        for version in (1, 2):
            _eq(taes.keystream_blocks(tkey, w["start"], w["nblocks"], version=version), want)


def test_keystream_bytes_and_sampling_blocks(tkey):
    ks = host_aes.ctr_keystream(KEY32, NONCE, 77, 20)
    _eq(taes.keystream_bytes(tkey, 16 * 77, 301), ks[:301])
    with pytest.raises(ValueError):
        taes.keystream_bytes(tkey, 16 * 77 + 8, 16)
    _eq(tsam.keystream_blocks(tsam.PRGKey(SEED, "cpu"), 77, 20), ks.reshape(20, 16))


def test_round_key_planes_vs_pallas_key(tkey, jkey):
    """The port's plane 8 * byte + bit against the JAX key's [15, 8, 16, 1]
    layout (bit k, row q = 4r + c): the same 0 / ~0 masks, 0x63 folded."""
    rk = np.asarray(jkey["rk_rm"])[..., 0]  # [15, bit, row]
    want = np.zeros((15, 128), np.int64)
    for q in range(16):
        byte = q // 4 + 4 * (q % 4)
        for k in range(8):
            want[:, 8 * byte + k] = rk[:, k, q]
    np.testing.assert_array_equal(tkey.rk_planes.numpy(), want)
    np.testing.assert_array_equal(
        tkey.rk_planes32.numpy().view(np.uint32).astype(np.int64), want)


def test_offset_parts_vs_jax():
    from c_lwe_snarks_tpu.ops import sampling as jsam

    for off in (0, 16 * 77 + 9, 16 * ((1 << 32) + 5) + 8):
        parts = tsam.offset_parts(off)
        assert list(parts) == [int(x) for x in jsam.offset_parts(off)]
        assert tsam.parts_to_offset(parts) == tsam.split_offset(off)


@pytest.mark.parametrize("trailing", [(), (5,), (2, 3)])
def test_transpose32_vs_jax(trailing):
    rng = np.random.default_rng(len(trailing))
    a = rng.integers(0, 1 << 32, size=(32,) + trailing, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.jit(jbitslice.transpose32)(jnp.asarray(a)))
    got = tbitslice.transpose32(torch.from_numpy(a.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    again = tbitslice.transpose32(got)  # an involution
    np.testing.assert_array_equal(again.numpy(), a.astype(np.int64))


@pytest.mark.parametrize("trailing", [(), (4,)])
def test_bytes_to_planes_vs_jax(trailing):
    """The public names around the transpose: words -> planes and back."""
    rng = np.random.default_rng(7 + len(trailing))
    a = rng.integers(0, 1 << 32, size=(32,) + trailing, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.jit(jbitslice.bytes_to_planes)(jnp.asarray(a)))
    planes = tbitslice.bytes_to_planes(torch.from_numpy(a.astype(np.int64)))
    np.testing.assert_array_equal(planes.numpy(), want.astype(np.int64))
    back = np.asarray(jax.jit(jbitslice.planes_to_bytes)(jnp.asarray(want)))
    np.testing.assert_array_equal(tbitslice.planes_to_bytes(planes).numpy(), back.astype(np.int64))
    np.testing.assert_array_equal(back, a)


def test_sbox_bits_bp_vs_jax():
    assert tsbox.GATE_COUNT == jsbox.GATE_COUNT == 115
    assert tsbox.check()
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 32, size=(8, 16, 3), dtype=np.uint64).astype(np.uint32)
    want = jax.jit(lambda p: jnp.stack(jsbox.sbox_bits_bp(list(p))))(jnp.asarray(x))
    got = torch.stack(tsbox.sbox_bits_bp(list(torch.from_numpy(x.astype(np.int64)))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_generated_header_is_current():
    """csrc/sbox_bp_gates.cuh == what the generator prints from the gate list:
    one lop3 a table of the gates' cover, and the tables as written compute
    the gate list's outputs on all 256 bytes."""
    spec = importlib.util.spec_from_file_location(
        "gen_sbox_bp_cuh", ROOT / "tools" / "gen_sbox_bp_cuh.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    text = gen.render()
    assert gen.TARGET.read_text() == text
    cover = gen.lop3_cover()
    tables = [ln for ln in text.splitlines() if ln.startswith("  const uint32_t r") and "x[" not in ln]
    assert len(tables) == len(cover) < tsbox.GATE_COUNT
    parsed = []
    for ln in tables:
        dst, lut, args = re.fullmatch(r"  const uint32_t r(\d+) = lop3<0x(\w\w)>\((.*)\);", ln).groups()
        parsed.append((int(dst), tuple(int(a.strip()[1:]) for a in args.split(",")), int(lut, 16)))
    every = (1 << 256) - 1
    planes = [sum((x >> k & 1) << x for x in range(256)) for k in range(8)]
    assert gen.run_cover(parsed, planes, every) == tsbox.sbox_bits_bp(planes)
