"""PyTorch port vs the JAX package: AES-CTR keystream (K1, K2) and sampling.

The port's plain versions are held against the JAX Pallas kernels in
interpret mode, the JAX sampling layer and the host AES oracle, bit for
bit.  The CUDA kernels are held against the plain versions on a GPU in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.oracle import aes as host_aes
from c_lwe_snarks_tpu.ops import aes_pallas
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu_torch.ops import sampling as tsam

torch.set_num_threads(1)

SEED = bytes(range(40))
KEY32, NONCE = SEED[8:], int.from_bytes(SEED[:8], "little")
WRAP = (1 << 32) - 3  # counter low word wraps after 3 blocks


@pytest.fixture(scope="module")
def keys():
    return tsam.PRGKey(SEED, "cpu"), jsam.PRGKey(SEED)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("start,nblocks", [(12345, 96), (WRAP, 40)])
def test_keystream_words_vs_pallas_and_oracle(keys, start, nblocks):
    tkey, jkey = keys
    got = tsam.keystream_words(tkey, start, nblocks)
    want = aes_pallas.keystream_words(jkey.pallas_key, start, nblocks, tile_w=2, interpret=True)
    _eq(got, want)
    ref = host_aes.ctr_keystream(KEY32, NONCE, start, nblocks).view("<u4")
    _eq(got, ref)


def test_keystream_fold_p_vs_pallas(keys):
    """Odd pair count across the counter low-word wrap."""
    tkey, jkey = keys
    npairs = 2 * 64 + 17
    got = tsam.keystream_fold_p(tkey, WRAP, npairs)
    want = aes_pallas.keystream_fold_p(jkey.pallas_key, WRAP, npairs, tile_w=2, interpret=True)
    _eq(got, want)
    w = host_aes.ctr_keystream(KEY32, NONCE, WRAP, -(-npairs // 2)).view("<u4").astype(np.uint64)
    ref = ((w[1::2] << np.uint64(32)) | w[0::2]) % np.uint64((1 << 32) - 5)
    _eq(got, ref[:npairs])


@pytest.mark.parametrize("offset", [16 * 77, 16 * 77 + 8, 16 * 77 + 3, 16 * 77 + 13])
def test_keystream_bytes_any_alignment(keys, offset):
    tkey, _ = keys
    got = tsam.keystream_bytes(tkey, offset, 301)
    ks = host_aes.ctr_keystream(KEY32, NONCE, offset // 16, 21)
    _eq(got, ks[offset % 16 : offset % 16 + 301])


DRAWS = [(92, 88), (70, 69), (81, 81)]
SKIPS = [0, 8, 3]
JAX_ROWS = [(92, 88, 0), (70, 69, 8), (81, 81, 3)]
A_OFFSETS = [0, 552 * 3 + 8, 16 * 5 + 4]


@pytest.fixture(scope="module")
def jax_samples(keys):
    """The JAX sampling references of this file from ONE jit (one compile)."""
    _, jkey = keys

    @jax.jit
    def run():
        rows = [jsam.sample_digit_rows(jkey, 16 * 1001 + sk, 13, draw_bytes=db, ndigits=nd)
                for db, nd, sk in JAX_ROWS]
        return rows, jsam.expand_a(jkey, A_OFFSETS[1], 3, 6)

    return run()


@pytest.mark.parametrize("draw_bytes,ndigits", DRAWS)
@pytest.mark.parametrize("skip", SKIPS)
def test_sample_digit_rows_vs_oracle(keys, draw_bytes, ndigits, skip):
    """Word path (skip 0, 8) and byte path (odd skip); 70- and 81-byte
    draws follow the floor-byte rule."""
    tkey, _ = keys
    got = tsam.sample_digit_rows(tkey, 16 * 1001 + skip, 13, draw_bytes=draw_bytes, ndigits=ndigits)
    ks = host_aes.ctr_keystream(KEY32, NONCE, 1001, 80)[skip : skip + 13 * draw_bytes]
    _eq(got, ks.reshape(13, draw_bytes)[:, :ndigits])


@pytest.mark.parametrize("case", range(len(JAX_ROWS)))
def test_sample_digit_rows_vs_jax(keys, jax_samples, case):
    tkey, _ = keys
    db, nd, sk = JAX_ROWS[case]
    got = tsam.sample_digit_rows(tkey, 16 * 1001 + sk, 13, draw_bytes=db, ndigits=nd)
    _eq(got, jax_samples[0][case])


def test_expand_a_vs_jax(keys, jax_samples):
    tkey, _ = keys
    _eq(tsam.expand_a(tkey, A_OFFSETS[1], 3, 6), jax_samples[1])


@pytest.mark.parametrize("offset", A_OFFSETS)
def test_expand_a_vs_oracle(keys, offset):
    tkey, _ = keys
    ks = host_aes.ctr_keystream(KEY32, NONCE, offset // 16, 3 * 552 // 16 + 2)
    want = ks[offset % 16 : offset % 16 + 3 * 552].reshape(3, 6, 92)[..., :88]
    _eq(tsam.expand_a(tkey, offset, 3, 6), want)


def test_counter_helpers():
    assert tsam.split_offset(16 * ((1 << 32) + 5) + 9) == (9, (5, 1))
    assert tsam.advance_ctr((1 << 32) - 2, 7, 5) == (3, 8)
    lo, hi = jsam.advance_ctr(jnp.uint32((1 << 32) - 2), jnp.uint32(7), 5)
    assert (int(lo), int(hi)) == (3, 8)
