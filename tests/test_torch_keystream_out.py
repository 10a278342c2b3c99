"""PyTorch port vs the JAX package: what K1 and K2 hand to their callers.

K1 (``keystream_blocks``) gives the stream's bytes, uint8 [nblocks, 16];
``keystream_words`` is the same memory read as words.  K2
(``keystream_fold_p``) gives uint32 words, the TPU kernel's type, and,
with ``out=``, writes them into the caller's tensor: ``ssp.gen_v`` passes
each tile of v.  On the CPU
the wrappers run the plain versions; they are held, bit for bit
(tolerance 0), against the JAX Pallas kernels in interpret mode, the JAX
``random_ssp`` and the host oracle.

A CUDA kernel cannot run without a card, so the launch arithmetic of
``csrc/keystream.cu`` (the grid, the grid-stride loop, K2's stores and its
odd tail, the device form of the mod-p fold) is modelled here as numpy
index arithmetic with the source's own constants, in the manner of
tests/test_torch_mma_tiles.py.  The kernels themselves are held against
the plain versions on a GPU in tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax

from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import aes_pallas
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.oracle import aes as host_aes
from c_lwe_snarks_tpu_torch.models import ssp as tssp
from c_lwe_snarks_tpu_torch.ops import aes as taes
from c_lwe_snarks_tpu_torch.ops import modp as tmodp
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

SEED = bytes(range(40))
KEY32, NONCE = SEED[8:], int.from_bytes(SEED[:8], "little")
WRAP = (1 << 32) - 3  # counter low word wraps after 3 blocks
CSRC = pathlib.Path(taes.__file__).resolve().parent.parent / "csrc"
U32 = np.uint32
P32 = (1 << 32) - 5
SENTINEL = (1 << 32) - 7  # >= p: no fold takes it


@pytest.fixture(scope="module")
def tkey():
    return taes.make_key(SEED, "cpu")


@pytest.fixture(scope="module")
def jkey():
    return aes_pallas.make_key_pallas(SEED)


def oracle_folds(start: int, npairs: int) -> np.ndarray:
    w = host_aes.ctr_keystream(KEY32, NONCE, start, -(-npairs // 2)).view("<u4").astype(np.uint64)
    return (((w[1::2] << np.uint64(32)) | w[0::2]) % np.uint64(P32))[:npairs].astype(np.int64)


# ---- K1: bytes --------------------------------------------------------------


@pytest.mark.parametrize("start,nblocks", [(12345, 96), (WRAP, 40)])
def test_keystream_blocks_vs_pallas_and_oracle(tkey, jkey, start, nblocks):
    got = taes.keystream_blocks(tkey, start, nblocks)
    assert got.dtype == torch.uint8 and got.shape == (nblocks, 16)
    want = aes_pallas.keystream_blocks(jkey, start, nblocks, tile_w=2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = host_aes.ctr_keystream(KEY32, NONCE, start, nblocks).reshape(nblocks, 16)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("start,nblocks", [(12345, 96), (WRAP, 40), ((1 << 33) + 11, 7), (0, 0)])
def test_keystream_words_is_the_int32_view_of_the_bytes(tkey, start, nblocks):
    blocks = taes.keystream_blocks(tkey, start, nblocks)
    words = taes.keystream_words(tkey, start, nblocks)
    assert words.dtype == torch.int64 and words.shape == (4 * nblocks,)
    view = blocks.view(torch.int32).reshape(-1).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(words, view)


# ---- K2: uint32 words, out= -------------------------------------------------


@pytest.mark.parametrize("npairs", [2 * 64 + 16, 2 * 64 + 17])
def test_fold_p_out_into_the_middle_vs_pallas(tkey, jkey, npairs):
    """Even and odd pair counts across the low-word wrap, written between
    sentinels: the neighbours stay."""
    buf = torch.full((npairs + 6,), SENTINEL, dtype=torch.uint32)
    out = taes.keystream_fold_p(tkey, WRAP, npairs, out=buf[2 : 2 + npairs])
    assert out.data_ptr() == buf[2:].data_ptr() and out.shape == (npairs,)
    want = np.asarray(aes_pallas.keystream_fold_p(jkey, WRAP, npairs, tile_w=2, interpret=True))
    assert buf.numpy().dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(buf[2 : 2 + npairs].numpy(), want)
    np.testing.assert_array_equal(out.numpy(), oracle_folds(WRAP, npairs))
    assert bool((buf[:2] == SENTINEL).all()) and bool((buf[2 + npairs :] == SENTINEL).all())
    assert torch.equal(out, taes.keystream_fold_p(tkey, WRAP, npairs))


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("why", ["dtype", "int64", "length", "strided", "misaligned", "two-dimensional"])
def test_fold_p_refuses_an_out_it_cannot_write(tkey, why, plain):
    """No quiet copy: the wrapper and the plain version raise alike, on an
    int64 out= (the type K2 wrote before v was uint32) too."""
    bad = {
        "dtype": torch.empty(8, dtype=torch.int32),
        "int64": torch.empty(8, dtype=torch.int64),
        "length": torch.empty(6, dtype=torch.uint32),
        "strided": torch.empty(16, dtype=torch.uint32)[::2],
        "misaligned": torch.empty(10, dtype=torch.uint32)[1:9],
        "two-dimensional": torch.empty(2, 4, dtype=torch.uint32),
    }[why]
    fold = taes.keystream_fold_p_plain if plain else taes.keystream_fold_p
    with pytest.raises(ValueError, match="out:"):
        fold(tkey, 0, 8, out=bad)


def test_sampling_fold_p_passes_out_on(tkey):
    key = tsam.PRGKey(SEED, "cpu")
    buf = torch.full((12,), SENTINEL, dtype=torch.uint32)
    tsam.keystream_fold_p(key, 9, 7, out=buf[2:9])
    np.testing.assert_array_equal(buf[2:9].numpy(), oracle_folds(9, 7))
    assert buf[:2].tolist() == [SENTINEL] * 2 and buf[9:].tolist() == [SENTINEL] * 3


# ---- random_ssp: every tile of v written once, where it lives ---------------

TINY = Params(d=16, m=8, n=32)


@pytest.fixture(scope="module")
def jax_ssp():
    key = jsam.PRGKey(SEED)
    wits, inst = jax.jit(lambda: jssp.random_ssp(key, 0, TINY))()
    return np.asarray(wits), np.asarray(inst.t).astype(np.int64), np.asarray(inst.v).astype(np.int64)


@pytest.mark.parametrize("tile", [3, 5, 8, 1024])
def test_random_ssp_ragged_tiles_vs_jax(jax_ssp, monkeypatch, tile):
    """Tiles that do not divide the m = 8 rows (3, 5), one that does, and the
    release tile: the same SSP as the JAX package."""
    monkeypatch.setattr(tssp, "TILE", tile)
    wits, inst = tssp.random_ssp(tsam.PRGKey(SEED, "cpu"), 0, TINY)
    np.testing.assert_array_equal(wits.numpy(), jax_ssp[0])
    np.testing.assert_array_equal(inst.t.numpy(), jax_ssp[1])
    np.testing.assert_array_equal(inst.v.numpy(), jax_ssp[2])


def test_gen_v_hands_k2_each_tile_of_v(monkeypatch):
    """gen_v makes no tile tensor of its own: every K2 call gets a view of v,
    the views are disjoint and cover v."""
    calls = []
    real = tsam.keystream_fold_p

    def spy(key, start_ctr, npairs, out=None):
        calls.append((out.data_ptr(), npairs))
        return real(key, start_ctr, npairs, out)

    monkeypatch.setattr(tssp.sampling, "keystream_fold_p", spy)
    monkeypatch.setattr(tssp, "TILE", 3)
    key = tsam.PRGKey(SEED, "cpu")
    mask = torch.ones(8, dtype=torch.uint8)
    v, t = tssp.gen_v(key, 5, mask, 16)
    assert [n for _, n in calls] == [48, 48, 32]
    assert [ptr for ptr, _ in calls] == [v.data_ptr() + 4 * 16 * lo for lo in (0, 3, 6)]
    np.testing.assert_array_equal(v.reshape(-1).numpy(), oracle_folds(5, 8 * 16))
    np.testing.assert_array_equal(t.numpy(), v.numpy().sum(0) % P32)


# ---- the launch arithmetic of csrc/keystream.cu, modelled --------------------


def constant(name: str) -> int:
    """An integer constexpr of keystream.cu."""
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / "keystream.cu").read_text())
    assert m, name
    return int(m.group(1))


THREADS, MAX_GRID = constant("kThreads"), constant("kMaxGrid")


def grid_1d(items: int, threads: int, cap: int) -> int:
    """aes_core.cuh:grid_1d."""
    return max(1, min(cap, -(-items // threads)))


def grid_stride_items(nblocks: int) -> np.ndarray:
    """The AES blocks every thread of the launch takes, in launch order:
    i = blockIdx * kThreads + threadIdx, then i += gridDim * kThreads."""
    total = grid_1d(nblocks, THREADS, MAX_GRID) * THREADS
    passes = -(-nblocks // total)
    i = np.arange(total)[None, :] + total * np.arange(passes)[:, None]
    return i[i < nblocks]


def test_kernel_constants():
    """One CUDA block of 1024 threads an SM of the 132: a pass of the
    grid-stride loop takes 135,168 counters."""
    assert (THREADS, MAX_GRID) == (1024, 132)
    assert grid_stride_items(THREADS * MAX_GRID + 1)[-1] == THREADS * MAX_GRID


@pytest.mark.parametrize("nblocks", [1, 1023, 1025, 132 * 1024 + 7])
def test_grid_stride_covers_each_counter_once(nblocks):
    items = grid_stride_items(nblocks)
    np.testing.assert_array_equal(np.sort(items), np.arange(nblocks))


@pytest.mark.parametrize("nblocks,grid", [
    (1, 1), (171, 1), (1024, 1), (1025, 2), (382292, 132), (2163840, 132)])
def test_grid_is_no_wider_than_the_work(nblocks, grid):
    """The main path's small calls (8, 24 and 2,730 bytes: 1, 2 and 171
    blocks) fill one table, not 132."""
    assert grid_1d(nblocks, THREADS, MAX_GRID) == grid


def fold64_device(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """aes_core.cuh:fold64_mod_p: a 32 x 32 -> 64 bit multiply-add, then
    wrapping uint32 arithmetic."""
    t = hi.astype(np.uint64) * np.uint64(5) + lo.astype(np.uint64)
    tl, th = t.astype(U32), (t >> np.uint64(32)).astype(U32)
    r = tl + U32(5) * th
    r = np.where(r < tl, r + U32(5), r)
    return np.where(r >= U32(P32), r - U32(P32), r)


def test_device_fold_in_the_double_wrap_window():
    """lo + 5 * hi (low word) in [2^33 - 5, 2^33 - 2], at the edges of p, and
    where tl + 5 * th wraps (hi = 2^32 - 1 with lo within 25 of 2^32)."""
    edge = np.array([0, 1, 4, 5, P32 - 1, P32, P32 + 1, (1 << 32) - 1, 0x33333333, 0xCCCCCCCC,
                     0x33333332, 0xCCCCCCCD, 0x99999999, 0x66666666, (1 << 32) - 25, (1 << 32) - 20,
                     (1 << 32) - 6], dtype=np.uint64)
    hi, lo = (x.reshape(-1) for x in np.meshgrid(edge, edge))
    want = ((hi << np.uint64(32)) | lo) % np.uint64(P32)
    with np.errstate(over="ignore"):
        got = fold64_device(hi.astype(U32), lo.astype(U32))
    np.testing.assert_array_equal(got.astype(np.uint64), want)
    both = tmodp.fold64_mod_p(torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(both.numpy().astype(np.uint64), want)


def k2_model(tkey, start: int, npairs: int, buf: torch.Tensor, at: int) -> None:
    """keystream_fold_p_kernel's stores into buf[at : at + npairs], the
    uint32 words the kernel addresses: {f0, f1} an AES block, and f0 alone
    for the block that holds an odd count's last pair."""
    out = buf.numpy()[at:]  # the launcher's pointer
    w = taes.keystream_words_plain(tkey, start, (npairs + 1) // 2).numpy().astype(U32).reshape(-1, 4)
    with np.errstate(over="ignore"):
        f0, f1 = fold64_device(w[:, 1], w[:, 0]), fold64_device(w[:, 3], w[:, 2])
    for i in grid_stride_items((npairs + 1) // 2):
        if 2 * i + 1 < npairs:
            out[2 * i : 2 * i + 2] = (f0[i], f1[i])
        else:
            out[2 * i] = f0[i]


@pytest.mark.parametrize("start,npairs", [(3, 1), ((1 << 32) - 1, 2), (WRAP, 2001), (7, 2 * 1024 + 2)])
def test_k2_stores_write_exactly_npairs_words(tkey, start, npairs):
    buf = torch.full((npairs + 4,), SENTINEL, dtype=torch.uint32)
    k2_model(tkey, start, npairs, buf, 2)
    np.testing.assert_array_equal(buf[2 : 2 + npairs].numpy(), oracle_folds(start, npairs))
    assert buf[:2].tolist() == [SENTINEL] * 2 and buf[2 + npairs :].tolist() == [SENTINEL] * 2
    assert torch.equal(buf[2 : 2 + npairs], taes.keystream_fold_p_plain(tkey, start, npairs))
