"""The tiling arithmetic of the tensor-core kernels K3 and K4
(c_lwe_snarks_tpu_torch/csrc/eval_fused.cu) and of their cipher core
(csrc/aes_core_cf.cuh), modelled on the CPU with the kernels' own index
formulas and held against the plain versions, tolerance 0.

A CUDA kernel cannot run without a card, so these models stand where
Pallas interpret mode stands for the TPU kernels: the same operand
layouts (reversed nibble rows and their byte-shifted copies, the B
registers read from them, the in-place AES blocks and the row skip of the
A registers, the 4 x 4 byte transpose and the row permutation of K3's
tiles, the PRMT selectors) written as numpy index arithmetic.  The
kernels themselves are held against the plain versions on a GPU in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from c_lwe_snarks_tpu_torch.ops import aes
from c_lwe_snarks_tpu_torch.ops import digits as dg
from c_lwe_snarks_tpu_torch.ops import eval_fused as tef
from c_lwe_snarks_tpu_torch.ops import sampling as tsam

torch.set_num_threads(1)

SEED = bytes(range(40))
CSRC = pathlib.Path(tef.__file__).resolve().parent.parent / "csrc"
U32 = np.uint32


@pytest.fixture(scope="module")
def key():
    return tsam.PRGKey(SEED, "cpu")


def constant(name: str) -> int:
    """An integer constexpr of eval_fused.cu."""
    m = re.search(rf"constexpr \w+ {name} = (\d+);", (CSRC / "eval_fused.cu").read_text())
    assert m, name
    return int(m.group(1))


def prmt(a, b, sel: int):
    """The PRMT instruction (__byte_perm): result byte i is byte
    (sel >> 4i) & 7 of the 8 bytes of a (0..3) and b (4..7)."""
    a, b = np.asarray(a, U32), np.asarray(b, U32)
    src = [(a >> U32(8 * i)) & U32(255) for i in range(4)]
    src += [(b >> U32(8 * i)) & U32(255) for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << U32(8 * i)
    return out


def stream_bytes(key, lo: int, hi: int) -> np.ndarray:
    """Keystream bytes [16 * (lo // 16), hi) and the byte position of the first."""
    base = lo // 16 * 16
    return aes.keystream_bytes_plain(key.aes, base, hi - base).numpy(), base


# ---- the cipher core -------------------------------------------------------


TABLE_ADDR = 0x10000  # the table's byte address in the shared-memory window


def cf_core_model(akey, ctrs: np.ndarray, lane: int = 5) -> np.ndarray:
    """uint32 [len(ctrs), 4] LE keystream words by the conflict-free core's
    arithmetic: one table in a byte-addressed window, entry x = 32 copies of
    Te0[x] then 32 of Te2[x]; a lookup address is one PRMT of the state word
    and the lane's constant; Te1, Te3 = Te0, Te2 rotated, one rotation a
    word; S[x] from byte 1 of Te0[x] in the last round; the last round key
    little-endian."""
    te = akey.te.numpy().astype(U32)
    window = np.zeros(2 * TABLE_ADDR // 4, U32)
    i = np.arange(256 * 64)
    window[TABLE_ADDR // 4:] = akey.tables32.numpy().view(U32)[((i & 32) << 4) + (i >> 6)]
    np.testing.assert_array_equal(window[TABLE_ADDR // 4:].reshape(256, 2, 32)[:, 0, lane], te[0])
    np.testing.assert_array_equal(window[TABLE_ADDR // 4:].reshape(256, 2, 32)[:, 1, lane], te[2])
    base = U32(TABLE_ADDR | (lane << 2))
    te0 = lambda s, sel: window[prmt(s, base, sel) // 4]
    te2 = lambda s, sel: window[(prmt(s, base, sel) + 128) // 4]
    rk = np.frombuffer(akey.rk_param, "<u4")
    bswap = lambda x: prmt(x, 0, 0x0123)
    ones = np.ones(len(ctrs), U32)
    s = [bswap(U32(akey.nonce_lo) * ones) ^ rk[0], bswap(U32(akey.nonce_hi) * ones) ^ rk[1],
         bswap((ctrs & 0xFFFFFFFF).astype(U32)) ^ rk[2], bswap((ctrs >> 32).astype(U32)) ^ rk[3]]
    for r in range(1, 14):
        s = [te0(s[c], 0x7634) ^ te2(s[(c + 2) % 4], 0x7614) ^ rk[4 * r + c]
             ^ prmt(te0(s[(c + 1) % 4], 0x7624) ^ te2(s[(c + 3) % 4], 0x7604), 0, 0x0321)
             for c in range(4)]
    out = []
    for c in range(4):
        lo = prmt(te0(s[c], 0x7634), te0(s[(c + 1) % 4], 0x7624), 0x5151)
        hi = prmt(te0(s[(c + 2) % 4], 0x7614), te0(s[(c + 3) % 4], 0x7604), 0x5151)
        out.append(prmt(lo, hi, 0x5410) ^ rk[56 + c])
    return np.stack(out, axis=1)


def test_lookup_address_is_one_byte_permute():
    """(window byte 2, state byte, 4 * lane): the address of entry x, word lane."""
    for lane in (0, 7, 31):
        base = U32(TABLE_ADDR | (lane << 2))
        s = U32(0xA1B2C3D4)
        for sel, x in ((0x7634, 0xA1), (0x7624, 0xB2), (0x7614, 0xC3), (0x7604, 0xD4)):
            assert int(prmt(s, base, sel)) == TABLE_ADDR + 256 * x + 4 * lane


@pytest.mark.parametrize("start", [0, (1 << 32) - 3, (1 << 33) + 11])
def test_cipher_core_arithmetic(key, start):
    ctrs = start + np.arange(70, dtype=np.uint64)
    want = aes.keystream_words_plain(key.aes, start, 70).numpy().reshape(70, 4)
    np.testing.assert_array_equal(cf_core_model(key.aes, ctrs).astype(np.int64), want)


def test_round_key_parameter(key):
    rk = np.frombuffer(key.aes.rk_param, "<u4").astype(np.int64)
    assert len(key.aes.rk_param) == 240
    np.testing.assert_array_equal(rk[:56], key.aes.rk.numpy()[:56])
    np.testing.assert_array_equal(prmt(rk[56:].astype(U32), 0, 0x0123), key.aes.rk.numpy()[56:])


# ---- K4: the banded product ------------------------------------------------

ENC_DRAWS = 8
BAND_STRIDE = 184


def nibble(sk: np.ndarray, nib: int) -> np.ndarray:
    return (sk >> 4) if nib else (sk & 15)


def reversed_rows(sk_nib: np.ndarray) -> np.ndarray:
    """[8, 184]: r_j[x] = nib(sk[j, 87 - x]) for x < 88, zeros after, and
    zero rows for the draws a short tile lacks."""
    r = np.zeros((ENC_DRAWS, BAND_STRIDE), np.int64)
    r[: len(sk_nib), :88] = sk_nib[:, ::-1]
    return r


def band_direct(sk_nib: np.ndarray) -> np.ndarray:
    """Band[92j + k, t] = nib(sk[j, t - k]) for k < 88, t >= k, else 0: [736, 88]."""
    band = np.zeros((ENC_DRAWS * 92, 88), np.int64)
    for j in range(len(sk_nib)):
        for k in range(88):
            band[92 * j + k, k:] = sk_nib[j, : 88 - k]
    return band


def band_from_b_registers(sk_nib: np.ndarray):
    """The band a tile's MMAs see, assembled from the kernel's B registers.
    A draw j is contracted as three chunks of 32 bytes at digits k0 = 0, 32,
    64 (the third runs 4 bytes into the next draw's stream bytes, where draw
    j's band row is zero padding); for half h, thread-in-group t4, column
    tile nt >= k0 / 8 and group g the register is the word of the
    byte-shifted copy (3 - g) & 3 at byte j * 184 + k0 + 16 * h + 4 * t4 +
    boff - 8 * nt.  Returns ([736 + 4, 88], the tiles the kernel skips as a
    set of (draw, chunk, nt))."""
    r = reversed_rows(sk_nib)
    flat = np.concatenate([r.reshape(-1), np.zeros(8, np.int64)])
    copies = [flat[s: s + ENC_DRAWS * BAND_STRIDE] for s in range(4)]  # copy s, byte a = r[a + s]
    band = np.zeros((ENC_DRAWS * 92 + 4, 88), np.int64)
    skipped = set()
    for j in range(ENC_DRAWS):
        for ci, k0 in enumerate((0, 32, 64)):
            for nt in range(11):
                if nt < k0 // 8:
                    skipped.add((j, ci, nt))
                    continue
                for g in range(8):
                    shift = (3 - g) & 3
                    boff = 87 - g - shift
                    for h in range(2):
                        for t4 in range(4):
                            k = k0 + 16 * h + 4 * t4
                            addr = BAND_STRIDE * j + k + boff - 8 * nt
                            assert addr % 4 == 0 and 0 <= addr
                            assert addr // BAND_STRIDE == j and addr % BAND_STRIDE + 3 < BAND_STRIDE
                            # the chunk's A bytes are stream bytes 92 j + k ..; a row of
                            # the product gets what every chunk that reads it adds
                            band[92 * j + k: 92 * j + k + 4, 8 * nt + g] += copies[shift][addr: addr + 4]
    return band, skipped


@pytest.mark.parametrize("nib", [0, 1])
@pytest.mark.parametrize("n", [2, 6])
def test_k4_band_from_reversed_rows(n, nib):
    """Band[92j + k, t] = r_j[87 - t + k], dead bytes included, and the B
    registers read from the shifted copies give the same band; every tile
    the kernel skips is zero."""
    sk = np.random.default_rng(n).integers(0, 256, size=(n, 88), dtype=np.uint8)
    sk_nib = nibble(sk, nib).astype(np.int64)
    want = band_direct(sk_nib)
    r = reversed_rows(sk_nib)
    toeplitz = np.zeros_like(want)
    for j in range(ENC_DRAWS):
        for k in range(92):
            toeplitz[92 * j + k] = r[j, 87 - np.arange(88) + k]
    np.testing.assert_array_equal(toeplitz, want)
    got, skipped = band_from_b_registers(sk_nib)
    np.testing.assert_array_equal(got[:736], want)
    assert not got[736:].any()  # the last chunk's 4 bytes past the tile meet zeros
    assert len(skipped) == ENC_DRAWS * (4 + 8)
    for j, ci, nt in skipped:
        # draw j's rows of the chunk (the third chunk's last 4 bytes are draw j + 1's,
        # which that draw's first chunk contracts)
        assert not want[92 * j + 32 * ci: 92 * j + min(32 * ci + 32, 92), 8 * nt: 8 * nt + 8].any()


@pytest.mark.parametrize("nib", [0, 1])
@pytest.mark.parametrize("n", [2, 6])
def test_k4_product_equals_antidiagonal_sums(n, nib):
    """a_bytes @ Band equals the plain version's anti-diagonal sums."""
    rng = np.random.default_rng(10 * n + nib)
    sk = rng.integers(0, 256, size=(n, 88), dtype=np.uint8)
    a = rng.integers(0, 256, size=(5, ENC_DRAWS * 92), dtype=np.uint8)  # dead and stale bytes too
    band, _ = band_from_b_registers(nibble(sk, nib).astype(np.int64))
    got = a.astype(np.int64) @ band[:736]
    at = torch.from_numpy(a[:, : 92 * n].reshape(5, n, 92)[..., :88].copy()).to(torch.float64)
    sk_nib = torch.from_numpy(nibble(sk, nib).astype(np.float64))
    want = dg.antidiag_sums((at.transpose(1, 2) @ sk_nib).to(torch.int64))[..., :88]
    np.testing.assert_array_equal(got, want.numpy())


def k4_model(key, off: int, sk: np.ndarray, count: int, n: int) -> torch.Tensor:
    """encrypt_b_fused by the kernel's data path: AES blocks stored in place
    in a 752-byte tile row, A registers read as aligned words at the row's
    skip and funnel-shifted by offset & 3, tiles of 8 draws in three chunks
    a draw, band from the B registers, signed 32-bit sums."""
    sub = off & 3
    v = np.zeros((2, count, 88), np.int64)
    for j0 in range(0, n, ENC_DRAWS):
        draws = min(ENC_DRAWS, n - j0)
        nblk = (15 + draws * 92 + 15) // 16
        a = np.zeros((count, ENC_DRAWS * 92 + 4), np.int64)  # the last chunk reads 4 bytes on
        for ct in range(count):
            first = off + ct * 92 * n + 92 * j0
            row = np.full(752 + 4, 77, np.uint8)  # stale bytes where no block is written
            ks, base = stream_bytes(key, first, first // 16 * 16 + 16 * nblk)
            assert base == first // 16 * 16 and nblk <= 47
            row[: 16 * nblk] = ks
            words = row.view("<u4").astype(np.uint64)  # and one word of the next row
            at = ((first & 15) - sub) // 4 + np.arange(ENC_DRAWS * 92 // 4 + 1)
            assert ((first & 15) - sub) % 4 == 0 and at[-1] + (sub > 0) <= 188
            regs = words[at]
            if sub:  # __funnelshift_r(p[0], p[1], 8 * sub)
                regs = ((regs | (words[at + 1] << np.uint64(32))) >> np.uint64(8 * sub))
            regs = (regs & np.uint64(0xFFFFFFFF)).astype("<u4")
            a[ct] = regs.view(np.uint8)
        for nib in range(2):
            # a short last tile contracts every chunk: stale bytes meet a zero band
            band, _ = band_from_b_registers(nibble(sk[j0: j0 + draws], nib).astype(np.int64))
            v[nib] += a @ band
    assert v.max() < 1 << 31
    return dg.nibble_dot_planes(torch.from_numpy(v[0]), torch.from_numpy(v[1]))


@pytest.mark.parametrize("off", [0, 8, 13, 16 * 7 + 8])
@pytest.mark.parametrize("n", [2, 6, 11])
def test_k4_tiles_equal_plain(key, n, off):
    sk = np.random.default_rng(n + off).integers(0, 256, size=(n, 88), dtype=np.uint8)
    want = tef.encrypt_b_fused_plain(key, off, torch.from_numpy(sk), 5, n, 92 * n)
    assert torch.equal(k4_model(key, off, sk, 5, n), want)


def enc_grid(count: int, n: int):
    """cls_encrypt_b_fused's launch arithmetic: (blocks.x, blocks.y, draws a split)."""
    cts, target = constant("kEncCts"), 16 * 132
    gx = -(-count // cts)
    gy = -(-target // gx)
    split = -(-(-(-n // gy)) // ENC_DRAWS) * ENC_DRAWS
    return gx, -(-n // split), split


@pytest.mark.parametrize("count,n", [(87381, 1470), (1, 1470), (300, 6), (129, 19), (10 ** 6, 1470)])
def test_k4_draw_split_covers_every_draw(count, n):
    gx, gy, split = enc_grid(count, n)
    assert split % ENC_DRAWS == 0 and split % 4 == 0  # tiles keep their 16-byte phase
    assert (gy - 1) * split < n <= gy * split and gx * constant("kEncCts") >= count
    assert gy <= 65535


# ---- K3: the transposed tiles ----------------------------------------------

MAC_COLS, MAC_PAD, MAC_ROWS, MAC_STRIDE = 496, 512, 128, 36


def k3_model(key, off: int, coeffs: np.ndarray, n: int, r_begin: int, r_end: int,
             cols: int = MAC_COLS, lane0: int = 0, lanes: int | None = None,
             rows_per_tile: int = MAC_ROWS) -> np.ndarray:
    """int64 [4k, 92n]: the sums of one row segment by the kernel's data
    path: a lane encrypts one block column of 4 rows 4 apart, transposes
    the 4 x 4 bytes of each word with PRMTs and stores one word per byte
    column; the coefficient bytes take the same row permutation.  A block
    owns ``cols`` byte columns (the many-lane form: 240, in tiles of 256
    rows, a lane's 4 rows 128 apart taking words L and 32 + L) and reads
    the window of ``lanes`` lanes from ``lane0`` (by default all k), plane
    c * lanes + kk of its tile going to plane c * k + lane0 + kk."""
    k, d = coeffs.shape
    kw = k if lanes is None else lanes
    pad, nplanes = cols + 16, max(32, 4 * kw)
    R, stride = rows_per_tile, rows_per_tile // 4 + 4
    ctr_ct = 92 * n
    last_row = r_begin + -(-(r_end - r_begin) // R) * R  # dead lanes encrypt too
    ks, base = stream_bytes(key, off, off + last_row * ctr_ct + ctr_ct + 16 * 33)
    lane = np.arange(32)
    out = np.zeros((4 * k, ctr_ct), np.int64)
    for c0 in range(0, ctr_ct, cols):
        acc = np.zeros((nplanes, pad), np.int64)  # [plane, tile column]
        tile = np.full((pad, stride), 0x4D4D4D4D, U32)  # stale words
        for r0 in range(r_begin, r_end, R):
            rows = min(R, r_end - r0)
            cfb = np.zeros((nplanes, 4 * stride), np.int64)
            for rr in range(R):
                pos = (rr & ~15) | ((rr & 3) << 2) | ((rr >> 2) & 3)
                for kk in range(kw):
                    cw = int(coeffs[lane0 + kk, r0 + rr]) if rr < rows else 0
                    for c in range(4):
                        cfb[c * kw + kk, pos] = (cw >> (8 * c)) & 255
            for h in range(R // 128):
                row0 = r0 + 128 * h + 16 * (lane >> 2) + (lane & 3)
                live = row0 < r_end
                first0 = off + row0 * ctr_ct + c0
                skip = first0 & 15
                for b in range(pad // 16):
                    w = np.zeros((4, 32, 4), U32)  # [row i, lane, word]
                    for i in range(4):
                        ctr = ((first0 + 4 * i * ctr_ct) >> 4) + b
                        for ln in range(32):
                            at = 16 * int(ctr[ln]) - base
                            w[i, ln] = ks[at: at + 16].view("<u4")
                    for i in range(4):
                        t0, t1 = prmt(w[0, :, i], w[1, :, i], 0x5140), prmt(w[2, :, i], w[3, :, i], 0x5140)
                        t2, t3 = prmt(w[0, :, i], w[1, :, i], 0x7362), prmt(w[2, :, i], w[3, :, i], 0x7362)
                        o = [prmt(t0, t1, 0x5410), prmt(t0, t1, 0x7632),
                             prmt(t2, t3, 0x5410), prmt(t2, t3, 0x7632)]
                        for c in range(4):
                            col = 16 * b + 4 * i + c - skip
                            ok = live & (col >= 0) & (col < pad)
                            tile[col[ok], 32 * h + lane[ok]] = o[c][ok]
            tbytes = tile[:, : R // 4].copy().view(np.uint8).astype(np.int64)  # [column, permuted row]
            acc += cfb[:, :R] @ tbytes.T
            assert acc.max() < 1 << 31
        width = min(cols, ctr_ct - c0)
        for c in range(4):
            out[c * k + lane0: c * k + lane0 + kw, c0: c0 + width] = acc[c * kw: (c + 1) * kw, :width]
    return out


@pytest.mark.parametrize("off", [0, 40, 3])
def test_k3_tiles_equal_plain(key, off):
    """Two row tiles (one ragged), two column chunks, rows whose skips
    differ, dead bytes dropped at the store."""
    n, k, d = 6, 2, 150
    coeffs = np.random.default_rng(off).integers(0, 1 << 32, size=(k, d), dtype=np.int64)
    got = k3_model(key, off, coeffs, n, 0, d).reshape(4, k, n, 92)[..., :88]
    want = tef.eval_mac_planes_plain(key, off, torch.from_numpy(coeffs), n, 92 * n)
    np.testing.assert_array_equal(got, want.numpy())


def test_k3_segments_add_up(key):
    """Row segments that start at multiples of 128 sum to the whole sweep."""
    n, k, d = 2, 1, 300
    coeffs = np.random.default_rng(9).integers(0, 1 << 32, size=(k, d), dtype=np.int64)
    got = sum(k3_model(key, 8, coeffs, n, lo, min(d, lo + 128)) for lo in range(0, d, 128))
    want = tef.eval_mac_planes_plain(key, 8, torch.from_numpy(coeffs), n, 92 * n)
    np.testing.assert_array_equal(got.reshape(4, k, n, 92)[..., :88], want.numpy())


def test_k3_many_lane_tiles_equal_plain(key):
    """The many-lane form's data path on the wrapper's own segments: 240
    columns a block (three column blocks, the last ragged), a window of 10
    lanes (past the 8 of one tile set) over one section and of 2 over the
    other, segments of one tile and of 2 rows; coefficients zero outside
    their section, as the wrapper's caller promises."""
    n, k, d = 6, 12, 500
    sections = ((0, 130, 0, 10), (130, d, 10, 12))
    rng = np.random.default_rng(12)
    coeffs = np.zeros((k, d), np.int64)
    for r0, r1, l0, l1 in sections:
        coeffs[l0:l1, r0:r1] = rng.integers(0, 1 << 32, size=(l1 - l0, r1 - r0), dtype=np.int64)
    segs = tef.lane_segments(d, n, sections)
    assert [s[1] - s[0] for s in segs] == [130, 256, 114]
    got = sum(k3_model(key, 40, coeffs, n, r0, r1, cols=constant("kWideCols"), lane0=l0, lanes=w,
                       rows_per_tile=constant("kWideRows"))
              for r0, r1, l0, w in segs)
    want = tef.eval_mac_planes_plain(key, 40, torch.from_numpy(coeffs), n, 92 * n)
    np.testing.assert_array_equal(got.reshape(4, k, n, 92)[..., :88], want.numpy())


def test_many_lane_constants_match_the_wrapper():
    """The wrapper's schedule uses the kernel's own window, columns and table size."""
    assert constant("kWideLanes") == tef.WIDE_LANES == 20
    assert constant("kWideCols") == tef.WIDE_COLS and constant("kWideColsPad") == tef.WIDE_COLS + 16
    assert constant("kWideMaxSegments") == tef.MAX_SEGMENTS
    assert 4 * constant("kWideLanes") == 8 * constant("kWideTiles")
    assert tef.MAX_SEGMENT_ROWS == constant("kMacMaxSegment") and tef.WIDE_ROWS == constant("kWideRows")
    assert constant("kWideRows") % MAC_ROWS == 0


def test_k3_row_permutation_is_a_bijection():
    pos = [(rr & ~15) | ((rr & 3) << 2) | ((rr >> 2) & 3) for rr in range(MAC_ROWS)]
    assert sorted(pos) == list(range(MAC_ROWS))
    # word L of a column holds rows 16 * (L / 4) + L % 4 + {0, 4, 8, 12}, low byte first
    for ln in range(32):
        for i in range(4):
            assert pos[16 * (ln >> 2) + (ln & 3) + 4 * i] == 4 * ln + i


def mac_grid(d: int, n: int):
    """cls_eval_mac_planes's launch arithmetic: (blocks.x, blocks.y, rows a segment)."""
    gx = -(-92 * n // MAC_COLS)
    gy = -(-4096 // gx)
    gy = min(gy, -(-d // MAC_ROWS))
    gy = max(gy, -(-d // constant("kMacMaxSegment")))
    seg = -(-(-(-d // gy)) // MAC_ROWS) * MAC_ROWS
    return gx, -(-d // seg), seg


@pytest.mark.parametrize("d,n", [(1, 6), (300, 6), (87381, 1470), (1 << 16, 2), (150000, 2),
                                 (10 ** 7, 1470)])
def test_k3_segments_stay_inside_int32(d, n):
    gx, gy, seg = mac_grid(d, n)
    assert seg % MAC_ROWS == 0 and seg <= constant("kMacMaxSegment")
    assert (gy - 1) * seg < d <= gy * seg and gx * MAC_COLS >= 92 * n and gy <= 65535
    assert seg * 255 * 255 < 1 << 31


# ---- the signed bounds -----------------------------------------------------


def test_signed_bounds():
    """Signed 32-bit sums: K4's guard raises at the first n with
    n * 88 * 255 * 15 >= 2^31, and K3's segment of 32768 rows is inside
    rows * 255^2 < 2^31, which 33026 rows are not."""
    first = next(n for n in range(1, 10 ** 5) if n * 88 * 255 * 15 >= 1 << 31)
    assert first == 6380
    tef.check_enc_bound(first - 1)
    tef.check_enc_bound(1470)
    with pytest.raises(ValueError, match="signed 32-bit"):
        tef.check_enc_bound(first)
    seg = constant("kMacMaxSegment")
    assert seg == 32768
    assert seg * 255 ** 2 < 1 << 31 <= 33026 * 255 ** 2
    assert constant("kMacCols") == MAC_COLS and constant("kMacColsPad") == MAC_PAD
    assert constant("kMacRows") == MAC_ROWS and constant("kMacColStride") == MAC_STRIDE
    assert constant("kEncDraws") == ENC_DRAWS and constant("kEncBandStride") == BAND_STRIDE


def test_k4_guard_runs_before_any_launch(monkeypatch):
    """On a CUDA tensor the wrapper refuses an n past the signed bound before
    it builds, allocates or launches anything: with a stand-in for a CUDA
    tensor (no card here) and a launcher that fails the test if it is
    reached, the call raises the guard's ValueError."""
    import types

    from c_lwe_snarks_tpu_torch.ops import _build

    def launched(*args):
        raise AssertionError("the kernel was launched")

    monkeypatch.setattr(_build, "launch", launched)
    monkeypatch.setattr(_build, "library", launched)
    n, cuda = 6380, torch.device("cuda")
    sk = types.SimpleNamespace(device=cuda, dtype=torch.uint8, shape=(n, 88),
                               is_contiguous=lambda: True)
    before = dict(tef.LAUNCHES)
    with pytest.raises(ValueError, match="signed 32-bit"):
        tef.encrypt_b_fused(types.SimpleNamespace(device=cuda), 0, sk, 1, n, 92 * n)
    assert tef.LAUNCHES == before


@pytest.mark.parametrize("n", [6379, 6380])
def test_encrypt_auto_takes_scan_past_k4_bound(monkeypatch, key, n):
    """encrypt_section(impl="auto") sends an n past K4's signed bound to
    the scan path before any key or tensor decides it: with K4's wrapper
    replaced by one that fails past the bound, auto at n = 6,380 never
    reaches it and gives the scan path's bytes; at n = 6,379 it takes K4."""
    from c_lwe_snarks_tpu_torch.models import lwe as tlwe
    from c_lwe_snarks_tpu_torch.utils.params import Params

    reached = []
    real = tef.encrypt_b_planes  # K4's launching wrapper, which the fused path calls

    def k4(*args):
        reached.append(args[4])
        assert tef.fits_enc_bound(args[4]), "K4 reached past its bound"
        return real(*args)

    monkeypatch.setattr(tef, "encrypt_b_planes", k4)
    P = Params(d=16, m=8, n=n)
    gen = torch.Generator().manual_seed(n)
    sk = torch.randint(0, 256, (n, 88), generator=gen, dtype=torch.uint8)
    msgs = torch.randint(0, P.p, (3,), generator=gen)
    errs = torch.randint(0, 256, (3, 88), generator=gen, dtype=torch.uint8)
    auto = tlwe.encrypt_section(key, 8, sk, msgs, errs, P, impl="auto")
    assert reached == ([n] if n < 6380 else [])
    scan = tlwe.encrypt_section(key, 8, sk, msgs, errs, P, impl="scan")
    assert torch.equal(auto, scan)
