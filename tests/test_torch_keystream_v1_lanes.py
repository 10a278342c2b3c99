"""Kernel K5 (``csrc/keystream_bitsliced.cu``) as the source lays it out,
emulated on the CPU and held against the JAX package, tolerance 0.

A CUDA kernel cannot run without a card, so this torch model stands where
Pallas interpret mode stands for the TPU kernel: the lanes are a tensor
dimension (a warp tile of 8 quads x 4 lanes, lane c holding state column
c as 32 planes), ShiftRows is a gather from lane (c + r) & 3, each lane
reads its round-key masks through the kernel's shared-memory layout, and
the output goes through the warp's swizzled staging buffer in the
kernel's store order.  The launch constants are read from the source.  The
model is held bit for bit against the plain version
(``keystream_blocks_v1_plain``), the JAX kernel
(``aes_pallas.keystream_blocks(version=1, interpret=True)``) and the host
oracle; the index arithmetic (grid, grid-stride loop, banks) is checked on
its own.  The kernel itself is held against the plain version on a GPU in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from c_lwe_snarks_tpu.ops import aes_pallas
from c_lwe_snarks_tpu.oracle import aes as host_aes
from c_lwe_snarks_tpu_torch.ops import aes as taes
from c_lwe_snarks_tpu_torch.ops.bitslice import transpose32

torch.set_num_threads(1)

SEED = bytes(range(40))
KEY32, NONCE = SEED[8:], int.from_bytes(SEED[:8], "little")
ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "c_lwe_snarks_tpu_torch" / "csrc" / "keystream_bitsliced.cu"
MASK32 = 0xFFFFFFFF
_spec = importlib.util.spec_from_file_location("gen_sbox_bp_cuh", ROOT / "tools" / "gen_sbox_bp_cuh.py")
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)
COVER = gen.lop3_cover()  # the S-box as csrc/sbox_bp_gates.cuh writes it


def constants() -> dict:
    """The integer constexprs of the source, evaluated in order."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr [\w:]+ (k\w+) = ([^;]+);", SOURCE.read_text()):
        expr = re.sub(r"\b0x([0-9A-Fa-f]+)u\b", r"0x\1", expr).replace("/", "//")
        env[name] = eval(expr, {}, dict(env))  # noqa: S307 (the repo's own source)
    return env


C = constants()
LANES, THREADS, MAX_GRID = C["kLanes"], C["kThreads"], C["kMaxGrid"]
WARPS, TILE = THREADS // 32, C["kTileBlocks"]
QUADS = 32 // LANES


@pytest.fixture(scope="module")
def tkey():
    return taes.make_key(SEED, "cpu")


# ---- the launch: grid, grid-stride loop over warp tiles --------------------


def grid(nblocks: int) -> int:
    """cls_keystream_blocks_v1's grid."""
    ntiles = -(-nblocks // TILE)
    return max(1, min(MAX_GRID, -(-ntiles // WARPS)))


def warp_tiles(nblocks: int) -> dict:
    """{(blockIdx, warp): [tiles in loop order]}: tile = blockIdx * kWarps +
    warp, then tile += gridDim * kWarps while tile < ntiles."""
    ntiles, g = -(-nblocks // TILE), grid(nblocks)
    return {(b, w): list(range(b * WARPS + w, ntiles, g * WARPS))
            for b in range(g) for w in range(WARPS)}


def lane_trips(nblocks: int) -> np.ndarray:
    """[grid, kThreads] loop trips of every thread, from its own index."""
    ntiles, g = -(-nblocks // TILE), grid(nblocks)
    first = np.arange(g)[:, None] * WARPS + (np.arange(THREADS)[None, :] >> 5)
    return np.maximum(0, -(-(ntiles - first) // (g * WARPS)))


# ---- the cipher on a warp tile, lanes as a dimension -----------------------


def smem_round_keys(key) -> np.ndarray:
    """uint32 [15, 8 (q), 4 (c), 4]: the kernel's shared-memory fill,
    plane p = 32c + 4q + t of round rnd at word rnd*128 + 16q + 4c + t."""
    src = key.rk_planes32.numpy().view(np.uint32).reshape(-1)
    smem = np.zeros_like(src)
    for i in range(src.size):
        p = i & 127
        smem[(i & ~127) | ((p & 31) >> 2) << 4 | (p >> 5) << 2 | (p & 3)] = src[i]
    return smem.reshape(15, 8, 4, 4)


def lane_masks(smem: np.ndarray, rnd: int) -> torch.Tensor:
    """int64 [4 (c), 32 (j)]: what round_key() loads: uint4 32*rnd + 4q + c."""
    rk4 = smem.reshape(-1, 4)
    m = np.stack([np.concatenate([rk4[32 * rnd + 4 * q + c] for q in range(8)]) for c in range(4)])
    return torch.from_numpy(m.astype(np.int64))


def initial_planes(key, start: int, tiles: np.ndarray) -> torch.Tensor:
    """int64 [T, 8 (quad), 4 (c), 32 (plane)] as initial_planes() builds them:
    w0 / w1 = word c of (nonce, base0) / (nonce, base0 + 32), off = base & 31,
    plane j = funnel(bit j of w0, bit j of w1, off), and for the low counter
    word (c = 2) bits 0..4 the pattern of bit j rotated by off."""
    pattern = [sum((x >> j & 1) << x for x in range(32)) for j in range(5)]
    s = torch.zeros(len(tiles), QUADS, LANES, 32, dtype=torch.int64)
    for i, t in enumerate(tiles):
        for q in range(QUADS):
            base = (start + int(t) * TILE + 32 * q) % (1 << 64)
            off = base & 31
            base0 = base - off
            base1 = (base0 + 32) % (1 << 64)
            for c in range(LANES):
                w0, w1 = [(key.nonce_lo, key.nonce_hi, b & MASK32, b >> 32)[c] for b in (base0, base1)]
                for j in range(32):
                    m0, m1 = (MASK32 * (w >> j & 1) for w in (w0, w1))
                    plane = ((m0 >> off) | (m1 << (32 - off))) & MASK32 if off else m0
                    if c == 2 and j < 5:
                        plane |= ((pattern[j] >> off) | (pattern[j] << (32 - off))) & MASK32
                    s[i, q, c, j] = plane
    return s


def shift_rows(s: torch.Tensor) -> torch.Tensor:
    """Row r of lane c from lane (c + r) & 3 of the same quad (__shfl_sync, width 4)."""
    out = s.clone()
    for r in range(1, 4):
        src = torch.tensor([(c + r) & 3 for c in range(LANES)])
        out[..., 8 * r : 8 * r + 8] = s[..., src, 8 * r : 8 * r + 8]
    return out


def sub_bytes(s: torch.Tensor) -> torch.Tensor:
    """The generated lookup-table cover of the S-box on each of the 4 bytes."""
    out = s.clone()
    for r in range(4):
        planes = gen.run_cover(COVER, [s[..., 8 * r + k] for k in range(8)], MASK32)
        for k in range(8):
            out[..., 8 * r + k] = planes[k]
    return out


def mix_columns_add_round_key(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The kernel's chains: a_{r+1} ^ u_{r+2} ^ xtime(u_r) ^ rk, u_r = a_r ^ a_{r+1}."""
    a = [s[..., 8 * r : 8 * r + 8] for r in range(4)]
    u = [a[r] ^ a[(r + 1) & 3] for r in range(4)]
    out = []
    for r in range(4):
        x = u[r]
        xt = [x[..., 7], x[..., 0] ^ x[..., 7], x[..., 1], x[..., 2] ^ x[..., 7],
              x[..., 3] ^ x[..., 7], x[..., 4], x[..., 5], x[..., 6]]
        out.append(a[(r + 1) & 3] ^ u[(r + 2) & 3] ^ torch.stack(xt, -1) ^ m[:, 8 * r : 8 * r + 8])
    return torch.cat(out, -1)


def cipher_tiles(key, start: int, tiles: np.ndarray) -> torch.Tensor:
    """int64 [T, 8, 4, 32]: after the last round's transpose, [..., c, b] =
    LE word c of block 32 * quad + b of the tile."""
    smem = smem_round_keys(key)
    s = initial_planes(key, start, tiles) ^ lane_masks(smem, 0)
    for rnd in range(1, 14):
        s = mix_columns_add_round_key(shift_rows(sub_bytes(s)), lane_masks(smem, rnd))
    s = shift_rows(sub_bytes(s)) ^ lane_masks(smem, 14)
    return transpose32(s.movedim(-1, 0)).movedim(0, -1)


def stage_and_store(words: torch.Tensor, tile: int, nblocks: int, out: np.ndarray,
                    written: np.ndarray) -> None:
    """One warp's staging buffer and its 16-byte stores: lane (q, c) writes
    word s[8h + l] at word 4 * (32q + (l ^ q)) + c + 32h, then lane L reads
    uint4 32i + (L ^ i) and stores it to block tile * 256 + 32i + L."""
    buf = np.full(4 * TILE, -1, dtype=np.int64)
    w = words.numpy()
    for q in range(QUADS):
        for c in range(LANES):
            for l in range(8):
                for h in range(4):
                    buf[4 * (32 * q + (l ^ q)) + c + 32 * h] = w[q, c, 8 * h + l]
    assert (buf >= 0).all()  # every word of the buffer written once a tile
    buf4 = buf.reshape(TILE, 4)
    for i in range(8):
        for lane in range(32):
            blk = tile * TILE + 32 * i + lane
            if blk < nblocks:
                out[blk] = buf4[32 * i + (lane ^ i)]
                written[blk] += 1


def k5_model(key, start: int, nblocks: int) -> torch.Tensor:
    """uint8 [nblocks, 16] as the kernel writes it, warp by warp."""
    out = np.zeros((nblocks, 4), dtype=np.int64)
    written = np.zeros(nblocks, dtype=np.int64)
    order = [t for tiles in warp_tiles(nblocks).values() for t in tiles]
    if order:
        words = cipher_tiles(key, start, np.array(order))
        for tile, w in zip(order, words):
            stage_and_store(w, tile, nblocks, out, written)
    assert (written == 1).all()  # each block stored once, none past the end
    return taes.words_to_bytes(torch.from_numpy(out))


def oracle(start: int, nblocks: int) -> np.ndarray:
    return host_aes.ctr_keystream(KEY32, NONCE, start, nblocks).reshape(nblocks, 16)


# ---- the model against the references ---------------------------------------

WRAP = (1 << 32) - 3  # the low word wraps after 3 blocks, inside the first group


@pytest.mark.parametrize("start,nblocks", [
    (12345, 31), (12345, 32), (7, 33),  # a ragged quad, a whole one
    (WRAP, 255), (WRAP - 64, 257),  # a ragged warp tile; the wrap inside a later group
    ((1 << 32) + 98765, THREADS * 8 + 5),  # a ragged CUDA block (4 warp tiles + 5), above 2^32
    (0, 0)])
def test_model_vs_plain_and_oracle(tkey, start, nblocks):
    got = k5_model(tkey, start, nblocks)
    assert got.dtype == torch.uint8 and got.shape == (nblocks, 16)
    assert torch.equal(got, taes.keystream_blocks_v1_plain(tkey, start, nblocks))
    np.testing.assert_array_equal(got.numpy(), oracle(start, nblocks))


@pytest.mark.parametrize("start,nblocks,tile_w", [(WRAP - 40, 300, 8), (12345, 33, 2)])
def test_model_vs_pallas_v1_interpret(tkey, start, nblocks, tile_w):
    want = aes_pallas.keystream_blocks(
        aes_pallas.make_key_pallas(SEED), start, nblocks, tile_w=tile_w, interpret=True, version=1)
    np.testing.assert_array_equal(k5_model(tkey, start, nblocks).numpy(), np.asarray(want))


# ---- the launch arithmetic ---------------------------------------------------


def test_launch_constants():
    """A quad a group, 8 groups a warp; 128 registers at most (4 CUDA blocks
    of kThreads an SM) and a grid-stride pass of 132 SMs' worth."""
    assert (LANES, QUADS, TILE) == (4, 8, 256)
    assert THREADS % 32 == 0 and C["kMinBlocks"] * THREADS * 128 <= 65536
    assert MAX_GRID == 132 * C["kMinBlocks"]


@pytest.mark.parametrize("nblocks", [1, 256, 257, THREADS * 8 + 1, MAX_GRID * WARPS * TILE + 3])
def test_grid_stride_takes_each_group_once(nblocks):
    tiles = sorted(t for ts in warp_tiles(nblocks).values() for t in ts)
    assert tiles == list(range(-(-nblocks // TILE)))
    groups = sorted(QUADS * t + q for t in tiles for q in range(QUADS) if QUADS * t + q < -(-nblocks // 32))
    assert groups == list(range(-(-nblocks // 32)))


@pytest.mark.parametrize("nblocks", [1, 33, 257, THREADS * 8 + 5, MAX_GRID * WARPS * TILE + 3])
def test_every_lane_reaches_every_shuffle(nblocks):
    """The loop's trips are the same for the 32 lanes of each warp, so every
    lane runs every __shfl_sync of the tiles its warp takes; in the last
    tile the lanes of groups past the end run too and store nothing."""
    trips = lane_trips(nblocks)
    per_warp = trips.reshape(trips.shape[0], WARPS, 32)
    assert (per_warp == per_warp[..., :1]).all()
    assert trips.sum() // 32 == -(-nblocks // TILE)
    for (b, w), tiles in warp_tiles(nblocks).items():
        assert len(tiles) == trips[b, 32 * w]


@pytest.mark.parametrize("nblocks,want", [(1, 1), (171, 1), (382292, 374), (2163840, MAX_GRID)])
def test_grid_is_no_wider_than_the_work(nblocks, want):
    """Setup's error draws (382,292 blocks) give 1,494 warp tiles, 374 CUDA
    blocks of 4 warps; a scan tile's 2,163,840 blocks fill the capped grid."""
    assert grid(nblocks) == want
    assert (grid(nblocks) - 1) * WARPS < -(-nblocks // TILE)  # every CUDA block has a tile


def test_masks_and_staging_hit_distinct_banks():
    """A quad's four 16-byte mask loads cover 16 banks (the 8 quads of a
    warp read the same words: a broadcast); each 32-lane staging store hits
    32 banks; each 8-lane phase of the 16-byte staging loads covers 32."""
    for rnd in range(15):
        for q in range(8):
            banks = {(4 * (32 * rnd + 4 * q + c) + t) % 32 for c in range(LANES) for t in range(4)}
            assert len(banks) == 16
    for l in range(8):
        for h in range(4):
            banks = {(4 * (32 * q + (l ^ q)) + c + 32 * h) % 32 for q in range(QUADS) for c in range(LANES)}
            assert len(banks) == 32
    for i in range(8):
        for phase in range(4):
            banks = {(4 * (32 * i + (lane ^ i)) + t) % 32 for lane in range(8 * phase, 8 * phase + 8)
                     for t in range(4)}
            assert len(banks) == 32
