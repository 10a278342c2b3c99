"""AES-256-CTR keystream: kernels K1 (raw stream bytes), K2 (mod-p folds)
and K5 (the bitsliced raw keystream, ``keystream_blocks(version=1)``).

Port of ``c_lwe_snarks_tpu/ops/aes_pallas.py`` (``_kernel_v2``,
``_kernel_v2_fold`` and ``_kernel``) and ``ops/aes_tpu.py``.  The block
layout is the reference's ``nonce (8 B LE) || ctr64 (8 B LE)`` and the
keystream is the AES-256 encryption of consecutive counters.

K1 and K2 (``csrc/keystream.cu``) use the conflict-free T-table cipher of
``csrc/aes_core_cf.cuh`` (one replicated Te0/Te2 table in shared memory,
the standard round keys from ``utils/aes_host.key_expansion`` as a kernel
parameter); their plain versions run the textbook four-table rounds as
torch gathers.  K5 (``csrc/keystream_bitsliced.cu``) is a table-free
bitsliced cipher: 128 bit planes per group of 32 blocks, split over a
quad of lanes (lane c holds state column c; ShiftRows is a shuffle), the
115-gate S-box of ``ops/sbox_bp.py`` as three-input lookup tables and
round keys as 0 / ~0 plane masks with the S-box constant 0x63 folded into
rounds 1..14; its plain version runs the same gates on tensors.

Each kernel writes what its callers read: K1 and K5 the stream's bytes,
uint8 ``[nblocks, 16]`` (``keystream_words`` is the same memory viewed as
words), K2 uint32 words < p, the type of the SSP's v (and of the TPU
kernel's output), straight into the caller's tensor if it passes
``out=``.  No torch pass follows a kernel, with one exception:
``keystream_words`` widens K1's words to int64 after the launch.  Nothing
in the protocol calls it on a CUDA key.

Each wrapper takes the plain version for a key on the CPU and launches
the CUDA kernel for a key on a CUDA device; ``LAUNCHES`` counts the
kernel launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import aes_host as host_aes
from ..utils import spans
from . import _build, sbox_bp
from .bitslice import transpose32

MASK32 = 0xFFFFFFFF
LAUNCHES = spans.count_launches(
    {"keystream_words": 0, "keystream_fold_p": 0, "keystream_blocks_v1": 0})


@dataclasses.dataclass(frozen=True)
class AESKey:
    """Round keys and T-tables of one AES-256-CTR stream, on one device."""

    nonce_lo: int  # LE word of nonce bytes 0..3
    nonce_hi: int  # LE word of nonce bytes 4..7
    rk: torch.Tensor  # int64 [60]: big-endian round-key words
    te: torch.Tensor  # int64 [4, 256]: T-tables Te0..Te3
    sbox: torch.Tensor  # int64 [256]
    tables32: torch.Tensor  # int32 [1280]: Te0..Te3 then the S-box (kernels K1..K4)
    rk_planes: torch.Tensor  # int64 [15, 128]: 0 / 2^32-1 masks, plane 8 * byte + bit
    rk_planes32: torch.Tensor  # int32 [15, 128] (kernel K5)
    # host bytes of 60 uint32: rk[0..55], then round key 14 as little-endian
    # words (the kernel parameter of K1..K4)
    rk_param: bytes

    @property
    def device(self) -> torch.device:
        return self.rk.device


def _t_tables() -> np.ndarray:
    """uint32 [5, 256]: Te0..Te3 and the S-box, from the generated S-box."""
    s = host_aes.sbox().astype(np.uint32)
    x2 = ((s << 1) ^ np.where(s & 0x80, 0x11B, 0)).astype(np.uint32) & 0xFF
    x3 = x2 ^ s
    te0 = (x2 << 24) | (s << 16) | (s << 8) | x3
    ror = lambda v, r: ((v >> r) | (v << (32 - r))) & MASK32
    return np.stack([te0, ror(te0, 8), ror(te0, 16), ror(te0, 24), s]).astype(np.uint32)


def _rk_planes(rks: np.ndarray) -> np.ndarray:
    """Round-key bytes [15, 16] -> uint32 [15, 128] bit-plane masks (0 / ~0).

    Plane 8 * i + k is bit k (LSB first) of byte i.  Round keys 1..14 also
    carry the S-box constant: the bitsliced circuit computes S(x) ^ 0x63,
    and a uniform 0x63 state passes ShiftRows and MixColumns unchanged, so
    flipping those planes of every later round key cancels it exactly.
    """
    bits = (rks[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1  # [15, 16, 8]
    const = (sbox_bp.AFFINE_CONST >> np.arange(8)) & 1
    bits[1:] ^= const.astype(np.uint8)
    return (bits.reshape(15, 128).astype(np.uint32) * np.uint32(MASK32))


def make_key(seed: bytes, device) -> AESKey:
    """seed = 8 nonce bytes (LE) || 32 key bytes."""
    assert len(seed) == 40
    rks = host_aes.key_expansion(bytes(seed[8:]))  # [15, 16] bytes
    planes = _rk_planes(rks)
    rk = rks.reshape(60, 4).astype(np.uint32)
    rk = (rk[:, 0] << 24) | (rk[:, 1] << 16) | (rk[:, 2] << 8) | rk[:, 3]
    tables = _t_tables()
    rk64 = torch.tensor(rk.astype(np.int64), device=device)
    tab64 = torch.tensor(tables.astype(np.int64), device=device)
    return AESKey(
        nonce_lo=int.from_bytes(seed[0:4], "little"),
        nonce_hi=int.from_bytes(seed[4:8], "little"),
        rk=rk64,
        te=tab64[:4],
        sbox=tab64[4],
        tables32=torch.tensor(tables.reshape(-1).view(np.int32), device=device),
        rk_planes=torch.tensor(planes.astype(np.int64), device=device),
        rk_planes32=torch.tensor(planes.view(np.int32), device=device),
        rk_param=rk[:56].astype("<u4").tobytes() + rks[14].tobytes(),
    )


# --------------------------------------------------------------------------
# Plain versions (torch gathers over the same T-table rounds).
# --------------------------------------------------------------------------


def _bswap(x: torch.Tensor) -> torch.Tensor:
    return (
        ((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF)
    )


def _encrypt_ctr_plain(key: AESKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """int64 [nblocks, 4]: LE keystream words of counters start..start+n."""
    if start_ctr + nblocks > 1 << 63:
        raise ValueError("counter beyond 2^63 is not supported by the plain path")
    ctr = start_ctr + torch.arange(nblocks, dtype=torch.int64, device=key.device)
    te, sb, rk = key.te, key.sbox, key.rk
    be = lambda w: int.from_bytes(w.to_bytes(4, "little"), "big")
    s = [
        torch.full_like(ctr, be(key.nonce_lo)) ^ rk[0],
        torch.full_like(ctr, be(key.nonce_hi)) ^ rk[1],
        _bswap(ctr & MASK32) ^ rk[2],
        _bswap(ctr >> 32) ^ rk[3],
    ]

    def b(x, sh):
        return (x >> sh) & 0xFF

    for r in range(1, 14):
        s = [
            te[0][b(s[c], 24)] ^ te[1][b(s[(c + 1) % 4], 16)]
            ^ te[2][b(s[(c + 2) % 4], 8)] ^ te[3][b(s[(c + 3) % 4], 0)]
            ^ rk[4 * r + c]
            for c in range(4)
        ]
    out = [
        (sb[b(s[c], 24)] << 24) ^ (sb[b(s[(c + 1) % 4], 16)] << 16)
        ^ (sb[b(s[(c + 2) % 4], 8)] << 8) ^ sb[b(s[(c + 3) % 4], 0)]
        ^ rk[56 + c]
        for c in range(4)
    ]
    return torch.stack([_bswap(w) for w in out], dim=1)


def keystream_words_plain(key: AESKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """int64 [4 * nblocks] LE keystream words (plain torch)."""
    return _encrypt_ctr_plain(key, start_ctr, nblocks).reshape(-1)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """int64 LE words [..., w] -> uint8 stream bytes [..., 4w]."""
    shifts = torch.arange(4, device=words.device) * 8
    return ((words[..., None] >> shifts) & 255).to(torch.uint8).reshape(
        *words.shape[:-1], 4 * words.shape[-1])


def keystream_bytes_plain(key: AESKey, byte_offset: int, nbytes: int) -> torch.Tensor:
    """uint8 stream bytes [byte_offset, byte_offset + nbytes) (plain torch)."""
    skip = byte_offset % 16
    words = keystream_words_plain(key, byte_offset // 16, -(-(skip + nbytes) // 16))
    return words_to_bytes(words)[skip : skip + nbytes]


def check_fold_out(out: torch.Tensor, npairs: int, device: torch.device) -> None:
    """Raise unless ``out`` can take K2's folds in place: uint32 [npairs],
    contiguous, on the key's device, 8-byte aligned (the kernel stores 8
    bytes an AES block).  No quiet copy is made for any other tensor."""
    if out.dtype != torch.uint32 or tuple(out.shape) != (npairs,):
        raise ValueError(f"out: expected uint32 ({npairs},), got {out.dtype} {tuple(out.shape)}")
    if out.device != device or not out.is_contiguous():
        raise ValueError(f"out: expected a contiguous tensor on {device}, got one on "
                         f"{out.device} with strides {out.stride()}")
    if out.data_ptr() % 8:
        raise ValueError("out: expected an 8-byte aligned tensor")


def keystream_fold_p_plain(
    key: AESKey, start_ctr: int, npairs: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """uint32 [npairs]: (w[2k+1] * 2^32 + w[2k]) mod p over the stream,
    written into ``out`` if given (the TPU kernel's type)."""
    if out is not None:
        check_fold_out(out, npairs, key.device)
    w = keystream_words_plain(key, start_ctr, -(-npairs // 2))[: 2 * npairs]
    w = w.reshape(npairs, 2)
    folds = ((w[:, 1] * 5 + w[:, 0]) % ((1 << 32) - 5)).to(torch.uint32)
    return folds if out is None else out.copy_(folds)


def keystream_blocks_v1_plain(key: AESKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """uint8 [nblocks, 16] keystream of counters start..start+n: the
    bitsliced circuit of kernel K5 on int64 tensors (plain torch).

    The state is 8 bit planes of shape [16, G], rows = state byte i (FIPS
    input order, i = r + 4c), one word per group of 32 consecutive blocks,
    bit b of a word = block b of the group.
    """
    groups = -(-nblocks // 32)
    if start_ctr + 32 * groups > 1 << 63:
        raise ValueError("counter beyond 2^63 is not supported by the plain path")
    dev = key.device
    ctr = start_ctr + torch.arange(32 * groups, dtype=torch.int64, device=dev)
    ctr = ctr.reshape(groups, 32).T  # [32 (block b), G]
    nonce = key.nonce_lo | (key.nonce_hi << 32)
    nonce_planes = torch.tensor(
        [MASK32 * ((nonce >> j) & 1) for j in range(64)], dtype=torch.int64, device=dev)
    state = torch.cat([
        nonce_planes[:, None].expand(64, groups),  # bytes 0..7
        transpose32(ctr & MASK32),  # bytes 8..11: plane j = counter bit j
        transpose32(ctr >> 32),  # bytes 12..15
    ]).reshape(16, 8, groups)
    rk = key.rk_planes.reshape(15, 16, 8, 1)
    planes = [state[:, k] ^ rk[0, :, k] for k in range(8)]

    # ShiftRows: new[r][c] = old[r][(c + r) % 4] as a gather of rows i = r + 4c
    shift = torch.tensor([(i % 4) + 4 * ((i // 4 + i % 4) % 4) for i in range(16)], device=dev)

    def mix_columns(x):
        """x: [16, G] -> per column new_r = a_r ^ t ^ xtime(a_r ^ a_{r+1})."""
        a = [p.reshape(4, 4, groups) for p in x]  # [c, r, G]
        u = [p ^ torch.roll(p, -1, dims=1) for p in a]
        t = [(p[:, 0] ^ p[:, 1] ^ p[:, 2] ^ p[:, 3])[:, None] for p in a]
        xt = [u[7], u[0] ^ u[7], u[1], u[2] ^ u[7], u[3] ^ u[7], u[4], u[5], u[6]]
        return [(a[k] ^ t[k] ^ xt[k]).reshape(16, groups) for k in range(8)]

    for rnd in range(1, 15):
        planes = [p[shift] for p in sbox_bp.sbox_bits_bp(planes)]
        if rnd < 14:
            planes = mix_columns(planes)
        planes = [p ^ rk[rnd, :, k] for k, p in enumerate(planes)]

    # planes 32w .. 32w + 31 of the [128, G] state are the bits of LE word w
    bits = torch.stack(planes, dim=1).reshape(4, 32, groups)
    words = torch.stack([transpose32(bits[w]) for w in range(4)])  # [w, b, G]
    words = words.permute(2, 1, 0).reshape(32 * groups, 4)[:nblocks]
    return words_to_bytes(words)


# --------------------------------------------------------------------------
# Kernel wrappers.
# --------------------------------------------------------------------------


def _check_ctr(start_ctr: int, count: int) -> None:
    if not 0 <= start_ctr < 1 << 64 or count < 0:
        raise ValueError((start_ctr, count))


def _require_cuda(key: AESKey) -> None:
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")


def keystream_blocks_v2(key: AESKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """uint8 [nblocks, 16] keystream bytes of counters start..start+n.

    K1: on a CUDA key, one kernel launch (``csrc/keystream.cu``), which
    writes the stream bytes themselves."""
    _check_ctr(start_ctr, nblocks)
    if key.device.type == "cpu":
        return words_to_bytes(_encrypt_ctr_plain(key, start_ctr, nblocks))
    _require_cuda(key)
    out = torch.empty(nblocks, 16, dtype=torch.uint8, device=key.device)
    if nblocks:
        _build.launch(
            "cls_keystream_blocks", key.tables32, key.rk_param, key.nonce_lo,
            key.nonce_hi, start_ctr, nblocks, out,
        )
        LAUNCHES["keystream_words"] += 1
    return out


def keystream_words(key: AESKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """int64 [4 * nblocks] LE keystream words for counters start..start+n.

    K1's bytes viewed as words, then widened by a torch pass: the one
    wrapper with a pass behind its kernel.  It is kept for callers that want
    words; the protocol reads bytes (``keystream_blocks``)."""
    if key.device.type == "cpu":
        _check_ctr(start_ctr, nblocks)
        return keystream_words_plain(key, start_ctr, nblocks)
    return _build.words64(keystream_blocks_v2(key, start_ctr, nblocks).view(torch.int32).reshape(-1))


def keystream_fold_p(
    key: AESKey, start_ctr: int, npairs: int, out: torch.Tensor | None = None
) -> torch.Tensor:
    """uint32 [npairs] mod-p folds of consecutive u64-LE stream words.

    K2: on a CUDA key the fold runs inside the cipher kernel, so the raw
    keystream never reaches device memory, and the kernel writes the uint32
    words themselves.  ``out``, if given, receives them in place (see
    ``check_fold_out``; anything else raises) and is returned."""
    _check_ctr(start_ctr, npairs)
    if key.device.type == "cpu":
        return keystream_fold_p_plain(key, start_ctr, npairs, out)
    _require_cuda(key)
    if out is None:
        out = torch.empty(npairs, dtype=torch.uint32, device=key.device)
    check_fold_out(out, npairs, key.device)
    if npairs:
        _build.launch(
            "cls_keystream_fold_p", key.tables32, key.rk_param, key.nonce_lo,
            key.nonce_hi, start_ctr, npairs, out,
        )
        LAUNCHES["keystream_fold_p"] += 1
    return out


def keystream_blocks_v1(key: AESKey, start_ctr: int, nblocks: int) -> torch.Tensor:
    """uint8 [nblocks, 16] keystream bytes of counters start..start+n.

    K5: on a CUDA key, one launch of the bitsliced register cipher
    (``csrc/keystream_bitsliced.cu``), which writes the stream bytes
    themselves; it never gives way to K1 or to the plain version."""
    _check_ctr(start_ctr, nblocks)
    if key.device.type == "cpu":
        return keystream_blocks_v1_plain(key, start_ctr, nblocks)
    _require_cuda(key)
    out = torch.empty(nblocks, 16, dtype=torch.uint8, device=key.device)
    if nblocks:
        _build.launch(
            "cls_keystream_blocks_v1", key.rk_planes32, key.nonce_lo, key.nonce_hi,
            start_ctr, nblocks, out,
        )
        LAUNCHES["keystream_blocks_v1"] += 1
    return out


def keystream_blocks(
    key: AESKey, start_ctr: int, nblocks: int, *, version: int = 2
) -> torch.Tensor:
    """uint8 [nblocks, 16] keystream bytes for counters [start, start+n).

    ``version == 2`` runs the T-table kernel K1; any other version runs
    the bitsliced kernel K5.  Both give the same bytes."""
    if version == 2:
        return keystream_blocks_v2(key, start_ctr, nblocks)
    return keystream_blocks_v1(key, start_ctr, nblocks)


def keystream_bytes(key: AESKey, byte_offset: int, nbytes: int) -> torch.Tensor:
    """Keystream bytes [byte_offset, byte_offset + nbytes); offset % 16 == 0.

    (``sampling.keystream_bytes`` takes any alignment.)"""
    if byte_offset % 16:
        raise ValueError("section base must be block aligned")
    return keystream_blocks(key, byte_offset // 16, -(-nbytes // 16)).reshape(-1)[:nbytes]
