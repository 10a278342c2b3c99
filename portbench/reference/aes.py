"""AES-256 in counter mode, written plainly in torch for the reference.

The block is ``nonce (8 bytes, as the seed gives them) || counter (8 bytes,
little-endian)``, the key the next 32 bytes of the 40-byte seed, and the
stream the AES-256 encryption of consecutive counters (FIPS-197).  The
rounds are the textbook four T-table rounds on big-endian column words,
each lookup one ``index_select``; nothing here is a kernel of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK = 16
CHUNK_BLOCKS = 1 << 23  # blocks a pass of the rounds takes at once


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _gmul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a, b = _xtime(a), b >> 1
    return r


@functools.cache
def sbox() -> tuple:
    """The S-box from its definition: inversion in GF(2^8), then the affine map."""
    inv = [0] * 256
    for x in range(1, 256):
        inv[x] = next(y for y in range(1, 256) if _gmul(x, y) == 1)
    out = []
    for x in range(256):
        b, s = inv[x], 0x63
        for k in range(5):
            s ^= ((b << k) | (b >> (8 - k))) & 0xFF
        out.append(s)
    return tuple(out)


def round_keys(key: bytes) -> list[int]:
    """The 60 big-endian words of the AES-256 key schedule (FIPS-197 5.2)."""
    assert len(key) == 32
    sb = sbox()
    w = [int.from_bytes(key[4 * i : 4 * i + 4], "big") for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = int.from_bytes(bytes(sb[b] for b in t.to_bytes(4, "big")), "big")
            t ^= rcon << 24
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = int.from_bytes(bytes(sb[b] for b in t.to_bytes(4, "big")), "big")
        w.append(w[i - 8] ^ t)
    return w


def _signed(words) -> np.ndarray:
    return np.asarray(words, dtype=np.uint64).astype(np.uint32).view(np.int32)


class Stream:
    """The keystream of one 40-byte seed on one device."""

    def __init__(self, seed: bytes, device):
        assert len(seed) == 40
        self.seed = bytes(seed)
        self.device = torch.device(device)
        sb = sbox()
        te0 = [(_xtime(s) & 0xFF) << 24 | s << 16 | s << 8 | (_xtime(s) & 0xFF) ^ s for s in sb]
        ror = lambda x, r: ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF
        tabs = [te0] + [[ror(x, 8 * k) for x in te0] for k in (1, 2, 3)]
        self.te = [torch.tensor(_signed(t), device=self.device) for t in tabs]
        self.sb = torch.tensor(sb, dtype=torch.uint8, device=self.device)
        rk = round_keys(self.seed[8:])
        self.rk = [int(x) for x in _signed(rk)]
        self.last = torch.tensor(
            np.frombuffer(b"".join(x.to_bytes(4, "big") for x in rk[56:]), dtype=np.uint8),
            device=self.device)
        self.head = [int(x) for x in _signed(
            [int.from_bytes(self.seed[0:4], "big"), int.from_bytes(self.seed[4:8], "big")])]

    def _encrypt(self, ctr: torch.Tensor) -> torch.Tensor:
        """uint8 [N, 16]: the stream blocks of int64 counters [N] (< 2^63)."""

        def word(x):  # the big-endian word of the counter's LE bytes, as int32
            x = ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF)
            return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)

        rk = self.rk
        s = [torch.full(ctr.shape, self.head[0] ^ rk[0], dtype=torch.int32, device=ctr.device),
             torch.full(ctr.shape, self.head[1] ^ rk[1], dtype=torch.int32, device=ctr.device),
             word(ctr & 0xFFFFFFFF) ^ rk[2], word(ctr >> 32) ^ rk[3]]

        def byte(x, k):  # byte k (0 = most significant) of int32 words, as indices
            return (x >> (24 - 8 * k)) & 0xFF if k < 3 else x & 0xFF

        for r in range(1, 14):
            s = [self.te[0].index_select(0, byte(s[c], 0))
                 ^ self.te[1].index_select(0, byte(s[(c + 1) % 4], 1))
                 ^ self.te[2].index_select(0, byte(s[(c + 2) % 4], 2))
                 ^ self.te[3].index_select(0, byte(s[(c + 3) % 4], 3))
                 ^ rk[4 * r + c] for c in range(4)]
        out = [self.sb.index_select(0, byte(s[(c + k) % 4], k)) ^ self.last[4 * c + k]
               for c in range(4) for k in range(4)]
        return torch.stack(out, dim=1)

    def blocks(self, ctr: torch.Tensor) -> torch.Tensor:
        """uint8 [N, 16]: the stream blocks of the int64 counters ctr [N]."""
        ctr = ctr.to(self.device, torch.int64).reshape(-1)
        if ctr.numel() and int(ctr.max()) >= 1 << 63:
            raise ValueError("counters must be below 2^63")
        parts = [self._encrypt(ctr[i : i + CHUNK_BLOCKS])
                 for i in range(0, ctr.numel(), CHUNK_BLOCKS)]
        return torch.cat(parts) if len(parts) != 1 else parts[0]

    def range_blocks(self, start: int, count: int) -> torch.Tensor:
        """uint8 [count, 16]: the blocks of counters [start, start + count)."""
        return self.blocks(start + torch.arange(count, dtype=torch.int64, device=self.device))

    def bytes(self, offset: int, nbytes: int) -> torch.Tensor:
        """uint8 [nbytes]: the stream's bytes [offset, offset + nbytes)."""
        first, skip = divmod(offset, BLOCK)
        count = -(-(skip + nbytes) // BLOCK)
        return self.range_blocks(first, count).reshape(-1)[skip : skip + nbytes]
