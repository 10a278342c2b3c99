"""Host-side AES-256 (numpy, generated tables): key schedule and referee.

The port's own copy of what it uses of ``c_lwe_snarks_tpu/oracle/aes.py``
(the two packages share no module): the S-box generated from the GF(2^8)
definition, the AES-256 key schedule that ``ops/aes.make_key`` runs on
the host, and a pure-numpy CTR keystream that the kernels are held
against.  Block layout as in the reference (src/aes.c:104-144): the CTR
block is ``nonce (8B LE) || counter (8B LE)`` and the keystream is the
AES-256-ECB encryption of consecutive counter blocks.
"""

from __future__ import annotations

import functools

import numpy as np

_AES_POLY = 0x11B  # Rijndael reduction polynomial x^8+x^4+x^3+x+1


def _gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= _AES_POLY
        b >>= 1
    return r


@functools.cache
def sbox() -> np.ndarray:
    """Forward AES S-box, generated from GF(2^8) inversion + affine map."""
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    out = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = inv[x]
        s = 0
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
            ) & 1
            s |= bit << i
        out[x] = s ^ 0x63
    return out


@functools.cache
def _xtime_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint16)
    t = (t << 1) ^ ((t >> 7) * 0x1B)
    return (t & 0xFF).astype(np.uint8)


def key_expansion(key: bytes) -> np.ndarray:
    """AES-256 key schedule -> [15, 16] round-key bytes (FIPS-197 §5.2)."""
    assert len(key) == 32
    sb = sbox()
    nk, nr = 8, 14
    w = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (nr + 1)):
        temp = list(w[i - 1])
        if i % nk == 0:
            temp = temp[1:] + temp[:1]  # RotWord
            temp = [int(sb[t]) for t in temp]  # SubWord
            temp[0] ^= rcon
            rcon = _gf_mul(rcon, 2)
        elif i % nk == 4:
            temp = [int(sb[t]) for t in temp]
        w.append([w[i - nk][j] ^ temp[j] for j in range(4)])
    flat = np.array(w, dtype=np.uint8).reshape(nr + 1, 16)
    return flat


def encrypt_blocks(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """AES-256 ECB encrypt a batch of blocks.

    blocks: [B, 16] uint8 (bytes in FIPS in[] order); returns [B, 16].
    Vectorized over the batch with numpy table lookups.
    """
    sb = sbox()
    xt = _xtime_table()
    assert blocks.ndim == 2 and blocks.shape[1] == 16
    # FIPS state: state[r, c] = in[r + 4c]; we keep [B, 4, 4] as [B, r, c].
    state = blocks.reshape(-1, 4, 4).transpose(0, 2, 1).copy()  # [B, r, c]
    rk = round_keys.reshape(15, 4, 4).transpose(0, 2, 1)  # [round, r, c]

    state ^= rk[0]
    for rnd in range(1, 15):
        # SubBytes
        state = sb[state]
        # ShiftRows: row r rotated left by r
        for r in range(1, 4):
            state[:, r, :] = np.roll(state[:, r, :], -r, axis=1)
        if rnd < 14:
            # MixColumns
            a = state
            t = a[:, 0] ^ a[:, 1] ^ a[:, 2] ^ a[:, 3]  # [B, c]
            new = a.copy()
            new[:, 0] ^= t ^ xt[a[:, 0] ^ a[:, 1]]
            new[:, 1] ^= t ^ xt[a[:, 1] ^ a[:, 2]]
            new[:, 2] ^= t ^ xt[a[:, 2] ^ a[:, 3]]
            new[:, 3] ^= t ^ xt[a[:, 3] ^ a[:, 0]]
            state = new
        state ^= rk[rnd]
    return state.transpose(0, 2, 1).reshape(-1, 16)


def _ctr_blocks(nonce: int, start_block: int, num_blocks: int) -> np.ndarray:
    """Counter-mode input blocks: bytes 0-7 nonce LE, 8-15 ctr LE."""
    ctrs = np.arange(start_block, start_block + num_blocks, dtype=np.uint64)
    blocks = np.zeros((num_blocks, 16), dtype=np.uint8)
    nonce_bytes = np.frombuffer(int(nonce).to_bytes(8, "little"), dtype=np.uint8)
    blocks[:, :8] = nonce_bytes
    for i in range(8):
        blocks[:, 8 + i] = ((ctrs >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
    return blocks


def ctr_keystream_numpy(key: bytes, nonce: int, start_block: int, num_blocks: int) -> np.ndarray:
    """Keystream bytes uint8 [16 * num_blocks] of counters [start, start + n)."""
    blocks = _ctr_blocks(nonce, start_block, num_blocks)
    return encrypt_blocks(blocks, key_expansion(key)).reshape(-1)
