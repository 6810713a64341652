"""AES-CBC byte-stream encryption (ext/aes/gstaesenc.c, gstaesdec.c).

The reference wraps OpenSSL EVP AES-128/256-CBC; this is a from-spec
FIPS-197 implementation (numpy table S-box / key schedule) with the
element semantics transcribed:

- cipher: aes-128-cbc | aes-256-cbc (gstaeshelper.h:65-66)
- serialize-iv: prepend the 16-byte IV to the FIRST output buffer
  (gstaesenc.c:464-466); the decryptor reads it from the first input
- per-buffer-padding (default TRUE, gstaeshelper.h:73): PKCS7-pad every
  buffer; otherwise the CBC chain runs across buffers and only the final
  (EOS) buffer is padded — matching the enc element's
  awaiting_first_buffer / finalize split (gstaesenc.c:356,476-487)
- decrypt validates the PKCS7 value 1..16 and strips it
  (gstaesdec.c:487-500)

ECB decryption is vectorized across all blocks (CBC decrypt is
parallel); encryption chains block-by-block as CBC requires.
"""

from __future__ import annotations

import numpy as np

BLOCK = 16

_SBOX = np.zeros(256, np.uint8)
_INV_SBOX = np.zeros(256, np.uint8)


def _init_tables():
    # multiplicative inverse via exp/log tables over GF(2^8), generator 3
    exp = np.zeros(256, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    exp[255] = exp[0]
    for i in range(256):
        inv = 0 if i == 0 else exp[255 - log[i]]
        s = inv
        for _ in range(4):
            inv = ((inv << 1) | (inv >> 7)) & 0xFF
            s ^= inv
        s ^= 0x63
        _SBOX[i] = s
        _INV_SBOX[s] = i


_init_tables()


def _xtime(v: np.ndarray) -> np.ndarray:
    return (((v.astype(np.int32) << 1) ^
             np.where(v & 0x80, 0x1B, 0)) & 0xFF).astype(np.uint8)


def _gmul(v: np.ndarray, c: int) -> np.ndarray:
    out = np.zeros_like(v)
    cur = v
    while c:
        if c & 1:
            out = out ^ cur
        cur = _xtime(cur)
        c >>= 1
    return out


def expand_key(key: bytes) -> np.ndarray:
    """FIPS-197 key schedule -> [rounds+1, 4, 4] round keys
    (column-major state layout)."""
    nk = len(key) // 4
    rounds = {4: 10, 8: 14}[nk]
    w = [np.frombuffer(key[4 * i:4 * i + 4], np.uint8).copy()
         for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (rounds + 1)):
        t = w[i - 1].copy()
        if i % nk == 0:
            t = np.roll(t, -1)
            t = _SBOX[t]
            t[0] ^= rcon
            rcon = ((rcon << 1) ^ (0x11B if rcon & 0x80 else 0)) & 0xFF
        elif nk == 8 and i % nk == 4:
            t = _SBOX[t]
        w.append(w[i - nk] ^ t)
    rk = np.stack(w).reshape(rounds + 1, 4, 4)
    return rk.transpose(0, 2, 1)       # -> [r, row, col] state layout


_SHIFT = np.array([[0, 1, 2, 3]] * 4) * 4 + np.arange(4)[:, None]
_ROW_IDX = np.arange(4)[:, None]
_SHIFT_COLS = (np.arange(4)[None, :] + np.arange(4)[:, None]) % 4
_INV_SHIFT_COLS = (np.arange(4)[None, :] - np.arange(4)[:, None]) % 4


def _encrypt_blocks(blocks: np.ndarray, rk: np.ndarray) -> np.ndarray:
    """ECB encrypt [N, 16] u8 (vectorized over N)."""
    n = blocks.shape[0]
    st = blocks.reshape(n, 4, 4).transpose(0, 2, 1)    # [N, row, col]
    st = st ^ rk[0]
    rounds = rk.shape[0] - 1
    for r in range(1, rounds + 1):
        st = _SBOX[st]
        st = st[:, _ROW_IDX, _SHIFT_COLS]              # ShiftRows
        if r != rounds:
            a = st
            t = (_gmul(a[:, 0], 2) ^ _gmul(a[:, 1], 3) ^ a[:, 2] ^ a[:, 3],
                 a[:, 0] ^ _gmul(a[:, 1], 2) ^ _gmul(a[:, 2], 3) ^ a[:, 3],
                 a[:, 0] ^ a[:, 1] ^ _gmul(a[:, 2], 2) ^ _gmul(a[:, 3], 3),
                 _gmul(a[:, 0], 3) ^ a[:, 1] ^ a[:, 2] ^ _gmul(a[:, 3], 2))
            st = np.stack(t, axis=1)
        st = st ^ rk[r]
    return st.transpose(0, 2, 1).reshape(n, 16)


def _decrypt_blocks(blocks: np.ndarray, rk: np.ndarray) -> np.ndarray:
    n = blocks.shape[0]
    st = blocks.reshape(n, 4, 4).transpose(0, 2, 1)
    rounds = rk.shape[0] - 1
    st = st ^ rk[rounds]
    for r in range(rounds - 1, -1, -1):
        st = st[:, _ROW_IDX, _INV_SHIFT_COLS]          # InvShiftRows
        st = _INV_SBOX[st]
        st = st ^ rk[r]
        if r != 0:
            a = st
            t = (_gmul(a[:, 0], 14) ^ _gmul(a[:, 1], 11)
                 ^ _gmul(a[:, 2], 13) ^ _gmul(a[:, 3], 9),
                 _gmul(a[:, 0], 9) ^ _gmul(a[:, 1], 14)
                 ^ _gmul(a[:, 2], 11) ^ _gmul(a[:, 3], 13),
                 _gmul(a[:, 0], 13) ^ _gmul(a[:, 1], 9)
                 ^ _gmul(a[:, 2], 14) ^ _gmul(a[:, 3], 11),
                 _gmul(a[:, 0], 11) ^ _gmul(a[:, 1], 13)
                 ^ _gmul(a[:, 2], 9) ^ _gmul(a[:, 3], 14))
            st = np.stack(t, axis=1)
    return st.transpose(0, 2, 1).reshape(n, 16)


def _parse_hex(s: str, want: int, what: str) -> bytes:
    b = bytes.fromhex(s)
    if len(b) != want:
        raise ValueError(f"aes: {what} must be {2 * want} hex chars")
    return b


class AesEnc:
    """aesenc (gstaesenc.c)."""

    def __init__(self, key: str, iv: str, cipher: str = "aes-128-cbc",
                 serialize_iv: bool = False,
                 per_buffer_padding: bool = True):
        klen = {"aes-128-cbc": 16, "aes-256-cbc": 32}[cipher]
        self._rk = expand_key(_parse_hex(key, klen, "key"))
        self.iv = _parse_hex(iv, BLOCK, "iv")
        self.serialize_iv = serialize_iv
        self.per_buffer_padding = per_buffer_padding
        self._chain = np.frombuffer(self.iv, np.uint8)
        self._first = True
        self._rem = b""

    def _cbc(self, blocks: np.ndarray) -> np.ndarray:
        out = np.empty_like(blocks)
        prev = self._chain
        for i in range(blocks.shape[0]):
            prev = _encrypt_blocks((blocks[i] ^ prev)[None], self._rk)[0]
            out[i] = prev
        self._chain = prev
        return out

    def push(self, data: bytes) -> bytes:
        out = b""
        if self._first and self.serialize_iv:
            out += self.iv
        self._first = False
        if self.per_buffer_padding:
            # PKCS7 per buffer (full pad block when aligned); the CBC
            # chain still carries across buffers — the reference inits
            # the EVP ctx only on the first one (gstaesenc.c:459-467)
            pad = BLOCK - len(data) % BLOCK
            buf = data + bytes([pad]) * pad
        else:
            buf = self._rem + data
            cut = len(buf) - len(buf) % BLOCK
            self._rem = buf[cut:]
            buf = buf[:cut]
        blocks = np.frombuffer(buf, np.uint8).reshape(-1, BLOCK)
        return out + self._cbc(blocks).tobytes()

    def finish(self) -> bytes:
        """EOS: in stream mode, PKCS7-pad the remaining tail
        (gstaesenc.c:476-487)."""
        if self.per_buffer_padding:
            return b""
        pad = BLOCK - len(self._rem) % BLOCK
        buf = self._rem + bytes([pad]) * pad
        self._rem = b""
        blocks = np.frombuffer(buf, np.uint8).reshape(-1, BLOCK)
        return self._cbc(blocks).tobytes()


class AesDec:
    """aesdec (gstaesdec.c)."""

    def __init__(self, key: str, iv: str = "00" * BLOCK,
                 cipher: str = "aes-128-cbc",
                 serialize_iv: bool = False,
                 per_buffer_padding: bool = True):
        klen = {"aes-128-cbc": 16, "aes-256-cbc": 32}[cipher]
        self._rk = expand_key(_parse_hex(key, klen, "key"))
        self.iv = _parse_hex(iv, BLOCK, "iv")
        self.serialize_iv = serialize_iv
        self.per_buffer_padding = per_buffer_padding
        self._chain = np.frombuffer(self.iv, np.uint8)
        self._first = True
        self._pending = b""

    def _cbc_dec(self, buf: bytes) -> bytes:
        blocks = np.frombuffer(buf, np.uint8).reshape(-1, BLOCK)
        dec = _decrypt_blocks(blocks, self._rk)
        prevs = np.concatenate([self._chain[None], blocks[:-1]], axis=0)
        self._chain = blocks[-1].copy() if blocks.shape[0] else self._chain
        return (dec ^ prevs).tobytes()

    def _strip_pkcs7(self, plain: bytes) -> bytes:
        if not plain:
            return plain
        pad = plain[-1]
        if pad == 0 or pad > BLOCK:
            raise ValueError(f"aes: illegal PKCS7 padding value {pad} "
                             "(gstaesdec.c:492-495)")
        return plain[:-pad]

    def push(self, data: bytes) -> bytes:
        if self._first and self.serialize_iv:
            self._chain = np.frombuffer(data[:BLOCK], np.uint8)
            data = data[BLOCK:]
        self._first = False
        if len(data) % BLOCK:
            raise ValueError("aes: ciphertext not block aligned")
        if self.per_buffer_padding:
            return self._strip_pkcs7(self._cbc_dec(data))
        # stream mode: hold back the last block until we know whether it
        # is the padded tail (resolved at finish())
        buf = self._pending + data
        keep = BLOCK if len(buf) >= BLOCK else 0
        self._pending = buf[len(buf) - keep:]
        return self._cbc_dec(buf[:len(buf) - keep]) if len(buf) > keep \
            else b""

    def finish(self) -> bytes:
        if self.per_buffer_padding or not self._pending:
            return b""
        out = self._strip_pkcs7(self._cbc_dec(self._pending))
        self._pending = b""
        return out
