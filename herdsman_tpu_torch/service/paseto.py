"""PASETO v2.local — the port's copy of ``herdsman_tpu.service.paseto``,
with the whole AEAD in pure Python.

v2.local per the PASETO spec:

    token   = "v2.local." || b64url(n || c) [ || "." || b64url(footer) ]
    n       = BLAKE2b(message, key = 24 random bytes, outlen = 24)
    c       = XChaCha20-Poly1305(message, aad = PAE([h, n, footer]),
                                 nonce = n, key = k)       (combined ct||tag)
    PAE     = LE64(#pieces) || (LE64(len(p)) || p for each piece)

The JAX package takes ChaCha20-Poly1305 (RFC 8439) from ``cryptography``,
which the GPU machines the port runs on do not have.  Here the ChaCha20
keystream and Poly1305 (RFC 8439 §2.4-2.8) are written out over Python
ints beside HChaCha20, so the service imports with the standard library
alone.  Tokens are wire-identical to the JAX package's: the same
``nonce_key`` gives the same string, and each side decrypts the other's
(tests/test_torch_service.py).  Tokens carry 16-byte payloads, so the
pure-Python cost (a few ChaCha blocks per token) does not matter.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import struct

HEADER = "v2.local."

_MASK32 = 0xFFFFFFFF
_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _quarter(st: list[int], a: int, b: int, c: int, d: int) -> None:
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] = _rotl32(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] = _rotl32(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & _MASK32
    st[d] = _rotl32(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _MASK32
    st[b] = _rotl32(st[b] ^ st[c], 7)


def _chacha_rounds(state: list[int]) -> list[int]:
    """The 20-round ChaCha permutation (10 double rounds), NO final add."""
    st = list(state)
    for _ in range(10):
        _quarter(st, 0, 4, 8, 12)
        _quarter(st, 1, 5, 9, 13)
        _quarter(st, 2, 6, 10, 14)
        _quarter(st, 3, 7, 11, 15)
        _quarter(st, 0, 5, 10, 15)
        _quarter(st, 1, 6, 11, 12)
        _quarter(st, 2, 7, 8, 13)
        _quarter(st, 3, 4, 9, 14)
    return st


_SIGMA = struct.unpack("<IIII", b"expand 32-byte k")


def chacha20_block(key: bytes, counter: int, nonce12: bytes) -> bytes:
    """RFC 8439 §2.3 ChaCha20 block function."""
    state = list(_SIGMA) + list(struct.unpack("<8I", key)) + [counter] \
        + list(struct.unpack("<3I", nonce12))
    working = _chacha_rounds(state)
    out = [(w + s) & _MASK32 for w, s in zip(working, state)]
    return struct.pack("<16I", *out)


def chacha20_xor(key: bytes, counter: int, nonce12: bytes,
                 data: bytes) -> bytes:
    """RFC 8439 §2.4 encryption: ``data`` XOR the keystream from block
    ``counter`` on (decryption is the same call)."""
    out = bytearray()
    for i in range(0, len(data), 64):
        ks = chacha20_block(key, (counter + i // 64) & _MASK32, nonce12)
        out += bytes(x ^ y for x, y in zip(data[i:i + 64], ks))
    return bytes(out)


def poly1305(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5 one-time authenticator: 32-byte key -> 16-byte tag."""
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        n = int.from_bytes(msg[i:i + 16] + b"\x01", "little")
        acc = (acc + n) * r % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _aead_tag(key: bytes, nonce12: bytes, aad: bytes, ct: bytes) -> bytes:
    """RFC 8439 §2.8: Poly1305 under block 0's keystream over
    aad || pad || ct || pad || le64(len(aad)) || le64(len(ct))."""
    otk = chacha20_block(key, 0, nonce12)[:32]
    mac_data = (aad + _pad16(aad) + ct + _pad16(ct)
                + struct.pack("<QQ", len(aad), len(ct)))
    return poly1305(otk, mac_data)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 subkey derivation (draft-irtf-cfrg-xchacha §2.2): the
    ChaCha permutation WITHOUT the final state addition; the subkey is
    words 0-3 and 12-15."""
    assert len(key) == 32 and len(nonce16) == 16
    state = list(_SIGMA) + list(struct.unpack("<8I", key)) \
        + list(struct.unpack("<4I", nonce16))
    st = _chacha_rounds(state)
    return struct.pack("<8I", *(st[0:4] + st[12:16]))


def _xchacha_key_nonce(key: bytes, nonce24: bytes) -> tuple[bytes, bytes]:
    """XChaCha20-Poly1305 = ChaCha20-Poly1305 under the HChaCha20 subkey
    with nonce12 = 4 zero bytes || nonce24[16:24]."""
    return hchacha20(key, nonce24[:16]), b"\x00" * 4 + nonce24[16:]


def pae(pieces: list[bytes]) -> bytes:
    """Pre-Authentication Encoding (PASETO spec §2.2.1)."""
    out = struct.pack("<Q", len(pieces))
    for p in pieces:
        out += struct.pack("<Q", len(p)) + p
    return out


def _b64e(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _b64d(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def encrypt(message: bytes, key: bytes, footer: bytes = b"",
            nonce_key: bytes | None = None) -> str:
    """Mint a v2.local token.  `nonce_key` (the 24 random bytes keying the
    BLAKE2b nonce derivation) is overridable only for test vectors."""
    if len(key) != 32:
        raise ValueError("v2.local requires a 32-byte key")
    b = os.urandom(24) if nonce_key is None else nonce_key
    n = hashlib.blake2b(message, key=b, digest_size=24).digest()
    sub, nonce12 = _xchacha_key_nonce(key, n)
    pre = pae([HEADER.encode(), n, footer])
    ct = chacha20_xor(sub, 1, nonce12, message)
    c = ct + _aead_tag(sub, nonce12, pre, ct)
    body = _b64e(n + c)
    return HEADER + body + ("." + _b64e(footer) if footer else "")


class PasetoError(ValueError):
    pass


def decrypt(token: str, key: bytes, footer: bytes = b"") -> bytes:
    """Verify + decrypt a v2.local token; raises PasetoError on any
    malformation, footer mismatch, or authentication failure."""
    if len(key) != 32:
        raise ValueError("v2.local requires a 32-byte key")
    if not token.startswith(HEADER):
        raise PasetoError("bad token header")
    parts = token[len(HEADER):].split(".")
    if len(parts) not in (1, 2):
        raise PasetoError("bad token shape")
    try:
        body = _b64d(parts[0])
        token_footer = _b64d(parts[1]) if len(parts) == 2 else b""
    except Exception as e:
        raise PasetoError("bad token encoding") from e
    if token_footer != footer:
        raise PasetoError("bad token footer")
    if len(body) < 24 + 16:
        raise PasetoError("bad token length")
    n, c = body[:24], body[24:]
    sub, nonce12 = _xchacha_key_nonce(key, n)
    pre = pae([HEADER.encode(), n, footer])
    ct, tag = c[:-16], c[-16:]
    if not hmac.compare_digest(_aead_tag(sub, nonce12, pre, ct), tag):
        raise PasetoError("token forged or corrupted")
    return chacha20_xor(sub, 1, nonce12, ct)
