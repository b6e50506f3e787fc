"""AuthService — PASETO v2.local token mint/verify, wire-compatible with
the reference (src/service/auth_service.cpp):

- token format: PASETO v2.local (XChaCha20-Poly1305; service/paseto.py,
  pure Python in the port, tokens string-equal to the JAX package's)
- 16-byte payload: user_id (u64 LE) || unix_seconds (i64 LE)  (:11-38)
- footer "herdsman"  (:9)
- single hardcoded credential: authentication_token == "admin==true"
  -> user_id 0  (:50-51)
- lifetime check: session_start + lifetime > now  (:94-100)

Key derivation: the reference loads the config secret with
`paseto_v2_local_load_key_base64` (src/utils/paseto_utils.cpp:15), i.e.
the secret IS the base64 of a 32-byte key.  A secret that decodes to
exactly 32 bytes is used as-is (wire-compatible with a reference server
sharing the same config); any other string is stretched with SHA-256 (the
reference would reject it at startup — we accept it for ergonomics and
log the deviation).
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import hashlib
import logging
import struct
import time

from herdsman_tpu_torch.service import paseto
from herdsman_tpu_torch.service.errors import InvalidTokenException

log = logging.getLogger("herdsman.auth")

_FOOTER = b"herdsman"
_PAYLOAD = struct.Struct("<Qq")  # user_id u64, unix seconds i64


@dataclasses.dataclass(frozen=True)
class AuthToken:
    user_id: int
    session_start: int


def _derive_key(secret_key: str) -> bytes:
    try:
        raw = base64.b64decode(secret_key, validate=True)
        if len(raw) == 32:
            return raw
    except (binascii.Error, ValueError):
        pass
    log.debug("security.secret_key is not base64 of 32 bytes; deriving "
              "the v2.local key with SHA-256 (reference servers require "
              "a paseto_v2_local_load_key_base64-compatible secret)")
    return hashlib.sha256(secret_key.encode()).digest()


class AuthService:
    def __init__(self, secret_key: str, token_lifetime: int = 43200):
        self._key = _derive_key(secret_key)
        self._lifetime = int(token_lifetime)

    # ---- credential check (reference :44-56) ----

    def authenticate(self, authentication_token: str) -> str:
        if authentication_token != "admin==true":
            raise InvalidTokenException("invalid credentials")
        return self.create_token(user_id=0)

    # ---- token mint/verify ----

    def create_token(self, user_id: int, now: int | None = None) -> str:
        now = int(time.time()) if now is None else int(now)
        payload = _PAYLOAD.pack(user_id, now)
        return paseto.encrypt(payload, self._key, footer=_FOOTER)

    def decode_token(self, token: str) -> AuthToken:
        try:
            payload = paseto.decrypt(token, self._key, footer=_FOOTER)
        except paseto.PasetoError as e:
            raise InvalidTokenException(str(e)) from e
        if len(payload) != _PAYLOAD.size:
            raise InvalidTokenException("bad token payload length")
        user_id, start = _PAYLOAD.unpack(payload)
        return AuthToken(user_id, start)

    def validate_token(self, token: str, now: int | None = None) -> AuthToken:
        """decode + lifetime check (reference :94-100)."""
        t = self.decode_token(token)
        now = int(time.time()) if now is None else int(now)
        if not t.session_start + self._lifetime > now:
            raise InvalidTokenException("token expired")
        return t
