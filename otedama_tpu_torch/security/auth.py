"""Authentication: HS256 JWTs, scrypt password hashing, TOTP 2FA, RBAC
(counterpart of ``otedama_tpu/security/auth.py``).

Reference parity: internal/auth/authentication.go:20-135 (JWT + bcrypt
login — bcrypt is not in the python stdlib, so password hashing uses
hashlib.scrypt, a deliberately stronger memory-hard KDF), mfa_totp.go:20-57
(RFC 6238 TOTP), rbac.go (role -> permission map). Pure stdlib.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import hashlib
import hmac
import json
import os
import struct
import time


class TokenError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_encode(claims: dict, secret: str, ttl_seconds: float = 3600.0) -> str:
    header = {"alg": "HS256", "typ": "JWT"}
    body = dict(claims)
    now = int(time.time())
    body.setdefault("iat", now)
    body.setdefault("exp", now + int(ttl_seconds))
    signing = _b64url(json.dumps(header).encode()) + "." + _b64url(
        json.dumps(body).encode()
    )
    sig = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
    return signing + "." + _b64url(sig)


def jwt_decode(token: str, secret: str) -> dict:
    try:
        signing, _, sig_part = token.rpartition(".")
        header_part, _, body_part = signing.partition(".")
        header = json.loads(_b64url_decode(header_part))
        if header.get("alg") != "HS256":
            raise TokenError(f"unsupported alg {header.get('alg')!r}")
        expect = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
        if not hmac.compare_digest(expect, _b64url_decode(sig_part)):
            raise TokenError("bad signature")
        claims = json.loads(_b64url_decode(body_part))
    except (ValueError, KeyError, TypeError) as e:
        raise TokenError(f"malformed token: {e}") from None
    if claims.get("exp", 0) < time.time():
        raise TokenError("expired")
    return claims


# -- passwords ----------------------------------------------------------------

def hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt if salt is not None else os.urandom(16)
    digest = hashlib.scrypt(
        password.encode(), salt=salt, n=16384, r=8, p=1, maxmem=64 * 1024 * 1024
    )
    return f"scrypt$16384$8$1${salt.hex()}${digest.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, n, r, p, salt_hex, digest_hex = stored.split("$")
        digest = hashlib.scrypt(
            password.encode(), salt=bytes.fromhex(salt_hex),
            n=int(n), r=int(r), p=int(p), maxmem=64 * 1024 * 1024,
        )
        return hmac.compare_digest(digest, bytes.fromhex(digest_hex))
    except (ValueError, TypeError):
        return False


# -- TOTP (RFC 6238) ----------------------------------------------------------

def totp_code(secret_b32: str, at: float | None = None, period: int = 30,
              digits: int = 6) -> str:
    key = base64.b32decode(secret_b32.upper() + "=" * (-len(secret_b32) % 8))
    counter = int((at if at is not None else time.time()) // period)
    mac = hmac.new(key, struct.pack(">Q", counter), hashlib.sha1).digest()
    offset = mac[-1] & 0x0F
    code = (struct.unpack(">I", mac[offset : offset + 4])[0] & 0x7FFFFFFF) % (10 ** digits)
    return f"{code:0{digits}d}"


def totp_verify(secret_b32: str, code: str, at: float | None = None,
                period: int = 30, window: int = 1) -> bool:
    at = at if at is not None else time.time()
    return any(
        hmac.compare_digest(totp_code(secret_b32, at + k * period), code)
        for k in range(-window, window + 1)
    )


def totp_new_secret() -> str:
    return base64.b32encode(os.urandom(20)).decode().rstrip("=")


# -- RBAC ---------------------------------------------------------------------

class Role(enum.Enum):
    VIEWER = "viewer"
    OPERATOR = "operator"
    ADMIN = "admin"


_PERMISSIONS: dict[Role, set[str]] = {
    Role.VIEWER: {"stats.read"},
    Role.OPERATOR: {"stats.read", "mining.control", "pool.read",
                    "logs.read"},
    Role.ADMIN: {"stats.read", "mining.control", "pool.read", "pool.admin",
                 "config.write", "users.manage", "logs.read"},
}


def role_allows(role: Role, permission: str) -> bool:
    return permission in _PERMISSIONS.get(role, set())


# -- user store + manager -----------------------------------------------------

@dataclasses.dataclass
class User:
    name: str
    password_hash: str
    role: Role = Role.VIEWER
    totp_secret: str = ""      # empty = 2FA disabled


class AuthManager:
    """In-memory user registry issuing JWTs (persistence via db layer)."""

    def __init__(self, secret: str, token_ttl: float = 3600.0):
        if not secret:
            raise ValueError("auth secret must not be empty")
        self.secret = secret
        self.token_ttl = token_ttl
        self.users: dict[str, User] = {}
        self.failed_logins = 0

    def add_user(self, name: str, password: str, role: Role = Role.VIEWER,
                 enable_2fa: bool = False) -> User:
        user = User(
            name=name,
            password_hash=hash_password(password),
            role=role,
            totp_secret=totp_new_secret() if enable_2fa else "",
        )
        self.users[name] = user
        return user

    def login(self, name: str, password: str, totp: str = "") -> str:
        user = self.users.get(name)
        if user is None or not verify_password(password, user.password_hash):
            self.failed_logins += 1
            raise TokenError("bad credentials")
        if user.totp_secret and not totp_verify(user.totp_secret, totp):
            self.failed_logins += 1
            raise TokenError("bad 2fa code")
        return jwt_encode(
            {"sub": name, "role": user.role.value}, self.secret, self.token_ttl
        )

    def authorize(self, token: str, permission: str) -> dict:
        claims = jwt_decode(token, self.secret)
        try:
            role = Role(claims.get("role", ""))
        except ValueError:
            raise TokenError("unknown role") from None
        if not role_allows(role, permission):
            raise TokenError(f"role {role.value} lacks {permission}")
        return claims
