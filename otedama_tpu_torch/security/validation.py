"""Input validation for everything that crosses a trust boundary
(counterpart of ``otedama_tpu/security/validation.py``, copied whole).

Reference parity: internal/security/input_validation.go (rule-registry
validator with SQL-injection / path-traversal / command-injection pattern
checks, length and charset rules). Redesigned for this framework's actual
surfaces: stratum JSON-RPC fields (hex blobs, worker names), API JSON
bodies (size/depth caps), and filesystem-adjacent strings.

Every check raises ``ValidationError`` with a stable, non-echoing message
(attacker input is never reflected back verbatim — length only).
"""

from __future__ import annotations

import json
import re
import string

MAX_JSON_BYTES = 64 * 1024
MAX_JSON_DEPTH = 8
MAX_JSON_KEYS = 256

_HEX = set(string.hexdigits)
# worker/user names: wallet-dot-rig convention; same shape the reference
# allows (alphanumeric + . _ - ), bounded length
_WORKER_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")

_SQL_PATTERNS = (
    re.compile(r"(?i)\b(union\s+select|insert\s+into|drop\s+table|delete\s+from)\b"),
    re.compile(r"(?i)('|\")\s*(or|and)\s+\d+\s*=\s*\d+"),
    re.compile(r"--\s*$"),
)
_PATH_PATTERNS = (
    re.compile(r"\.\.[\\/]"),
    re.compile(r"^[\\/]etc[\\/]"),
    re.compile(r"\x00"),
)
_CMD_PATTERNS = (
    re.compile(r"[;&|`$]"),
    re.compile(r"\$\("),
)


class ValidationError(ValueError):
    """Input failed validation; message is safe to send to the peer."""


def validate_hex(value: str, *, exact_bytes: int | None = None,
                 max_bytes: int = 1024, field: str = "field") -> bytes:
    """Hex string -> bytes, enforcing shape before any decoding."""
    if not isinstance(value, str):
        raise ValidationError(f"{field}: not a string")
    if len(value) % 2 != 0:
        raise ValidationError(f"{field}: odd-length hex")
    if len(value) > max_bytes * 2:
        raise ValidationError(f"{field}: too long ({len(value) // 2} bytes)")
    if not set(value) <= _HEX:
        raise ValidationError(f"{field}: non-hex characters")
    raw = bytes.fromhex(value)
    if exact_bytes is not None and len(raw) != exact_bytes:
        raise ValidationError(
            f"{field}: expected {exact_bytes} bytes, got {len(raw)}"
        )
    return raw


def validate_worker_name(value: str) -> str:
    if not isinstance(value, str) or not _WORKER_RE.match(value):
        raise ValidationError("worker name: 1-128 chars of [A-Za-z0-9._-]")
    return value


def validate_int(value, *, lo: int, hi: int, field: str = "field") -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValidationError(f"{field}: not an integer")
    if not lo <= value <= hi:
        raise ValidationError(f"{field}: out of range [{lo}, {hi}]")
    return value


def contains_injection(value: str) -> str | None:
    """Return the matched THREAT CLASS name (never the payload) or None."""
    for pat in _SQL_PATTERNS:
        if pat.search(value):
            return "sql"
    for pat in _PATH_PATTERNS:
        if pat.search(value):
            return "path-traversal"
    for pat in _CMD_PATTERNS:
        if pat.search(value):
            return "command"
    return None


def sanitize_filename(name: str) -> str:
    """Strip directory components and dangerous characters; parity with
    the reference's SanitizeFilename (input_validation.go:495)."""
    name = name.replace("\\", "/").rsplit("/", 1)[-1]
    name = re.sub(r"[^A-Za-z0-9._-]", "_", name)
    return (name or "_")[:255]


def _depth(obj) -> int:
    """Iterative max nesting depth (recursion would be the very stack bomb
    the cap exists to stop)."""
    deepest = 0
    stack = [(obj, 1)]
    while stack:
        node, d = stack.pop()
        if isinstance(node, dict):
            deepest = max(deepest, d)
            stack.extend((v, d + 1) for v in node.values())
        elif isinstance(node, list):
            deepest = max(deepest, d)
            stack.extend((v, d + 1) for v in node)
    return deepest


def _count_keys(obj) -> int:
    total = 0
    stack = [obj]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            total += len(node)
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
    return total


def validate_json_body(raw: bytes, *, max_bytes: int = MAX_JSON_BYTES,
                       max_depth: int = MAX_JSON_DEPTH,
                       max_keys: int = MAX_JSON_KEYS):
    """Parse an untrusted JSON body with resource caps (a 100 MB or
    1000-level-deep body must fail with ValidationError, never with a
    RecursionError escaping the handler)."""
    if len(raw) > max_bytes:
        raise ValidationError(f"body too large ({len(raw)} bytes)")
    try:
        obj = json.loads(raw)
    except json.JSONDecodeError:
        raise ValidationError("malformed json") from None
    except RecursionError:
        # CPython's C scanner recurses per nesting level; a bracket bomb
        # inside the byte cap can still trip the interpreter limit
        raise ValidationError("json nesting too deep") from None
    if _depth(obj) > max_depth:
        raise ValidationError("json nesting too deep")
    if _count_keys(obj) > max_keys:
        raise ValidationError("too many json keys")
    return obj


class InputValidator:
    """Rule-registry validator (parity: InputValidator.RegisterRule /
    Validate, input_validation.go:259-434). Rules are callables raising
    ``ValidationError``; ``validate`` returns (ok, error-message)."""

    def __init__(self):
        self.rules: dict[str, callable] = {}
        self.stats = {"validated": 0, "rejected": 0}
        self.register("worker", validate_worker_name)
        self.register("hex", validate_hex)

    def register(self, name: str, rule) -> None:
        self.rules[name] = rule

    def validate(self, name: str, value, **kw) -> tuple[bool, str]:
        rule = self.rules.get(name)
        if rule is None:
            return False, f"unknown rule {name!r}"
        try:
            rule(value, **kw)
        except ValidationError as e:
            self.stats["rejected"] += 1
            return False, str(e)
        self.stats["validated"] += 1
        return True, ""
