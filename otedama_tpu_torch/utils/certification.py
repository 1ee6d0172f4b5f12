"""Out-of-band certification artifact for gated (non-canonical) algorithms.

Problem (VERDICT r3 / kernels.x11 + kernels.ethash docstrings): x11's
simd512 stage and ethash's composition cannot be externally verified in
this zero-egress environment, so both register ``canonical=False`` and
the coin aliases / profit switcher refuse them. When real network vectors
ARE obtainable (operator drops in a vector file, or a deployment has
egress), ``tools/certify.py`` runs them and — on full pass — writes THIS
artifact. Kernel modules then flip their canonical gate at import.

Two-layer trust model:

- the artifact records WHICH vectors passed and a per-algorithm
  **fingerprint** of the implementation's observable behavior at
  certification time (x11: the Dash-genesis chain digest; ethash: a
  deterministic mini-trace digest on a tiny synthetic epoch);
- at import, the kernel RECOMPUTES its fingerprint and flips the gate
  only on a match — so editing the kernel after certification silently
  un-certifies it instead of shipping a drifted chain as canonical.

Artifact location: ``$OTEDAMA_CERT_PATH`` or ``certification.json`` next
to the repo root (the package's parent directory).

Reference parity: the reference has no certification machinery at all —
its x11 is a name-only registration (algorithm_simple_impls.go:84-101);
this gate-plus-artifact discipline is the honest upgrade.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib

log = logging.getLogger("otedama.utils.certification")

ARTIFACT_ENV = "OTEDAMA_CERT_PATH"
_DEFAULT = pathlib.Path(__file__).resolve().parents[2] / "certification.json"


def artifact_path() -> pathlib.Path:
    override = os.environ.get(ARTIFACT_ENV, "").strip()
    return pathlib.Path(override) if override else _DEFAULT


def load() -> dict:
    """The whole artifact ({} when absent/unreadable — absence is the
    normal state; certification is strictly opt-in)."""
    try:
        data = json.loads(artifact_path().read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def get(algorithm: str) -> dict | None:
    entry = load().get(algorithm.lower())
    return entry if isinstance(entry, dict) else None


def record(algorithm: str, payload: dict) -> pathlib.Path:
    """Merge one algorithm's certification into the artifact (atomic
    replace so a crashed writer can't leave a half-written gate file)."""
    path = artifact_path()
    data = load()
    data[algorithm.lower()] = payload
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    tmp.replace(path)
    log.info("recorded %s certification in %s", algorithm, path)
    return path
