"""Hash kernels: plain PyTorch versions and the hand-written CUDA kernels
that replace them on the card."""

from __future__ import annotations

import threading


class LaunchCounter:
    """Thread-safe count of a kernel's launches (or of a plain version's
    calls). The engine launches from executor threads, so a bare ``+= 1``
    could lose updates."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n
