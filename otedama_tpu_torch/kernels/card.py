"""What ``nvidia-smi`` reads of the card while a measurement runs."""

from __future__ import annotations

import statistics
import subprocess
import threading


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line, or ``?``."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return "?"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


class Sampler:
    """``clocks.sm``, ``power.draw`` and ``temperature.gpu`` every
    ``period`` seconds while the ``with`` block runs."""

    def __init__(self, period: float = 0.2):
        self.rows: list[tuple[float, float, float]] = []
        self._period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            row = smi("clocks.sm,power.draw,temperature.gpu").split(",")
            try:
                self.rows.append((float(row[0].split()[0]),
                                  float(row[1].split()[0]),
                                  float(row[2].split()[0])))
            except (ValueError, IndexError):
                pass
            self._stop.wait(self._period)

    def __enter__(self) -> "Sampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def summary(self) -> str:
        if not self.rows:
            return "clocks.sm and power.draw: no samples"
        mhz = [r[0] for r in self.rows]
        watts = [r[1] for r in self.rows]
        celsius = [r[2] for r in self.rows]
        return (f"{len(self.rows)} samples: clocks.sm median "
                f"{statistics.median(mhz):.0f} MHz (min {min(mhz):.0f}, max "
                f"{max(mhz):.0f}), power.draw median {statistics.median(watts):.1f}"
                f" W (max {max(watts):.1f}), temperature.gpu median "
                f"{statistics.median(celsius):.0f} C (max {max(celsius):.0f})")
