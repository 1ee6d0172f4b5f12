"""Algorithm manager: backend selection, warm builds and benchmarks
(counterpart of ``otedama_tpu/engine/algo_manager.py``).

``"auto"`` means the card: it picks ``cuda`` (for scrypt, its default
``romix`` tier; for ethash, the epoch-managed backend over card tiers,
which owns the DAG's lifecycle across epochs) and raises when no CUDA
device is visible. The plain
version runs only when a caller asks for it with ``kind="torch"`` (and a
``device``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import logging
import time

import torch

from otedama_tpu_torch.engine import algos
from otedama_tpu_torch.runtime.search import make_backend, synthetic_job_constants

log = logging.getLogger("otedama.engine.algos")


@dataclasses.dataclass
class BenchmarkResult:
    algorithm: str
    backend: str
    hashes: int
    seconds: float

    @property
    def hashrate(self) -> float:
        return self.hashes / self.seconds if self.seconds > 0 else 0.0


class AlgorithmManager:
    """Builds, warms and benchmarks backends on one torch device."""

    def __init__(self, preferred_backend: str = "auto", device: str = "cuda"):
        self.preferred_backend = preferred_backend
        self.device = device
        # (algorithm, backend name) -> the last benchmark's result
        self.results: dict[tuple[str, str], BenchmarkResult] = {}

    def backend_for(self, algorithm: str, kind: str | None = None, **kwargs):
        """Instantiate the backend for an algorithm (``auto`` = ``cuda``)."""
        spec = algos.get(algorithm)
        if not spec.implemented():
            raise ValueError(f"algorithm {algorithm!r} has no implemented backend")
        kind = kind or self.preferred_backend
        if kind == "auto":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'auto' runs on the card, but "
                    "torch.cuda.is_available() is False; ask for the plain "
                    "version explicitly with kind='torch', device='cpu'"
                )
            kind = "cuda"
        if kind not in spec.backends:
            raise ValueError(
                f"backend {kind!r} does not implement {algorithm!r} "
                f"(available: {spec.backends})"
            )
        kwargs.setdefault("device", self.device)
        return make_backend(kind, algorithm=spec.name, **kwargs)

    def prepare_backend(self, algorithm: str, kind: str | None = None,
                        warm_count=None, **kwargs):
        """Build AND warm a backend (kernel built and loaded, one launch of
        ``warm_count`` nonces — an int, or a callable(backend) -> int such
        as the engine's ``planned_batch``): handing it to
        ``MiningEngine.switch_algorithm`` then costs one batch boundary,
        not a build. A backend whose warmup fails is closed (it may hold
        device memory) and the failure raised."""
        backend = self.backend_for(algorithm, kind, **kwargs)
        try:
            count = warm_count(backend) if callable(warm_count) else warm_count
            seconds = backend.precompile(count=count)
        except Exception:
            close = getattr(backend, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    log.exception("closing %s after a failed warmup also "
                                  "failed", backend.name)
            raise
        log.info("prepared %s/%s in %.2fs", algorithm, backend.name, seconds)
        return backend

    async def prepare_backend_async(self, algorithm: str,
                                    kind: str | None = None,
                                    warm_count=None, **kwargs):
        """Double-buffered switching: build and warm OFF the event loop
        while the engine keeps mining the current algorithm."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None,
            functools.partial(self.prepare_backend, algorithm, kind,
                              warm_count=warm_count, **kwargs),
        )

    def benchmark(
        self, algorithm: str, kind: str | None = None,
        budget_hashes: int | None = None,
    ) -> BenchmarkResult:
        """Timed production-path search over a synthetic job (target 0, so
        no winners). The default budget is the backend's preferred batch,
        or one chunk for a memory-hard algorithm. Blocking: it refuses to
        run on an event loop's thread."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            raise RuntimeError(
                "benchmark() blocks on device searches; run it in an executor"
            )
        extra = {}
        if algorithm == "ethash":
            # a benchmark backend is discarded right after timing; the
            # managed tier would otherwise start a background 1 GiB
            # epoch-0 DAG build that outlives it
            extra["full_dataset"] = False
        backend = self.backend_for(algorithm, kind, **extra)
        jc = synthetic_job_constants()
        if budget_hashes is None:
            if algos.get(algorithm).memory_hard:
                budget_hashes = getattr(backend, "chunk", 1 << 6)
            else:
                budget_hashes = getattr(backend, "preferred_batch", 1 << 18)
        backend.precompile(jc)
        t0 = time.monotonic()
        backend.search(jc, 1 << 20, budget_hashes)
        dt = time.monotonic() - t0
        result = BenchmarkResult(algorithm, backend.name, budget_hashes, dt)
        self.results[(algorithm, result.backend)] = result
        log.info("benchmark %s/%s: %.0f H/s", algorithm, result.backend,
                 result.hashrate)
        return result

    def snapshot(self) -> dict:
        """The benchmarks run so far (the API's ``benchmarks`` provider)."""
        return {
            f"{a}/{b}": {"hashrate": r.hashrate, "hashes": r.hashes}
            for (a, b), r in self.results.items()
        }
