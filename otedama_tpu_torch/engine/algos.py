"""Algorithm registry with capability flags (counterpart of
``otedama_tpu/engine/algos.py``).

An entry declares which search backends implement it; asking for an
unimplemented (algorithm, backend) pair is a loud error. The port carries
the sha256 family and scrypt. ``planning_hashrate`` is 0.0: the port's
rates are measured on the card (``PERF.md``), and no TPU rate stands in
for one.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    aliases: tuple[str, ...] = ()
    backends: tuple[str, ...] = ()      # implemented search backends
    memory_hard: bool = False           # scrypt family: V scratch per lane
    chained: int = 1                    # chained hash rounds (x11 = 11)
    planning_hashrate: float = 0.0      # H/s per card, pre-measurement

    def implemented(self) -> bool:
        return bool(self.backends)


_REGISTRY: dict[str, AlgorithmSpec] = {}


def register(spec: AlgorithmSpec) -> AlgorithmSpec:
    _REGISTRY[spec.name] = spec
    for alias in spec.aliases:
        _REGISTRY[alias] = spec
    return spec


def get(name: str) -> AlgorithmSpec:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown algorithm {name!r}; known: {names()}"
        ) from None


def names(implemented_only: bool = False) -> list[str]:
    out = {s.name: s for s in _REGISTRY.values()}
    return sorted(
        n for n, s in out.items() if s.implemented() or not implemented_only
    )


register(AlgorithmSpec(
    name="sha256d",
    aliases=("sha256double", "bitcoin"),
    backends=("cuda", "torch", "python"),
))
register(AlgorithmSpec(
    name="sha256",
    backends=("cuda", "torch", "python"),
))
register(AlgorithmSpec(
    name="scrypt",
    aliases=("litecoin",),
    backends=("cuda", "torch", "python"),
    memory_hard=True,
))
