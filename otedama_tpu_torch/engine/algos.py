"""Algorithm registry with capability flags (counterpart of
``otedama_tpu/engine/algos.py``).

An entry declares which search backends implement it; asking for an
unimplemented (algorithm, backend) pair is a loud error. The port carries
the sha256 family, scrypt, x11 and ethash. ``planning_hashrate`` is 0.0: the
port's rates are measured on the card (``PERF.md``), and no TPU rate
stands in for one.

``canonical`` says whether the implementation is certified bit-compatible
with the live network. x11 is not (its ``simd512`` stage is an
uncertified reconstruction, ``kernels/x11``): it registers
``canonical=False``, and the coin alias ``"dash"`` refuses to resolve
until ``kernels.x11._maybe_certify`` finds a certification artifact whose
fingerprint matches and calls ``mark_canonical``. ethash is not either
(its composition is from recall, with no offline vector): ``etchash``
refuses the same way until ``kernels.ethash._maybe_certify`` lifts it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    aliases: tuple[str, ...] = ()
    backends: tuple[str, ...] = ()      # implemented search backends
    memory_hard: bool = False           # scrypt: V a lane; ethash: the DAG
    chained: int = 1                    # chained hash rounds (x11 = 11)
    # certified bit-compatible with the live network's rules; a chain
    # that is not may be consistent between miner and pool here but would
    # produce invalid work on the network, so its coin alias refuses
    canonical: bool = True
    planning_hashrate: float = 0.0      # H/s per card, pre-measurement

    def implemented(self) -> bool:
        return bool(self.backends)


_REGISTRY: dict[str, AlgorithmSpec] = {}


def register(spec: AlgorithmSpec) -> AlgorithmSpec:
    _REGISTRY[spec.name] = spec
    for alias in spec.aliases:
        _REGISTRY[alias] = spec
    return spec


# coin aliases that name LIVE networks: they refuse to resolve while the
# chain under them is uncertified (ask for the algorithm's own name to use
# it as a chain internal to this framework)
_CANONICAL_ALIASES = {"dash": "x11", "etchash": "ethash"}


def _load_kernels() -> None:
    """Import the x11 and ethash host tiers, whose imports run the
    certification checks (``_maybe_certify``), before a canonical gate is
    read."""
    import otedama_tpu_torch.kernels.ethash  # noqa: F401
    import otedama_tpu_torch.kernels.x11  # noqa: F401


def get(name: str) -> AlgorithmSpec:
    key = name.lower()
    target = _CANONICAL_ALIASES.get(key)
    if target is not None:
        _load_kernels()
        spec = _REGISTRY.get(target)
        if spec is None:
            raise KeyError(f"alias {key!r} names {target!r}, which the port "
                           "does not carry yet")
        if not spec.canonical:
            raise ValueError(
                f"alias {key!r} names the live {target} network, but this "
                f"{target} implementation is not certified canonical "
                f"(KAT parity pending) — request {target!r} explicitly to "
                f"use it as a framework-internal chain"
            )
        return spec
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown algorithm {name!r}; known: {names()}"
        ) from None


def names(implemented_only: bool = False) -> list[str]:
    out = {s.name: s for s in _REGISTRY.values()}
    return sorted(
        n for n, s in out.items() if s.implemented() or not implemented_only
    )


def supports(name: str, backend: str) -> bool:
    try:
        return backend in get(name).backends
    except (KeyError, ValueError):
        # ValueError = a gated canonical alias; a capability probe answers
        # False rather than propagating the refusal
        return False


def implemented(name: str) -> bool:
    try:
        return get(name).implemented()
    except (KeyError, ValueError):
        return False


def mark_canonical(name: str) -> None:
    """Called by a kernel package once its chain is certified against the
    live network's vectors: unlocks its coin alias."""
    spec = _REGISTRY[name.lower()]
    if not spec.canonical:
        register(dataclasses.replace(spec, canonical=True))


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
register(AlgorithmSpec(
    name="x11",
    # the "dash" coin alias lives in _CANONICAL_ALIASES: it resolves only
    # once the chain is certified (canonical=True)
    backends=("cuda", "torch", "python"),
    chained=11,
    canonical=False,
))
register(AlgorithmSpec(
    name="ethash",
    # the "etchash" coin alias lives in _CANONICAL_ALIASES, as "dash"
    # does. Every kind is the epoch-managed backend over tiers of that
    # kind (runtime.search._BACKENDS)
    backends=("cuda", "torch", "python"),
    memory_hard=True,
    canonical=False,
))
