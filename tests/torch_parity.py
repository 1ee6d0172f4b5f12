"""A reference test file bound to either package: the port's parity tests
run the JAX package's own test functions once as written (``jax``) and
once with every ``otedama_tpu.`` import pointed at ``otedama_tpu_torch.``
(``torch``)."""

from __future__ import annotations

import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
_BOUND: dict[tuple, types.ModuleType] = {}


def reference_cases(filename: str, package: str,
                    drop: tuple[str, ...] = ()) -> types.ModuleType:
    """``tests/<filename>`` executed as a module bound to ``package``
    (``jax`` or ``torch``); for ``torch``, the lines in ``drop`` (imports
    of what the port does not carry) are left out first."""
    key = (filename, package)
    if key not in _BOUND:
        path = TESTS / filename
        text = path.read_text()
        if package == "torch":
            for line in drop:
                assert line in text, line
                text = text.replace(line, "")
            text = text.replace("otedama_tpu.", "otedama_tpu_torch.")
        mod = types.ModuleType(f"_{path.stem}_{package}")
        mod.__file__ = str(path)
        exec(compile(text, str(path), "exec"), mod.__dict__)
        _BOUND[key] = mod
    return _BOUND[key]
