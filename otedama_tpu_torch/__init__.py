"""Otedama on PyTorch and CUDA: the port of ``otedama_tpu`` to an NVIDIA
Hopper card.

The package mirrors the JAX package's layout and public names so each
module's counterpart is easy to find (``runtime/search.py``,
``JobConstants``, ``MiningEngine``, ...). It imports ``torch``, ``numpy``
and the standard library only — never ``jax`` and nothing of
``otedama_tpu`` — and keeps its own copy of every host helper it needs.

Entry points run on CUDA unless the caller asks for the CPU explicitly
(``kind="torch", device="cpu"``). The kernels are hand-written CUDA C++
(``kernels/csrc/sha256d.cu`` for sha256d, ``kernels/csrc/scrypt.cu`` for
scrypt), built at first use.
"""

__version__ = "0.1.0"
