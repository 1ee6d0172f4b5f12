"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled at first use with ``nvcc`` for
``sm_90a`` into ``build/otedama_tpu_torch/`` beside the package, as a
shared library with a plain C interface that ``ctypes`` loads (seconds
to build: no PyTorch headers). The library's file name carries a hash of
the source, the headers it includes and the flags, so an edited source is
rebuilt and a stale library is never loaded. A missing toolkit or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "otedama_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build(source: str, headers: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, dict]:
    """Build ``csrc/<source>`` (unless a library of the same content is
    there) and load it. Returns the library and what the build reported:
    ``seconds`` and ``ptxas`` (registers, spills) when it compiled, and
    ``library``, the path."""
    src = CSRC / source
    content = src.read_bytes() + b"".join((CSRC / h).read_bytes()
                                          for h in headers)
    tag = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    info: dict = {}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.monotonic()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        info.update(seconds=time.monotonic() - t0, ptxas=proc.stderr.strip())
    info["library"] = str(so)
    return ctypes.CDLL(str(so)), info
