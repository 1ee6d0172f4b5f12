"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled at first use with ``nvcc`` for
``sm_90a`` (and ``csrc/*.cc``, host C++, with the same ``nvcc``) into
``build/otedama_tpu_torch/`` beside the package, as a shared library with a plain C interface that ``ctypes`` loads (seconds
to build: no PyTorch headers). The library's file name carries a hash of
the source, the headers it includes and the flags, so an edited source is
rebuilt and a stale library is never loaded. A missing toolkit or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "otedama_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# host C++ (csrc/*.cc) through the same nvcc, for the host compiler alone
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _compile(source: str, headers: tuple[str, ...], flags: tuple[str, ...],
             name: str, nice: int = 0) -> tuple[Path, dict]:
    """``csrc/<source>`` compiled with ``flags`` into ``BUILD_DIR`` under
    ``name`` (``{stem}`` and ``{tag}`` filled in: the tag hashes the
    source, its headers and the flags), unless it is there, by an nvcc
    at niceness ``nice``. Returns the path and ``seconds`` and ``ptxas``
    when it compiled."""
    src = CSRC / source
    content = src.read_bytes() + b"".join((CSRC / h).read_bytes()
                                          for h in headers)
    tag = hashlib.sha256(content + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / name.format(stem=src.stem, tag=tag)
    info: dict = {}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.monotonic()
        proc = subprocess.run(["nice", "-n", str(nice), nvcc(), *flags,
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{src} ({' '.join(flags)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        info.update(seconds=time.monotonic() - t0, ptxas=proc.stderr.strip())
    info["library"] = str(out)
    return out, info


def build(source: str, headers: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, dict]:
    """Build ``csrc/<source>`` (unless a library of the same content is
    there) and load it. Returns the library and what the build reported:
    ``seconds`` and ``ptxas`` (registers, spills) when it compiled, and
    ``library``, the path."""
    so, info = _compile(source, headers, NVCC_FLAGS, "lib{stem}-{tag}.so")
    return ctypes.CDLL(str(so)), info


def build_host(source: str) -> tuple[ctypes.CDLL, dict]:
    """Build the host C++ source ``csrc/<source>`` (unless a library of
    the same content is there) and load it, as ``build`` does."""
    so, info = _compile(source, (), HOST_FLAGS, "lib{stem}-{tag}.so")
    return ctypes.CDLL(str(so)), info


def cubin(source: str, headers: tuple[str, ...] = (),
          defines: tuple[str, ...] = ()) -> dict:
    """Compile ``csrc/<source>`` with ``-D`` ``defines`` into a cubin, for
    its SASS only (nothing loads it), at a low priority. Returns what
    ``build`` reports, ``library`` being the cubin's path."""
    flags = (*NVCC_FLAGS[:NVCC_FLAGS.index("-shared")], "-cubin",
             "-Xptxas", "-v", *(f"-D{d}" for d in defines))
    return _compile(source, headers, flags, "{stem}-{tag}.cubin",
                    nice=10)[1]


def ptxas_usage(ptxas: str) -> dict[str, str]:
    """Registers and spills of each function, from ``-Xptxas -v``'s
    report: ``{function: "N registers, S bytes spill stores, L bytes
    spill loads"}``."""
    usage, fn = {}, None
    for line in ptxas.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if head:
            fn = head.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if fn and spill:
            usage.setdefault(fn, "")
            usage[fn] = (usage[fn] + f" {spill.group(1)} B spill stores, "
                         f"{spill.group(2)} B spill loads").strip(" ,")
        if fn and regs:
            usage[fn] = f"{regs.group(1)} registers, " + usage.get(fn, "")
            usage[fn] = usage[fn].strip(" ,")
    return usage


# the integer pipes of an SM sub-partition: the ALU pipe (IADD3, LOP3, SHF
# and the other plain integer ops) and the FMA pipe (IMAD in all its forms)
ALU_OPS = ("IADD3", "LOP3", "SHF", "IABS", "IMNMX", "ISETP", "LEA", "PRMT",
           "SEL", "FLO", "POPC", "BREV", "VIMNMX", "BMSK")
FMA_OPS = ("IMAD",)


def sass_functions(library: str, kernel: str) -> dict[str, list[tuple[int, str, str]]]:
    """The compiled SASS of each function of ``library`` whose name holds
    ``kernel`` (``cuobjdump -sass``, beside nvcc): a list of
    ``(address, opcode, operands)`` per function."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    fns, code = {}, None
    for line in out.stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            code = fns.setdefault(head.group(1), []) \
                if kernel in head.group(1) else None
            continue
        op = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9]*)(\S*)\s*([^;]*)", line)
        if code is not None and op:
            code.append((int(op.group(1), 16), op.group(2) + op.group(3),
                         op.group(4)))
    if not fns:
        raise RuntimeError(f"no function {kernel!r} in {library}")
    return fns


def hot_loop(code: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The instructions of a function's largest loop: from the target of
    its longest backward branch to the branch (the branch to itself that
    ends every function is no loop); empty if it has none."""
    best = []
    for addr, op, args in code:
        target = re.search(r"0x[0-9a-f]+", args)
        if op.startswith("BRA") and target and int(target.group(0), 16) < addr:
            to = int(target.group(0), 16)
            body = [c for c in code if to <= c[0] <= addr]
            if len(body) > len(best):
                best = body
    return best


def pipe_counts(code) -> dict[str, int]:
    """Instructions of ``code`` on the ALU pipe, on the FMA pipe (IMAD),
    shuffles, and in all."""
    base = [op.split(".")[0] for _, op, _ in code]
    return {"total": len(base),
            "alu": sum(b in ALU_OPS for b in base),
            "fma": sum(b in FMA_OPS for b in base),
            "shfl": sum(b == "SHFL" for b in base)}


def kernel_report(info: dict, kernel: str, loop: bool = True) -> list[str]:
    """Lines on each function of a build whose name holds ``kernel``: its
    registers and spills (``-Xptxas -v``, when the build compiled), then
    its SASS: the whole function's instruction count and its hot loop's
    instructions by integer pipe, and its shuffles. With ``loop`` False
    (a kernel whose work is straight-line code, its loops only
    bookkeeping) the counts are the whole function's."""
    lines = [f"ptxas {fn}: {usage}"
             for fn, usage in ptxas_usage(info.get("ptxas", "")).items()
             if kernel in fn]
    for fn, code in sass_functions(info["library"], kernel).items():
        loop_code = hot_loop(code) if loop else []
        part = pipe_counts(loop_code or code)
        lines.append(
            f"SASS {fn}: {len(code)} instructions; "
            + (f"hot loop {part['total']} an iteration" if loop_code
               else "the whole function")
            + f": ALU pipe {part['alu']} ({part['alu'] / part['total']:.1%}),"
            f" FMA pipe (IMAD) {part['fma']} ({part['fma'] / part['total']:.1%}),"
            f" SHFL {part['shfl']}")
    return lines
