"""Two trees of the port's kernels on one card, in turns.

    python -m otedama_tpu_torch.kernels.kernel_ab A B [--kernels b1,b5]
        [--lanes 1024,4096,262144]

``A`` and ``B`` are directories that each hold an ``otedama_tpu_torch``
package: this checkout's root, or an earlier commit's package unpacked
under the gitignored ``build/`` (``git archive <commit> otedama_tpu_torch
| tar -x -C build/<name>``), or a copy with one design choice edited.
Each tree runs in a process of its own and is driven only through its
public wrappers (``scrypt_cuda.romix``, ``scrypt_cuda.scrypt_verify``,
``sha256_cuda.sha256d_search``), so two designs with different C
interfaces compare. The script builds both trees at once (each into its
own ``build/``, printing its kernels' registers and spills), then times
them A, B, B, A with CUDA events (median of three rounds after a warm-up
call):

- B5 (``romix``, full V and ``half_v``) and the scrypt verify path
  (prologue, B5, epilogue; 4 planted failures, k = 16) at each lane count;
- B1 (``sha256d_search``) per 2^31-nonce launch, and over eight
  difficulty-1 jobs (about half hold a winner).

Every process makes the same inputs from one seed and reports a digest
of each output (for B1 also at counts 1, 3, 256 x 37 + 1, across 2^32,
with no lane in range, and overflowed: count and min only); the script
fails unless A's digests equal B's. It needs a CUDA card and prints the
card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 20261017
BATCH = 1 << 31          # B1: the engine's launch
K = 16


# -- the child: one tree's kernels ---------------------------------------------

def _import_tree(tree: Path):
    sys.path.insert(0, str(tree))
    from otedama_tpu_torch.kernels import cuda_build
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    if not Path(scc.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {scc.__file__}, not the tree {tree}")
    return cuda_build, scc, sc


def build_tree(tree: Path) -> dict:
    """Build both libraries of a tree; their hot kernels' registers."""
    cuda_build, scc, sc = _import_tree(tree)
    report = {}
    for mod, kernel in ((scc, "romix_kernel"), (sc, "search_kernel")):
        _, info = cuda_build.build(mod.SOURCE, mod.HEADERS)
        fn = None
        for line in info.get("ptxas", "").splitlines():
            if "Compiling entry function" in line or "Function properties" in line:
                fn = line.split("'")[1] if "'" in line else line.split()[-1]
            if fn and kernel in fn and ("registers" in line or "spill" in line):
                report.setdefault(fn, []).append(line.strip())
    return report


def time_ms(fn, reps: int) -> list[float]:
    """Three rounds of ``reps`` calls after one warm-up call: ms per call."""
    import torch
    fn()
    out = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return out


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def time_tree(tree: Path, kernels: list[str], lanes_list: list[int]) -> dict:
    import torch
    _, scc, sc = _import_tree(tree)
    dev = torch.device("cuda", 0)
    times, digests = {}, {}

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                .view(np.int32)).to(dev)

    if "b5" in kernels:
        rng = np.random.default_rng(SEED)
        V = torch.empty(scc.scratch_words(max(lanes_list)), dtype=torch.int32,
                        device=dev)
        for lanes in lanes_list:
            X = on_card(rng.integers(0, 1 << 32, (32, lanes), dtype=np.uint64))
            reps = 2 if lanes > 1 << 16 else 20
            for half in (False, True):
                name = f"B5 {lanes} lanes{', half_v' if half else ''}"
                digests[name] = digest(scc.romix(X, half, scratch=V))
                times[name] = time_ms(lambda: scc.romix(X, half, scratch=V), reps)
            w20 = on_card(rng.integers(0, 1 << 32, (lanes, 20), dtype=np.uint64))
            limbs = np.full((lanes, 8), 0xFFFFFFFF, np.uint32)
            limbs[rng.choice(lanes, min(4, lanes), replace=False)] = 0
            limbs = on_card(limbs)
            scratch = (torch.empty(scc.ROW_WORDS * lanes, dtype=torch.int32,
                                   device=dev), V)
            name = f"scrypt verify {lanes} shares"
            digests[name] = digest(scc.scrypt_verify(w20, limbs, lanes, k=K,
                                                     scratch=scratch))
            times[name] = time_ms(lambda: scc.scrypt_verify(
                w20, limbs, lanes, k=K, scratch=scratch), reps)
        del V
        torch.cuda.empty_cache()
    if "b1" in kernels:
        rng = np.random.default_rng(SEED + 1)
        ms_ = rng.integers(0, 1 << 32, 8, dtype=np.uint64)
        tail = rng.integers(0, 1 << 32, 3, dtype=np.uint64)
        out = torch.empty(2 * K + 3, dtype=torch.int32, device=dev)

        def search(jw):
            return lambda: sc.sha256d_search(jw, batch=BATCH, k=K, device=dev,
                                             out=out)

        for top, count in ((16, None), (1 << 26, 1 << 20), (1 << 31, 3),
                           (1 << 31, 1), (1 << 24, 256 * 37 + 1),
                           (0xFFFFFFFF, 0)):
            base = int(rng.integers(1 << 32))
            jw = sc.pack_job_words(ms_, tail, base, np.asarray(
                [top] + [0xFFFFFFFF] * 7, np.uint32), count=count)
            search(jw)()
            buf = out.cpu().numpy().view(np.uint32)
            kept = buf if buf[2 * K] <= K else buf[[2 * K, 2 * K + 2]]
            digests[f"B1 top limb {top:#x}, count {count}, base {base:#x}"] = \
                hashlib.sha256(kept.tobytes()).hexdigest()[:16]
        jw = sc.pack_job_words(ms_, tail, 0, np.zeros(8, np.uint32))
        times[f"B1 {BATCH} nonces"] = time_ms(search(jw), 3)
        d1 = np.asarray([0, 0xFFFF0000] + [0] * 6, np.uint32)
        jobs = [search(sc.pack_job_words(
            rng.integers(0, 1 << 32, 8, dtype=np.uint64),
            rng.integers(0, 1 << 32, 3, dtype=np.uint64), 0, d1))
            for _ in range(8)]
        times[f"B1 {BATCH} nonces, 8 difficulty-1 jobs"] = [
            t / len(jobs) for t in time_ms(lambda: [j() for j in jobs], 1)]
    return {"times": times, "digests": digests}


# -- the parent: both trees in turns ----------------------------------------------

def run_child(tree: Path, *args: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, __file__, "--child", str(tree),
                           *args], capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--kernels", default="b1,b5")
    ap.add_argument("--lanes", default="1024,4096,262144")
    ap.add_argument("--child", type=Path)
    ap.add_argument("--build", action="store_true")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    lanes = [int(x) for x in args.lanes.split(",")]
    if args.child is not None:
        tree = args.child.resolve()
        rec = (build_tree(tree) if args.build
               else time_tree(tree, kernels, lanes))
        print(json.dumps(rec))
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    from otedama_tpu_torch.kernels.card import smi
    a, b = (t.resolve() for t in args.trees)
    card = smi("name,power.limit")
    print(card, flush=True)
    if card == "?":
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        built = list(pool.map(lambda t: run_child(t, "--build"), (a, b)))
    for tree, regs in zip((a, b), built):
        for fn, lines in regs.items():
            print(f"   {tree.name}: {fn}: " + "; ".join(lines), flush=True)
    passes = {a: [], b: []}
    for tree in (a, b, b, a):
        passes[tree].append(run_child(tree, "--kernels", args.kernels,
                                      "--lanes", args.lanes))
        print(f"   timed {tree.name}; {smi('clocks.sm,power.draw')}", flush=True)
    same = all(p["digests"] == passes[a][0]["digests"]
               for p in passes[a] + passes[b])
    print(f"== ms per call, {a.name} then {b.name}, in turns "
          f"({a.name}, {b.name}, {b.name}, {a.name}); {card}", flush=True)
    for case in passes[a][0]["times"]:
        ta = [statistics.median(p["times"][case]) for p in passes[a]]
        tb = [statistics.median(p["times"][case]) for p in passes[b]]
        print(f"   {case}: {a.name} " + ", ".join(f"{t:.4f}" for t in ta)
              + f"; {b.name} " + ", ".join(f"{t:.4f}" for t in tb)
              + f" ({statistics.mean(ta) / statistics.mean(tb):.3f}x)",
              flush=True)
    print(f"   outputs {'equal' if same else 'DIFFER'}: "
          f"{len(passes[a][0]['digests'])} cases", flush=True)
    print(card, flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
