"""Two trees of the port's kernels on one card, in turns.

    python -m otedama_tpu_torch.kernels.kernel_ab A B [--kernels b1,b2,b5,b6,b7]
        [--lanes 1024,4096,262144]

``A`` and ``B`` are directories that each hold an ``otedama_tpu_torch``
package: this checkout's root, or an earlier commit's package unpacked
under the gitignored ``build/`` (``git archive <commit> otedama_tpu_torch
| tar -x -C build/<name>``), or a copy with one design choice edited.
Each tree runs in a process of its own and is driven only through its
public wrappers (``scrypt_cuda.romix``, ``scrypt_cuda.scrypt_verify``,
``sha256_cuda.sha256d_search``, ``sha256_cuda.sha256d_verify``,
``x11_cuda.x11_search``, ``x11_cuda.x11_verify``, ``ethash_cuda.build_dag``,
``ethash_cuda.ethash_search``, ``ethash_cuda.ethash_verify``), so two designs with
different C interfaces compare. The script builds both
trees at once (each into its own ``build/``, only the libraries the
chosen kernels need, printing their registers and spills), then times
them A, B, B, A with CUDA events (median of three rounds after a warm-up
call):

- B5 (``romix``, full V and ``half_v``) and the scrypt verify path
  (prologue, B5, epilogue; 4 planted failures, k = 16) at each lane count;
- B1 (``sha256d_search``) per 2^31-nonce launch, and over eight
  difficulty-1 jobs (about half hold a winner);
- B2 (``sha256d_verify``, k = 16, 3 planted failures) per call back to
  back at 128, 1,024, 4,096 and 2^20 shares, into a kept ``out=`` buffer
  where the tree's wrapper takes one (as the ledger calls it), the
  host's enqueue of one call (host clock over 200 calls, no wait), the
  card's time a call with the host's enqueue hidden (``device_ms``),
  and up to 4,096 shares one call alone (events around it, waited for);
- B6 (``x11_search``) per launch at 2^20, 2^22 and 2^24 lanes, and the
  verify (``x11_verify``, k = 16, 5 planted failures) per 1,024-share
  call, back to back and with the host's enqueue hidden;
- B7 at epoch 0 (the cache from the compiled generator): B7a
  (``build_dag``) per DAG, B7b light (``ethash_search``) per call at 2^14
  lanes and the engine's 2^18, B7c (``ethash_verify``, k = 16, 5 planted
  failures) per call of 1,024 shares and of one, and as a control B7b full
  at 2^24 lanes.

Every process makes the same inputs from one seed and reports a digest
of each output (for B1 also at counts 1, 3, 256 x 37 + 1, across 2^32,
with no lane in range, and overflowed: count and min only; for B2 at
counts 0, 1, 37, 255 and 256 x 37 + 1, a ``words20[off:]`` view, an
overflowed batch — count and min — and a batch whose one failure is its
last lane; for B6 searches at counts 0, 1, 37, one past a 512-lane block
and one past a 2^19-lane chunk, an overflowed window — count and min —,
a window whose nonces wrap past 2^32, each shavite counter order, and
verify calls at counts 0, 1, 1,000 and 1,024; for B7 the whole epoch-0
DAG, light searches at counts 0, 1 and 37, one past a 64-lane and a
128-lane block, an overflowed window — count and min — and a window
whose nonces wrap past 2^32, a full search, and verify calls at counts 0,
1, 3, 129, 1,023 and 1,024 with 64-bit nonces, the rows past each count
failing ones); the
script fails unless A's digests equal B's. It needs a
CUDA card and prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261017
BATCH = 1 << 31          # B1: the engine's launch
K = 16
B2_LANES = (128, 1024, 4096, 1 << 20)


# -- the child: one tree's kernels ---------------------------------------------

def _import_tree(tree: Path):
    sys.path.insert(0, str(tree))
    from otedama_tpu_torch.kernels import cuda_build
    from otedama_tpu_torch.kernels import scrypt_cuda as scc
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import x11_cuda as xc
    if not Path(scc.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {scc.__file__}, not the tree {tree}")
    return cuda_build, scc, sc, xc


def build_tree(tree: Path, kernels: list[str]) -> dict:
    """Build the libraries of a tree that ``kernels`` need; their hot
    kernels' registers and spills."""
    cuda_build, scc, sc, xc = _import_tree(tree)
    report = {}
    wanted = []
    if "b5" in kernels:
        wanted.append((scc, ("romix_kernel",)))
    if "b1" in kernels or "b2" in kernels:
        wanted.append((sc, ("search_kernel", "verify_kernel")))
    if "b6" in kernels:
        wanted.append((xc, ("x11",)))
    if "b7" in kernels:
        from otedama_tpu_torch.kernels import ethash_cuda as ec
        wanted.append((ec, ("dag_kernel", "search_light_kernel",
                            "search_full_kernel", "verify_kernel")))
    for mod, names in wanted:
        _, info = cuda_build.build(mod.SOURCE, mod.HEADERS)
        fn = None
        for line in info.get("ptxas", "").splitlines():
            if "Compiling entry function" in line or "Function properties" in line:
                fn = line.split("'")[1] if "'" in line else line.split()[-1]
            if (fn and any(n in fn for n in names)
                    and ("registers" in line or "spill" in line)):
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


def device_ms(fn, reps: int) -> list[float]:
    """As ``time_ms``, but each round starts behind a ~10 ms spin kernel
    (``torch.cuda._sleep``) during which the host enqueues the round's
    calls: the events then time the card's work back to back, not the
    host's enqueue."""
    import torch
    fn()
    out = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return out


def alone_ms(fn, reps: int = 50) -> list[float]:
    """Three rounds of the median time of one call launched alone (CUDA
    events around it, waited for before the next): its launch-to-finish
    latency, where back-to-back calls would overlap it."""
    import torch
    fn()
    out = []
    for _ in range(3):
        one = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            one.append(a.elapsed_time(b))
        out.append(statistics.median(one))
    return out


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def time_tree(tree: Path, kernels: list[str], lanes_list: list[int]) -> dict:
    import torch
    _, scc, sc, xc = _import_tree(tree)
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
    if "b2" in kernels:
        rng = np.random.default_rng(SEED + 2)
        lanes = max(B2_LANES)
        words = on_card(rng.integers(0, 1 << 32, (lanes, 20), dtype=np.uint64))
        passing = np.full((lanes, 8), 0xFFFFFFFF, np.uint32)
        takes_out = "out" in inspect.signature(sc.sha256d_verify).parameters
        out = torch.empty(2 * K + 3, dtype=torch.int32, device=dev)

        def verify(w, t, count, k=K):
            if takes_out and k == K:
                return sc.sha256d_verify(w, t, count, k=k, out=out)
            return sc.sha256d_verify(w, t, count, k=k)

        def planted(count, rows=None):
            """all-pass targets but zero ones (fail) at a few lanes, and
            at every row past count, which must not count"""
            limbs = passing[:rows or lanes].copy()
            limbs[count:] = 0
            limbs[[i for i in (0, count // 2, count - 1) if 0 <= i < count]] = 0
            return on_card(limbs)

        for count in (0, 1, 37, 255, 256 * 37 + 1):
            buf = verify(words[:count + 5], planted(count, count + 5), count)
            digests[f"B2 count {count}"] = digest(buf)
        off = 3
        digests["B2 words20[3:] view, 37 of 40 rows"] = digest(verify(
            words[off:off + 40], planted(37, 43)[off:], 37))
        limbs = on_card(rng.integers(0, 1 << 32, (1024, 8), dtype=np.uint64))
        buf = verify(words[:1024], limbs, 1024).cpu().numpy().view(np.uint32)
        digests["B2 overflowed (count, min)"] = hashlib.sha256(
            buf[[2 * K, 2 * K + 2]].tobytes()).hexdigest()[:16] + f" n={buf[2 * K]}"
        last = passing[:4096].copy()
        last[-1] = 0
        digests["B2 one failure, the last lane"] = digest(
            verify(words[:4096], on_card(last), 4096))
        for n in B2_LANES:
            w, t = words[:n], planted(n, n)
            reps = 20 if n > 1 << 16 else 200
            digests[f"B2 {n} lanes"] = digest(verify(w, t, n))
            times[f"B2 {n} lanes"] = time_ms(lambda: verify(w, t, n), reps)
            torch.cuda.synchronize()
            rounds = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(200):
                    verify(w, t, n)
                rounds.append((time.perf_counter() - t0) / 200 * 1e3)
                torch.cuda.synchronize()
            times[f"B2 {n} lanes, host enqueue"] = rounds
            times[f"B2 {n} lanes, the card's time alone"] = device_ms(
                lambda: verify(w, t, n), reps // 4)
            if n <= 4096:
                times[f"B2 {n} lanes, one call alone"] = alone_ms(
                    lambda: verify(w, t, n))
    if "b6" in kernels:
        _time_b6(xc, dev, on_card, times, digests)
    if "b7" in kernels:
        _time_b7(dev, on_card, times, digests)
    return {"times": times, "digests": digests}


def _limbs_of(v: int) -> list[int]:
    return [(v >> (224 - 32 * j)) & 0xFFFFFFFF for j in range(8)]


def _kept(buf) -> str:
    """every word of a winner buffer, or the count and the min of an
    overflowed one"""
    b = buf.cpu().numpy().view(np.uint32)
    k = (len(b) - 3) // 2
    n = int(b[2 * k])
    b = b if n <= k else b[[2 * k, 2 * k + 2]]
    return f"{hashlib.sha256(b.tobytes()).hexdigest()[:16]} n={n}"


B6_LANES = (1 << 20, 1 << 22, 1 << 24)
B6_VARIANTS = ("r3-recall", "identity", "c0-cycle", "swap-mid", "reverse-all")


def _time_b6(xc, dev, on_card, times, digests) -> None:
    """B6's digests and times through ``x11_search`` and ``x11_verify``."""
    import torch

    from otedama_tpu_torch.kernels import x11_torch as xt

    rng = np.random.default_rng(SEED + 6)
    prefix = rng.integers(0, 256, 76, dtype=np.uint8).tobytes()
    out = torch.empty(2 * K + 3, dtype=torch.int32, device=dev)

    for name, base, count, top in (
            ("count 0", 5, 0, (1 << 256) - 1), ("count 1", 77, 1, 1 << 255),
            ("count 37", int(rng.integers(1 << 32)), 37, 1 << 253),
            ("one past a 512-lane block", int(rng.integers(1 << 32)), 513,
             1 << 250),
            ("one past a 2^19-lane chunk", int(rng.integers(1 << 32)),
             (1 << 19) + 1, 1 << 243),
            ("overflowed (count, min)", 7, 1 << 14, 1 << 251),
            ("nonces wrap past 2^32", (1 << 32) - 1000, 1 << 14, 1 << 246)):
        digests[f"B6 search, {name}"] = _kept(xc.x11_search(
            prefix, base, count - 1, _limbs_of(top), batch=max(count, 1),
            k=K, device=dev, out=out))
    for v in B6_VARIANTS:
        digests[f"B6 search, counter order {v}"] = _kept(xc.x11_search(
            prefix, 99, 4095, _limbs_of(1 << 250), batch=4096, k=K,
            device=dev, cnt_order=xt.cnt_variant_order(v), out=out))
    for lanes in B6_LANES:
        def search(lanes=lanes):
            xc.x11_search(prefix, 0, lanes - 1, _limbs_of(0), batch=lanes,
                          k=K, device=dev, out=out)
        times[f"B6 search {lanes} lanes"] = time_ms(search, 3)
    rows = rng.integers(0, 256, (1024, 80), dtype=np.uint8)
    words = on_card(xt.headers_to_words(rows))
    limbs = np.full((1024, 8), 0xFFFFFFFF, np.uint32)
    limbs[[0, 100, 511, 512, 1023]] = 0
    limbs = on_card(limbs)
    for count in (0, 1, 1000, 1024):
        digests[f"B6 verify, count {count}"] = _kept(xc.x11_verify(
            words, limbs, count, k=K, out=out))

    def verify():
        xc.x11_verify(words, limbs, 1024, k=K, out=out)

    times["B6 verify 1024 shares"] = time_ms(verify, 20)
    times["B6 verify 1024 shares, the card's time alone"] = device_ms(verify, 20)


B7_LIGHT_LANES = (1 << 14, 1 << 18)   # the engine's light call: 2^18
B7_FULL_LANES = 1 << 24
B7_SHARES = 1024
B7C_COUNTS = (0, 1, 3, 129, 1023, 1024)


def _time_b7(dev, on_card, times, digests) -> None:
    """B7's digests and times at epoch 0 through ``build_dag``,
    ``ethash_search`` and ``ethash_verify``."""
    import torch

    from otedama_tpu_torch.kernels import ethash as eth
    from otedama_tpu_torch.kernels import ethash_cuda as ec

    rng = np.random.default_rng(SEED + 7)
    full_size = eth.dataset_size(0)
    cache = ec.cache_tensor(eth.make_cache(eth.cache_size(0), eth.seed_hash(0)),
                            dev)
    dag = ec.build_dag(cache, full_size)
    digests["B7a epoch-0 DAG"] = digest(dag)
    times["B7a epoch-0 DAG"] = time_ms(
        lambda: ec.build_dag(cache, full_size, out=dag), 1)
    hh = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    out = torch.empty(2 * K + 3, dtype=torch.int32, device=dev)
    for name, base, count, top in (
            ("count 0", 5, 0, (1 << 256) - 1), ("count 1", 77, 1, 1 << 255),
            ("count 37", int(rng.integers(1 << 32)), 37, 1 << 253),
            ("one past a 64-lane block", int(rng.integers(1 << 32)), 65,
             1 << 252),
            ("one past a 128-lane block", int(rng.integers(1 << 32)), 129,
             1 << 251),
            ("overflowed (count, min)", 7, 1 << 12, 1 << 251),
            ("nonces wrap past 2^32", (1 << 32) - 1000, 1 << 12, 1 << 246)):
        digests[f"B7b light, {name}"] = _kept(ec.ethash_search(
            full_size, cache, hh, base, count - 1, _limbs_of(top),
            batch=max(count, 1), k=K, full=False, out=out))
    for lanes in B7_LIGHT_LANES:
        def light(lanes=lanes):
            ec.ethash_search(full_size, cache, hh, 0, lanes - 1, _limbs_of(0),
                             batch=lanes, k=K, full=False, out=out)
        times[f"B7b light {lanes} lanes"] = time_ms(light, 1)
    digests["B7b full, 2^16 lanes"] = _kept(ec.ethash_search(
        full_size, dag, hh, 11, (1 << 16) - 1, _limbs_of(1 << 243),
        batch=1 << 16, k=K, full=True, out=out))

    def full():
        ec.ethash_search(full_size, dag, hh, 0, B7_FULL_LANES - 1, _limbs_of(0),
                         batch=B7_FULL_LANES, k=K, full=True, out=out)

    times[f"B7b full {B7_FULL_LANES} lanes"] = time_ms(full, 3)
    nonces = rng.integers(0, 1 << 64, B7_SHARES, dtype=np.uint64)
    nonces[:3] = [(1 << 64) - 1, 1 << 63, 1 << 32]
    rows_h, rows_n = ec.share_rows(
        rng.integers(0, 256, (B7_SHARES, 32), dtype=np.uint8), nonces)
    limbs = np.full((B7_SHARES, 8), 0xFFFFFFFF, np.uint32)
    limbs[[0, 100, 511, 512, 1023]] = 0
    rows = [on_card(x) for x in (rows_h, rows_n, limbs)]
    for count in B7C_COUNTS:
        past = limbs.copy()
        past[count:] = 0          # rows past the count would all fail
        digests[f"B7c verify, count {count}"] = _kept(ec.ethash_verify(
            full_size, cache, *rows[:2], on_card(past), count, k=K, out=out))
    for count in (B7_SHARES, 1):
        def verify(count=count):
            ec.ethash_verify(full_size, cache, *rows, count, k=K, out=out)

        times[f"B7c verify {count} share(s)"] = time_ms(verify, 5)


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
    ap.add_argument("--kernels", default="b1,b5")  # of b1, b2, b5, b6, b7
    ap.add_argument("--lanes", default="1024,4096,262144")
    ap.add_argument("--child", type=Path)
    ap.add_argument("--build", action="store_true")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    lanes = [int(x) for x in args.lanes.split(",")]
    if args.child is not None:
        tree = args.child.resolve()
        rec = (build_tree(tree, kernels) if args.build
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
        built = list(pool.map(lambda t: run_child(t, "--build", "--kernels",
                                                  args.kernels), (a, b)))
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
