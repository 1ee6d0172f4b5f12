#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Builds the port's kernel from the sources in this checkout, drives the
solo sha256d main path through the entry points a user calls, and checks
every phase; any failure exits non-zero. Phases:

1. card: name, power limit, clocks, versions; build the kernel;
2. known answer: the bitcoin genesis block's nonce wins a 2^20 window;
3. kernel against the plain PyTorch version on the card, buffer for buffer
   (few winners, target at a lane's hash and +-1, a ragged count, a
   window that wraps 2^32, an empty window, table overflow, the backend's
   bisecting overflow rescan, and the main path's 2^31-lane launch);
4. main path: ``Application`` in solo mode on the card against a
   difficulty-1 mock chain until it accepts 3 blocks, through the
   engine's default 2^31-nonce grouped launches; every block is re-hashed
   with hashlib, the kernel must have launched and the plain version not;
5. times: the kernel's time per 2^31-nonce launch (CUDA events, after
   warm-up) beside its bound.

The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints neither.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import struct
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 20261016
MAIN_BATCH = 1 << 31          # the engine's launch: CudaBackend.preferred_batch
GENESIS_HASH = "000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f"
BLOCKS_NEEDED = 3
MAIN_PATH_BOUND_S = 180.0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run "
              "needs a CUDA card", file=sys.stderr)
        return 2

    import numpy as np

    from otedama_tpu_torch.app import Application
    from otedama_tpu_torch.config.schema import AppConfig
    from otedama_tpu_torch.kernels import sha256_cuda as sc
    from otedama_tpu_torch.kernels import sha256_torch as st
    from otedama_tpu_torch.kernels import target as tgt
    from otedama_tpu_torch.pool.blockchain import MockChainClient
    from otedama_tpu_torch.runtime.search import CudaBackend, JobConstants

    dev = torch.device("cuda", 0)
    k = sc.K_WINNERS
    rng = np.random.default_rng(SEED)

    def kernel_buf(jw, batch, kk=k):
        out = sc.sha256d_search(jw, batch=batch, k=kk, device=dev)
        torch.cuda.synchronize(dev)
        return out.cpu().numpy().view(np.uint32)

    def plain_buf(jw, batch, kk=k, chunk=1 << 22):
        out = st.sha256d_search_buffer(jw, batch=batch, k=kk, device=dev,
                                       chunk=chunk)
        torch.cuda.synchronize(dev)
        return out.cpu().numpy().view(np.uint32)

    def random_job_words(base, count, limbs):
        ms = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
        tail = rng.integers(0, 1 << 32, size=3, dtype=np.uint64)
        return sc.pack_job_words(ms, tail, base, np.asarray(limbs, np.uint32),
                                 count=count)

    max_abs_err = 0

    def compare(name, jw, batch, kk=k):
        """Kernel buffer against the plain buffer: every word when the table
        did not overflow, else the count and the min top limb."""
        nonlocal max_abs_err
        a = kernel_buf(jw, batch, kk)
        b = plain_buf(jw, batch, kk)
        n = int(b[2 * kk])
        if n <= kk:
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            check(not diff.any(), f"{name}: kernel buffer != plain buffer\n"
                  f"kernel {a.tolist()}\nplain  {b.tolist()}")
        else:
            for i in (2 * kk, 2 * kk + 2):
                check(a[i] == b[i], f"{name}: word {i} kernel {a[i]} != "
                      f"plain {b[i]} (overflowed table)")
            diff = np.abs(a[2 * kk:].astype(np.int64) - b[2 * kk:].astype(np.int64))
        max_abs_err = max(max_abs_err, int(diff.max()))
        print(f"   {name}: {batch} lanes, n={n}, min_h0={b[2 * kk + 2]:#010x} "
              "equal", flush=True)
        return b

    # -- 1. card ----------------------------------------------------------
    phase("1 card")
    card = smi("name,power.limit")
    print(card, flush=True)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(dev)
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {props.multi_processor_count} "
          f"SMs, max SM clock {clock_mhz:.0f} MHz", flush=True)
    t0 = time.monotonic()
    sc.load_library()
    print(f"   kernel built and loaded in {time.monotonic() - t0:.1f} s "
          f"({sc.build_info['library']})", flush=True)
    for line in sc.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"   ptxas: {line.strip()}", flush=True)

    # -- 2. known answer: the genesis block -----------------------------------
    phase("2 genesis known answer")
    merkle = bytes.fromhex(
        "4a5e1e4baab89f3a32518a88c31bc87f618f76673e2cc77ab2127b7afdeda33b")[::-1]
    h76 = (struct.pack("<I", 1) + bytes(32) + merkle
           + struct.pack("<II", 1231006505, 0x1D00FFFF))
    lane = int.from_bytes(struct.pack("<I", 2083236893), "big")
    window = 1 << 20
    gen = JobConstants.from_header_prefix(h76, tgt.bits_to_target(0x1D00FFFF))
    base = (lane - 333_333) & 0xFFFFFFFF
    wn, _, n, _ = sc.unpack_winner_buffer(
        kernel_buf(gen.job_words(base, window), window), k)
    check(n == 1 and int(wn[0]) == lane,
          f"genesis: expected exactly lane {lane:#x}, got n={n} {wn[:n]}")
    digest = gen.digest_for(int(wn[0]))
    check(digest[::-1].hex() == GENESIS_HASH, f"genesis hash {digest[::-1].hex()}")
    print(f"   lane {lane:#010x} wins; hash {GENESIS_HASH}", flush=True)

    # -- 3. kernel against the plain version --------------------------------
    phase("3 kernel vs plain version")
    full = 0xFFFFFFFF
    few = [1 << 12] + [full] * 7                 # ~4 winners per 2^22 lanes
    jw = random_job_words(int(rng.integers(1 << 32)), None, few)
    compare("few winners", jw, 1 << 22)
    t0 = time.monotonic()
    plain_buf(jw, 1 << 22)
    print(f"   plain version, 2^22 lanes: {(time.monotonic() - t0) * 1e3:.1f} ms",
          flush=True)

    # target exactly at the best lane's hash, and +-1: the 256-bit compare
    # is decided on the low limbs
    span = 1 << 16
    ms = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
    tail = rng.integers(0, 1 << 32, size=3, dtype=np.uint64)
    base = int(rng.integers(1 << 32))
    nonces = (torch.arange(span, device=dev) + base) & 0xFFFFFFFF
    limbs = torch.stack(st.digest_words_to_compare_order(
        st.sha256d_from_midstate([int(x) for x in ms], [int(x) for x in tail],
                                 nonces))).T.cpu().numpy()      # [span, 8]
    best_lane = int(np.lexsort(limbs.T[::-1])[0])
    best_hash = tgt.limbs_to_target(limbs[best_lane])
    for delta, expect in ((0, 1), (-1, 0), (1, 1)):
        jw = sc.pack_job_words(ms, tail, base,
                               tgt.target_to_limbs(best_hash + delta), count=span)
        b = compare(f"target = best lane's hash {delta:+d}", jw, span)
        check(int(b[2 * k]) == expect, f"target hash{delta:+d}: n={b[2 * k]}")
        if expect:
            check(int(b[0]) == (base + best_lane) & 0xFFFFFFFF,
                  "target at hash: wrong lane")

    ragged = (1 << 20) + 77
    compare("ragged count", random_job_words(int(rng.integers(1 << 32)), ragged,
                                             [1 << 14] + [full] * 7), ragged)
    compare("nonce wraps 2^32", random_job_words((1 << 32) - 1234, None,
                                                 [1 << 15] + [full] * 7), 1 << 18)
    b = compare("count=0 (empty)", random_job_words(5, 0, [full] * 8), 4096)
    check(int(b[2 * k]) == 0 and int(b[2 * k + 2]) == full, "empty window")
    b = compare("table overflow n > k", random_job_words(7, None,
                                                         [1 << 26] + [full] * 7),
                1 << 16)
    check(int(b[2 * k]) > k, "overflow case did not overflow")

    # CudaBackend's bisecting rescan against the plain version's winners
    cb = CudaBackend(dev)
    target = (1 << 26) << 224 | ((1 << 224) - 1)      # ~1/64 of lanes win
    ov = JobConstants.from_header_prefix(bytes(rng.integers(0, 256, 76, dtype=np.uint8)),
                                         target)
    count = 3000
    res = cb.search(ov, 12345, count)
    pb = plain_buf(ov.job_words(12345, count), count, kk=count)
    pwn, _, pn, pmin = sc.unpack_winner_buffer(pb, count)
    check(pn > k, "bisect case did not overflow")
    check([w.nonce_word for w in res.winners] == [int(x) for x in pwn[:pn]],
          "CudaBackend bisect winners != plain winners")
    check(res.best_hash_hi == pmin and res.hashes == count, "bisect telemetry")
    print(f"   CudaBackend bisect: {pn} winners in {count} lanes equal", flush=True)

    # the main path's launch shape: 2^31 lanes, k=16, ~8 winners
    jw = random_job_words(int(rng.integers(1 << 32)), None, [16] + [full] * 7)
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    a = kernel_buf(jw, MAIN_BATCH)
    kernel_main_s = time.monotonic() - t0
    t0 = time.monotonic()
    b = plain_buf(jw, MAIN_BATCH, chunk=1 << 24)
    plain_main_s = time.monotonic() - t0
    check(int(b[2 * k]) <= k, "main-shape case overflowed")
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    check(not diff.any(), f"2^31 launch: kernel {a.tolist()} != plain {b.tolist()}")
    max_abs_err = max(max_abs_err, int(diff.max()))
    print(f"   main shape 2^31 lanes: n={b[2 * k]} equal; kernel "
          f"{kernel_main_s * 1e3:.1f} ms (first call), plain "
          f"{plain_main_s:.1f} s", flush=True)

    # -- 4. main path ---------------------------------------------------------
    phase("4 main path: solo Application on the card, difficulty 1")
    cfg = AppConfig()
    cfg.mining.device = "cuda"
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.5
    chain = MockChainClient(nbits=0x1D00FFFF)
    app = Application(cfg, chain=chain)

    async def run_main_path():
        await app.start()
        try:
            t_end = time.monotonic() + MAIN_PATH_BOUND_S
            while app.engine.state.value != "running":
                check(time.monotonic() < t_end, "engine never started")
                check(not any(t.done() and not t.cancelled() and t.exception()
                              for t in app._tasks),
                      "a background task failed before the engine started")
                await asyncio.sleep(0.05)
            t_start = time.monotonic()
            while len(chain.submitted) < BLOCKS_NEEDED:
                check(time.monotonic() < t_end,
                      f"only {len(chain.submitted)} blocks in "
                      f"{MAIN_PATH_BOUND_S:.0f} s")
                await asyncio.sleep(0.05)
            return time.monotonic() - t_start, app.engine.stats.hashes
        finally:
            await app.stop()

    sc.launches.reset()
    st.calls.reset()
    seconds, hashes = asyncio.run(run_main_path())
    main_launches = sc.launches.value
    main_plain_calls = st.calls.value
    chain_target = tgt.bits_to_target(0x1D00FFFF)
    for height, header, block_hash in chain.submitted:
        d = hashlib.sha256(hashlib.sha256(header).digest()).digest()
        check(int.from_bytes(d, "little") <= chain_target
              and d[::-1].hex() == block_hash,
              f"block {height} fails hashlib re-check")
        print(f"   block {height}: {block_hash}", flush=True)
    check(main_launches > 0, "main path launched no kernel")
    check(main_plain_calls == 0, f"main path called the plain version "
          f"{main_plain_calls} times")
    print(f"   {len(chain.submitted)} blocks, {hashes} hashes in {seconds:.2f} s"
          f" = {hashes / seconds / 1e9:.3f} GH/s end to end; kernel launches "
          f"{main_launches}, plain-version calls {main_plain_calls}", flush=True)

    # -- 5. times ---------------------------------------------------------------
    phase("5 kernel time per 2^31-nonce launch")
    jw = random_job_words(0, None, tgt.target_to_limbs(chain_target))
    stream = torch.cuda.Stream(dev)
    out = torch.empty(sc.winner_buffer_words(k), dtype=torch.int32, device=dev)
    reps, rounds = 5, 3
    sc.sha256d_search(jw, batch=MAIN_BATCH, device=dev, stream=stream, out=out)
    round_ms = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            sc.sha256d_search(jw, batch=MAIN_BATCH, device=dev, stream=stream,
                              out=out)
        stop.record(stream)
        stop.synchronize()
        round_ms.append(start.elapsed_time(stop) / reps)
    kernel_ms = sorted(round_ms)[rounds // 2]
    print(f"   {rounds} rounds of {reps} launches, ms per launch: "
          + ", ".join(f"{t:.2f}" for t in round_ms), flush=True)
    ops = sc.ops_per_nonce()
    int_ops_per_s = props.multi_processor_count * 64 * clock_mhz * 1e6
    ops_ms = ops * MAIN_BATCH / int_ops_per_s * 1e3
    bytes_ms = (sc.JOB_WORDS + sc.winner_buffer_words(k)) * 4 / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"   kernel {kernel_ms:.2f} ms = {MAIN_BATCH / kernel_ms / 1e6:.3f} GH/s;"
          f" bound {bound_ms:.2f} ms = {MAIN_BATCH / bound_ms / 1e6:.3f} GH/s "
          f"({ops} int32 ops/nonce over {props.multi_processor_count} SMs x 64 "
          f"lanes x {clock_mhz:.0f} MHz); plain version "
          f"{plain_main_s * 1e3:.0f} ms for a 2^31-lane launch; "
          f"{card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "sha256d_search",
        "route": "cuda",
        "source": "otedama_tpu_torch/kernels/csrc/sha256d_search.cu",
        "replaces": "otedama_tpu/kernels/sha256_pallas.py:293",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_main_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # no lingering executor thread may hold the process open
    os._exit(rc)
