"""Command-line interface: ``init``, ``start``, ``solo``, ``pool``,
``p2p``, ``benchmark`` and ``status`` (counterpart of
``otedama_tpu/cli.py``).

Run as ``python -m otedama_tpu_torch.cli <command>``. Every command runs
on the card (``mining.device`` / ``--device`` ``cuda``) unless asked for
another device; ``start`` with ``upstreams`` in the config mines for
those pools, ``pool --mine`` serves miners and mines for itself through a
loopback stratum client, and ``p2p --mine`` does the same while its node
keeps the share chain of the gossip overlay (durable under
``p2p.chain_dir``). ``status`` asks a running instance's API (``api``
section of the config) for ``/api/v1/status``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys
import urllib.request


def _setup_logging(level: str, logfile: str = "") -> None:
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if logfile:
        from logging.handlers import RotatingFileHandler

        handlers.append(RotatingFileHandler(
            logfile, maxBytes=32 * 1024 * 1024, backupCount=5
        ))
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)-7s %(name)s: %(message)s",
        handlers=handlers,
    )


def cmd_init(args) -> int:
    from otedama_tpu_torch.config.schema import example_yaml

    path = args.config or "otedama.yaml"
    if os.path.exists(path) and not args.force:
        print(f"{path} already exists (use --force to overwrite)",
              file=sys.stderr)
        return 1
    with open(path, "w") as f:
        f.write(example_yaml())
    print(f"wrote {path}")
    return 0


async def _run_app(cfg) -> int:
    from otedama_tpu_torch.app import Application

    app = Application(cfg)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover - non-unix
            pass
    try:
        await app.start()
        await stop.wait()
    finally:
        await app.stop()
    return 0


def cmd_start(args) -> int:
    from otedama_tpu_torch.config.schema import load_config

    cfg = load_config(args.config)
    _setup_logging(cfg.logging.level, cfg.logging.file)
    return asyncio.run(_run_app(cfg))


def cmd_solo(args) -> int:
    from otedama_tpu_torch.config.schema import load_config

    cfg = load_config(args.config)
    cfg.mining.enabled = True
    cfg.pool.enabled = False
    cfg.upstreams = []
    cfg.mining.device = args.device
    if args.algorithm:
        cfg.mining.algorithm = args.algorithm
    if args.backend:
        cfg.mining.backend = args.backend
    _setup_logging(cfg.logging.level, cfg.logging.file)
    return asyncio.run(_run_app(cfg))


def cmd_pool(args) -> int:
    from otedama_tpu_torch.config.schema import load_config

    cfg = load_config(args.config)
    cfg.pool.enabled = True
    cfg.stratum.enabled = True
    cfg.mining.enabled = args.mine
    _setup_logging(cfg.logging.level, cfg.logging.file)
    return asyncio.run(_run_app(cfg))


def cmd_p2p(args) -> int:
    from otedama_tpu_torch.config.schema import load_config

    cfg = load_config(args.config)
    cfg.p2p.enabled = True
    cfg.pool.enabled = True
    cfg.mining.enabled = args.mine
    _setup_logging(cfg.logging.level, cfg.logging.file)
    return asyncio.run(_run_app(cfg))


def cmd_benchmark(args) -> int:
    _setup_logging("info")
    from otedama_tpu_torch.engine import algos
    from otedama_tpu_torch.engine.algo_manager import AlgorithmManager

    mgr = AlgorithmManager(args.backend, device=args.device)
    names = [args.algorithm] if args.algorithm else algos.names(implemented_only=True)
    results = {}
    for name in names:
        r = mgr.benchmark(name, budget_hashes=args.hashes)
        results[f"{name}/{r.backend}"] = r.hashrate
        print(f"{name:10s} {r.backend:12s} {r.hashrate:>14,.0f} H/s")
    print(json.dumps({"benchmarks_h_per_s": results, "device": args.device}))
    return 0 if results else 1


def cmd_status(args) -> int:
    from otedama_tpu_torch.config.schema import load_config

    cfg = load_config(args.config)
    url = f"http://{cfg.api.host}:{cfg.api.port}/api/v1/status"
    try:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            print(json.dumps(json.loads(resp.read()), indent=2))
        return 0
    except OSError as e:
        print(f"cannot reach {url}: {e}", file=sys.stderr)
        return 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="otedama-tpu-torch",
        description="sha256d, scrypt, x11 or ethash mining, a stratum pool "
                    "and a P2P pool on a CUDA card (PyTorch port).",
    )
    parser.add_argument("-c", "--config", default=None, help="config YAML path")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="write an example config file")
    p.add_argument("--force", action="store_true")
    p.set_defaults(fn=cmd_init)

    p = sub.add_parser("start", help="start with the config file as-is "
                       "(upstreams: mine for those pools)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("solo", help="solo-mine against the node at "
                       "pool.chain_rpc_url, else the mock chain")
    p.add_argument("-a", "--algorithm", default=None,
                   help="sha256d (default) | sha256 | scrypt | x11 | ethash")
    p.add_argument("-b", "--backend", default=None,
                   help="auto (= cuda) | cuda | torch | python")
    p.add_argument("--device", default="cuda", help="torch device")
    p.set_defaults(fn=cmd_solo)

    p = sub.add_parser("pool", help="run a stratum pool server")
    p.add_argument("--mine", action="store_true",
                   help="also mine locally, through a loopback client")
    p.set_defaults(fn=cmd_pool)

    p = sub.add_parser("p2p", help="run a P2P pool node")
    p.add_argument("--mine", action="store_true",
                   help="also mine locally, through a loopback client")
    p.set_defaults(fn=cmd_p2p)

    p = sub.add_parser("benchmark", help="benchmark the search backend")
    p.add_argument("-a", "--algorithm", default=None,
                   help="one algorithm (default: every implemented one)")
    p.add_argument("-b", "--backend", default="auto")
    p.add_argument("-n", "--hashes", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device")
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("status", help="query a running instance's API")
    p.set_defaults(fn=cmd_status)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
