"""Port parity, the slice as a whole: the solo sha256d path of the PyTorch
package against the JAX package on the CPU.

- host job assembly (header prefix, coinbase halves, templates) is
  byte-identical;
- the port's ``MiningEngine`` on ``TorchBackend("cpu")`` and the reference
  ``MiningEngine`` on ``XlaBackend`` emit the same shares for one job;
- the port's solo ``Application`` gets a block accepted by its mock chain,
  and the reference's mock chain accepts the same header;
- importing the port pulls in neither ``jax`` nor ``otedama_tpu``.
"""

from __future__ import annotations

import asyncio
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from otedama_tpu.engine import jobs as ref_jobs
from otedama_tpu.engine.engine import EngineConfig as RefEngineConfig
from otedama_tpu.engine.engine import MiningEngine as RefMiningEngine
from otedama_tpu.engine.types import Job as RefJob
from otedama_tpu.pool.blockchain import MockChainClient as RefMockChainClient
from otedama_tpu.runtime.search import XlaBackend
from otedama_tpu.work import template as ref_template
from otedama_tpu_torch.app import Application
from otedama_tpu_torch.config.schema import AppConfig, load_config
from otedama_tpu_torch.engine import jobs
from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.pool.blockchain import MockChainClient
from otedama_tpu_torch.runtime.search import TorchBackend
from otedama_tpu_torch.work import template

REPO = Path(__file__).resolve().parents[1]
BATCH = 1024
HASHES = 4 * BATCH


def _job_fields(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def rb(n):
        return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()

    return dict(
        job_id=f"job-{seed}", prev_hash=rb(32), coinb1=rb(41), coinb2=rb(50),
        merkle_branch=[rb(32) for _ in range(3)], version=0x20000000,
        nbits=0x1D00FFFF, ntime=int(time.time()), clean=True,
        extranonce1=rb(4),
        # ~1 in 64 hashes is a share
        share_target=(1 << 26 << 224) | ((1 << 224) - 1),
    )


@pytest.mark.parametrize("seed", [1, 2])
def test_header_assembly_matches_reference(seed):
    f = _job_fields(seed)
    job, ref = Job(**f), RefJob(**f)
    for en2 in (b"\x00" * 4, b"\x12\x34\x56\x78"):
        assert jobs.build_header_prefix(job, en2) == ref_jobs.build_header_prefix(ref, en2)
        jc, rjc = jobs.job_constants(job, en2), ref_jobs.job_constants(ref, en2)
        assert (jc.midstate, jc.tail) == (rjc.midstate, rjc.tail)
        assert np.array_equal(jc.limbs, rjc.limbs)
        assert jobs.header_from_share(job, en2, 7, 0xDEADBEEF) == \
            ref_jobs.header_from_share(ref, en2, 7, 0xDEADBEEF)
    assert template.build_coinbase_halves(
        840_000, 312_500_000, bytes(range(22)), b"/otedama/", 8) == \
        ref_template.build_coinbase_halves(
            840_000, 312_500_000, bytes(range(22)), b"/otedama/", 8)


@pytest.mark.asyncio
async def test_template_source_matches_reference():
    port_chain, ref_chain = MockChainClient(), RefMockChainClient()
    src = template.TemplateSource(port_chain, extranonce1_len=0)
    ref = ref_template.TemplateSource(ref_chain, extranonce1_len=0)
    for _ in range(2):
        a, b = await src.poll_once(), await ref.poll_once()
        for field in ("prev_hash", "coinb1", "coinb2", "merkle_branch",
                      "version", "nbits", "clean", "block_number",
                      "share_target"):
            assert getattr(a, field) == getattr(b, field), field
        port_chain.bump_template()
        ref_chain.bump_template()


async def _shares(engine, job) -> set:
    found = []

    async def on_share(share):
        found.append(share)

    engine.on_share = on_share
    await engine.start()
    engine.set_job(job)
    deadline = time.monotonic() + 60.0
    while engine.stats.hashes < HASHES:
        assert time.monotonic() < deadline, "engine made no progress"
        await asyncio.sleep(0.01)
    await engine.stop()
    # the engines may run past HASHES before stopping: compare the prefix
    return {
        (s.job_id, s.extranonce2, s.nonce_word, s.digest) for s in found
        if s.extranonce2 == b"\x00" * 4 and s.nonce_word < HASHES
    }


@pytest.mark.asyncio
async def test_engine_emits_the_reference_engines_shares():
    f = _job_fields(3)
    port = MiningEngine({"torch": TorchBackend("cpu", chunk=BATCH)},
                        config=EngineConfig(batch_size=BATCH, auto_batch=False,
                                            pipeline_depth=2))
    ref = RefMiningEngine({"xla": XlaBackend(chunk=BATCH, rolled=True)},
                          config=RefEngineConfig(batch_size=BATCH,
                                                 auto_batch=False,
                                                 pipeline_depth=2))
    got = await _shares(port, Job(**f))
    want = await _shares(ref, RefJob(**f))
    assert got == want and len(got) > 10
    assert port.stats.shares_found >= len(got)


@pytest.mark.asyncio
async def test_solo_application_mines_a_block_on_cpu():
    cfg = AppConfig()
    cfg.mining.backend = "torch"
    cfg.mining.device = "cpu"
    cfg.mining.batch_size = BATCH
    cfg.work.enabled = True
    cfg.work.poll_seconds = 0.05
    chain = MockChainClient(nbits=0x2000FFFF)   # ~1 in 256 hashes is a block
    app = Application(cfg, chain=chain)
    await app.start()
    try:
        deadline = time.monotonic() + 60.0
        while not chain.submitted:
            assert time.monotonic() < deadline, app.snapshot()
            await asyncio.sleep(0.02)
    finally:
        await app.stop()
    assert app.engine.state.value == "stopped"
    assert app.snapshot()["engine"]["blocks_found"] >= 1
    _, header, block_hash = chain.submitted[0]
    ref_chain = RefMockChainClient(nbits=0x2000FFFF)
    outcome = await ref_chain.submit_block(header)
    assert outcome.accepted and outcome.block_hash == block_hash


def test_config_loads_and_validates(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("mining:\n  backend: torch\n  device: cpu\n"
                    "work:\n  poll_seconds: 0.5\n")
    cfg = load_config(str(path), environ={"OTEDAMA_MINING_BATCH_SIZE": "4096"})
    assert (cfg.mining.backend, cfg.mining.device) == ("torch", "cpu")
    assert cfg.mining.batch_size == 4096 and cfg.work.poll_seconds == 0.5
    with pytest.raises(ValueError, match="backend"):
        load_config(None, environ={"OTEDAMA_MINING_BACKEND": "pallas-tpu"})


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    modules = sorted(
        "otedama_tpu_torch." + ".".join(p.relative_to(REPO / "otedama_tpu_torch")
                                        .with_suffix("").parts)
        for p in (REPO / "otedama_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    assert len(modules) >= 20
    assert {"otedama_tpu_torch.kernels.cuda_build",
            "otedama_tpu_torch.kernels.scrypt_cuda",
            "otedama_tpu_torch.kernels.scrypt_torch",
            "otedama_tpu_torch.utils.pow_host",
            "otedama_tpu_torch.runtime.validate",
            "otedama_tpu_torch.pool.manager",
            "otedama_tpu_torch.db.database",
            "otedama_tpu_torch.runtime.supervision",
            "otedama_tpu_torch.runtime.failure",
            "otedama_tpu_torch.utils.netpool",
            "otedama_tpu_torch.stratum.protocol",
            "otedama_tpu_torch.stratum.server",
            "otedama_tpu_torch.stratum.client",
            "otedama_tpu_torch.stratum.resume",
            "otedama_tpu_torch.pool.failover",
            "otedama_tpu_torch.engine.vardiff",
            "otedama_tpu_torch.security.validation",
            "otedama_tpu_torch.security.ratelimit",
            "otedama_tpu_torch.security.ddos",
            "otedama_tpu_torch.db.pgwire",
            "otedama_tpu_torch.db.postgres",
            "otedama_tpu_torch.p2p.messages",
            "otedama_tpu_torch.p2p.node",
            "otedama_tpu_torch.p2p.memnet",
            "otedama_tpu_torch.p2p.sharechain",
            "otedama_tpu_torch.p2p.pool",
            "otedama_tpu_torch.p2p.chainstore",
            "otedama_tpu_torch.utils.logging_setup",
            "otedama_tpu_torch.security.auth",
            "otedama_tpu_torch.api.metrics",
            "otedama_tpu_torch.api.http",
            "otedama_tpu_torch.api.server",
            "otedama_tpu_torch.utils.certification",
            "otedama_tpu_torch.kernels.x11_torch",
            "otedama_tpu_torch.kernels.x11_cuda"} | {
            f"otedama_tpu_torch.kernels.x11.{stage}" for stage in (
                "blake", "bmw", "groestl", "skein", "jh", "keccak", "luffa",
                "cubehash", "shavite", "simd", "echo")} <= set(modules)
    # the API serves the port's own copies of the web pages
    pages = ("static/index.html", "admin/index.html", "admin/login.html")
    assert all((REPO / "otedama_tpu_torch" / "web" / p).is_file()
               for p in pages)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'otedama_tpu' or m.startswith('otedama_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
