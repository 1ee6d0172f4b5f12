"""Payout calculation: PPS / PPLNS / PROP / SOLO / FPPS (counterpart of
``otedama_tpu/pool/payouts.py``; the fee distributor comes with the pool
modes).

Reference parity: internal/pool/payout_calculator.go:82-171 (scheme consts,
per-currency config, worker share aggregation), fee_distributor.go:16-76.
Amounts are integer atomic units; remainders from integer division go to the
largest share-holder so every distributed block sums exactly to
``reward - pool_fee`` (the reference's big.Int math leaks dust).
"""

from __future__ import annotations

import dataclasses
import enum
import time


class PayoutScheme(enum.Enum):
    PPS = "PPS"        # pay per share at fixed rate, pool absorbs variance
    PPLNS = "PPLNS"    # split block over last-N shares
    PROP = "PROP"      # split block over shares since previous block
    SOLO = "SOLO"      # block finder takes all
    FPPS = "FPPS"      # PPS + tx-fee share


@dataclasses.dataclass
class PayoutConfig:
    scheme: PayoutScheme = PayoutScheme.PPLNS
    pplns_window: int = 10000            # shares in the PPLNS window
    pool_fee_percent: float = 1.0
    minimum_payout: int = 100_000        # atomic units
    payout_fee: int = 1_000              # per-tx network fee charged to worker
    currency: str = "BTC"
    coinbase_maturity: int = 100
    # PPS: expected value per difficulty-1 share = block_reward / network_diff
    pps_rate_per_diff1: float = 0.0


@dataclasses.dataclass
class WorkerPayout:
    worker: str
    amount: int
    share_value: float       # sum of share difficulties credited
    percentage: float


@dataclasses.dataclass
class PayoutResult:
    scheme: PayoutScheme
    block_reward: int
    pool_fee: int
    payouts: list[WorkerPayout]
    total_share_value: float
    calculated_at: float = dataclasses.field(default_factory=time.time)

    @property
    def distributed(self) -> int:
        return sum(p.amount for p in self.payouts)


def _split_proportional(
    reward_after_fee: int, weights: dict[str, float]
) -> list[WorkerPayout]:
    total = sum(weights.values())
    if total <= 0:
        return []
    # integer floor split, remainder to the largest weight (exact-sum invariant)
    out: list[WorkerPayout] = []
    floor_sum = 0
    for worker, weight in sorted(weights.items()):
        amt = int(reward_after_fee * (weight / total))
        floor_sum += amt
        out.append(WorkerPayout(worker, amt, weight, weight / total))
    if out:
        remainder = reward_after_fee - floor_sum
        # remainder tie-break must be FULLY deterministic: settlement ids
        # and replayed ledgers hash these amounts, so equal share_values
        # break by worker name, never by list order
        biggest = min(out, key=lambda p: (-p.share_value, p.worker))
        biggest.amount += remainder
    return out


class PayoutCalculator:
    """Turns (shares window, block reward) into per-worker amounts."""

    def __init__(self, config: PayoutConfig | None = None):
        self.config = config or PayoutConfig()

    def pool_fee(self, reward: int) -> int:
        return int(reward * self.config.pool_fee_percent / 100.0)

    def calculate_block(
        self,
        reward: int,
        shares: list[dict],
        finder: str | None = None,
    ) -> PayoutResult:
        """Distribute a found block's reward.

        ``shares``: dicts with at least ``worker`` and ``difficulty`` keys —
        the PPLNS last-N window or the PROP round window, ordered oldest
        first (the repository provides either).
        """
        cfg = self.config
        fee = self.pool_fee(reward)
        after_fee = reward - fee

        if cfg.scheme == PayoutScheme.SOLO:
            payouts = (
                [WorkerPayout(finder, after_fee, 1.0, 1.0)] if finder else []
            )
            total = 1.0
        elif cfg.scheme in (PayoutScheme.PPLNS, PayoutScheme.PROP):
            window = (
                shares[-cfg.pplns_window:]
                if cfg.scheme == PayoutScheme.PPLNS
                else shares
            )
            weights: dict[str, float] = {}
            for s in window:
                weights[s["worker"]] = weights.get(s["worker"], 0.0) + float(
                    s["difficulty"]
                )
            payouts = _split_proportional(after_fee, weights)
            total = sum(weights.values())
        elif cfg.scheme in (PayoutScheme.PPS, PayoutScheme.FPPS):
            # PPS pays continuously via pps_credit(); at block time nothing
            # extra is distributed (FPPS adds the fee share, folded into rate)
            payouts = []
            total = 0.0
        else:  # pragma: no cover
            raise ValueError(f"unknown scheme {cfg.scheme}")

        return PayoutResult(
            scheme=cfg.scheme,
            block_reward=reward,
            pool_fee=fee,
            payouts=payouts,
            total_share_value=total,
        )

    def pps_credit(self, share_difficulty: float) -> int:
        """Immediate PPS credit for one accepted share."""
        cfg = self.config
        if cfg.scheme not in (PayoutScheme.PPS, PayoutScheme.FPPS):
            return 0
        rate = cfg.pps_rate_per_diff1 * (
            1.0 + (0.02 if cfg.scheme == PayoutScheme.FPPS else 0.0)
        )
        credit = share_difficulty * rate * (1.0 - cfg.pool_fee_percent / 100.0)
        return int(credit)


def stage_payable_workers(
    workers: list[dict], cfg: PayoutConfig
) -> list[tuple[str, str, int]]:
    """The one payout-eligibility rule, shared by every payer: workers
    whose balance clears ``minimum_payout`` AND nets positive after the
    per-payout fee become ``(worker, address, payable)`` rows; everyone
    else carries forward. Address falls back to the stratum-convention
    account half of ``account.rig``. Both the legacy interval loop
    (PoolManager.process_payouts) and the settlement engine stage
    through here — the settlement ledger hashes these amounts, so the
    rule must never diverge between payers."""
    out: list[tuple[str, str, int]] = []
    for w in workers:
        balance = int(w["balance"])
        payable = balance - cfg.payout_fee
        if balance >= cfg.minimum_payout and payable > 0:
            address = w["wallet"] or w["name"].split(".")[0]
            out.append((w["name"], address, payable))
    return out
