"""Shadow-oracle audit: the bit-identity discipline as a production
invariant.

Every device lane in this repo is pinned bit-identical to a numpy host
oracle — at test time. This module enforces the same pin on a *live*
server: every K ticks (and on every ``solve_mode`` transition) the
tick loop snapshots each resource's staged solve inputs (kind,
capacity, static parameter, and the store's has/wants/subclients rows
— cheap host copies, no device sync) and replays them through
:func:`doorman_tpu_torch.algorithms.tick.oracle_row` **off the hot path** in
a single-thread executor, comparing the oracle's grants against the
store of record.

The comparison leans on a fixpoint property of the lanes: at a
converged, delivered row one more oracle tick is idempotent —
``oracle_row(..., wants, has, sub) == has``. Lanes whose output is
has-independent (NO_ALGORITHM, STATIC, FAIR_SHARE, MAX_MIN_FAIR,
BALANCED_FAIRNESS, PROPORTIONAL_FAIRNESS) reach that fixpoint one
delivered tick after a wants change; the proportional lanes
(PROPORTIONAL_SHARE, PROPORTIONAL_TOPUP) converge toward it under
constant wants. Mid-convergence and delivery-lag states are absorbed
by the **two-strike rule**: a resource is flagged only when it
mismatches at two consecutive audit samples with an *identical* input
digest — a legitimately converging or lag-delayed row changes ``has``
between samples, so its digest moves; a corrupted-but-stable grant
does not. Each offending digest is flagged once, so divergence counts
are deterministic.

Tolerance is bit-exact by default; the iterative fairness lanes
(MAX_MIN_FAIR, BALANCED_FAIRNESS, PROPORTIONAL_FAIRNESS) get a few-ulp
relative bound because their oracles re-run an iteration whose
floating-point reassociation is not replayed exactly by the fixpoint
check. Resources in learning mode, empty stores, and lanes without a
scalar oracle (PRIORITY_BANDS) are skipped.

On divergence the auditor invokes its ``on_divergence`` hook (the
server wires this to a flight-recorder error record + auto-dump, the
``doorman_audit_divergence`` counter, and an ``audit.divergence``
trace instant) and keeps a standing nonzero ``divergences`` count that
``evaluate_slos`` turns into a failing audit gate.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.algorithms.tick import oracle_row
from doorman_tpu_torch.core.resource import algo_kind_for, static_param

log = logging.getLogger(__name__)

__all__ = ["ShadowAuditor", "ITERATIVE_LANES", "ITERATIVE_REL_BOUND"]

# Lanes audited against a relative bound instead of bit-exactly (see
# module docstring). Everything else must match to the bit.
ITERATIVE_LANES = frozenset(
    {
        AlgoKind.MAX_MIN_FAIR,
        AlgoKind.BALANCED_FAIRNESS,
        AlgoKind.PROPORTIONAL_FAIRNESS,
    }
)
# "A few ulps" at f64: the iterative oracles reassociate sums across
# rounds; anything beyond this is a real divergence, not rounding.
ITERATIVE_REL_BOUND = 4 * np.finfo(np.float64).eps

# Lanes with no scalar oracle: skipped (learning-mode resources are
# skipped separately — their grants echo wants by design).
_SKIP_LANES = frozenset({AlgoKind.PRIORITY_BANDS})


class ShadowAuditor:
    """Sampled fixpoint audit of a server's stores against the host
    oracles. ``sample`` is K (audit every K ticks); ``inline`` runs the
    comparison synchronously on the caller's thread — the chaos runner
    uses it so verdicts are byte-stable, the live server leaves it off
    so the compare rides the executor."""

    def __init__(
        self,
        *,
        sample: int = 8,
        inline: bool = False,
        on_divergence: Optional[Callable[[dict], None]] = None,
        max_details: int = 32,
        clock=time.time,
    ):
        if sample <= 0:
            raise ValueError("sample interval must be positive")
        self.sample = int(sample)
        self.inline = bool(inline)
        self.on_divergence = on_divergence
        self._clock = clock
        self._lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = (
            None
            if inline
            else ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="shadow-audit"
            )
        )
        self._last_solve_mode: Optional[str] = None
        # rid -> digest of the inputs that mismatched at the previous
        # sample (strike one); guarded-by: _lock
        self._pending: Dict[str, str] = {}
        # digests already flagged — each offending state counts once,
        # so divergence totals are deterministic; guarded-by: _lock
        self._flagged: set = set()
        self.samples = 0
        self.compared_resources = 0
        self.divergences = 0
        self.details: List[dict] = []  # bounded; guarded-by: _lock
        self._max_details = int(max_details)

    # -- sampling (hot path: snapshot only) -----------------------------

    def should_sample(self, tick: int, solve_mode: Optional[str]) -> bool:
        transition = (
            self._last_solve_mode is not None
            and solve_mode != self._last_solve_mode
        )
        self._last_solve_mode = solve_mode
        return transition or (tick % self.sample == 0)

    def snapshot(self, resources: Dict[str, object], tick: int
                 ) -> List[dict]:
        """Host-side copies of every auditable resource's staged solve
        inputs. O(rows) numpy copies off the store dump — no device
        work, safe inside the tick lock."""
        out: List[dict] = []
        for rid, res in sorted(resources.items()):
            if res.in_learning_mode:
                continue
            try:
                kind = algo_kind_for(res.template)
            except Exception:
                continue
            if kind in _SKIP_LANES:
                continue
            rows = res.store.dump_rows()
            if not rows:
                continue
            out.append(
                {
                    "rid": rid,
                    "tick": tick,
                    "kind": int(kind),
                    "capacity": float(res.capacity),
                    "static": float(static_param(res.template)),
                    "clients": [r[0] for r in rows],
                    "has": np.array([r[3] for r in rows], np.float64),
                    "wants": np.array([r[4] for r in rows], np.float64),
                    "sub": np.array([r[5] for r in rows], np.float64),
                }
            )
        return out

    def maybe_sample(
        self,
        tick: int,
        solve_mode: Optional[str],
        resources: Dict[str, object],
    ) -> bool:
        """The server's per-tick hook: cheap predicate, snapshot when
        due, compare off-thread (or inline). Returns whether a sample
        was taken."""
        if not self.should_sample(tick, solve_mode):
            return False
        snap = self.snapshot(resources, tick)
        self.samples += 1
        if self.inline or self._executor is None:
            self._compare(snap)
        else:
            self._executor.submit(self._compare_safe, snap)
        return True

    # -- comparison (off the hot path) ----------------------------------

    def _compare_safe(self, snap: List[dict]) -> None:
        try:
            self._compare(snap)
        except Exception:
            log.exception("shadow audit comparison failed")

    @staticmethod
    def _digest(entry: dict) -> str:
        h = hashlib.sha256()
        h.update(
            f"{entry['rid']}|{entry['kind']}|{entry['capacity']!r}|"
            f"{entry['static']!r}".encode()
        )
        h.update(entry["has"].tobytes())
        h.update(entry["wants"].tobytes())
        h.update(entry["sub"].tobytes())
        return h.hexdigest()[:16]

    def _compare(self, snap: List[dict]) -> None:
        with self._lock:
            self.compared_resources += len(snap)
        for entry in snap:
            expect = oracle_row(
                entry["kind"],
                entry["capacity"],
                entry["static"],
                entry["wants"],
                entry["has"],
                entry["sub"],
            )
            has = entry["has"]
            if entry["kind"] in ITERATIVE_LANES:
                scale = np.maximum(np.abs(has), np.abs(expect))
                bad = np.abs(expect - has) > ITERATIVE_REL_BOUND * np.maximum(
                    scale, 1.0
                )
            else:
                bad = expect != has
            rid = entry["rid"]
            if not bool(np.any(bad)):
                with self._lock:
                    self._pending.pop(rid, None)
                continue
            digest = self._digest(entry)
            detail = None
            with self._lock:
                prev = self._pending.get(rid)
                self._pending[rid] = digest
                if prev != digest or digest in self._flagged:
                    # Strike one (inputs moved since the last sample:
                    # convergence/delivery lag, not corruption) — or a
                    # state already flagged once.
                    continue
                self._flagged.add(digest)
                self.divergences += 1
                idx = [int(i) for i in np.nonzero(bad)[0][:8]]
                detail = {
                    "rid": rid,
                    "tick": entry["tick"],
                    "kind": int(entry["kind"]),
                    "digest": digest,
                    "rows": idx,
                    "clients": [entry["clients"][i] for i in idx],
                    "has": [float(has[i]) for i in idx],
                    "expected": [float(expect[i]) for i in idx],
                    "at": self._clock(),
                }
                if len(self.details) < self._max_details:
                    self.details.append(detail)
            log.error(
                "shadow-oracle divergence on %s (lane %d): store %s vs "
                "oracle %s",
                rid, entry["kind"], detail["has"], detail["expected"],
            )
            if self.on_divergence is not None:
                try:
                    self.on_divergence(detail)
                except Exception:
                    log.exception("audit on_divergence hook failed")

    # -- lifecycle / status ---------------------------------------------

    def drain(self) -> None:
        """Block until queued comparisons have run (tests, chaos)."""
        if self._executor is not None:
            self._executor.submit(lambda: None).result()

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
            self.inline = True

    def status(self) -> dict:
        with self._lock:
            return {
                "sample": self.sample,
                "inline": self.inline,
                "samples": self.samples,
                "compared_resources": self.compared_resources,
                "divergences": self.divergences,
                "pending": len(self._pending),
                "details": [dict(d) for d in self.details],
            }
