"""SLO-driven elastic shard count: hysteresis + cool-down.

The SLO engine (obs/slo.py) already renders the fleet's health as
verdict dicts — tick budget, goodput, satisfaction — so the autoscaler
is deliberately small: it turns a STREAK of same-signed verdicts into
one shard-count step, and then refuses to move again until the
cool-down lapses. Both guards exist because verdict noise is real
(a single stressed tick fails a gate; a single quiet tick passes with
huge margin) and a fleet that flaps 2→3→2→3 pays the reshard drain
window each way while delivering nothing.

Signals:

  * GROW when any watched verdict FAILS (the fleet is missing an
    objective — more shards is the lever this controller owns);
  * SHRINK when every watched verdict passes with at least
    `shrink_margin` headroom (margin is the engine's absolute
    headroom: target - observed for "max" gates, observed - target
    for "min");
  * HOLD otherwise, and any signal flip resets the streak.

`observe()` returns the target shard count when a step fires, else
None; the caller (workload autoscale generator, cmd.fleet loop) owns
actually calling FleetController.reshard.

Port of doorman_tpu/fleet/autoscale.py: a copy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["Autoscaler"]


class Autoscaler:
    def __init__(
        self,
        *,
        min_shards: int,
        max_shards: int,
        step: int = 1,
        hysteresis: int = 3,
        cooldown: int = 6,
        shrink_margin: float = 0.0,
    ):
        if not 1 <= min_shards <= max_shards:
            raise ValueError(
                f"bounds [{min_shards}, {max_shards}] are not a range"
            )
        self.min_shards = int(min_shards)
        self.max_shards = int(max_shards)
        self.step = int(step)
        self.hysteresis = int(hysteresis)
        self.cooldown = int(cooldown)
        self.shrink_margin = float(shrink_margin)
        # Signed streak: positive = consecutive grow signals, negative
        # = consecutive shrink signals.
        self._streak = 0
        self._last_change: Optional[int] = None
        self.decisions: List[dict] = []

    def _signal(self, verdicts: Sequence[dict]) -> int:
        scored = [v for v in verdicts if v.get("status") != "no_data"]
        if not scored:
            return 0
        if any(v.get("status") == "fail" for v in scored):
            return 1
        if all(
            (v.get("margin") or 0.0) >= self.shrink_margin
            for v in scored
        ):
            return -1
        return 0

    def observe(
        self, tick: int, verdicts: Sequence[dict], current: int
    ) -> Optional[int]:
        """Fold one tick's verdicts in. Returns the new target shard
        count when hysteresis + cool-down + bounds all clear, else
        None."""
        signal = self._signal(verdicts)
        if signal == 0 or (signal > 0) != (self._streak > 0):
            self._streak = signal
        else:
            self._streak += signal
        if abs(self._streak) < self.hysteresis:
            return None
        if (
            self._last_change is not None
            and tick - self._last_change < self.cooldown
        ):
            return None
        target = current + self.step * (1 if self._streak > 0 else -1)
        target = max(self.min_shards, min(self.max_shards, target))
        if target == current:
            return None
        self._last_change = tick
        reason = "grow:fail-streak" if self._streak > 0 else (
            "shrink:margin-streak"
        )
        self._streak = 0
        self.decisions.append(
            {"tick": tick, "from": current, "to": target,
             "reason": reason}
        )
        return target

    def status(self) -> dict:
        return {
            "bounds": [self.min_shards, self.max_shards],
            "hysteresis": self.hysteresis,
            "cooldown": self.cooldown,
            "shrink_margin": self.shrink_margin,
            "streak": self._streak,
            "last_change": self._last_change,
            "decisions": list(self.decisions),
        }
