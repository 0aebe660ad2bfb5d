"""Recipe-driven QPS schedules for loadtest workers.

Capability parity with reference go/client/recipe/recipe.go:207-313: a
recipe string like "5x100+sin(30)" starts 5 workers at base QPS 100 whose
QPS is re-derived by the named function every `interval`; every `reset`
the QPS snaps back to the base. Functions:

  - constant_increase(x): QPS += x each interval
  - random_change(x):     QPS = base + x * uniform(-1, 1)
  - sin(x):               QPS = x * sin(pi * t_since_reset / reset)
  - inc_sin(x):           QPS = resets_so_far * x * sin(pi * t / reset)

Redesign notes (idiomatic Python, not a flag-coupled port): parsing and
timing parameters are explicit arguments, the clock and RNG are injectable
(so schedules are exactly reproducible in tests and in the simulation
harness), and parse errors raise RecipeError instead of exiting.

Port of doorman_tpu/loadtest/recipe.py: a copy apart from import paths.
"""

from __future__ import annotations

import math
import random
import re
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

__all__ = ["Recipe", "RecipeError", "WorkerState", "parse_recipes"]

DEFAULT_INTERVAL = 60.0  # --recipe_interval default (1 min)
DEFAULT_RESET = 30 * 60.0  # --recipe_reset default (30 min)


class RecipeError(ValueError):
    """A recipe string could not be parsed."""


_RECIPE_RE = re.compile(
    r"^(\d+)x(\d+(?:\.\d+)?)\+(\w+)\(([^)]*)\)$"
)

# name -> (arity, fn(worker, args, rng) -> new QPS)
_FUNCS = {
    "constant_increase": (
        1,
        lambda w, a, rng: w.current_qps + a[0],
    ),
    "random_change": (
        1,
        lambda w, a, rng: w.recipe.base_qps + a[0] * rng.uniform(-1.0, 1.0),
    ),
    "sin": (
        1,
        lambda w, a, rng: a[0] * math.sin(
            math.pi * w.time_since_reset() / w.recipe.reset
        ),
    ),
    "inc_sin": (
        1,
        lambda w, a, rng: w.reset_count * a[0] * math.sin(
            math.pi * w.time_since_reset() / w.recipe.reset
        ),
    ),
}


@dataclass(frozen=True)
class Recipe:
    """A parsed recipe; read-only, shared by all its workers."""

    name: str
    num_workers: int
    base_qps: float
    args: tuple
    interval: float = DEFAULT_INTERVAL
    reset: float = DEFAULT_RESET

    def apply(self, worker: "WorkerState", rng: random.Random) -> float:
        return _FUNCS[self.name][1](worker, self.args, rng)


@dataclass
class WorkerState:
    """Per-worker schedule state. Call interval_expired() in the worker
    loop; when it returns True, current_qps holds the QPS for the new
    interval and old_qps the one just finished."""

    recipe: Recipe
    clock: Callable[[], float] = time.monotonic
    rng: random.Random = field(default_factory=random.Random)
    current_qps: float = 0.0
    old_qps: float = 0.0
    reset_count: int = 0
    _last_reset: float = 0.0
    _last_interval: float = 0.0

    def __post_init__(self) -> None:
        self.current_qps = self.recipe.base_qps
        self._start = self.clock()
        self._last_reset = self._start
        self._last_interval = self._start

    def time_since_reset(self) -> float:
        return self.clock() - self._last_reset

    def interval_expired(self) -> bool:
        now = self.clock()
        reset_expired = now > self._last_reset + self.recipe.reset
        interval_expired = now > self._last_interval + self.recipe.interval
        if reset_expired:
            self._last_reset = now
            self._last_interval = now
            self.reset_count += 1
            self.old_qps = self.current_qps
            self.current_qps = self.recipe.base_qps
        elif interval_expired:
            self._last_interval = now
            self.old_qps = self.current_qps
            self.current_qps = self.recipe.apply(self, self.rng)
        return reset_expired or interval_expired


def _split_recipes(text: str) -> List[str]:
    """Split a comma-separated recipe list, ignoring commas inside the
    function's argument parentheses."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def parse_recipes(
    text: str,
    *,
    interval: float = DEFAULT_INTERVAL,
    reset: float = DEFAULT_RESET,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
) -> List[WorkerState]:
    """Parse a recipe list like "5x100+sin(30),2x10+constant_increase(1)"
    into one WorkerState per worker (recipe.go:207-248)."""
    if not text:
        raise RecipeError("empty recipe list")
    workers: List[WorkerState] = []
    for part in _split_recipes(text):
        m = _RECIPE_RE.match(part)
        if m is None:
            raise RecipeError(f"cannot parse recipe {part!r} "
                              f"(expected e.g. '5x100+sin(30)')")
        count, base, name, arg_text = m.groups()
        if name not in _FUNCS:
            raise RecipeError(f"unknown recipe function {name!r} in {part!r}")
        try:
            args = tuple(
                float(a) for a in arg_text.split(",") if a.strip()
            )
        except ValueError as e:
            raise RecipeError(f"bad arguments in {part!r}: {e}") from None
        arity = _FUNCS[name][0]
        if len(args) != arity:
            raise RecipeError(
                f"{name} expects {arity} argument(s), got {len(args)} "
                f"in {part!r}"
            )
        recipe = Recipe(
            name=name,
            num_workers=int(count),
            base_qps=float(base),
            args=args,
            interval=interval,
            reset=reset,
        )
        for _ in range(recipe.num_workers):
            workers.append(
                WorkerState(
                    recipe=recipe,
                    clock=clock,
                    rng=rng if rng is not None else random.Random(),
                )
            )
    return workers
