"""The one generator of traffic: it reads a mix's data file
(portbench/traffic/<mix>.json) and draws every input of a run from the
seed during set-up, so the measured window only hands them to the port.
A mix's `kind` names its driver (portbench/cells/<kind>.py).

Kinds of mix:

  refresh  a closed loop of master ticks, each standing for one tick
           interval of the deployment's clients: every lease is
           refreshed once per refresh interval (a fixed phase a lease,
           dealt from the seed, so each iteration refreshes the same
           share of the leases), and each client's wants follow its
           recipe, redrawn once per recipe interval (a fixed phase a
           client) and sent with its next refresh.

Recipes (upstream doorman go/client/recipe/recipe.go, the load-test
client's `--recipes`): `random_change` draws base + change x U(-1, 1).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

# Stream ids of the seed's generators (numpy SeedSequence spawn keys).
_POPULATION, _REFRESH = 1, 2


def load_mix(root: Path, name: str) -> dict:
    path = root / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def recipe_wants(mix: dict, gen: np.random.Generator, shape) -> np.ndarray:
    """Wants drawn by the mix's recipe (float64)."""
    r = mix["recipe"]
    if r["function"] != "random_change":
        raise ValueError(f"no recipe function {r['function']!r}")
    return r["base"] + r["change"] * gen.uniform(-1.0, 1.0, shape)


def population_wants(mix: dict, seed: int, shape) -> np.ndarray:
    """The population's demand: every client's first draw."""
    return recipe_wants(mix, rng(seed, _POPULATION), shape)


def _ratio(a: float, b: float, what: str) -> int:
    n = int(round(a / b))
    if n < 1 or abs(n * b - a) > 1e-9 * a:
        raise ValueError(f"{what}: {a} is no whole multiple of {b}")
    return n


class RefreshPlan:
    """The refreshes of every iteration. Lease l (resource-major index)
    has refresh phase f(l) < F (F = refresh interval / tick interval)
    and recipe phase r(l) < M (M = recipe interval / refresh interval),
    dealt from a permutation so that every seed has the same counts.
    Iteration i refreshes the leases of phase i mod F, in the
    permutation's order; a lease's wants change at the refreshes of
    cycles c = i // F with c = r(l) mod M, alternating between two draws
    (its population wants and a second draw), so that the plan repeats
    every P = 2 M F iterations and holds P arrays of wants."""

    def __init__(self, initial: np.ndarray, mix: dict, seed: int,
                 refresh_interval: float, tick_interval: float):
        a = np.ascontiguousarray(initial, np.float64).ravel()
        N = len(a)
        F = _ratio(refresh_interval, tick_interval, "refresh interval")
        M = _ratio(float(mix["recipe"]["interval_s"]), refresh_interval,
                   "recipe interval")
        gen = rng(seed, _REFRESH)
        perm = gen.permutation(N)
        b = recipe_wants(mix, gen, N)
        pos = np.empty(N, np.int64)
        pos[perm] = np.arange(N)
        recipe = (pos // F) % M
        self.F, self.M, self.P, self.n_leases = F, M, 2 * M * F, N
        self.initial = a
        self.members: List[np.ndarray] = [perm[f::F] for f in range(F)]
        self.pool: List[np.ndarray] = []
        for k in range(self.P):
            m = self.members[k % F]
            c = k // F
            r = recipe[m]
            changes = np.where(c >= r, (c - r) // M + 1, 0)
            self.pool.append(np.where(changes % 2 == 1, b[m], a[m]))
        self.rids: List[np.ndarray] = []
        self.cids: List[np.ndarray] = []

    def bind(self, rid: np.ndarray, cids: np.ndarray) -> None:
        """Engine handles from the population ([R], [R, clients])."""
        C = cids.shape[1]
        flat = cids.ravel()
        self.rids = [np.ascontiguousarray(rid[m // C], np.int32)
                     for m in self.members]
        self.cids = [np.ascontiguousarray(flat[m]) for m in self.members]

    def batch(self, i: int):
        """(resource handles, client handles, wants) of iteration i."""
        f = i % self.F
        return self.rids[f], self.cids[f], self.pool[i % self.P]

    def size(self, i: int) -> int:
        return len(self.members[i % self.F])

    def key(self, i: int):
        """Iterations with one key leave the table with the same wants
        (the plan repeats every P once every phase has been sent)."""
        return i % self.P if i >= self.F - 1 else ("head", i)

    def state(self, i: int) -> np.ndarray:
        """[N] every lease's wants once iterations 0..i have been sent."""
        out = self.initial.copy()
        for f in range(self.F):
            if i >= f:
                j = i - (i - f) % self.F
                out[self.members[f]] = self.pool[j % self.P]
        return out
