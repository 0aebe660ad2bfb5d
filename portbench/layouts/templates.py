"""Layout `templates`: an upstream doorman configuration, its resource
templates as they are, and `resources` copies of the resource its
clients use, each held by `clients` clients.

Configuration keys: `templates` (ResourceTemplates as the upstream YAML
writes them; the server loads them as they stand, with
`learning_mode_duration` set on each algorithm), `resource_id` (a format
of a copy's number), `resources`, `clients`. A resource takes the
template that upstream's matching rules give it (an exact glob first,
then the first glob that matches, in file order). The population's
demand is the traffic mix's recipe.
"""

from __future__ import annotations

import copy
import fnmatch
import json

import numpy as np

from portbench.gen import traffic
from portbench.gen.deploy import Deployment

# doorman.proto Algorithm.Kind values of the kinds the reference knows.
KINDS = {"NO_ALGORITHM": 0, "STATIC": 1, "PROPORTIONAL_SHARE": 2,
         "FAIR_SHARE": 3}


def match(templates, resource_id: str) -> dict:
    for t in templates:
        if t["identifier_glob"] == resource_id:
            return t
    for t in templates:
        if fnmatch.fnmatchcase(resource_id, t["identifier_glob"]):
            return t
    raise ValueError(f"no template matches {resource_id!r}")


def _one(values, what: str) -> float:
    values = set(values)
    if len(values) != 1:
        raise ValueError(f"the served resources differ in {what}: {values}")
    return float(values.pop())


def build(cfg: dict, mix: dict, seed: int) -> Deployment:
    R, C = int(cfg["resources"]), int(cfg["clients"])
    templates = copy.deepcopy(cfg["templates"])
    for t in templates:
        t["algorithm"]["learning_mode_duration"] = cfg[
            "learning_mode_duration"]
    ids = [cfg["resource_id"].format(r) for r in range(R)]
    served = [match(templates, r) for r in ids]
    algo = [t["algorithm"] for t in served]
    return Deployment(
        ids=ids,
        capacity=np.asarray([t["capacity"] for t in served], np.float64),
        kind=np.asarray([KINDS[a["kind"]] for a in algo], np.int64),
        clients=C,
        wants=traffic.population_wants(mix, seed, (R, C)),
        subclients=np.ones((R, C), np.int32),
        priority=np.zeros((R, C), np.int64),
        document=json.dumps({"resources": templates}),
        lease_length=_one((a["lease_length"] for a in algo), "lease_length"),
        refresh_interval=_one((a["refresh_interval"] for a in algo),
                              "refresh_interval"),
    )


def check(cell, dep: Deployment, sent: np.ndarray, grants: np.ndarray):
    """`grant_gap` of the program's grants [R, C] against the reference
    on the demand sent, and with `cell.control` the same number of the
    reference itself in bfloat16 put in the program's place."""
    import torch

    from portbench.reference import judge

    dev = "cpu" if cell.device == "cpu" else "cuda"
    args = (dep.kind, dep.capacity, sent, dep.subclients)
    ref = judge.lane_reference(*args, device=dev)
    numbers = {"grant_gap": judge.grant_gap(grants, ref, sent, dep.capacity)}
    control = None
    if cell.control:
        low = judge.lane_reference(*args, device=dev, dtype=torch.bfloat16)
        control = {"grant_gap": judge.grant_gap(low, ref, sent, dep.capacity)}
    return numbers, control


def work(dep: Deployment, wants: np.ndarray):
    """(bytes, operations) of one K1 solve of every row at demand
    `wants` [R, C] (the frozen `_bytes` / `_ops`)."""
    from portbench.measure import roofline

    return roofline.lane_work(dep.kind, dep.capacity, wants)
