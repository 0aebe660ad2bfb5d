"""Layout `tree`: upstream doorman's server tree (simulation/
scenario_five.py) over a load-test deployment. The root loads the
deployment's templates (layout `templates`' keys: `templates`,
`resource_id`, `resources`, `clients`, `learning_mode_duration`);
`regions` intermediates lease from the root and `dcs_per_region`
datacenters from each region, and the clients of every resource live on
the datacenters: client c on datacenter c mod (regions x
dcs_per_region), so each datacenter holds `clients_per_dc[d]` of them.

`build` gives the deployment as the root sees it (its templates, the
clients' demand), `placement` the topology, `check` the tree's numbers
against reference/tree.py and `work` the K1 work of every server's
rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from portbench.gen.deploy import Deployment
from portbench.layouts import templates


@dataclass
class Placement:
    """The tree's servers and where each client lives."""

    root: str  # server id
    regions: list  # server ids, region g at index g
    dcs: list  # server ids, datacenter d at index d
    region_of_dc: np.ndarray  # [D]
    dc_of_client: np.ndarray  # [C]

    def clients_of(self, d: int) -> np.ndarray:
        return np.flatnonzero(self.dc_of_client == d)


@dataclass
class TreeDeployment(Deployment):
    """The deployment as the root sees it, with its tree."""

    place: Placement = None


def build(cfg: dict, mix: dict, seed: int) -> TreeDeployment:
    dep = templates.build(cfg, mix, seed)
    return TreeDeployment(**{f.name: getattr(dep, f.name)
                             for f in dataclasses.fields(dep)},
                          place=placement(cfg))


def placement(cfg: dict) -> Placement:
    G, per = int(cfg["regions"]), int(cfg["dcs_per_region"])
    D, C = G * per, int(cfg["clients"])
    out = Placement(
        root="root",
        regions=[f"region-{g}" for g in range(G)],
        dcs=[f"dc-{d // per}.{d % per}" for d in range(D)],
        region_of_dc=np.arange(D) // per,
        dc_of_client=np.arange(C) % D,
    )
    counts = [len(out.clients_of(d)) for d in range(D)]
    if counts != list(cfg["clients_per_dc"]):
        raise ValueError(f"clients_per_dc {cfg['clients_per_dc']} but the "
                         f"placement gives {counts}")
    return out


def check(cell, dep: TreeDeployment, sent: np.ndarray, held):
    """The tree's numbers (reference/tree.py `judge`) of what the servers
    hold (`held`, a HeldGrants) on the demand sent [R, C], and with
    `cell.control` the same numbers of the reference itself in bfloat16
    put in the program's place."""
    import torch

    from portbench.reference import tree as ref_tree

    place = dep.place
    dev = "cpu" if cell.device == "cpu" else "cuda"
    args = (dep.capacity, sent, place.dc_of_client, place.region_of_dc)
    ref = ref_tree.tree_grants(*args, device=dev)
    judged = args[2:]
    numbers = ref_tree.judge(held, ref, sent, dep.capacity, *judged)
    control = None
    if cell.control:
        low = ref_tree.tree_grants(*args, device=dev, dtype=torch.bfloat16)
        control = ref_tree.judge(ref_tree.as_held(low), ref, sent,
                                 dep.capacity, *judged)
    return numbers, control


def work(dep: TreeDeployment, wants: np.ndarray) -> dict:
    """Server id -> (bytes, operations) of one K1 solve of all of that
    server's rows at demand `wants` [R, C], at the capacities the
    settled tree gives them: the root's rows hold a band of each region
    (its aggregated wants), a region's a band of each of its
    datacenters, a datacenter's its clients (each row as wide as its
    holders)."""
    from portbench.measure import roofline
    from portbench.reference import tree as ref_tree

    place = dep.place
    ref = ref_tree.tree_grants(dep.capacity, wants, place.dc_of_client,
                               place.region_of_dc)
    out = {place.root: roofline.lane_work(dep.kind, dep.capacity,
                                      ref.region_wants)}
    for g, name in enumerate(place.regions):
        dcs = np.flatnonzero(place.region_of_dc == g)
        out[name] = roofline.lane_work(dep.kind, ref.root[:, g],
                                       ref.dc_wants[:, dcs])
    for d, name in enumerate(place.dcs):
        out[name] = roofline.lane_work(dep.kind, ref.region[:, d],
                                       wants[:, place.clients_of(d)])
    return out
