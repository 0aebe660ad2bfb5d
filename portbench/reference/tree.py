"""The reference of a capacity tree (layout `tree`): the grants every
server of a root <- regions <- datacenters tree holds once the tree has
settled with its clients' demand held still, in plain PyTorch.

Each server splits what it holds by its downstream demand with the
proportional share (reference/vector.py `lane_targets`, the fixed point
of the chained proportional tick):

  * the root splits each resource's configured capacity by the regions'
    aggregated wants (each region's the sum of its datacenters');
  * each region splits the root's grant by its datacenters' aggregated
    wants (each datacenter's the sum of its clients');
  * each datacenter splits its region's grant by its clients' wants.

`dtype` sets the precision of every step, the sums included: float64 is
the reference, bfloat16 the control the comparison has to catch.
Nothing here imports the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import vector


@dataclass
class TreeGrants:
    """[R, ...] float64 arrays of one settled tree (R resources, G
    regions, D datacenters, C clients a resource)."""

    dc_wants: np.ndarray  # [R, D] each datacenter's aggregated wants
    region_wants: np.ndarray  # [R, G] each region's aggregated wants
    root: np.ndarray  # [R, G] the root's grant to each region
    region: np.ndarray  # [R, D] each region's grant to each of its DCs
    clients: np.ndarray  # [R, C] each datacenter's grant to each client


def split(capacity, wants):
    """The proportional share of `capacity` [R] over each row of `wants`
    [R, K] (every lane a live client of one subclient)."""
    kind = torch.full((wants.shape[0],), vector.PROP, dtype=torch.long,
                      device=wants.device)
    return vector.lane_targets(kind, capacity, wants, torch.ones_like(wants),
                               torch.ones_like(wants, dtype=torch.bool))


def tree_grants(capacity, wants, dc_of_client, region_of_dc, *,
                dtype=torch.float64, device="cpu") -> TreeGrants:
    """The settled tree of `capacity` [R] (the root's templates) over the
    clients' `wants` [R, C]: client c lives on datacenter
    `dc_of_client[c]`, datacenter d under region `region_of_dc[d]`."""
    dc_of_client = np.asarray(dc_of_client)
    region_of_dc = np.asarray(region_of_dc)
    D, G = len(region_of_dc), int(region_of_dc.max()) + 1
    w = torch.as_tensor(np.ascontiguousarray(wants)).to(device=device,
                                                        dtype=dtype)
    cap = torch.as_tensor(np.ascontiguousarray(capacity)).to(device=device,
                                                             dtype=dtype)
    R = w.shape[0]
    by_dc = [torch.as_tensor(np.flatnonzero(dc_of_client == d), device=device)
             for d in range(D)]
    by_region = [torch.as_tensor(np.flatnonzero(region_of_dc == g),
                                 device=device) for g in range(G)]
    dc_wants = torch.stack([w[:, cols].sum(1) for cols in by_dc], 1)
    region_wants = torch.stack([dc_wants[:, dcs].sum(1) for dcs in by_region],
                               1)
    root = split(cap, region_wants)
    region = torch.zeros((R, D), dtype=dtype, device=device)
    for g, dcs in enumerate(by_region):
        region[:, dcs] = split(root[:, g], dc_wants[:, dcs])
    clients = torch.zeros_like(w)
    for d, cols in enumerate(by_dc):
        clients[:, cols] = split(region[:, d], w[:, cols])

    def out(t):
        return t.double().cpu().numpy()

    return TreeGrants(out(dc_wants), out(region_wants), out(root),
                      out(region), out(clients))


def _gap(got, ref, scale) -> float:
    """Widest |got - ref| / scale; a grant that is no number reads as
    infinite."""
    if got.size == 0:
        return 0.0
    scale = np.where(scale > 0, scale, 1.0)
    gap = np.abs(got - ref) / scale
    return float(np.where(np.isnan(gap), np.inf, gap).max())


def _over(total, capacity) -> float:
    """Widest (total - capacity) / capacity; any grant on a capacity of
    0 is infinitely over."""
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(capacity > 0, (total - capacity) / capacity,
                       np.where(total > 0, np.inf, 0.0))
    return float(np.where(np.isnan(rel), np.inf, rel).max())


def judge(held, ref: TreeGrants, wants, root_capacity, dc_of_client,
          region_of_dc) -> dict:
    """The tree's numbers of `held` (TreeGrants-shaped grants as the
    servers hold them, and `dc_capacity` [R, D] / `region_capacity`
    [R, G], the grants each intermediate installed) against `ref`:

      grant_gap  each client's grant against the reference's, over the
                 larger of its datacenter's reference capacity and the
                 largest wants of its datacenter's row;
      hop_gap    the root's and the regions' band grants against the
                 reference's splits, each over the larger of the
                 granting server's reference capacity and the largest
                 aggregated wants of its row;
      overgrant  the largest sum of one server's grants on one resource
                 over that server's capacity (the template at the root,
                 the installed grant below it), relative to it.
    """
    dc_of_client = np.asarray(dc_of_client)
    region_of_dc = np.asarray(region_of_dc)
    D, G = len(region_of_dc), ref.root.shape[1]
    cols = [np.flatnonzero(dc_of_client == d) for d in range(D)]
    dcs = [np.flatnonzero(region_of_dc == g) for g in range(G)]
    client_scale = np.empty_like(ref.clients)
    for d, c in enumerate(cols):
        client_scale[:, c] = np.maximum(ref.region[:, d],
                                        wants[:, c].max(1))[:, None]
    root_scale = np.maximum(root_capacity, ref.region_wants.max(1))[:, None]
    region_scale = np.empty_like(ref.region)
    for g, ds in enumerate(dcs):
        region_scale[:, ds] = np.maximum(
            ref.root[:, g], ref.dc_wants[:, ds].max(1))[:, None]
    over = [_over(held.root.sum(1), np.asarray(root_capacity, np.float64))]
    for g, ds in enumerate(dcs):
        over.append(_over(held.region[:, ds].sum(1),
                          held.region_capacity[:, g]))
    for d, c in enumerate(cols):
        over.append(_over(held.clients[:, c].sum(1), held.dc_capacity[:, d]))
    return {
        "grant_gap": _gap(held.clients, ref.clients, client_scale),
        "hop_gap": max(_gap(held.root, ref.root, root_scale),
                       _gap(held.region, ref.region, region_scale)),
        "overgrant": max(over),
    }


@dataclass
class HeldGrants(TreeGrants):
    """What the servers hold: TreeGrants' grants (the aggregated wants
    as the reference states them) and each intermediate's installed
    capacity."""

    dc_capacity: np.ndarray = None  # [R, D]
    region_capacity: np.ndarray = None  # [R, G]


def as_held(grants: TreeGrants) -> HeldGrants:
    """A reference's grants in the servers' place: each intermediate has
    installed what its parent granted (the control's reading)."""
    return HeldGrants(grants.dc_wants, grants.region_wants, grants.root,
                      grants.region, grants.clients,
                      dc_capacity=grants.region,
                      region_capacity=grants.root)
