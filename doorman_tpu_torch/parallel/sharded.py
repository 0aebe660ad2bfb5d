"""Sharded solves: the reference's server tree fused over a device mesh
(port of doorman_tpu/parallel/sharded.py).

The edge list shards across the mesh; each shard computes partial
per-resource aggregates over its edges and the totals combine across
shards (parallel.combine, the port's psum / pmax) — the aggregation an
intermediate doorman server performs over its clients before asking the
root (reference server.go:227-261, doorman.proto PriorityBandAggregate).
Every shard then computes final grants for its own edges from the
combined totals. With a two-axis mesh ("dc", "clients") `dc_aggregates`
exposes the per-dc partials.

Placement returns `Sharded` arrays in place of the reference's
NamedShardings: the rows are padded to a multiple of the shard count and
split into equal blocks, one per shard in mesh order, and each device
group of this process (Mesh.device_groups) holds its shards' blocks
stacked [n_g, rows, ...] on its device. `Replicated` arrays hold one
copy per device group. A solve runs once per device group
(Combine.run) and its kernels once per shard: K1 per shard in the dense
solve, K3 per shard in each bisection evaluation of the priority solve.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import List

import numpy as np
import torch

from doorman_tpu_torch.parallel.combine import Combine, fold
from doorman_tpu_torch.parallel.mesh import Mesh
from doorman_tpu_torch.solver.fairshare import stacked_segment_reduces
from doorman_tpu_torch.solver.kernels import EdgeBatch, ResourceBatch, solve_edges
from doorman_tpu_torch.solver.lanes import rowmax, rowsum, solve_lanes

_TORCH = {np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(bool): torch.bool}


@dataclass
class Sharded:
    """A row-sharded array held by this process: for each local device
    group, its shards' row blocks stacked [n_g, rows, ...]."""

    mesh: Mesh
    parts: List[torch.Tensor]

    def shards(self) -> List[torch.Tensor]:
        """This process's shards, in mesh order."""
        return [s for p in self.parts for s in p]

    def numpy(self) -> np.ndarray:
        """This process's shards' rows, concatenated in mesh order."""
        return np.concatenate(
            [s.detach().cpu().numpy() for s in self.shards()]
        )


@dataclass
class Replicated:
    """One copy of an array on every local device group."""

    parts: List[torch.Tensor]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.dtype != _TORCH.get(arr.dtype, t.dtype):
        t = t.to(_TORCH[arr.dtype])
    return t.to(device).contiguous() if device.type != "cpu" else t.clone()


def place_blocks(mesh: Mesh, blocks: np.ndarray) -> Sharded:
    """Place per-shard blocks [n_dev, rows, ...] (global, mesh order):
    each device group gets its own shards' blocks, nothing else."""
    return Sharded(mesh, [
        _tensor(blocks[shards[0]: shards[-1] + 1], dev)
        for dev, shards in mesh.device_groups()
    ])


def place_local(mesh: Mesh, blocks: np.ndarray) -> Sharded:
    """Place this process's blocks [n_local, rows, ...] (its shards, in
    mesh order) on their device groups."""
    local = mesh.local_shards()
    first = local[0]
    return Sharded(mesh, [
        _tensor(blocks[shards[0] - first: shards[-1] + 1 - first], dev)
        for dev, shards in mesh.device_groups()
    ])


def replicate(mesh: Mesh, arr) -> Replicated:
    arr = _host(arr)
    return Replicated([_tensor(arr, dev) for dev, _ in mesh.device_groups()])


def _row_placer(mesh: Mesh, num_rows: int):
    """Shared pad-and-place machinery for the row-sharded batch layouts
    (shard_dense / shard_priority / shard_chunked / shard_edges): rows
    pad up to a multiple of the shard count with `fill` — shard_chunked
    relies on fill=pad_seg keeping row_seg sorted — then split into one
    block per shard, or replicate (sharded_rows=False)."""
    n_dev = mesh.size
    pad = (-num_rows) % n_dev

    def put(arr, *, sharded_rows: bool = True, fill=0):
        arr = _host(arr)
        if not sharded_rows:
            return replicate(mesh, arr)
        if pad:
            arr = np.concatenate(
                [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)]
            )
        return place_blocks(mesh, arr.reshape((n_dev, -1) + arr.shape[1:]))

    return put


def _group_view(batch, g: int):
    """The dataclass batch with every Sharded / Replicated field replaced
    by its group-g tensor."""
    return replace(batch, **{
        f.name: getattr(batch, f.name).parts[g]
        for f in fields(batch)
        if isinstance(getattr(batch, f.name), (Sharded, Replicated))
    })


# -- the edge list ----------------------------------------------------


def make_sharded_solver(mesh: Mesh, *, combine: "Combine | None" = None):
    """solve(edges, resources) -> gets: edge arrays sharded (shard_edges
    or multihost.pack_process_edges), resource arrays replicated
    (replicate_resources), per-resource totals combined with the psum /
    pmax of `combine` (default: the mesh's)."""
    combine = combine or Combine(mesh)

    def solve(edges: EdgeBatch, resources: ResourceBatch) -> Sharded:
        def body(g):
            e = _group_view(edges, g)
            r = _group_view(resources, g)
            ssum, smax = stacked_segment_reduces(e.resource,
                                                 r.capacity.shape[0])
            return solve_edges(
                e, r,
                lambda v: combine.group_sum(g, ssum(v)),
                lambda v: combine.group_max(g, smax(v)),
            )

        return Sharded(mesh, combine.run(body))

    return solve


def shard_edges(mesh: Mesh, edges: EdgeBatch) -> EdgeBatch:
    """Place an EdgeBatch on the mesh: the edge axis is padded (inactive
    edges carrying the last resource id, which keeps every shard sorted
    by segment) up to a multiple of the shard count and split."""
    rid = _host(edges.resource)
    put = _row_placer(mesh, int(rid.shape[0]))
    last_rid = rid[-1] if rid.size else 0
    return EdgeBatch(
        resource=put(rid, fill=last_rid),
        wants=put(edges.wants),
        has=put(edges.has),
        subclients=put(edges.subclients),
        active=put(edges.active, fill=False),
    )


def replicate_resources(mesh: Mesh, resources: ResourceBatch) -> ResourceBatch:
    return ResourceBatch(
        capacity=replicate(mesh, resources.capacity),
        algo_kind=replicate(mesh, _host(resources.algo_kind).astype(np.int32)),
        learning=replicate(mesh, _host(resources.learning).astype(bool)),
        static_capacity=replicate(mesh, resources.static_capacity),
    )


def dc_aggregates(mesh: Mesh, edges: EdgeBatch, num_resources: int):
    """Per-dc (first mesh axis) aggregate tables — each intermediate
    server's PriorityBandAggregate report: for every dc, per-resource
    (sum_wants, sum_has, num_subclients), three [n_dc, R] arrays (this
    process's dcs; their per-shard partials combined over the dc's
    shards in shard order)."""
    if len(mesh.axis_names) < 2:
        raise ValueError("dc_aggregates needs a two-axis ('dc', ...) mesh")
    per_dc = mesh.size // mesh.shape[mesh.axis_names[0]]
    out = []
    for field in ("wants", "has", "subclients"):
        partials = []
        for g, part in enumerate(edges.resource.parts):
            vals = getattr(edges, field).parts[g]
            act = edges.active.parts[g]
            zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
            ssum, _ = stacked_segment_reduces(part, num_resources)
            partials.extend(ssum(torch.where(act, vals, zero)))
        rows = []
        for d0 in range(0, len(partials), per_dc):
            rows.append(fold(partials[d0: d0 + per_dc], torch.add))
        out.append(torch.stack([r.to(rows[0].device) for r in rows]))
    return tuple(out)


# -- the dense row layouts ----------------------------------------------


def make_sharded_dense_solver(mesh: Mesh):
    """Resource-axis sharded dense solve: the [R, K] tables shard their
    row axis. Rows are independent, so this needs no combine: K1 runs
    once per shard over the shard's rows (its plain version on the CPU)
    and the grants land sharded the same way. Place inputs with
    `shard_dense`."""
    from doorman_tpu_torch.solver.dense_cuda import solve_dense_k1

    def solve(batch) -> Sharded:
        parts = []
        for g in range(len(batch.wants.parts)):
            gb = _group_view(batch, g)
            parts.append(torch.stack([
                solve_dense_k1(_dense_shard(gb, i))
                for i in range(gb.wants.shape[0])
            ]))
        return Sharded(mesh, parts)

    return solve


def _dense_shard(gb, i):
    from doorman_tpu_torch.solver.dense import DenseBatch

    return DenseBatch(**{f.name: getattr(gb, f.name)[i] for f in fields(gb)})


def shard_dense(mesh: Mesh, batch):
    """Place a DenseBatch on the mesh: the row axis sharded, padded with
    inactive rows up to a multiple of the shard count."""
    from doorman_tpu_torch.solver.dense import DenseBatch

    put = _row_placer(mesh, int(_host(batch.capacity).shape[0]))
    return DenseBatch(
        wants=put(batch.wants),
        has=put(batch.has),
        subclients=put(batch.subclients),
        active=put(_host(batch.active).astype(bool)),
        capacity=put(batch.capacity),
        algo_kind=put(_host(batch.algo_kind).astype(np.int32)),
        learning=put(_host(batch.learning).astype(bool)),
        static_capacity=put(batch.static_capacity),
    )


def make_sharded_chunked_solver(mesh: Mesh, *, combine: "Combine | None" = None):
    """Chunk-row sharded WIDE-resource solve: the chunked layout
    (solver.dense.ChunkedDenseBatch) with its rows sharded. A wide
    resource's chunks SPAN shards, so per-segment totals are the
    two-level reduction's local half (row reduction, then each shard's
    sorted segment sum) combined with one [S]-sized psum — which
    re-associates the sum of a straddling resource (the resident wide
    tick uses the bit-exact `resident_chunk_reduces` instead). Place
    inputs with `shard_chunked`."""
    combine = combine or Combine(mesh)

    def solve(batch) -> Sharded:
        def body(g):
            b = _group_view(batch, g)
            n_g, rows, K = b.wants.shape
            S = b.capacity.shape[0]
            ssum, smax = stacked_segment_reduces(b.row_seg, S)
            seg = b.row_seg.long()

            def segsum(v):
                return combine.group_sum(
                    g, ssum(rowsum(v.reshape(-1, K)).reshape(n_g, rows)))

            def segmax(v):
                return combine.group_max(
                    g, smax(rowmax(v.reshape(-1, K)).reshape(n_g, rows)))

            return solve_lanes(
                b.wants, b.has, b.subclients, b.active, b.capacity,
                b.algo_kind, b.learning, b.static_capacity,
                segsum=segsum, segmax=segmax,
                expand=lambda totals: totals[seg][..., None],
            )

        return Sharded(mesh, combine.run(body))

    return solve


def shard_chunked(mesh: Mesh, batch):
    """Place a ChunkedDenseBatch on the mesh: chunk rows (and row_seg)
    sharded, padded with inactive rows mapped to the LAST segment (the
    caller's padding segment) so each shard's row_seg stays sorted; the
    per-segment config replicated."""
    from doorman_tpu_torch.solver.dense import ChunkedDenseBatch

    row_seg = _host(batch.row_seg).astype(np.int64)
    put = _row_placer(mesh, int(row_seg.shape[0]))
    pad_seg = int(_host(batch.capacity).shape[0]) - 1
    return ChunkedDenseBatch(
        wants=put(batch.wants),
        has=put(batch.has),
        subclients=put(batch.subclients),
        active=put(_host(batch.active).astype(bool)),
        row_seg=put(row_seg, fill=pad_seg),
        capacity=put(batch.capacity, sharded_rows=False),
        algo_kind=put(_host(batch.algo_kind).astype(np.int32),
                      sharded_rows=False),
        learning=put(_host(batch.learning).astype(bool), sharded_rows=False),
        static_capacity=put(batch.static_capacity, sharded_rows=False),
    )


def resident_chunk_reduces(combine: Combine, g: int, row_seg_global,
                           lengths, offset: int, num_rows: int):
    """Cross-shard chunk reduction for the mesh-resident wide tick
    (solver.resident_wide with mesh=), assembled so totals come out
    BIT-IDENTICAL to the single-device solve.

    A psum of per-shard partial [S] totals re-associates the float sum of
    any resource whose chunks straddle a shard boundary. Here each
    device group instead writes its shards' per-row totals into the
    GLOBAL [R] row vector at its own offset, with 0 / -inf everywhere
    else; the combine adds disjoint supports (exact), so the assembled
    vector is bitwise the single-device row-total vector, and every
    group then runs the SAME sorted segment op over it. Straddling
    chunks need no special case: their rows assemble from two shards.

    `row_seg_global` [R] and `lengths` [S] are the whole table's
    row->segment map on group g's device; returns (segsum, segmax)
    taking the group's [rows, W] block and returning [S] totals."""
    from doorman_tpu_torch.solver.fairshare import (
        local_segment_max,
        local_segment_sum,
    )

    S = lengths.shape[0]
    seg_sum = local_segment_sum(row_seg_global, S, lengths)
    seg_max = local_segment_max(row_seg_global, S, lengths)

    def segsum(v):
        rows = combine.group_assemble(g, rowsum(v), offset, num_rows,
                                      0.0, "sum")
        return seg_sum(rows)

    def segmax(v):
        rows = combine.group_assemble(g, rowmax(v), offset, num_rows,
                                      float("-inf"), "max")
        return seg_max(rows)

    return segsum, segmax


def scoped_chunk_reduces(combine: Combine, g: int, gpos, row_seg_compact,
                         lengths, num_compact_rows: int,
                         count: "int | None" = None):
    """The SCOPED variant of resident_chunk_reduces: each device group
    assembles its COMPACT per-row totals into the global compact row
    vector [Cbg] at the host-computed global compact positions `gpos`
    (one per local compact row, or the first of them as an int when
    they are consecutive); every position is owned by exactly one
    shard, so the combine stays exact, and the segment op runs over the
    compact row->segment map in global row order — the partial sums of a
    straddling segment add in exactly the full reduce's order. The
    combine now scales with churn, not table size. With `count`, only
    the first `count` rows of the group's block are real (the rest pad
    the gather to a bucketed size and reach no total)."""
    from doorman_tpu_torch.solver.fairshare import (
        local_segment_max,
        local_segment_sum,
    )

    S = lengths.shape[0]
    seg_sum = local_segment_sum(row_seg_compact, S, lengths)
    seg_max = local_segment_max(row_seg_compact, S, lengths)

    def segsum(v):
        rows = combine.group_assemble(g, rowsum(v)[:count], gpos,
                                      num_compact_rows, 0.0, "sum")
        return seg_sum(rows)

    def segmax(v):
        rows = combine.group_assemble(g, rowmax(v)[:count], gpos,
                                      num_compact_rows, float("-inf"), "max")
        return seg_max(rows)

    return segsum, segmax


# -- PRIORITY_BANDS ------------------------------------------------------


def make_sharded_priority_solver(mesh: Mesh, num_bands: int = 4, *,
                                 combine: "Combine | None" = None):
    """Resource-axis sharded PRIORITY_BANDS solve with capacity groups.

    Rows shard like the dense solve, but group caps couple resources
    ACROSS shards: each shard computes its per-group usage and the
    combine sums them, so the theta bisection runs on the same totals
    everywhere — one [G]-sized psum per bisection evaluation is the
    entire cross-shard traffic; the banded water-fill itself (K3 on the
    card, once per shard per evaluation) stays row-local. Place inputs
    with `shard_priority`; group_cap is replicated."""
    from doorman_tpu_torch.solver.priority import PriorityBatch, solve_priority

    combine = combine or Combine(mesh)

    def solve(batch) -> Sharded:
        shards, sizes = [], []
        for g in range(len(batch.wants.parts)):
            gb = _group_view(batch, g)
            n_g = gb.wants.shape[0]
            sizes.append(n_g)
            for i in range(n_g):
                shards.append(PriorityBatch(
                    wants=gb.wants[i], weights=gb.weights[i],
                    band=gb.band[i], active=gb.active[i],
                    capacity=gb.capacity[i], group=gb.group[i],
                    group_cap=gb.group_cap,
                ))
        gets = solve_priority(shards, num_bands=num_bands, use_kernel=True,
                              combine=combine.sum)
        parts, pos = [], 0
        for n_g in sizes:
            parts.append(torch.stack(gets[pos: pos + n_g]))
            pos += n_g
        return Sharded(mesh, parts)

    return solve


def shard_priority(mesh: Mesh, batch):
    """Place a PriorityBatch on the mesh: the row axis sharded and padded
    with inactive, ungrouped rows up to a multiple of the shard count;
    group_cap replicated."""
    from doorman_tpu_torch.solver.priority import PriorityBatch

    put = _row_placer(mesh, int(_host(batch.capacity).shape[0]))
    return PriorityBatch(
        wants=put(batch.wants),
        weights=put(batch.weights),
        band=put(_host(batch.band).astype(np.int32)),
        active=put(_host(batch.active).astype(bool)),
        capacity=put(batch.capacity),
        # Padding rows are ungrouped (-1): they add to no group's usage.
        group=put(_host(batch.group).astype(np.int32), fill=-1),
        group_cap=put(batch.group_cap, sharded_rows=False),
    )
