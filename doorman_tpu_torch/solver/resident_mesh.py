"""Mesh sharding support for the device-resident tick solvers (port of
doorman_tpu/solver/resident_mesh.py).

The resident solvers (solver/resident.py, solver/resident_wide.py) keep
the [R, W] demand tables on the device and move only deltas across the
host link. Their tables always shard their ROW axis over a mesh — the
caller's parallel.mesh Mesh, or without one a one-shard mesh over the
solver's device, which is the single-device layout — contiguous equal
row blocks, one per shard in mesh order (every mesh axis flattened).
This module owns the host-side layout math both solvers share:

  * `MeshRows` — the partition itself: padded row counts, the device
    groups (the shards that share a device lie side by side in one
    allocation there, shard-major, and take one staged upload and one
    download a tick), and the per-shard rotation cursors (each shard
    walks its OWN real rows, so every tick's delivery download is
    balanced across shards instead of one contiguous window marching
    through them; one shard walks the whole table);
  * `split_rows` / `pad_shard_block` — turn a tick's global dirty-row
    (or dirty-slot) and delivery sets into per-shard [n_dev, U] blocks
    with shard-LOCAL indices. A device group's upload carries only its
    own shards' rows of each block: a dirty slot's upload reaches the
    device of the shard that owns it. On one shard they permute nothing
    and copy each block once, with its cast to the wire dtype.

Per-shard blocks pad to one width (the max across shards, rounded up to
a multiple of 8). The host knows each shard's real count, so the device
side slices every block to it and padded slots are never read (the
reference instead aims padded scatter slots out of range and drops
them, `mode="drop"`), so padding is only ever the fill.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def mesh_device(mesh):
    """The first of this process's mesh devices, after checking that
    every one is usable (a CUDA shard without a GPU raises: a mesh never
    drops to the CPU on its own)."""
    from doorman_tpu_torch.utils.backend import resolve_device

    devs = [resolve_device(mesh.flat_devices[i]) for i in mesh.local_shards()]
    return devs[0]


class MeshRows:
    """Row-axis partition of a resident table over a Mesh held by this
    process: contiguous row blocks, one per shard (mesh axes flattened
    in order)."""

    def __init__(self, mesh):
        if mesh.n_processes > 1:
            raise ValueError(
                "the resident solvers shard over one process's devices; "
                f"this mesh spans {mesh.n_processes} processes"
            )
        self.n_dev = mesh.size
        # [(device, first shard, shard count)] in mesh order.
        self.groups = [(dev, shards[0], len(shards))
                       for dev, shards in mesh.device_groups()]

    def round_rows(self, rp: int) -> int:
        """Pad a row count so every shard holds an equal block."""
        return -(-rp // self.n_dev) * self.n_dev

    def rotation_rows(
        self,
        cursors: np.ndarray,
        n_real: int,
        rows_per_shard: int,
        rotate: int,
    ) -> np.ndarray:
        """One tick's rotation slice, per-shard: shard d advances its
        own cursor through its real rows (global rows [d*Rl, d*Rl+n_d)),
        delivering ceil(n_d / rotate) of them — so the whole table is
        covered every `rotate` ticks AND each shard's download stays
        ~1/n_dev of the slice every tick. Advances `cursors` in place.
        Returns global row indices."""
        parts: List[np.ndarray] = []
        for d in range(self.n_dev):
            lo = d * rows_per_shard
            n_loc = min(max(n_real - lo, 0), rows_per_shard)
            if n_loc <= 0:
                break  # shards are filled front to back
            block = -(-n_loc // max(rotate, 1))
            rot = (
                int(cursors[d]) + np.arange(block, dtype=np.int64)
            ) % n_loc
            cursors[d] = (int(cursors[d]) + block) % n_loc
            parts.append(lo + rot)
        if not parts:
            return np.zeros(0, np.int64)
        return np.concatenate(parts)


def split_rows(
    rows: np.ndarray, block: int, n_dev: int, cols: Sequence = ()
) -> Tuple[List[int], np.ndarray, List[np.ndarray]]:
    """Stable-partition global indices by owning shard (shard d owns
    [d * block, (d + 1) * block)), with parallel per-item columns.

    Returns (per-shard counts, shard-local indices, columns), shard-
    major.
    The sort is stable, so a sorted index column (e.g. a delivery set)
    comes back in EXACTLY its input order — the property that keeps a
    TickHandle's global row bookkeeping aligned with the shard-major
    download blocks. Items already in shard order (sorted indices, or
    every item on one shard) come back as given, with no permutation or
    copy."""
    owner, local = np.divmod(rows, block)
    counts = np.bincount(owner, minlength=n_dev).tolist()
    if (owner[1:] < owner[:-1]).any():
        perm = np.argsort(owner, kind="stable")
        return counts, local[perm], [np.asarray(c)[perm] for c in cols]
    return counts, local, list(cols)


def pad_shard_block(
    counts: Sequence[int],
    arr: np.ndarray,
    width: int = 0,
    fill=0,
    *,
    dtype=None,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """Scatter shard-major packed rows into a padded [n_dev, width, ...]
    block (or into `out`), cast to its dtype on the copy: shard d's
    rows, then `fill`."""
    arr = np.asarray(arr)
    if out is None:
        out = np.empty((len(counts), width) + arr.shape[1:],
                       dtype or arr.dtype)
    pos = 0
    for d, c in enumerate(counts):
        out[d, :c] = arr[pos: pos + c]
        out[d, c:] = fill
        pos += c
    return out
