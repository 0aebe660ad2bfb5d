"""Mesh sharding support for the device-resident tick solvers (port of
doorman_tpu/solver/resident_mesh.py).

The resident solvers (solver/resident.py, solver/resident_wide.py) keep
the [R, W] demand tables on the device and move only deltas across the
host link. With a parallel.mesh Mesh the same tables shard their ROW
axis over every mesh axis — contiguous equal row blocks, one per shard
in mesh order — and this module owns the host-side layout math both
solvers share:

  * `MeshRows` — the partition itself: padded row counts, the device
    groups (the shards that share a device lie side by side in one
    allocation there, shard-major, and take one staged upload and one
    download a tick), and the per-shard rotation cursors (each shard
    walks its OWN real rows, so every tick's delivery download is
    balanced across shards instead of one contiguous window marching
    through them);
  * `group_by_shard` / `pad_shard_blocks` / `pad_shard_indices` — turn a
    tick's global dirty-row (or dirty-slot) and delivery sets into
    per-shard [n_dev, U] blocks with shard-LOCAL indices. A device
    group's upload carries only its own shards' rows of each block: a
    dirty slot's upload reaches the device of the shard that owns it.

Per-shard blocks pad to one width (the max across shards). The host
knows each shard's real count, so the device side slices every block
to it and padded slots are never read (the reference instead aims
padded scatter slots out of range and drops them, `mode="drop"`).
Padded gather slots repeat the shard's last index, as the reference's.
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


def group_by_shard(
    owner: np.ndarray, n_dev: int, arrays: Sequence[np.ndarray]
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Stable-partition parallel per-item arrays by owning shard.

    Returns (counts [n_dev], arrays reordered shard-major). The sort is
    stable, so a globally sorted index column (owner nondecreasing, e.g.
    a sorted delivery set) comes back in EXACTLY its input order — the
    property that keeps a TickHandle's global row bookkeeping aligned
    with the shard-major download blocks."""
    owner = np.asarray(owner)
    counts = np.bincount(owner, minlength=n_dev).astype(np.int64)
    perm = np.argsort(owner, kind="stable")
    return counts, [np.asarray(a)[perm] for a in arrays]


def pad_shard_blocks(
    counts: np.ndarray,
    width: int,
    arrays_fills: Sequence[Tuple[np.ndarray, object]],
) -> List[np.ndarray]:
    """Scatter shard-major packed rows into padded [n_dev, width, ...]
    blocks (one fill value per array)."""
    n_dev = len(counts)
    outs: List[np.ndarray] = []
    for arr, fill in arrays_fills:
        arr = np.asarray(arr)
        out = np.full((n_dev, width) + arr.shape[1:], fill, arr.dtype)
        pos = 0
        for d in range(n_dev):
            c = int(counts[d])
            out[d, :c] = arr[pos: pos + c]
            pos += c
        outs.append(out)
    return outs


def pad_shard_indices(
    counts: np.ndarray, width: int, idx: np.ndarray
) -> np.ndarray:
    """Per-shard GATHER index blocks [n_dev, width], padded by repeating
    the shard's last index — each block stays sorted and always in
    range. Empty shards pad with 0; their gathered rows are sliced off
    at collect."""
    idx = np.asarray(idx)
    out = np.zeros((len(counts), width), idx.dtype)
    pos = 0
    for d in range(len(counts)):
        c = int(counts[d])
        if c:
            out[d, :c] = idx[pos: pos + c]
            out[d, c:] = idx[pos + c - 1]
            pos += c
    return out
