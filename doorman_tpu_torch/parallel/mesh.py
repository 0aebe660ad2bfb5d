"""Device meshes (port of doorman_tpu/parallel/mesh.py).

A `Mesh` names its axes and their sizes, as the reference's
jax.sharding.Mesh does, over an explicit list of `torch.device`s: one
device per shard, in mesh order (the axes flattened row-major). The
list may repeat a device. Shards that share a device are still separate
shards — their own rows, their own kernel launches — and lie side by
side in one allocation on that device (`device_groups`). That lets one
card hold a 4-shard mesh (`[cuda:0] * 4`) and the CPU tests stand in
for the reference's forced 8-device platform (`[cpu] * 8`).

A mesh can span processes (parallel.multihost.make_multihost_mesh):
each shard then also names the rank that owns it, and a process holds
and computes only its own shards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _as_device(d) -> torch.device:
    return d if isinstance(d, torch.device) else torch.device(d)


class Mesh:
    """Named axes over one device per shard.

    `devices` is flat in mesh order; `processes` names each shard's
    owning rank (default: every shard belongs to this process) and
    `process_index` is this process's rank."""

    def __init__(
        self,
        devices: Sequence,
        axis_sizes: Sequence[int],
        axis_names: Tuple[str, ...],
        processes: "Sequence[int] | None" = None,
        process_index: int = 0,
    ):
        devs = [_as_device(d) for d in devices]
        sizes = [int(s) for s in axis_sizes]
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} axis sizes for axes {axis_names}")
        if int(np.prod(sizes)) != len(devs):
            raise ValueError(
                f"axis sizes {sizes} do not cover {len(devs)} devices"
            )
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.devices = np.empty(len(devs), object)
        self.devices[:] = devs
        self.devices = self.devices.reshape(sizes)
        procs = np.zeros(len(devs), np.int64) if processes is None else (
            np.asarray(processes, np.int64))
        if procs.shape != (len(devs),):
            raise ValueError("one owning process per device")
        self.processes = procs
        self.process_index = int(process_index)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.flat)

    @property
    def n_processes(self) -> int:
        return len(set(self.processes.tolist()))

    def local_shards(self) -> List[int]:
        """This process's shards, in mesh order."""
        return [i for i in range(self.size)
                if self.processes[i] == self.process_index]

    def device_groups(self) -> List[Tuple[torch.device, List[int]]]:
        """This process's shards as runs of consecutive shards on one
        device: [(device, [shard, ...]), ...] in mesh order. A run's
        shards share one allocation (their rows adjacent, shard-major)
        and one host<->device copy a tick."""
        groups: List[Tuple[torch.device, List[int]]] = []
        flat = self.flat_devices
        prev = None
        for i in self.local_shards():
            if groups and flat[i] == groups[-1][0] and i == prev + 1:
                groups[-1][1].append(i)
            else:
                groups.append((flat[i], [i]))
            prev = i
        return groups

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat_devices]})"


def visible_cuda_devices() -> List[torch.device]:
    """Every CUDA device torch sees; raises without one (a mesh never
    drops to the CPU on its own)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "a mesh over the visible devices needs a CUDA device; torch "
            "sees none (pass devices=[torch.device('cpu')] * n to shard "
            "on the host)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("clients",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh over `devices` (default: every visible CUDA device).

    With the default single "clients" axis, all devices shard the rows.
    For the two-level tree pass axis_names=("dc", "clients") and the
    per-axis sizes (their product must equal the device count)."""
    devices = list(devices if devices is not None else visible_cuda_devices())
    if axis_sizes is None:
        axis_sizes = [len(devices)] if len(axis_names) == 1 else None
    if axis_sizes is None:
        raise ValueError("axis_sizes required for multi-axis meshes")
    return Mesh(devices, axis_sizes, tuple(axis_names))


def _spec_sizes(spec: str) -> Optional[List[int]]:
    """An axis-size spec's sizes ('8' -> [8], '2x4' -> [2, 4]); None for
    '' or 'auto'. Raises ValueError on anything else."""
    spec = (spec or "").strip().lower()
    if spec in ("", "auto"):
        return None
    try:
        return [int(p) for p in spec.replace("*", "x").split("x")]
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: want 'auto', '8', or '2x4'"
        ) from None


def make_mesh_from_spec(spec: str, devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from an operator-facing axis-size spec.

    '8' or '2x4' name per-axis sizes (their product must equal the
    device count); '' or 'auto' takes one axis over every device. Axis
    names follow the reference: one axis -> ("clients",), two ->
    ("dc", "clients"), more -> ax<i>."""
    sizes = _spec_sizes(spec)
    if sizes is None:
        return make_mesh(devices=devices)
    names = {
        1: ("clients",),
        2: ("dc", "clients"),
    }.get(len(sizes)) or tuple(f"ax{i}" for i in range(len(sizes)))
    return make_mesh(sizes, names, devices)


def mesh_for_device(spec: str, device="cuda") -> Mesh:
    """The server binary's --mesh: with a CUDA --device the spec covers
    the visible CUDA devices ('auto': all of them); with --device cpu it
    names its own count of CPU shards ('auto' has no meaning there and
    raises — it never becomes a CPU mesh)."""
    if torch.device(device).type != "cpu":
        return make_mesh_from_spec(spec)
    sizes = _spec_sizes(spec)
    if sizes is None:
        raise ValueError(
            "'auto' takes the visible CUDA devices; with --device cpu give "
            "the shard count ('8' or '2x4')"
        )
    return make_mesh_from_spec(spec, [torch.device("cpu")] * int(np.prod(sizes)))
