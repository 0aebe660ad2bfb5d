"""The mesh combine: the port's psum / pmax.

The reference runs its sharded solves under `shard_map` and combines
per-shard partials with `jax.lax.psum` / `pmax` over mesh axes, which
XLA lowers to collectives. torch has no shard_map, so
doorman_tpu/parallel/compat.py (the JAX-version shim around it) has no
counterpart here. Instead a sharded solve runs once per device group of
the mesh (Mesh.device_groups: the shards one process holds on one
device, stacked along a leading shard axis), and `Combine` says where
each partial lives and how it meets the others:

  * the shards of one group combine on its device, in shard order;
  * the groups of one process combine in group order, on the first
    group's device. With more than one group the solve runs one thread
    per group (`Combine.run`) and the groups meet at a barrier in each
    combine: the lockstep shard_map gives the reference;
  * processes combine with `torch.distributed.all_reduce` (SUM / MAX)
    over the process group that parallel.multihost.initialize set up.
    Under gloo, CUDA partials are copied to the host, reduced there and
    copied back (`staged_through_host`); under nccl they reduce on the
    card.

A failure raises: nothing switches backend or device on its own.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import torch

from doorman_tpu_torch.parallel.mesh import Mesh


def fold(parts: Sequence[torch.Tensor], fn) -> torch.Tensor:
    """Partials combined with `fn` (torch.add, torch.maximum) in their
    order, on the first one's device."""
    acc = parts[0]
    for p in parts[1:]:
        acc = fn(acc, p.to(acc.device))
    return acc


class Combine:
    """psum / pmax of per-shard partials over a mesh."""

    def __init__(self, mesh: Mesh, group=None):
        self.mesh = mesh
        self.groups = mesh.device_groups()
        self.cross_process = mesh.n_processes > 1
        self._pg = group
        self.backend: "str | None" = None
        if self.cross_process:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError(
                    "the mesh spans processes but torch.distributed is "
                    "not initialised (parallel.multihost.initialize)"
                )
            self.backend = str(dist.get_backend(group))
        self.staged_through_host = self.cross_process and (
            self.backend == "gloo"
            and any(d.type == "cuda" for d, _ in self.groups)
        )
        self._barrier = (
            threading.Barrier(len(self.groups)) if len(self.groups) > 1
            else None
        )
        self._slots: List[Optional[torch.Tensor]] = [None] * len(self.groups)
        self._result: Optional[torch.Tensor] = None

    # -- running a body once per device group ---------------------------

    def run(self, body: Callable[[int], object]) -> list:
        """body(g) for every local device group g, in lockstep: inline
        for one group, one thread a group otherwise. Returns the results
        in group order; an exception in any group is raised here (the
        others are released from their barrier)."""
        if self._barrier is None:
            return [body(0)]
        out: list = [None] * len(self.groups)
        errors: list = []

        def worker(g, index):
            try:
                if index is not None:
                    torch.cuda.set_device(index)
                out[g] = body(g)
            except BaseException as e:  # re-raised below
                errors.append(e)
                self._barrier.abort()

        def cuda_index(d):
            # A CUDA device named without an index is the caller's
            # current one; a new thread's current device is cuda:0.
            if d.type != "cuda":
                return None
            return torch.cuda.current_device() if d.index is None else d.index

        threads = [threading.Thread(target=worker, args=(g, cuda_index(d)))
                   for g, (d, _) in enumerate(self.groups)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._barrier.reset()
        if errors:
            real = [e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or errors)[0]
        return out

    # -- the combines ---------------------------------------------------

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The psum of per-shard partials held by this process (one per
        local shard, in shard order, on any devices): their sum in
        shard order on the first part's device, then across processes."""
        return self._across(fold(parts, torch.add), "sum")

    def group_sum(self, g: int, stacked: torch.Tensor) -> torch.Tensor:
        """Inside `run`'s body for group g: the psum of the group's
        per-shard partials `stacked` [n_g, ...], on the group's device."""
        return self._meet(g, fold(list(stacked), torch.add), "sum")

    def group_max(self, g: int, stacked: torch.Tensor) -> torch.Tensor:
        return self._meet(g, fold(list(stacked), torch.maximum), "max")

    def group_assemble(self, g: int, values: torch.Tensor, positions,
                       size: int, fill: float, op: str) -> torch.Tensor:
        """Inside `run`'s body for group g: the global [size] vector of
        which this group holds `values` at `positions` (a slice start or
        an index tensor) and every other group and process holds its
        own disjoint part; `fill` (0 for sum, -inf for max) everywhere
        else. Combining disjoint supports adds only identities, so the
        assembled vector is bitwise the one a single device computes.
        A lone group whose values cover the whole vector has nothing to
        assemble: they are returned as they are."""
        alone = self._barrier is None and not self.cross_process
        if alone and isinstance(positions, int) and positions == 0 and (
                values.shape[0] == size):
            return values
        vec = torch.full((size,), fill, dtype=values.dtype,
                         device=values.device)
        if isinstance(positions, int):
            vec[positions: positions + values.shape[0]] = values
        else:
            vec[positions] = values
        if alone:
            return vec
        return self._meet(g, vec, op)

    # -- internals -------------------------------------------------------

    def _meet(self, g: int, part: torch.Tensor, op: str) -> torch.Tensor:
        """Group g's partial meets the other groups' (in group order, on
        group 0's device) and the other processes'; returns the total on
        group g's device."""
        if self._barrier is None:
            return self._across(part, op)
        self._slots[g] = part
        if self._barrier.wait() == 0:
            fn = torch.add if op == "sum" else torch.maximum
            total = self._across(fold(self._slots, fn), op)
            self._result = total
        self._barrier.wait()
        # A group deposits its next partial only after this barrier and
        # the next total is written only once every group has, so two
        # barriers a combine keep the slots and the total consistent.
        return self._result.to(part.device)

    def _across(self, t: torch.Tensor, op: str) -> torch.Tensor:
        if not self.cross_process:
            return t
        import torch.distributed as dist

        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        if self.staged_through_host:
            host = t.detach().to("cpu").clone()
            dist.all_reduce(host, op=red, group=self._pg)
            return host.to(t.device)
        out = t.clone()
        dist.all_reduce(out, op=red, group=self._pg)
        return out
