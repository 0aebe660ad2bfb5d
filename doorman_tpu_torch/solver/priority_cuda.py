"""Kernel K3, the banded water-fill, on the card (the counterpart of
doorman_tpu/solver/pallas_priority.py).

`alloc_banded_k3` computes solver.priority._alloc_banded — bands in
rank order, each water-filled in the capacity the higher bands left —
for every row of a [R, K] table. Given CPU tensors it runs that plain
version; given CUDA tensors it launches K3 (hand-written CUDA C++ for
sm_90a in csrc/dense_solve.cu, built and bound by solver.dense_cuda)
and raises on a build or launch failure — nothing falls back. Each
launch adds one to dense_cuda.LAUNCHES["k3"] and one to its layout's
count in dense_cuda.K3_LAYOUT_LAUNCHES.

K3 launches one of three layouts, chosen from the row width by
`k3_layout`: rows of up to dense_cuda.WARP_MAX_K lanes (the same bound
as K1/K2's) run one warp per row with the row in registers
(`banded_fill_warp_kernel`); wider rows run one block per row with the
row staged in shared memory (`banded_fill_kernel`) while it fits there
(SMEM_LIMIT), and one thread-block cluster per row above that
(`banded_fill_cluster_kernel`, any width), its blocks exchanging their
partial sums through distributed shared memory; `k3_cluster_plan` picks
the cluster's size and whether its blocks stage the row. A fourth
layout, one block per row reading the row from global memory in every
pass (`banded_fill_global_kernel`), is reached only through
`_launch_layout("global", ...)`, as the cluster layout's comparison.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from doorman_tpu_torch.solver import dense_cuda
from doorman_tpu_torch.solver.lanes import rowsum
from doorman_tpu_torch.solver.priority import _alloc_banded
from doorman_tpu_torch.utils.backend import require_hopper

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448

# K3's cluster layout (csrc/dense_solve.cu): threads a block, the most
# blocks a cluster (above 8 needs the non-portable opt-in), the lane multiple
# a block's chunk of the row is rounded to, the reduction scratch at the
# front of a block's shared memory (values), and the band byte a staged
# lane in no band holds.
CLUSTER_THREADS = 512
CLUSTER_MAX = 16
CLUSTER_ALIGN = 128
CLUSTER_RED_SLOTS = 144
NO_BAND = 255


def k3_layout(K: int, itemsize: int) -> str:
    """The layout K3 launches for rows of K lanes of `itemsize`-byte
    floats: "warp" (one warp per row, the row in registers) up to
    dense_cuda.WARP_MAX_K lanes, "block" (one block per row, the row
    staged in shared memory) while k3_smem_bytes fits SMEM_LIMIT,
    "cluster" (one thread-block cluster per row, k3_cluster_plan) above."""
    if K <= dense_cuda.WARP_MAX_K:
        return "warp"
    return "block" if k3_smem_bytes(K, itemsize) <= SMEM_LIMIT else "cluster"


def k3_cluster_chunk(K: int, C: int) -> int:
    """Lanes of the row each of a cluster's C blocks owns (the last
    blocks' chunks end at K): ceil(K / C) rounded up to CLUSTER_ALIGN."""
    per = -(-K // C)
    return -(-per // CLUSTER_ALIGN) * CLUSTER_ALIGN


def k3_cluster_smem_bytes(K: int, C: int, staged: bool, itemsize: int) -> int:
    """Shared memory one block of the cluster layout uses
    (csrc/dense_solve.cu k3_cluster_smem_for): the reduction scratch,
    and when staged its chunk's wants and weights and a band byte a
    lane."""
    red = CLUSTER_RED_SLOTS * itemsize
    return red + k3_cluster_chunk(K, C) * (2 * itemsize + 1) if staged else red


def k3_cluster_plan(K: int, itemsize: int, num_bands: int = 1,
                    rows: int = 1, sms: int = 132, resident=None):
    """(C, staged, shared memory bytes a block) of K3's cluster layout
    for `rows` rows of K lanes. Of the cluster sizes C <= CLUSTER_MAX
    whose blocks can each stage their chunk in shared memory (while the
    band ranks fit a byte), or of all of them where none can (the blocks
    then read the row from global memory), the one with the fewest
    lanes a block times waves: a cluster's passes take time in
    proportion to its blocks' chunks, and the `rows` clusters take
    ceil(rows / n) waves when the card holds n of them at once —
    `resident(C, staged)`, the card's own count, or by default `sms`
    // C (one block an SM). On a tie, the fewer blocks."""
    def cost(C, staged):
        n = resident(C, staged) if resident is not None else sms // C
        waves = -(-rows // n) if n > 0 else float("inf")
        return waves * k3_cluster_chunk(K, C), C

    sizes = range(1, CLUSTER_MAX + 1)
    plans = [(C, True) for C in sizes if num_bands <= NO_BAND
             and k3_cluster_smem_bytes(K, C, True, itemsize) <= SMEM_LIMIT]
    C, staged = min(plans or [(C, False) for C in sizes],
                    key=lambda p: cost(*p))
    return C, staged, k3_cluster_smem_bytes(K, C, staged, itemsize)


def k3_cluster_plan_for(wants: torch.Tensor, num_bands: int):
    """k3_cluster_plan for a [R, K] table on its card: the plan the
    wrapper launches."""
    R, K = wants.shape
    return k3_cluster_plan(
        K, wants.element_size(), num_bands, R, resident=lambda C, staged:
        k3_cluster_max_active(wants.dtype, K, C, staged))


@functools.lru_cache(maxsize=None)
def k3_cluster_max_active(dtype: torch.dtype, K: int, C: int,
                          staged: bool) -> int:
    """Clusters of that plan the card holds at once
    (cudaOccupancyMaxActiveClusters); raises if the query fails."""
    out = ctypes.c_int(0)
    fn = getattr(dense_cuda._load(),
                 f"dsk_k3_cluster_{dense_cuda._DT[dtype]}_max_active")
    dense_cuda._raise_on(fn(K, C, int(staged), ctypes.byref(out)),
                         "K3 (cluster occupancy query)")
    return out.value


def k3_smem_bytes(K: int, itemsize: int) -> int:
    """Shared memory K3's block layout stages one row in
    (csrc/dense_solve.cu k3_smem_for): five [K] value arrays, 64
    reduction slots, the [K] band ranks and two [K] masks."""
    return 5 * K * itemsize + 64 * itemsize + 6 * K


def _check(wants, weights, band, active, eff_cap):
    dev, dtype = wants.device, wants.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K3 takes float32/float64, got {dtype}")
    R, K = wants.shape
    for name, t, want in (
        ("weights", weights, dtype), ("band", band, torch.int32),
        ("active", active, torch.bool),
    ):
        if t.dtype != want or t.shape != (R, K):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}")
    if eff_cap.dtype != dtype or eff_cap.shape != (R,):
        raise ValueError(f"eff_cap: {eff_cap.dtype} {tuple(eff_cap.shape)}")
    for name, t in (("wants", wants), ("weights", weights), ("band", band),
                    ("active", active), ("eff_cap", eff_cap)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, wants on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def alloc_banded_k3(
    wants: torch.Tensor,  # [R, K]
    weights: torch.Tensor,  # [R, K]
    band: torch.Tensor,  # [R, K] int32 dense rank
    active: torch.Tensor,  # [R, K] bool
    eff_cap: torch.Tensor,  # [R] capacity (already scaled by theta)
    num_bands: int,
    totals: bool = False,
):
    """Grants [R, K] (and, with `totals`, each row's grant total [R]).
    CPU tensors take the plain version; CUDA tensors launch K3."""
    dev = wants.device
    if dev.type == "cpu":
        gets = _alloc_banded(wants, weights, band, active, eff_cap, num_bands)
        return (gets, rowsum(gets)) if totals else gets
    if dev.type != "cuda":
        raise ValueError(f"no K3 kernel for device {dev}")
    _check(wants, weights, band, active, eff_cap)
    require_hopper(dev)
    layout = k3_layout(wants.shape[1], wants.element_size())
    gets, tot = _launch_layout(
        layout, wants, weights, band, active, eff_cap, num_bands, totals,
    )
    dense_cuda.LAUNCHES["k3"] += 1
    dense_cuda.K3_LAYOUT_LAUNCHES[layout] += 1
    return (gets, tot) if totals else gets


def _launch_layout(layout, wants, weights, band, active, eff_cap,
                   num_bands, totals, plan=None, syncs=None):
    """One launch of K3's `layout` ("warp", "block", "cluster" or
    "global") on tensors that `_check` passed: (gets, row totals or
    None). Counts nothing: the wrapper counts its own launch, and a
    comparison of the layouts calls this directly. The block layout
    takes rows up to SMEM_LIMIT's width, the warp layout up to
    WARP_MAX_K lanes. The cluster layout runs `plan` ((C, staged), by
    default k3_cluster_plan's) and raises if the card holds no cluster
    of it; `syncs` (int32 [R] on the device, or None) receives each
    row's count of cluster barriers."""
    R, K = wants.shape
    dev = wants.device
    lib = dense_cuda._load()
    gets = torch.empty((R, K), dtype=wants.dtype, device=dev)
    tot = (
        torch.empty(R, dtype=wants.dtype, device=dev) if totals else None
    )
    dt = dense_cuda._DT[wants.dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (wants.data_ptr(), weights.data_ptr(), band.data_ptr(),
            active.data_ptr(), eff_cap.data_ptr(), gets.data_ptr(),
            tot.data_ptr() if tot is not None else None)
    if layout == "cluster":
        C, staged = plan or k3_cluster_plan_for(wants, num_bands)[:2]
        if k3_cluster_max_active(wants.dtype, K, C, staged) < 1:
            raise RuntimeError(
                f"K3 (cluster layout): the card holds no cluster of {C} "
                f"{'staged' if staged else 'streamed'} blocks at K = {K}")
        state = torch.empty(R * C * 2 * int(num_bands), dtype=wants.dtype,
                            device=dev)
        err = getattr(lib, f"dsk_k3_cluster_{dt}")(
            *args, state.data_ptr(),
            syncs.data_ptr() if syncs is not None else None,
            R, K, int(num_bands), int(C), int(staged), stream,
        )
    else:
        err = getattr(lib, f"dsk_k3_{layout}_{dt}")(
            *args, R, K, int(num_bands), stream,
        )
    dense_cuda._raise_on(err, f"K3 ({layout} layout)")
    return gets, tot
