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

K3 has three layouts, chosen from the row width by `k3_layout`: rows of
up to dense_cuda.WARP_MAX_K lanes (the same bound as K1/K2's) run one
warp per row with the row in registers (`banded_fill_warp_kernel`);
wider rows run one block per row with the row staged in shared memory
(`banded_fill_kernel`) while it fits there (SMEM_LIMIT), and one block
per row reading the row from global memory in every pass above that
(`banded_fill_global_kernel`, any width).
"""

from __future__ import annotations

import torch

from doorman_tpu_torch.solver import dense_cuda
from doorman_tpu_torch.solver.lanes import rowsum
from doorman_tpu_torch.solver.priority import _alloc_banded
from doorman_tpu_torch.utils.backend import require_hopper

# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448


def k3_layout(K: int, itemsize: int) -> str:
    """The layout K3 launches for rows of K lanes of `itemsize`-byte
    floats: "warp" (one warp per row, the row in registers) up to
    dense_cuda.WARP_MAX_K lanes, "block" (one block per row, the row
    staged in shared memory) while k3_smem_bytes fits SMEM_LIMIT,
    "global" (one block per row, the row read from global memory in
    every pass) above."""
    if K <= dense_cuda.WARP_MAX_K:
        return "warp"
    return "block" if k3_smem_bytes(K, itemsize) <= SMEM_LIMIT else "global"


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
                   num_bands, totals):
    """One launch of K3's `layout` ("warp", "block" or "global") on
    tensors that `_check` passed: (gets, row totals or None). Counts
    nothing: the wrapper counts its own launch, and a comparison of the
    layouts calls this directly. The block layout takes rows up to
    SMEM_LIMIT's width, the warp layout up to WARP_MAX_K lanes."""
    R, K = wants.shape
    dev = wants.device
    lib = dense_cuda._load()
    gets = torch.empty((R, K), dtype=wants.dtype, device=dev)
    tot = (
        torch.empty(R, dtype=wants.dtype, device=dev) if totals else None
    )
    fn = getattr(lib, f"dsk_k3_{layout}_{dense_cuda._DT[wants.dtype]}")
    err = fn(
        wants.data_ptr(), weights.data_ptr(), band.data_ptr(),
        active.data_ptr(), eff_cap.data_ptr(), gets.data_ptr(),
        tot.data_ptr() if tot is not None else None,
        R, K, int(num_bands), torch.cuda.current_stream(dev).cuda_stream,
    )
    dense_cuda._raise_on(err, f"K3 ({layout} layout)")
    return gets, tot
