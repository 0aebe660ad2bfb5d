"""The dense solve kernels on the card: build, bind, launch.

K1 (`solve_dense_k1`) is the lane solve of solver.dense.solve_dense;
K2 (`fused_tick_k2`) is K1 fused with the delivered-grant delta
epilogue of solver.dense.fused_tick_plain. Both are hand-written CUDA
C++ for sm_90a in csrc/dense_solve.cu (it replaces the TPU kernels of
doorman_tpu/solver/pallas_dense.py and says what bounds it and how).
The same library carries K3, the banded water-fill, whose wrapper is
solver.priority_cuda.alloc_banded_k3.

Every kernel has two layouts, chosen from the row width K: rows of up
to WARP_MAX_K lanes run one warp per row, the row in registers and
every reduction a warp shuffle (`dense_solve_warp_kernel`,
`banded_fill_warp_kernel`); wider rows run one block per row, the row
staged in shared memory (`dense_solve_kernel`, `banded_fill_kernel`).
K3 runs rows wider than one block's shared memory as one thread-block
cluster per row (`banded_fill_cluster_kernel`), and keeps a one-block
global-memory layout (`banded_fill_global_kernel`) as its comparison.
`k1_layout` picks K1/K2's layout, priority_cuda.k3_layout K3's.

The source is compiled with nvcc at first use into the package's
`_build/` directory as a shared library with a plain C interface, and
bound with ctypes: pointers are `tensor.data_ptr()`, the stream is
torch's current stream. A wrapper given CPU tensors runs the plain
PyTorch version; given CUDA tensors it launches the kernel, and a build
or launch failure raises — nothing falls back.

`LAUNCHES` counts kernel launches per kernel: a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from doorman_tpu_torch.solver.dense import (
    DenseBatch,
    fused_tick_plain,
    solve_dense,
)
from doorman_tpu_torch.utils.backend import require_hopper

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dense_solve.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libdense_solve.so"

# Kernel launches since process start (or the caller's last reset).
LAUNCHES = {"k1": 0, "k2": 0, "k3": 0}
# K3's launches again, by the layout that ran them, so a run shows which
# layout served a path (the global layout is launched only as the
# cluster layout's comparison, which counts nothing).
K3_LAYOUT_LAUNCHES = {"warp": 0, "block": 0, "cluster": 0}

# The widest row the warp-per-row layouts take (csrc/dense_solve.cu
# kWarpMaxK: 8 elements a lane).
WARP_MAX_K = 256

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # Each elementwise expression rounds exactly as the plain version's:
    # no fused multiply-add contraction, no fast math.
    "-fmad=false",
    # ptxas's report of each kernel's registers and spills, kept beside
    # the library (PTXAS_LOG, read by ptxas_usage).
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]
PTXAS_LOG = BUILD_DIR / "libdense_solve.ptxas.txt"

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for counts in (LAUNCHES, K3_LAYOUT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/dense_solve.cu into _build/ unless an up-to-date
    library is there; returns the library path."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR),
                               prefix="libdense_solve_")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        PTXAS_LOG.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIBRARY


def ptxas_usage(text: "str | None" = None) -> dict:
    """{kernel entry (mangled name): {"registers", "spill_stores",
    "spill_loads"}} from ptxas's `-v` report (`text`, or the last
    build's PTXAS_LOG); spills are in bytes."""
    if text is None:
        text = PTXAS_LOG.read_text()
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_stores": None,
                          "spill_loads": None}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


# A kernel entry's mangled name -> (kernel, layout, types, V or None).
_ENTRY = re.compile(
    r"(dense_solve_warp_kernel|dense_solve_kernel|banded_fill_warp_kernel"
    r"|banded_fill_global_kernel|banded_fill_cluster_kernel"
    r"|banded_fill_kernel)I([fd])"
    r"(?:([fd]|13__nv_bfloat16|DF16b)?Lb([01])E)?(?:Li(\d+)E)?"
)
_TYPE = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16", "DF16b": "bf16"}


def entry_label(entry: str) -> "str | None":
    """"K1 warp f32 V=4", "K2 block f64/bf16", "K3 global f64",
    "K3 cluster f32 staged", ... for a kernel entry of ptxas's report (a
    mangled name); None for anything else. K2's types are the solve's
    and prev's."""
    m = _ENTRY.search(entry)
    if m is None:
        return None
    kern, t, p, flag, V = m.groups()
    if kern.startswith("banded"):
        name = "K3"
    else:
        name = "K2" if flag == "1" else "K1"
    layout = next((k for k in ("warp", "global", "cluster") if k in kern),
                  "block")
    types = _TYPE[t] + (f"/{_TYPE[p]}" if name == "K2" else "")
    if layout == "cluster":
        types += " staged" if flag == "1" else " streamed"
    return f"{name} {layout} {types}" + (f" V={V}" if V else "")


def k1_layout(K: int) -> str:
    """"warp" (one warp per row, the row in registers) for rows of up to
    WARP_MAX_K lanes, "block" (one block per row, the row in shared
    memory) above: the layout K1 and K2 launch at width K."""
    return "warp" if K <= WARP_MAX_K else "block"


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for layout in ("block", "warp"):
                for dt in ("f32", "f64"):
                    fn = getattr(lib, f"dsk_k1_{layout}_{dt}")
                    fn.restype = _I
                    fn.argtypes = [_P] * 10 + [_I, _I, _P]
                    for pdt in (dt, "bf16"):
                        fn = getattr(lib, f"dsk_k2_{layout}_{dt}_{pdt}")
                        fn.restype = _I
                        fn.argtypes = [_P] * 13 + [_I, _I, _P]
            for name in ("dsk_k3_block_f32", "dsk_k3_block_f64",
                         "dsk_k3_warp_f32", "dsk_k3_warp_f64",
                         "dsk_k3_global_f32", "dsk_k3_global_f64"):
                fn = getattr(lib, name)
                fn.restype = _I
                fn.argtypes = [_P] * 7 + [_I, _I, _I, _P]
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"dsk_k3_cluster_{dt}")
                fn.restype = _I
                fn.argtypes = [_P] * 9 + [_I] * 5 + [_P]
                fn = getattr(lib, f"dsk_k3_cluster_{dt}_max_active")
                fn.restype = _I
                fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
            _lib = lib
        return _lib


_DT = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def _check_batch(batch: DenseBatch) -> "tuple[torch.device, torch.dtype]":
    w = batch.wants
    dev, dtype = w.device, w.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dense kernels take float32/float64, got {dtype}")
    R, K = w.shape
    for name in ("wants", "has", "subclients"):
        t = getattr(batch, name)
        if t.dtype != dtype or t.shape != (R, K):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}")
    if batch.active.dtype != torch.bool or batch.active.shape != (R, K):
        raise ValueError("active must be a bool [R, K] tensor")
    for name, want in (("capacity", dtype), ("static_capacity", dtype),
                       ("algo_kind", torch.int32), ("learning", torch.bool)):
        t = getattr(batch, name)
        if t.dtype != want or t.shape != (R,):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}")
    for f in ("wants", "has", "subclients", "active", "capacity",
              "algo_kind", "learning", "static_capacity"):
        t = getattr(batch, f)
        if t.device != dev:
            raise ValueError(f"{f} is on {t.device}, wants on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{f} must be contiguous")
    return dev, dtype


def _inputs(batch: DenseBatch):
    return [
        batch.wants.data_ptr(), batch.has.data_ptr(),
        batch.subclients.data_ptr(), batch.active.data_ptr(),
        batch.capacity.data_ptr(), batch.algo_kind.data_ptr(),
        batch.learning.data_ptr(), batch.static_capacity.data_ptr(),
    ]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def solve_dense_k1(
    batch: DenseBatch,
    rows: "torch.Tensor | None" = None,
    lanes=None,
    lane_rows=None,
) -> torch.Tensor:
    """Grants of the batch's rows (all of them, or `rows` [n] int32 in
    that order) as a new [n, K] tensor. CPU tensors take the plain
    version (`lanes` / `lane_rows` are its host-knowledge fast paths,
    byte-identical, and index the gathered rows); CUDA tensors launch
    K1 in the layout k1_layout(K) picks."""
    dev = batch.wants.device
    if dev.type == "cpu":
        b = batch.rows(rows) if rows is not None else batch
        return solve_dense(b, lanes=lanes, lane_rows=lane_rows)
    if dev.type != "cuda":
        raise ValueError(f"no dense kernel for device {dev}")
    dev, _dtype = _check_batch(batch)
    if rows is not None:
        if rows.dtype != torch.int32 or rows.device != dev or rows.dim() != 1:
            raise ValueError("rows must be a 1-D int32 tensor on the device")
        rows = rows.contiguous()
    require_hopper(dev)
    out = _launch_k1(k1_layout(batch.wants.shape[1]), batch, rows)
    LAUNCHES["k1"] += 1
    return out


def _launch_k1(layout: str, batch: DenseBatch, rows=None) -> torch.Tensor:
    """One launch of K1's `layout` ("warp" or "block") on a batch (and
    rows) that solve_dense_k1 checked: the [n, K] grants. Counts
    nothing: the wrapper counts its own launch, and a comparison of the
    two layouts calls this directly."""
    R, K = batch.wants.shape
    dev, dtype = batch.wants.device, batch.wants.dtype
    n = rows.shape[0] if rows is not None else R
    out = torch.empty((n, K), dtype=dtype, device=dev)
    fn = getattr(_load(), f"dsk_k1_{layout}_{_DT[dtype]}")
    err = fn(
        *_inputs(batch),
        rows.data_ptr() if rows is not None else None,
        out.data_ptr(), n, K,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, f"K1 ({layout} layout)")
    return out


def fused_tick_k2(
    batch: DenseBatch,
    prev: torch.Tensor,  # [R, K] previous delivered grants
    delivered: torch.Tensor,  # [R] bool
    lanes=None,
    lane_rows=None,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """(gets, prev_new, changed) of the whole batch: K1's grants, prev
    advanced on delivered rows, and changed[r] = delivered[r] and
    any(gets[r] cast to prev's dtype != prev[r]). CPU tensors take the
    plain version; CUDA tensors launch K2 in the layout k1_layout(K)
    picks."""
    dev = batch.wants.device
    if dev.type == "cpu":
        return fused_tick_plain(
            batch, prev, delivered, lanes=lanes, lane_rows=lane_rows
        )
    if dev.type != "cuda":
        raise ValueError(f"no dense kernel for device {dev}")
    dev, dtype = _check_batch(batch)
    R, K = batch.wants.shape
    if prev.shape != (R, K) or prev.device != dev or not prev.is_contiguous():
        raise ValueError("prev must be a contiguous [R, K] tensor on the device")
    if prev.dtype not in (dtype, torch.bfloat16):
        raise TypeError(f"prev dtype {prev.dtype} with solve dtype {dtype}")
    if delivered.dtype != torch.bool or delivered.shape != (R,):
        raise ValueError("delivered must be a bool [R] tensor")
    require_hopper(dev)
    res = _launch_k2(k1_layout(K), batch, prev, delivered.contiguous())
    LAUNCHES["k2"] += 1
    return res


def _launch_k2(layout: str, batch: DenseBatch, prev, delivered):
    """One launch of K2's `layout` on tensors that fused_tick_k2
    checked: (gets, prev_new, changed). Counts nothing, as _launch_k1."""
    R, K = batch.wants.shape
    dev, dtype = batch.wants.device, batch.wants.dtype
    gets = torch.empty((R, K), dtype=dtype, device=dev)
    prev_new = torch.empty_like(prev)
    changed = torch.empty(R, dtype=torch.bool, device=dev)
    fn = getattr(_load(), f"dsk_k2_{layout}_{_DT[dtype]}_{_DT[prev.dtype]}")
    err = fn(
        *_inputs(batch),
        prev.data_ptr(), delivered.data_ptr(),
        gets.data_ptr(), prev_new.data_ptr(), changed.data_ptr(),
        R, K, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, f"K2 ({layout} layout)")
    return gets, prev_new, changed
