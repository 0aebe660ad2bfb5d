"""Device resolution for the port's entry points.

Every entry point (CapacityServer, ResidentDenseSolver, cmd.server)
takes an explicit `device` and defaults to "cuda". A CUDA request on a
machine without a usable GPU raises instead of dropping to the CPU: a
server that silently solved on the host would serve at a fraction of
its provisioned rate with nothing in its output saying so. The CPU runs
only when the caller asks for it (the tests do), and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch

# The kernels are built for sm_90a (csrc/dense_solve.cu): Hopper only.
REQUIRED_CAPABILITY = (9, 0)


def resolve_device(device="cuda") -> torch.device:
    """A torch.device for "cuda", "cuda:N" or "cpu"; raises when CUDA is
    asked for and no GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def require_hopper(device: torch.device) -> None:
    """Raise unless `device` is a compute-capability 9.0 GPU (the only
    target the kernels are compiled for)."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap}; the kernels are built for sm_90a"
        )


def device_info(device: torch.device) -> dict:
    """Name and capability of a device, for status pages and results."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "capability": list(torch.cuda.get_device_capability(device)),
        "count": torch.cuda.device_count(),
    }
