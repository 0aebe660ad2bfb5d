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

import sys
import time
from typing import Optional

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


def wait_for_backend(
    attempts: int = 3,
    per_timeout_s: float = 180.0,
    cwd: Optional[str] = None,
    probe_argv=None,
) -> Optional[str]:
    """Wait out a device blip: probe the card in a throwaway subprocess
    every attempt (a fresh process initialises CUDA anew, so a device
    that recovered mid-wait is picked up, and a probe that hangs never
    holds this process's CUDA context). Attempts are paced to the full
    per-attempt window even when a probe fails fast. Returns None once
    a probe succeeds, else the last failure reason. Progress goes to
    stderr.

    `probe_argv` substitutes the probe command: a list, or a callable
    returning one, resolved fresh per attempt (the chaos harness injects
    failing and healing probes this way).

    Port of doorman_tpu/utils/backend.py's wait_for_backend: the same
    retry classification; the default probe initialises CUDA through
    torch instead of listing JAX devices."""
    import subprocess

    default_argv = [
        sys.executable, "-c",
        "import torch; torch.zeros(1, device='cuda'); "
        "torch.cuda.synchronize(); print('ok')",
    ]
    reason = "backend probe never ran"
    for attempt in range(1, attempts + 1):
        attempt_start = time.monotonic()
        if callable(probe_argv):
            argv = probe_argv()
        else:
            argv = probe_argv or default_argv
        try:
            proc = subprocess.run(
                argv,
                capture_output=True, text=True, timeout=per_timeout_s,
                cwd=cwd,
            )
            if proc.returncode == 0 and "ok" in proc.stdout:
                return None
            reason = (
                proc.stderr.strip()[-1500:] or f"rc={proc.returncode}"
            )
            # Only the final stderr line (the raising exception) counts.
            # Code or environment breakage never heals by waiting, so
            # it reports at once; RuntimeError and ValueError stay
            # retryable, since a device that is down raises those.
            last_line = reason.splitlines()[-1] if reason else ""
            if last_line.startswith(
                ("ModuleNotFoundError", "ImportError", "SyntaxError",
                 "AttributeError", "NameError")
            ):
                print(
                    f"backend probe failed (unretryable): {last_line}",
                    file=sys.stderr, flush=True,
                )
                return reason
        except subprocess.TimeoutExpired:
            reason = (
                f"the device did not initialise within "
                f"{per_timeout_s:.0f}s"
            )
        print(
            f"backend probe {attempt}/{attempts} failed: {reason}",
            file=sys.stderr, flush=True,
        )
        if attempt < attempts:
            elapsed = time.monotonic() - attempt_start
            time.sleep(max(0.0, per_timeout_s - elapsed))
    return reason
