"""The batched solve: lane math (plain torch), the dense layout, the
CUDA kernel wrappers, the tick engine, the device-resident solver, and
the BatchSolver's priority part (PRIORITY_BANDS with capacity groups)."""

from doorman_tpu_torch.solver.batch import (  # noqa: F401
    BatchSolver,
    PrioritySnapshot,
)
from doorman_tpu_torch.solver.priority import (  # noqa: F401
    PriorityBatch,
    solve_priority,
)
