"""The batched solve: lane math (plain torch), the dense, chunked and
edge-list layouts, the CUDA kernel wrappers, the tick engine, the
device-resident solvers (narrow rows and wide chunked resources), and
the BatchSolver (its dense and edge-list lane parts and its priority
part, PRIORITY_BANDS with capacity groups). Import the modules
themselves: the package imports none of them, so that core.snapshot
and the solver modules may import each other's types in any order."""
