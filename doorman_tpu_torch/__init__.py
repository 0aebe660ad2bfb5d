"""doorman-tpu on PyTorch and CUDA: the port of `doorman_tpu` to an
NVIDIA H100.

The same capacity server — clients of a shared resource obtain
time-bounded capacity leases, and a batch tick re-solves every
resource's allocation at once — with the device-resident tick written
in PyTorch and its dense lane solve as hand-written CUDA kernels
(csrc/dense_solve.cu). The package imports torch and never jax; every
module it needs from the JAX package is kept here as its own copy.

Package layout (mirrors doorman_tpu/):
    proto/        wire schema + hand-wired gRPC service (identical wire)
    algorithms/   lane ids, scalar first-response algorithms, oracles
    core/         lease, lease store, resource
    native/       the C++ lease-store engine (ctypes, built at first use)
    solver/       lanes (plain torch), dense, CUDA kernel wrappers,
                  tick engine, resident solver, state carry-over
    server/       the batch-mode capacity server, config, election
    cmd/          the server binary
    utils/        device resolution, dispatch accounting, transfers

Entry points run on the CUDA device unless the caller passes
device="cpu"; without a GPU and without that request they raise.
"""

__version__ = "0.1.0"
