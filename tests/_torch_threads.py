"""Imported for its effect: torch's CPU ops take one intra-op thread.

The port's tests run small tensors (a few dozen rows), where torch's
thread pool only adds overhead, and the suite runs in parallel workers:
with torch's default of one thread a core in every worker, a loaded
machine ran `tests/test_torch_k3_cluster.py`'s banded-fill cases 10x
slower than with one thread (114 s against 10.5 s for 12 cases beside 7
busy processes). One thread keeps each worker to its own core."""

import torch

torch.set_num_threads(1)
