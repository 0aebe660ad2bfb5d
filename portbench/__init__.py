"""The benchmark of doorman_tpu_torch, the PyTorch and CUDA port: one
command runs one cell (`python3 portbench/run.py --workload <name> ...`);
BENCHMARK.json at the repository's root names the cells."""
