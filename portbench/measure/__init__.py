"""Part of the port's benchmark (see portbench/run.py)."""
