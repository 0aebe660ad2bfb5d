"""setup_s: seconds from the process's start to the first measured
iteration (imports, the port's build or load, the population, warm-up)."""


def read(run):
    return run["setup_s"]
