"""Workload models (port of doorman_tpu/workload): so far the seasonal
demand forecaster of predictive admission (`forecast.py`)."""
