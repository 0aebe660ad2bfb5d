"""Support utilities: device resolution, dispatch accounting, transfers,
backoff."""

from doorman_tpu_torch.utils.backoff import backoff  # noqa: F401
