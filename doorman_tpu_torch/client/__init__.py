"""Client side: master-aware connection + background-refresh capacity
client (port of doorman_tpu/client)."""

from doorman_tpu_torch.client.client import Client, ClientResource  # noqa: F401
from doorman_tpu_torch.client.connection import Connection  # noqa: F401
