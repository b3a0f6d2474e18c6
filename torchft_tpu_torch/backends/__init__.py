"""Cross-replica-group collective backends.

- :mod:`torchft_tpu_torch.backends.host` — elastic host TCP ring (the
  Gloo-role default; survives membership changes).
"""

from torchft_tpu_torch.backends.host import HostCommunicator

__all__ = ["HostCommunicator"]
