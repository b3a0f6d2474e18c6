"""torchft_tpu_torch: the PyTorch/CUDA port of ``torchft_tpu``.

Per-step fault tolerance for data-parallel training across replica groups —
lighthouse quorum, per-group manager, commit vote and live heal — with the
JAX package's wire and on-disk formats, in PyTorch, and the JAX package's
Pallas kernels rewritten by hand for NVIDIA Hopper. Nothing here imports
JAX or the JAX package.
"""

from torchft_tpu_torch.backends.host import HostCommunicator
from torchft_tpu_torch.communicator import (Communicator, CommunicatorError,
                                            Int8Wire)
from torchft_tpu_torch.local_sgd import (DiLoCoTrainer,
                                         StreamingDiLoCoTrainer,
                                         diloco_outer_optimizer)
from torchft_tpu_torch.manager import (Manager, PreemptedExit,
                                       WorldSizeMode)
from torchft_tpu_torch.optim import FTOptimizer
from torchft_tpu_torch.parallel.step import FTTrainer

__all__ = ["Communicator", "CommunicatorError", "DiLoCoTrainer",
           "FTOptimizer", "FTTrainer", "HostCommunicator", "Int8Wire",
           "Manager", "PreemptedExit", "StreamingDiLoCoTrainer",
           "WorldSizeMode", "diloco_outer_optimizer"]
