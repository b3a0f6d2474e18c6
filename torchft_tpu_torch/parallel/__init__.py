from torchft_tpu_torch.parallel.step import FTTrainer, SPTrainer

__all__ = ["FTTrainer", "SPTrainer"]
