from torchft_tpu_torch.parallel.step import FTTrainer

__all__ = ["FTTrainer"]
