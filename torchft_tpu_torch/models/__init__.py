"""Models of the port (the JAX package's ``torchft_tpu.models``)."""

from torchft_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  chunked_causal_lm_loss,
                                                  llama2_7b_config,
                                                  params_from_jax,
                                                  tiny_config)

__all__ = ["Transformer", "TransformerConfig", "chunked_causal_lm_loss",
           "llama2_7b_config", "params_from_jax", "tiny_config"]
