"""Model builders of the port (copies of the JAX package's builders)."""

from flexflow_tpu_torch.models.llama import llama_lm, swiglu
from flexflow_tpu_torch.models.transformer import (build_encoder_classifier,
                                                   encoder_block)

__all__ = ["build_encoder_classifier", "encoder_block", "llama_lm", "swiglu"]
