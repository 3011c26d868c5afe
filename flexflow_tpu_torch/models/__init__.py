"""Model builders of the port (copies of the JAX package's builders)."""

from flexflow_tpu_torch.models.llama import llama_lm, swiglu

__all__ = ["llama_lm", "swiglu"]
