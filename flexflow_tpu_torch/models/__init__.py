"""Model builders of the port (copies of the JAX package's builders)."""

from flexflow_tpu_torch.models.bert import bert_base, gpt_lm, gpt_pipelined
from flexflow_tpu_torch.models.cnn import (alexnet, alexnet_cifar10,
                                           candle_uno, inception_v3,
                                           inception_v3_stem, resnet50)
from flexflow_tpu_torch.models.dlrm import dlrm
from flexflow_tpu_torch.models.llama import llama_lm, swiglu
from flexflow_tpu_torch.models.nmt import nmt_seq2seq
from flexflow_tpu_torch.models.transformer import (build_encoder_classifier,
                                                   encoder_block)
from flexflow_tpu_torch.models.vit import vit

__all__ = ["alexnet", "alexnet_cifar10", "bert_base",
           "build_encoder_classifier", "candle_uno", "dlrm", "encoder_block",
           "gpt_lm", "gpt_pipelined", "inception_v3", "inception_v3_stem",
           "llama_lm", "nmt_seq2seq", "resnet50", "swiglu", "vit"]
