"""Model substrate of the port: the transformer (dense, MoE, VLM), RWKV-6,
zamba2 and enc-dec families on tensors (port of ``repro.models``)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, build_model, lm_loss
from repro_torch.models.params import (ParamDef, abstract, materialize,
                                       tree_num_params)

__all__ = ["ModelConfig", "Model", "build_model", "lm_loss", "ParamDef",
           "abstract", "materialize", "tree_num_params"]
