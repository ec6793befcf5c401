from merv_tpu_torch.nn.core import ACT2FN, Embed, LayerNorm, Linear, RMSNorm, init_weights
from merv_tpu_torch.nn.fusion import CrossAttentionAdapterLearnableQuery
from merv_tpu_torch.nn.projectors import AveragePooling3DProjector, LinearProjector

__all__ = [
    "ACT2FN",
    "AveragePooling3DProjector",
    "CrossAttentionAdapterLearnableQuery",
    "Embed",
    "LayerNorm",
    "Linear",
    "LinearProjector",
    "RMSNorm",
    "init_weights",
]
