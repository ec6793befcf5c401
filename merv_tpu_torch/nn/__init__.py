from merv_tpu_torch.nn.core import ACT2FN, Embed, LayerNorm, Linear, RMSNorm, init_weights
from merv_tpu_torch.nn.fusion import CrossAttentionAdapterLearnableQuery, ScalarAdapter
from merv_tpu_torch.nn.projectors import (
    AttentivePooler,
    AveragePooling3DProjector,
    AveragePoolingProjector,
    Convolutional3DProjector,
    ConvolutionalProjector,
    FusedMLPProjector,
    Identity,
    LinearProjector,
    MLPDeepProjector,
    MLPProjector,
)

__all__ = [
    "ACT2FN",
    "AttentivePooler",
    "AveragePooling3DProjector",
    "AveragePoolingProjector",
    "Convolutional3DProjector",
    "ConvolutionalProjector",
    "CrossAttentionAdapterLearnableQuery",
    "Embed",
    "FusedMLPProjector",
    "Identity",
    "LayerNorm",
    "Linear",
    "LinearProjector",
    "MLPDeepProjector",
    "MLPProjector",
    "RMSNorm",
    "ScalarAdapter",
    "init_weights",
]
