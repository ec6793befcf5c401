"""Factory layer: registry ids -> backbones / VidLM (counterpart of
``merv_tpu/models/materialize.py``), for every tower id and every LLM id
``merv_tpu`` registers, with its kwargs (every tower at
``default_image_size = 224``, the 256 / 384 px SigLIP ids included, as in
``merv_tpu``). The ``get_*`` entry points keep ``merv_tpu``'s
signatures plus ``device`` (default: the card; raises without one),
``param_dtype`` and an optional ``generator``: when given, the built modules
are random-initialised from it. Trained weights are loaded by
:func:`merv_tpu_torch.models.load_vid.load_vid`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.backbones.llm.base_llm import LLM_SPECS, LLMBackbone
from merv_tpu_torch.models.backbones.video import (
    DinoV2VideoBackbone,
    HieraVideoBackbone,
    LangBindVideoBackbone,
    SiglipVideoBackbone,
    VideoBackbone,
    ViVITVideoBackbone,
)
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn.core import init_weights
from merv_tpu_torch.preprocessing.transforms import VideoTransform

# fmt: off
VIDEO_BACKBONES: Dict[str, Dict[str, Any]] = {
    # === DINOv2 ===
    "dinov2-video": {"cls": DinoV2VideoBackbone, "kwargs": {"default_image_size": 224}},
    "dinov2-video-all-tokens": {"cls": DinoV2VideoBackbone, "kwargs": {"default_image_size": 224}},
    "dinov2-video-all-token-with-cls": {"cls": DinoV2VideoBackbone, "kwargs": {"default_image_size": 224}},
    "dinov2-video-classemb-at-first": {"cls": DinoV2VideoBackbone, "kwargs": {"default_image_size": 224}},

    # === LanguageBind Video ===
    "languagebind-video": {"cls": LangBindVideoBackbone, "kwargs": {"default_image_size": 224}},
    "languagebind-video-averagetoken": {"cls": LangBindVideoBackbone, "kwargs": {"default_image_size": 224, "token": "average"}},
    "languagebind-video-classemb": {"cls": LangBindVideoBackbone, "kwargs": {"default_image_size": 224, "token": "classemb"}},
    "languagebind-video-noclass": {"cls": LangBindVideoBackbone, "kwargs": {"default_image_size": 224, "token": "noclass"}},
    "languagebind-video-classemb-at-first": {"cls": LangBindVideoBackbone, "kwargs": {"default_image_size": 224, "token": "classemb-at-first"}},

    # === ViViT ===
    "vivit-google-b-cls-token": {"cls": ViVITVideoBackbone, "kwargs": {"default_image_size": 224}},
    "vivit-google-b-all-tokens": {"cls": ViVITVideoBackbone, "kwargs": {"default_image_size": 224}},
    "vivit-google-b-all-no-cls": {"cls": ViVITVideoBackbone, "kwargs": {"default_image_size": 224}},
    "vivit-google-b-all-no-cls-16frames": {"cls": ViVITVideoBackbone, "kwargs": {"default_image_size": 224}},
    "vivit-google-b-classemb-at-first-16frames": {"cls": ViVITVideoBackbone, "kwargs": {"default_image_size": 224}},

    # === SigLIP ===
    "siglip-vit-b16-224px": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-b16-224px-all-tokens": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-b16-224px-all-no-cls": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-b16-224px-classemb-at-first": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-b16-256px": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-b16-256px-all-tokens": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-b16-384px": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-b16-384px-all-tokens": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-so400m": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-so400m-all-tokens": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-so400m-384px": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},
    "siglip-vit-so400m-384px-all-tokens": {"cls": SiglipVideoBackbone, "kwargs": {"default_image_size": 224}},

    # === Hiera ===
    "hiera-base-video": {"cls": HieraVideoBackbone, "kwargs": {"default_image_size": 224}},
    "hiera-base-video-noft": {"cls": HieraVideoBackbone, "kwargs": {"default_image_size": 224}},
    "hiera-base-plus-video": {"cls": HieraVideoBackbone, "kwargs": {"default_image_size": 224}},
    "hiera-base-plus-video-noft": {"cls": HieraVideoBackbone, "kwargs": {"default_image_size": 224}},
    "hiera-large-video": {"cls": HieraVideoBackbone, "kwargs": {"default_image_size": 224}},
    "hiera-large-video-noft": {"cls": HieraVideoBackbone, "kwargs": {"default_image_size": 224}},
}
# fmt: on

LLM_BACKBONES = tuple(LLM_SPECS)


def _maybe_init(module: torch.nn.Module, generator: Optional[torch.Generator]) -> None:
    if generator is not None:
        init_weights(module, generator)


def get_video_backbone_and_transform(
    video_backbone_ids: List[str],
    image_resize_strategy: str,
    num_frames: List[int],
    device: Optional[torch.device] = None,
    param_dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[List[VideoBackbone], List[VideoTransform]]:
    """Instantiate video backbones + their per-backbone transforms."""
    device = resolve_device(device)
    backbones, transforms = [], []
    for vb_id, nf in zip(video_backbone_ids, num_frames):
        if vb_id not in VIDEO_BACKBONES:
            raise ValueError(f"Video Backbone `{vb_id}` is not supported!")
        entry = VIDEO_BACKBONES[vb_id]
        vb = entry["cls"](
            vb_id, image_resize_strategy, num_frames=nf, param_dtype=param_dtype, device=device, **entry["kwargs"]
        )
        _maybe_init(vb, generator)
        backbones.append(vb)
        transforms.append(vb.get_video_transform())
    return backbones, transforms


def get_llm_backbone_and_tokenizer(
    llm_backbone_id: str,
    llm_max_length: int = 2048,
    inference_mode: bool = False,
    device: Optional[torch.device] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[LLMBackbone, Any]:
    if llm_backbone_id not in LLM_BACKBONES:
        raise ValueError(f"unknown LLM backbone {llm_backbone_id!r}; known: {list(LLM_BACKBONES)}")
    llm = LLMBackbone(
        llm_backbone_id, llm_max_length=llm_max_length, inference_mode=inference_mode, device=resolve_device(device)
    )
    _maybe_init(llm, generator)
    return llm, llm.tokenizer


def get_vidlm(
    model_id: str,
    arch_specifier: str,
    feature_fusion: Optional[str],
    video_backbones: List[VideoBackbone],
    llm_backbone: LLMBackbone,
    projector_token_length: int = 64,
    visual_feature_length: int = 512,
    pre_proj_layernorm: bool = False,
    param_dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
    generator: Optional[torch.Generator] = None,
) -> MERV:
    """Compose the VidLM; ``generator`` random-inits the projectors and fusion."""
    vidlm = MERV(
        model_id, video_backbones, llm_backbone, arch_specifier=arch_specifier, feature_fusion=feature_fusion,
        projector_token_length=projector_token_length, visual_feature_length=visual_feature_length,
        pre_proj_layernorm=pre_proj_layernorm, param_dtype=param_dtype, device=resolve_device(device),
    )
    if generator is not None:
        for p in vidlm.projectors:
            init_weights(p, generator)
        if vidlm.feature_fusion is not None:
            init_weights(vidlm.feature_fusion, generator)
    return vidlm
