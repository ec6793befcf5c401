"""Tiny configurations and mixes of the benchmark's cells for the CPU tests: merv-full's four tower
families and a Qwen-2.5-shaped LLM at widths a CPU runs in seconds, and the cells' traffic cut to a
few requests and examples."""

from __future__ import annotations

import copy
import json
import time

import torch

from benchmark import harness

TOWERS = [
    dict(id="languagebind-video-noclass", family="languagebind", frames=4, image_size=28, patch_size=14,
         hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, num_cls_tokens=1, num_register_tokens=0,
         pos_embed_includes_prefix=True, act="quick_gelu", layer_norm_eps=1e-5, use_layerscale=False, pre_norm=True,
         patch_bias=False, tubelet_t=0, temporal_attn=True, temporal_frames=2,
         transform=dict(resize="resize-crop", shortest_edge=28, interpolation="bilinear",
                        mean=[0.48145466, 0.4578275, 0.40821073], std=[0.26862954, 0.26130258, 0.27577711])),
    dict(id="dinov2-video-all-tokens", family="dinov2", frames=4, image_size=28, patch_size=14, hidden_size=32,
         intermediate_size=64, num_layers=2, num_heads=2, num_cls_tokens=1, num_register_tokens=4,
         pos_embed_includes_prefix=True, act="gelu", layer_norm_eps=1e-6, use_layerscale=True, pre_norm=False,
         patch_bias=True, tubelet_t=0, temporal_attn=False, temporal_frames=0,
         transform=dict(resize="resize-naive", shortest_edge=28, interpolation="bicubic",
                        mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])),
    dict(id="vivit-google-b-all-no-cls-16frames", family="vivit", frames=8, image_size=32, patch_size=16,
         hidden_size=48, intermediate_size=96, num_layers=2, num_heads=3, num_cls_tokens=1, num_register_tokens=0,
         pos_embed_includes_prefix=True, act="gelu_tanh", layer_norm_eps=1e-6, use_layerscale=False,
         pre_norm=False, patch_bias=True, tubelet_t=2, temporal_attn=False, temporal_frames=0,
         transform=dict(resize="resize-naive", shortest_edge=36, interpolation="bilinear",
                        mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5])),
    dict(id="siglip-vit-b16-224px-all-no-cls", family="siglip", frames=4, image_size=32, patch_size=16,
         hidden_size=48, intermediate_size=96, num_layers=2, num_heads=3, num_cls_tokens=0, num_register_tokens=0,
         pos_embed_includes_prefix=False, act="gelu_tanh", layer_norm_eps=1e-6, use_layerscale=False,
         pre_norm=False, patch_bias=True, tubelet_t=0, temporal_attn=False, temporal_frames=0,
         transform=dict(resize="resize-naive", shortest_edge=32, interpolation="bicubic",
                        mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5])),
]


def config(tied: bool) -> dict:
    """A Qwen-2.5-shaped tiny MERV: the 3B's tied head (``tied``) or the 7B's own."""
    return dict(
        vocab_size=151936, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=32768, rope_theta=1000000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=tied,
        llm_backbone_id="qwen2.5-3b-instruct" if tied else "qwen2.5-7b-instruct",
        merv=dict(model_id="merv-full", arch_specifier="3davg+linear", feature_fusion="cross_attention_avg_lq",
                  image_resize_strategy="resize-naive", projector_token_length=4, visual_feature_length=16,
                  fusion_embed_dim=3072, llm_max_length=256, towers=copy.deepcopy(TOWERS)),
        align=dict(stage="align", global_batch_size=4, published_global_batch_size=32, per_device_batch_size=2,
                   learning_rate=1e-3, weight_decay=0.0, max_grad_norm=1.0,
                   lr_scheduler_type="linear-warmup+cosine-decay", warmup_ratio=0.03, remat=True,
                   loss_chunk_size=16, align_examples=320),
    )


def serve_mix() -> dict:
    mix = json.loads((harness.BENCH / "workloads" / "describe.json").read_text())
    mix.update(engine=dict(mix["engine"], slots=2, max_len=96, length_bucket=16), queue=3, deck=8,
               video=dict(frames=16, height=30, width=40, pool=4),
               question_tokens=dict(dist="uniform", min=4, max=10),
               answer_tokens=dict(dist="lognormal", median=6, sigma=0.5, min=3, max=12),
               warmup_budget=3, check_requests=3, profile_s=0.2)
    return mix


def train_mix() -> dict:
    mix = json.loads((harness.BENCH / "workloads" / "align.json").read_text())
    mix.update(batch=4, video=dict(frames=8), prompt_tokens=dict(dist="uniform", min=2, max=4),
               caption_tokens=dict(dist="uniform", min=3, max=8), profile_s=0.2)
    return mix


def cell(kind: str, seed: int = 1234567, seconds: float = 1.0, trace: bool = False,
         limits: dict = None) -> harness.Cell:
    serve = kind == "serve"
    return harness.Cell(
        name="tiny." + kind, cfg=config(tied=not serve), mix=serve_mix() if serve else train_mix(),
        limits=limits or (dict(max_gap=1e-3) if serve else dict(loss_gap=1e-4, grad_gap=1e-3, change_gap=1e-3)),
        seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"), t_process=time.perf_counter())
