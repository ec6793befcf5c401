"""MERV: the multi-encoder video-language model (counterpart of
``merv_tpu/models/vidlms/merv.py``).

- arch grammar ``{,no-align}+{avg,attntv,conv,3davg,3dconv}{,+frame{N}}+
  {linear,gelu-mlp,fused-gelu-mlp,none}`` selects one projector per encoder
  (a resampler, or with none of them an MLP projector, or ``Identity`` for
  ``none``; ``frame{N}`` divides the 3D resamplers' output frames), with the
  token-consistency asserts of ``merv_tpu``; fusion ``first`` / ``None``,
  ``concat``, ``concat_channel``, ``concat_channel_ln``, ``cross_attention*``
  (``avg``: averaged summaries, ``pe``: an encoder embedding on them),
  ``scalar``, and ``query_mlp``, whose module is built and whose forward
  raises, as in ``merv_tpu``.
- multimodal splice: visual tokens after BOS (first, for an LLM without
  one: Qwen-2.5's ``bos_token_length == 0``); text-only rows keep their text
  followed by zero embeddings with a False mask. The projectors' output
  width is the LLM's hidden size, and generation stops on the LLM's
  ``stop_token_id`` and pads with its ``pad_token_id``.
- generation: towers -> projectors -> fusion -> splice -> cache prefill ->
  decode (the T=1 step captured as one CUDA graph on the card; the JAX
  package jits the whole pipeline), or prompt-lookup speculation at B=1
  (``speculative_gamma``), for one video (:meth:`MERV.generate`), a
  batch (:meth:`MERV.generate_batch`), or many questions on one video
  sharing its ``[BOS | visual]`` (or ``[visual]``) cache (:meth:`MERV.build_video_prefix`,
  :meth:`MERV.generate_batch_shared`); :meth:`MERV.score_options` reads a
  multiple-choice answer from one forward's last-position logits.
- training: :meth:`MERV.forward` is differentiable (the towers, frozen in
  every stage, run under ``torch.no_grad``, the counterpart of
  ``stop_gradient``);
  :meth:`MERV.freeze_backbones` realises a stage's trainable modules as
  ``requires_grad``; the loss is :func:`causal_lm_loss` or, with
  ``loss_chunk_size``, :func:`chunked_causal_lm_loss`.

``generate`` takes a video or image path (decoded on the host by
:func:`merv_tpu_torch.preprocessing.load_video`), a raw uint8
``[T, H, W, C]`` video, or ``None``.
"""

from __future__ import annotations

import math
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from merv_tpu_torch.device import resolve_device
from merv_tpu_torch.models.backbones.llm.base_llm import LLMBackbone
from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone
from merv_tpu_torch.models.generation import (
    GenerationConfig,
    VideoPrefix,
    _sync,
    generate as _generate,
    generate_speculative,
    generate_with_prefix,
    prefill_prefix,
)
from merv_tpu_torch.models.vidlms.base_vidlm import IGNORE_INDEX, VidLM
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
    MLPProjector,
)
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.preprocessing.transforms import subsample_frames

overwatch = initialize_overwatch(__name__)


def _load_media(video: Any, num_frames_max: int, **clip_kwargs: Any) -> np.ndarray:
    """A path -> uint8 [T, H, W, C] on the host: an image (by its extension,
    ``.jpg`` / ``.jpeg`` / ``.png``) repeated ``num_frames_max`` times, else a
    video through ``load_video`` with the clip window in ``clip_kwargs``."""
    path = str(video)
    if Path(path).suffix.lower() in (".jpg", ".jpeg", ".png"):
        from PIL import Image

        image = np.asarray(Image.open(path).convert("RGB"))
        return np.repeat(image[None], num_frames_max, axis=0)
    from merv_tpu_torch.preprocessing.video_io import load_video

    return load_video(path, num_frames_max, **clip_kwargs)


def _extract_frame_number(query: str) -> int:
    return int(re.search(r"frame(\d+)", query).group(1))


class MERV(VidLM):
    def __init__(
        self,
        model_id: str,
        video_backbones: List[VideoBackbone],
        llm_backbone: LLMBackbone,
        arch_specifier: str = "gelu-mlp",
        feature_fusion: Optional[str] = None,
        projector_token_length: int = 64,
        visual_feature_length: int = 512,
        pre_proj_layernorm: bool = False,
        text_embedding_dim: int = 3072,
        param_dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__("merv", model_id, video_backbones, llm_backbone)
        device = resolve_device(device)
        self.feature_fusion_type = feature_fusion
        self.arch_specifier = arch_specifier
        self.pre_proj_layernorm = pre_proj_layernorm
        llm_dim = llm_backbone.embed_dim
        kw = dict(param_dtype=param_dtype, device=device)

        # projector selection, as merv_tpu's (merv.py:118-176)
        mlp_type = next((t for t in ("linear", "fused-gelu-mlp", "gelu-mlp", "none") if arch_specifier.endswith(t)),
                        None)
        if mlp_type is None:
            raise ValueError(f"MERV with arch_specifier = {arch_specifier!r} is not supported!")
        parts = arch_specifier.split("+")
        factor = _extract_frame_number(arch_specifier) if "frame" in arch_specifier else 1
        output_size = math.isqrt(projector_token_length)
        if projector_token_length != output_size ** 2:
            raise ValueError("projector_token_length should be a square number")
        resampler = next((p for p in ("avg", "attntv", "conv", "3davg", "3dconv") if p in parts), None)
        self.tokens_resampled = resampler is not None

        def make_resampler(vb: VideoBackbone) -> nn.Module:
            # frame{N} divides the output frames of the 3D resamplers only
            out_frames = vb.temporal_resolution // (factor if resampler in ("3davg", "3dconv") else 1)
            if resampler == "avg":
                return AveragePoolingProjector(vb.embed_dim, llm_dim, output_size, out_frames, mlp_type, **kw)
            if resampler == "attntv":
                return AttentivePooler(vb.embed_dim, llm_dim, projector_token_length, 8, out_frames, mlp_type, **kw)
            if resampler == "conv":
                return ConvolutionalProjector(vb.embed_dim, llm_dim, output_size, 3, out_frames, mlp_type, **kw)
            if resampler == "3davg":
                return AveragePooling3DProjector(vb.embed_dim, llm_dim, out_frames, output_size, mlp_type, **kw)
            return Convolutional3DProjector(vb.embed_dim, llm_dim, out_frames, output_size, mlp_type, **kw)

        if self.tokens_resampled:
            projectors = [make_resampler(vb) for vb in video_backbones]
        elif mlp_type == "none":
            projectors = [Identity() for _ in video_backbones]
        else:
            proj_cls = {"linear": LinearProjector, "gelu-mlp": MLPProjector, "fused-gelu-mlp": FusedMLPProjector}
            projectors = [proj_cls[mlp_type](vb.embed_dim, llm_dim, pre_proj_layernorm=pre_proj_layernorm, **kw)
                          for vb in video_backbones]
        self.projectors = nn.ModuleList(projectors)

        # token-length consistency (merv.py:178-200)
        if len(video_backbones) > 1:
            if self.tokens_resampled:
                lengths = [p.output_token_length * p.output_frame_length for p in self.projectors]
            else:
                lengths = [p.output_token_length * vb.temporal_resolution
                           for p, vb in zip(self.projectors, video_backbones)]
            assert all(n in (1, visual_feature_length) for n in lengths), (
                f"Output token length is not consistent across all projectors! visual_feature_length="
                f"{visual_feature_length}, projector outputs {lengths}"
            )
        else:
            if self.tokens_resampled:
                correct = self.projectors[0].output_token_length * self.projectors[0].output_frame_length
            else:
                correct = video_backbones[0].num_patches
            if correct != visual_feature_length:
                overwatch.info(
                    f"Visual feature length {visual_feature_length} is not consistent with the output token "
                    f"length of the projector! Changing to {correct}", ctx_level=1,
                )
                visual_feature_length = correct
        self.visual_feature_length = visual_feature_length
        self.projector_token_length = projector_token_length

        # the fusion module (merv.py:203-219); concat and first / None have none
        E = len(video_backbones)
        self.feature_fusion: Optional[nn.Module]
        if feature_fusion == "query_mlp":
            self.feature_fusion = MLPProjector(text_embedding_dim, E, **kw)
        elif feature_fusion is not None and "cross_attention" in feature_fusion:
            self.feature_fusion = CrossAttentionAdapterLearnableQuery(
                embed_dim=text_embedding_dim, llm_dim=llm_dim, token_length=visual_feature_length,
                averagetoken="avg" in feature_fusion, num_encoder=E,
                positional_embedding="pe" in feature_fusion, **kw,
            )
        elif feature_fusion == "concat_channel":
            self.feature_fusion = LinearProjector(E * llm_dim, llm_dim, **kw)
        elif feature_fusion == "concat_channel_ln":
            self.feature_fusion = LinearProjector(E * llm_dim, llm_dim, pre_proj_layernorm=True, **kw)
        elif feature_fusion == "scalar":
            self.feature_fusion = ScalarAdapter(E, **kw)
        else:
            self.feature_fusion = None

        self.trainable_module_keys: List[str] = []
        # MCQ likelihood readout tokens, resolved at first use so that building
        # the model never instantiates the tokenizer
        self._string2idx: Optional[Dict[str, int]] = None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def string2idx(self) -> Dict[str, int]:
        if self._string2idx is None:
            s2i = {}
            tok = self.llm_backbone.tokenizer
            for s in ["True", "False", "Yes", "No"] + [chr(ord("A") + i) for i in range(26)]:
                ids = tok.encode(s, add_special_tokens=False)
                if len(ids) != 1:
                    raise ValueError(f'String "{s}" is tokenized as more than one token!')
                s2i[s] = ids[0]
            self._string2idx = s2i
        return self._string2idx

    # ------------------------------------------------------------------------------
    # Forward pieces
    # ------------------------------------------------------------------------------

    def encode_videos(self, video_values: Sequence[torch.Tensor], impl: str = "auto") -> List[torch.Tensor]:
        """Run every tower -> list of [B, num_patches_i, embed_dim_i], under
        ``torch.no_grad``: the towers are frozen in every stage."""
        with torch.no_grad():
            return [vb(v, impl=impl) for vb, v in zip(self.video_backbones, video_values)]

    def project_and_fuse(
        self, video_features: Sequence[torch.Tensor], impl: str = "auto"
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Per-encoder projection + fusion -> ([B, V, llm_dim], mixer weights).
        ``impl`` reaches the attentive pooler's attention (plain at its shapes)."""
        feats = list(video_features)
        if self.tokens_resampled:
            feats = [f.reshape(f.shape[0], vb.temporal_resolution, vb.spatial_resolution, f.shape[-1])
                     for f, vb in zip(feats, self.video_backbones)]
        projected = [p(f, impl) if isinstance(p, AttentivePooler) else p(f) for p, f in zip(self.projectors, feats)]
        ff = self.feature_fusion_type
        if ff == "first" or ff is None:
            return projected[0], None
        if ff == "concat":
            return torch.cat(projected, dim=1), None
        if ff in ("concat_channel", "concat_channel_ln"):
            return self.feature_fusion(torch.cat(projected, dim=-1)), None
        if "cross_attention" in ff or ff == "scalar":
            return self.feature_fusion(projected)
        raise NotImplementedError(f'feature_fusion "{ff}" doesn\'t exist')

    def embed_multimodal(
        self,
        input_ids: torch.Tensor,  # [B, T] right-padded
        attention_mask: torch.Tensor,  # [B, T]
        visual_embeds: torch.Tensor,  # [B, V, llm_dim]
        labels: Optional[torch.Tensor] = None,
        is_multimodal: Optional[torch.Tensor] = None,  # [B] bool
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Multimodal rows: [text[:bos] | visual | text[bos:]]; unimodal rows:
        [text | zero-pad] with False mask / IGNORE labels."""
        nbos = self.llm_backbone.bos_token_length
        embeds = self.llm_backbone.embed_input_ids(input_ids)
        B, T, E = embeds.shape
        V = visual_embeds.shape[1]
        visual_embeds = visual_embeds.to(embeds.dtype)
        dev = embeds.device

        mm_embeds = torch.cat([embeds[:, :nbos], visual_embeds, embeds[:, nbos:]], dim=1)
        am = attention_mask.bool()
        mm_mask = torch.cat([am[:, :nbos], torch.ones((B, V), dtype=torch.bool, device=dev), am[:, nbos:]], dim=1)
        if is_multimodal is None:
            fused_embeds, fused_mask = mm_embeds, mm_mask
        else:
            uni_embeds = torch.cat([embeds, torch.zeros((B, V, E), dtype=embeds.dtype, device=dev)], dim=1)
            uni_mask = torch.cat([am, torch.zeros((B, V), dtype=torch.bool, device=dev)], dim=1)
            sel = is_multimodal.bool().to(dev)
            fused_embeds = torch.where(sel[:, None, None], mm_embeds, uni_embeds)
            fused_mask = torch.where(sel[:, None], mm_mask, uni_mask)

        fused_labels = None
        if labels is not None:
            ign = torch.full((B, V), IGNORE_INDEX, dtype=labels.dtype, device=dev)
            mm_labels = torch.cat([labels[:, :nbos], ign, labels[:, nbos:]], dim=1)
            if is_multimodal is None:
                fused_labels = mm_labels
            else:
                uni_labels = torch.cat([labels, ign], dim=1)
                fused_labels = torch.where(is_multimodal.bool().to(dev)[:, None], mm_labels, uni_labels)
        return fused_embeds, fused_mask, fused_labels

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        video_values: Sequence[torch.Tensor],
        labels: Optional[torch.Tensor] = None,
        is_multimodal: Optional[torch.Tensor] = None,
        attn_impl: str = "auto",
        remat: bool = False,
        loss_chunk_size: Optional[int] = None,
        timings: Optional[Dict[str, float]] = None,
    ) -> Dict[str, Any]:
        """Full multimodal forward (no cache), differentiable. Returns
        dict(logits, loss, mixer, attention_mask, labels).

        ``remat`` checkpoints each decoder layer. ``loss_chunk_size`` (with
        labels) streams the loss over token blocks through the lm_head and
        never materialises the [B, T, vocab] logits (``logits`` is None then).
        ``timings`` (optional) adds the towers' time, between two device
        syncs, to ``towers_s``."""
        t0 = _sync(input_ids.device) if timings is not None else 0.0
        feats = self.encode_videos(video_values, attn_impl)
        if timings is not None:
            timings["towers_s"] = timings.get("towers_s", 0.0) + _sync(input_ids.device) - t0
        visual, mixer = self.project_and_fuse(feats, attn_impl)
        embeds, mask, fused_labels = self.embed_multimodal(input_ids, attention_mask, visual, labels, is_multimodal)
        dec = self.llm_backbone.decoder
        out = {"logits": None, "loss": None, "mixer": mixer, "attention_mask": mask, "labels": fused_labels}
        if fused_labels is not None and loss_chunk_size:
            hidden, _ = dec(inputs_embeds=embeds, attention_mask=mask, attn_impl=attn_impl, remat=remat,
                            return_hidden=True)
            out["loss"] = chunked_causal_lm_loss(dec, hidden, fused_labels, block=loss_chunk_size)
            return out
        out["logits"], _ = dec(inputs_embeds=embeds, attention_mask=mask, attn_impl=attn_impl, remat=remat)
        if fused_labels is not None:
            out["loss"] = causal_lm_loss(out["logits"], fused_labels)
        return out

    # ------------------------------------------------------------------------------
    # Stage freezing
    # ------------------------------------------------------------------------------

    def freeze_backbones(self, stage: str) -> None:
        """Record the stage's trainable modules and set ``requires_grad`` to
        match; the video towers are always frozen."""
        if stage in ("align", "second_align"):
            self.trainable_module_keys = ["projectors", "feature_fusion"]
        elif stage in ("finetune", "full-align", "second_finetune", "full-finetune"):
            self.trainable_module_keys = ["llm_backbone", "projectors", "feature_fusion"]
        else:
            raise ValueError(f"Stage {stage} is not supported!")
        for name, trainable in self.trainable_mask().items():
            self.get_parameter(name).requires_grad_(trainable)
        overwatch.info(f"Stage {stage}: trainable modules = {self.trainable_module_keys}")

    def trainable_mask(self) -> Dict[str, bool]:
        """{parameter name: trainable} from the trainable module keys (by
        default the projectors and the fusion), as ``merv_tpu`` masks its tree."""
        keys = set(self.trainable_module_keys or ["projectors", "feature_fusion"])
        return {name: name.split(".", 1)[0] in keys for name, _ in self.named_parameters()}

    # ------------------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------------------

    @torch.inference_mode()
    def build_inputs_embeds(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        video_values: Sequence[torch.Tensor],
        is_multimodal: Optional[torch.Tensor] = None,
        attn_impl: str = "auto",
        timings: Optional[Dict[str, float]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Towers -> projectors -> fusion -> splice: (embeds [B, T+V, E], mask [B, T+V]).
        ``timings`` (optional) receives ``towers_s`` and ``project_fuse_s``."""
        dev = input_ids.device
        t0 = _sync(dev) if timings is not None else 0.0
        feats = self.encode_videos(video_values, attn_impl)
        if timings is not None:
            t1 = _sync(dev)
            timings["towers_s"] = t1 - t0
        visual, _ = self.project_and_fuse(feats, attn_impl)
        embeds, mask, _ = self.embed_multimodal(input_ids, attention_mask, visual, None, is_multimodal)
        if timings is not None:
            timings["project_fuse_s"] = _sync(dev) - t1
        return embeds, mask

    @torch.inference_mode()
    def generate_ids(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        video_values: Sequence[torch.Tensor],
        is_multimodal: Optional[torch.Tensor] = None,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_length: int = 1,
        generator: Optional[torch.Generator] = None,
        kv_cache_dtype: Optional[str] = None,
        attn_impl: str = "auto",
        timings: Optional[Dict[str, float]] = None,
        speculative_gamma: int = 0,
        speculative_ngram: int = 2,
    ) -> torch.Tensor:
        """Batched multimodal generation -> new token ids [B, max_new_tokens].
        Inputs must lie on the model's device.

        ``speculative_gamma > 0`` decodes by prompt-lookup speculation
        (:func:`~merv_tpu_torch.models.generation.generate_speculative`, B=1
        only): drafts from the text prompt's n-grams, ``gamma + 1`` tokens
        verified a forward; greedy output is token-identical to the plain
        path."""
        dev = self.device
        for t in (input_ids, attention_mask, *video_values):
            if t.device != dev:
                raise ValueError(f"generate_ids: input on {t.device}, model on {dev}")
        cfg = self._generation_config(max_new_tokens, do_sample, temperature, top_p, top_k, min_length,
                                      kv_cache_dtype)
        embeds, mask = self.build_inputs_embeds(
            input_ids, attention_mask, video_values, is_multimodal, attn_impl, timings
        )
        if speculative_gamma > 0:
            return generate_speculative(
                self.llm_backbone.decoder, inputs_embeds=embeds, attention_mask=mask.long(),
                prompt_lookup_ids=input_ids, lookup_mask=attention_mask, config=cfg, gamma=speculative_gamma,
                ngram=speculative_ngram, generator=generator, attn_impl=attn_impl, timings=timings,
            )
        return _generate(
            self.llm_backbone.decoder, inputs_embeds=embeds, attention_mask=mask.long(), config=cfg,
            generator=generator, attn_impl=attn_impl, timings=timings,
        )

    def _prepare_batch_inputs(
        self,
        videos: Sequence[Any],
        prompt_texts: Sequence[str],
        num_frames: Optional[List[int]] = None,
        clip_args: Optional[Sequence[Dict[str, Any]]] = None,
        length_bucket: int = 64,
        pad_to_batch: Optional[int] = None,
        timings: Optional[Dict[str, float]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor], torch.Tensor]:
        """Tokenize + right-pad prompts to a ``length_bucket`` multiple, and
        subsample + transform each video per encoder, on the model's device.
        A ``None`` video gives a text-only row (zero video tensors); a path is
        decoded on the host to ``max(num_frames)`` frames, with the row's
        ``clip_args`` (``clip_start_sec`` / ``clip_end_sec`` / ``end_frame``).
        ``pad_to_batch`` pads the batch with text-only rows (prompt ``"."``)
        up to that size, so a partial last group runs at the full group's
        shapes (callers slice the outputs back). ``timings`` (optional)
        receives the host decode's time, ``decode_video_s``."""
        dev = self.device
        if num_frames is None:
            num_frames = [vb.num_frames for vb in self.video_backbones]
        B = len(videos)
        if len(prompt_texts) != B:
            raise ValueError("one prompt per video")
        clip_args = list(clip_args) if clip_args else [{}] * B
        if pad_to_batch is not None and B < pad_to_batch:
            n_pad = pad_to_batch - B
            videos = list(videos) + [None] * n_pad
            prompt_texts = list(prompt_texts) + ["."] * n_pad
            clip_args = clip_args + [{}] * n_pad
            B = pad_to_batch
        tok = self.llm_backbone.tokenizer
        id_lists = [tok(p, truncation=True).input_ids for p in prompt_texts]
        T = max(len(ids) for ids in id_lists)
        if length_bucket > 1:
            cap = self.llm_backbone.llm_max_length
            T = min(-(-T // length_bucket) * length_bucket, max(cap, T))
        input_ids = np.full((B, T), self.llm_backbone.pad_token_id, np.int64)
        attention_mask = np.zeros((B, T), np.int64)
        for b, ids in enumerate(id_lists):
            input_ids[b, : len(ids)] = ids
            attention_mask[b, : len(ids)] = 1

        per_encoder: List[List[torch.Tensor]] = [[] for _ in self.video_backbones]
        is_mm = []
        for b, video in enumerate(videos):
            if video is None:
                for e, vb in enumerate(self.video_backbones):
                    per_encoder[e].append(torch.zeros(vb.default_video_resolution, dtype=torch.float32, device=dev))
                is_mm.append(False)
                continue
            if isinstance(video, str) or hasattr(video, "__fspath__"):
                t0 = time.perf_counter()
                video = _load_media(video, max(num_frames), **clip_args[b])
                if timings is not None:
                    timings["decode_video_s"] = timings.get("decode_video_s", 0.0) + time.perf_counter() - t0
            frames_all = torch.as_tensor(np.asarray(video)).to(dev)  # uint8 [T, H, W, C], one copy to the card
            for e, (vb, nf) in enumerate(zip(self.video_backbones, num_frames)):
                per_encoder[e].append(vb.get_video_transform()(subsample_frames(frames_all, nf)))
            is_mm.append(True)
        vids = [torch.stack(v) for v in per_encoder]
        return (
            torch.as_tensor(input_ids, device=dev), torch.as_tensor(attention_mask, device=dev),
            vids, torch.as_tensor(is_mm, device=dev),
        )

    def generate(
        self,
        video: Any,
        prompt_text: str,
        num_frames: Optional[List[int]] = None,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_length: int = 1,
        clip_start_sec: float = 0.0,
        clip_end_sec: Optional[float] = None,
        end_frame: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        kv_cache_dtype: Optional[str] = None,
        attn_impl: str = "auto",
        timings: Optional[Dict[str, float]] = None,
        speculative_gamma: int = 0,
        speculative_ngram: int = 2,
    ) -> str:
        """Single-example API: ``video`` is a path (decoded within
        ``[clip_start_sec, clip_end_sec]`` or up to ``end_frame``), a uint8
        [T, H, W, C] array, or None (text only). ``speculative_gamma > 0``:
        see :meth:`generate_ids`."""
        t0 = time.perf_counter()
        input_ids, attention_mask, vids, is_mm = self._prepare_batch_inputs(
            [video], [prompt_text], num_frames,
            clip_args=[dict(clip_start_sec=clip_start_sec, clip_end_sec=clip_end_sec, end_frame=end_frame)],
            timings=timings,
        )
        if timings is not None:
            timings["prepare_s"] = _sync(self.device) - t0
        tokens = self.generate_ids(
            input_ids, attention_mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
            do_sample=do_sample, temperature=temperature, top_p=top_p, top_k=top_k, min_length=min_length,
            generator=generator, kv_cache_dtype=kv_cache_dtype, attn_impl=attn_impl, timings=timings,
            speculative_gamma=speculative_gamma, speculative_ngram=speculative_ngram,
        )
        return self._texts(tokens, 1)[0]

    def _generation_config(self, max_new_tokens: int, do_sample: bool, temperature: float, top_p: float,
                           top_k: int, min_length: int, kv_cache_dtype: Optional[str]) -> GenerationConfig:
        return GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample, temperature=temperature, top_p=top_p,
            top_k=top_k, min_length=min_length, eos_token_id=self.llm_backbone.stop_token_id,
            pad_token_id=self.llm_backbone.pad_token_id, kv_cache_dtype=kv_cache_dtype,
        )

    def _texts(self, tokens: torch.Tensor, n_real: int) -> List[str]:
        """The first ``n_real`` rows of generated ids, each cut at the stop
        token and decoded."""
        stop = self.llm_backbone.stop_token_id
        outs = []
        for row in tokens[:n_real].tolist():
            if stop in row:
                row = row[: row.index(stop)]
            outs.append(self.llm_backbone.tokenizer.decode(row, skip_special_tokens=True).strip())
        return outs

    def generate_batch(
        self,
        videos: Sequence[Any],
        prompt_texts: Sequence[str],
        num_frames: Optional[List[int]] = None,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_length: int = 1,
        clip_args: Optional[Sequence[Dict[str, Any]]] = None,
        generator: Optional[torch.Generator] = None,
        pad_to_batch: Optional[int] = None,
        kv_cache_dtype: Optional[str] = None,
        mesh: Optional[Any] = None,
        speculative_gamma: int = 0,
        speculative_ngram: int = 2,
    ) -> List[str]:
        """Batched multi-video generation: one prefill and one decode for the
        whole batch. ``videos`` entries: a path, a uint8 array or None. Prompt
        lengths pad to ``length_bucket`` multiples and, with ``pad_to_batch``,
        the batch to a fixed size (see :meth:`_prepare_batch_inputs`), which
        bounds the decode shapes, and so the captured graphs, of a run.
        ``speculative_gamma > 0`` takes a batch of one (see
        :meth:`generate_ids`). ``mesh`` (a serving mesh) is not ported
        (ROADMAP A12)."""
        _no_mesh(mesh)
        input_ids, attention_mask, vids, is_mm = self._prepare_batch_inputs(
            videos, prompt_texts, num_frames, clip_args, pad_to_batch=pad_to_batch
        )
        tokens = self.generate_ids(
            input_ids, attention_mask, vids, is_multimodal=is_mm, max_new_tokens=max_new_tokens,
            do_sample=do_sample, temperature=temperature, top_p=top_p, top_k=top_k, min_length=min_length,
            generator=generator, kv_cache_dtype=kv_cache_dtype, speculative_gamma=speculative_gamma,
            speculative_ngram=speculative_ngram,
        )
        return self._texts(tokens, len(videos))

    # ------------------------------------------------------------------------------
    # Video-prefix KV caching (many questions on one video)
    # ------------------------------------------------------------------------------

    @torch.inference_mode()
    def build_video_prefix(
        self,
        video: Any,
        num_frames: Optional[List[int]] = None,
        clip_args: Optional[Dict[str, Any]] = None,
        kv_cache_dtype: Optional[str] = None,
        bos_ids: Optional[Any] = None,
    ) -> VideoPrefix:
        """Towers + fusion + the ``[BOS | visual]`` KV prefill, once per video:
        every question about the video reuses it (:meth:`generate_batch_shared`).
        Returns a :class:`VideoPrefix`: the B=1 cache and the BOS ids and KV
        dtype it was built with, which a later request must match."""
        dev = self.device
        if num_frames is None:
            num_frames = [vb.num_frames for vb in self.video_backbones]
        if isinstance(video, str) or hasattr(video, "__fspath__"):
            video = _load_media(video, max(num_frames), **(clip_args or {}))
        frames_all = torch.as_tensor(np.asarray(video)).to(dev)
        vids = [vb.get_video_transform()(subsample_frames(frames_all, nf))[None]
                for vb, nf in zip(self.video_backbones, num_frames)]

        nbos = self.llm_backbone.bos_token_length
        visual, _ = self.project_and_fuse(self.encode_videos(vids))
        bos_tuple: Tuple[int, ...] = ()
        prefix = visual
        if nbos:
            if bos_ids is None:
                bos_ids = [self.llm_backbone.tokenizer(".", truncation=True).input_ids[:nbos]]
            bos_ids = torch.as_tensor(bos_ids, device=dev).long()
            bos_tuple = tuple(bos_ids[0].tolist())
            bos_embeds = self.llm_backbone.embed_input_ids(bos_ids)
            prefix = torch.cat([bos_embeds, visual.to(bos_embeds.dtype)], dim=1)
        cache = prefill_prefix(self.llm_backbone.decoder, inputs_embeds=prefix, kv_cache_dtype=kv_cache_dtype)
        return VideoPrefix(cache=cache, bos_ids=bos_tuple, kv_cache_dtype=kv_cache_dtype)

    def generate_ids_shared(
        self,
        prefix_cache: Any,
        suffix_ids: torch.Tensor,  # [B, Ts] right-padded post-BOS prompt tokens
        suffix_mask: torch.Tensor,  # [B, Ts]
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_length: int = 1,
        generator: Optional[torch.Generator] = None,
        kv_cache_dtype: Optional[str] = None,
    ) -> torch.Tensor:
        """Batched generation against a shared video-prefix cache (a
        :class:`VideoPrefix` or its bare cache): token-identical to
        :meth:`generate_ids` on the full spliced sequences, each question
        paying only its suffix prefill and decode."""
        if isinstance(prefix_cache, VideoPrefix):
            if prefix_cache.kv_cache_dtype != kv_cache_dtype:
                raise ValueError(
                    f"prefix cache was built with kv_cache_dtype={prefix_cache.kv_cache_dtype!r} but this request "
                    f"asks for {kv_cache_dtype!r}"
                )
            prefix_cache = prefix_cache.cache
        cfg = self._generation_config(max_new_tokens, do_sample, temperature, top_p, top_k, min_length,
                                      kv_cache_dtype)
        return generate_with_prefix(
            self.llm_backbone.decoder, prefix_cache, suffix_ids=suffix_ids, suffix_mask=suffix_mask, config=cfg,
            generator=generator,
        )

    def generate_batch_shared(
        self,
        video: Any,
        prompt_texts: Sequence[str],
        num_frames: Optional[List[int]] = None,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_length: int = 1,
        clip_args: Optional[Dict[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
        pad_to_batch: Optional[int] = None,
        length_bucket: int = 64,
        kv_cache_dtype: Optional[str] = None,
        prefix_cache: Any = None,
    ) -> List[str]:
        """One video, many questions: towers and the video-prefix prefill run
        once, each question pays its suffix prefill and decode. Same bucketing
        as :meth:`generate_batch`. ``prefix_cache`` (from
        :meth:`build_video_prefix`) reuses a prefix across calls. Raises
        ``ValueError`` where the prompts disagree on BOS, where the prefix was
        built with other BOS ids, or where a prompt is empty after its BOS."""
        n_real = len(prompt_texts)
        nbos = self.llm_backbone.bos_token_length
        tok = self.llm_backbone.tokenizer
        id_lists = [tok(p, truncation=True).input_ids for p in prompt_texts]
        if nbos:
            bos = id_lists[0][:nbos]
            if not all(ids[:nbos] == bos for ids in id_lists):
                raise ValueError(
                    "prompts disagree on BOS: a shared prefix bakes one BOS into its cache, got "
                    f"{sorted({tuple(i[:nbos]) for i in id_lists})}"
                )
        else:
            bos = []
        if isinstance(prefix_cache, VideoPrefix) and prefix_cache.bos_ids != tuple(bos):
            raise ValueError(
                f"prefix cache was built with bos_ids={prefix_cache.bos_ids} but these prompts tokenize to "
                f"bos_ids={tuple(bos)}"
            )
        suffixes = [ids[nbos:] for ids in id_lists]
        if any(len(s) == 0 for s in suffixes):
            empty = [i for i, s in enumerate(suffixes) if not s]
            raise ValueError(
                f"prompts {empty} are empty after BOS stripping: the shared-prefix path needs at least one suffix "
                "token per row to anchor its first sampled position"
            )
        if pad_to_batch is not None and n_real < pad_to_batch:
            suffixes += [suffixes[-1]] * (pad_to_batch - n_real)
        B = len(suffixes)
        Ts = max(1, max(len(s) for s in suffixes))
        if length_bucket > 1:
            cap = max(self.llm_backbone.llm_max_length, Ts)
            Ts = min(-(-Ts // length_bucket) * length_bucket, cap)
        suffix_ids = np.full((B, Ts), self.llm_backbone.pad_token_id, np.int64)
        suffix_mask = np.zeros((B, Ts), np.int64)
        for b, sfx in enumerate(suffixes):
            suffix_ids[b, : len(sfx)] = sfx
            suffix_mask[b, : len(sfx)] = 1

        dev = self.device
        if prefix_cache is None:
            prefix_cache = self.build_video_prefix(
                video, num_frames, clip_args, kv_cache_dtype=kv_cache_dtype, bos_ids=[bos] if nbos else None,
            )
        tokens = self.generate_ids_shared(
            prefix_cache, torch.as_tensor(suffix_ids, device=dev), torch.as_tensor(suffix_mask, device=dev),
            max_new_tokens=max_new_tokens, do_sample=do_sample, temperature=temperature, top_p=top_p, top_k=top_k,
            min_length=min_length, generator=generator, kv_cache_dtype=kv_cache_dtype,
        )
        return self._texts(tokens, n_real)

    @torch.inference_mode()
    def score_options(
        self,
        videos: Sequence[Any],
        prompt_texts: Sequence[str],
        option_strings: Sequence[Sequence[str]],
        num_frames: Optional[List[int]] = None,
        clip_args: Optional[Sequence[Dict[str, Any]]] = None,
        pad_to_batch: Optional[int] = None,
        mesh: Optional[Any] = None,
    ) -> List[str]:
        """Likelihood MCQ readout: one batched no-cache forward, next-token
        logits at each row's last prompt position, the option whose single
        token (:attr:`string2idx`) scores highest; ids past the LM head (tiny
        test vocabularies) score -inf. No decode at all."""
        _no_mesh(mesh)
        input_ids, attention_mask, vids, is_mm = self._prepare_batch_inputs(
            videos, prompt_texts, num_frames, clip_args, pad_to_batch=pad_to_batch
        )
        embeds, mask = self.build_inputs_embeds(input_ids, attention_mask, vids, is_mm)
        last = mask.long().sum(dim=1) - 1
        logits, _ = self.llm_backbone.decoder(inputs_embeds=embeds, attention_mask=mask, logits_indices=last)
        rows = logits[:, 0].float().cpu().numpy()  # [B, V] next-token logits
        picks = []
        V = rows.shape[1]
        for b, options in enumerate(option_strings):
            ids = [self.string2idx[o] for o in options]
            scores = [rows[b, i] if i < V else -np.inf for i in ids]
            picks.append(options[int(np.argmax(scores))])
        return picks


def _no_mesh(mesh: Optional[Any]) -> None:
    if mesh is not None:
        raise NotImplementedError("serving over a device mesh (the sequence-sharded cache) is not ported (ROADMAP A12)")


def _block_nll(decoder: Any, h_blk: torch.Tensor, l_blk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = decoder.lm_head_apply(h_blk).float()
    valid = l_blk != IGNORE_INDEX
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, l_blk, 0)[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


def chunked_causal_lm_loss(
    decoder: Any,
    hidden: torch.Tensor,  # [B, T, E] post-final-norm hidden states
    labels: torch.Tensor,  # [B, T]
    block: int = 256,
) -> torch.Tensor:
    """Next-token CE without materialising [B, T, vocab] logits: a loop over
    token blocks, each projected through the lm_head with its fp32
    log-softmax NLL under ``torch.utils.checkpoint``, so the backward
    recomputes a block's logits instead of keeping them. Per-row math is that
    of :func:`causal_lm_loss`; only the cross-block summation order differs."""
    B, T, _ = hidden.shape
    shifted = torch.cat([labels[:, 1:], torch.full((B, 1), IGNORE_INDEX, dtype=labels.dtype, device=labels.device)], 1)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.long, device=hidden.device)
    for i in range(0, T, block):
        h_blk, l_blk = hidden[:, i : i + block], shifted[:, i : i + block]
        if torch.is_grad_enabled() and hidden.requires_grad:
            s, c = checkpoint(_block_nll, decoder, h_blk, l_blk, use_reentrant=False)
        else:
            s, c = _block_nll(decoder, h_blk, l_blk)
        nll_sum, count = nll_sum + s, count + c
    return nll_sum / count.clamp(min=1)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE with IGNORE_INDEX masking (HF CausalLM loss semantics)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, shift_labels, 0)[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)
