"""Load a trained MERV from a local run directory (counterpart of ``merv_tpu/models/load_vid.py``).

``load_vid(run_dir)`` reads ``config.json``'s ``"model"`` dict and the run's
checkpoint: ``checkpoints/latest-checkpoint.pt`` (the released reference
layout, :mod:`merv_tpu_torch.models.ckpt_import`) first, else the latest
checkpoint directory (``merv_tpu``'s Orbax or the port's own,
:func:`merv_tpu_torch.training.checkpointing.load_checkpoint`). Towers come
from ``$MERV_TPU_TOWER_DIR``, the base LLM from the checkpoint or
``$MERV_TPU_LLM_DIR``. Only local files are read: a registry id
(``merv-full``) that is not a directory raises, since the port downloads
nothing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from merv_tpu_torch.conf import MERV_Base
from merv_tpu_torch.device import make_generator, resolve_device
from merv_tpu_torch.models.backbones.llm.hf_import import load_safetensors_dir
from merv_tpu_torch.models.backbones.llm.transformer import pack_serving_params, round_to_compute_dtype
from merv_tpu_torch.models.backbones.video.vision_import import load_pretrained_tower
from merv_tpu_torch.models.ckpt_import import import_merv_checkpoint
from merv_tpu_torch.models.materialize import (
    get_llm_backbone_and_tokenizer,
    get_video_backbone_and_transform,
    get_vidlm,
)
from merv_tpu_torch.models.registry import GLOBAL_REGISTRY, MODEL_REGISTRY
from merv_tpu_torch.nn.core import init_weights
from merv_tpu_torch.nn.quantization import quantize_tree
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.training.checkpointing import latest_checkpoint, load_checkpoint

overwatch = initialize_overwatch(__name__)

RANDOM_INIT_SEED = 7


def available_models() -> List[str]:
    return list(MODEL_REGISTRY.keys())


def available_model_names() -> List[str]:
    return list(GLOBAL_REGISTRY.items())


def get_model_description(model_id_or_name: str) -> str:
    if model_id_or_name not in GLOBAL_REGISTRY:
        raise ValueError(f"Couldn't find `{model_id_or_name = }; check `merv_tpu_torch.available_model_names()`")
    print(json.dumps(description := GLOBAL_REGISTRY[model_id_or_name]["description"], indent=2))
    return description


def _float_dtype(state: Dict[str, torch.Tensor]) -> torch.dtype:
    return next(t.dtype for t in state.values() if t.is_floating_point())


def _unavailable(what: str, remedy: str, e: Exception, allow_random: bool) -> None:
    """Raise, or warn loudly where random weights are allowed."""
    if not allow_random:
        raise RuntimeError(
            f"{what} unavailable ({type(e).__name__}: {e}). {remedy}, or pass allow_random_weights=True for "
            f"structure/speed testing (outputs will be meaningless)."
        ) from e
    overwatch.warning(f"{what} unavailable ({type(e).__name__}); RANDOM init — outputs are meaningless "
                      f"(structure/speed testing only)", ctx_level=1)


def load_vid(
    model_id_or_path: Union[str, Path],
    get_model_cfg: bool = False,
    quantize_llm: bool = False,
    allow_random_weights: bool = False,
    pack_llm: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
):
    """Load a trained MERV from a local run directory -> ``vidlm`` [, ``model_cfg``].

    The port's modules hold their own weights, so there is no separate
    ``params`` as ``merv_tpu`` returns. The weights are put together in
    ``merv_tpu``'s order and dtypes:
    - the LLM from the checkpoint's ``llm_backbone``, else ``$MERV_TPU_LLM_DIR``
      (a directory of HF safetensors shards), stored in the spec's
      ``half_precision_dtype``;
    - projectors and fusion from the checkpoint, in its dtype;
    - each tower from ``$MERV_TPU_TOWER_DIR/{identifier}.safetensors``, stored
      in the tower's ``half_precision_dtype``.

    ``allow_random_weights=True`` lets a missing LLM or tower be random
    (structure and speed testing only; the default raises, so an evaluation
    never silently runs on garbage). Random weights come from a
    ``torch.Generator`` on ``device`` seeded with ``RANDOM_INIT_SEED``; they
    cannot equal ``merv_tpu``'s, which come from ``jax.random.PRNGKey(7)``.

    The LLM is assembled in ``merv_tpu``'s order: stored in the family's
    ``half_precision_dtype`` (fp16 for Qwen-2.5), then, with ``pack_llm`` (the
    default), packed into the serving layout (q/k/v and gate/up as one wide
    Linear each, :func:`~merv_tpu_torch.models.backbones.llm.transformer.pack_serving_params`),
    then, with ``quantize_llm=True``, its Linears stored as weight-only int8
    (:mod:`merv_tpu_torch.nn.quantization`) from those half-precision values.
    Last, every float leaf left is rounded once to the compute dtype
    (:func:`~merv_tpu_torch.models.backbones.llm.transformer.round_to_compute_dtype`):
    each reaches the model only through that cast, so the numbers are the
    stored dtype's bit for bit, and a decode step reads each weight once
    instead of casting a copy of it. ``device``: the card unless ``"cpu"`` is
    asked for.

    ``mesh``: the serving mesh (``merv_tpu``'s argument of the same name).
    Every rank loads the whole model, so the weights are replicated; the
    memory a long context needs is the KV cache, which shards on its rows
    when the caller serves under an ``sp`` axis above 1 (and sets
    ``vidlm.llm_backbone.sequence_parallel``). Under a ``tensor`` axis above 1
    the LLM takes ``merv_tpu``'s Megatron splits: packing is turned off (the
    rules key on the unpacked paths; ``merv_tpu``'s info line), the LLM is
    quantized whole where asked, and then cut to this rank's shards
    (:func:`~merv_tpu_torch.parallel.sharding.shard_decoder`, on a device
    mesh: one process a rank); towers, projectors and fusion stay whole. A
    ``pp`` axis leaves every weight whole (serving runs the plain cached loop).
    """
    from merv_tpu_torch.parallel.mesh import TENSOR_AXIS, axis_size
    from merv_tpu_torch.parallel.sharding import shard_decoder

    dev = resolve_device(device)
    if not os.path.isdir(model_id_or_path):
        if model_id_or_path in GLOBAL_REGISTRY:
            raise ValueError(
                f"`{model_id_or_path}` is a registry id: its weights must be in a local run directory "
                f"(config.json + checkpoints/); merv_tpu_torch downloads nothing"
            )
        raise ValueError(f"Couldn't find `{model_id_or_path = }; check `merv_tpu_torch.available_model_names()`")

    run_dir = Path(model_id_or_path)
    overwatch.info(f"Loading from local path `{run_dir}`")
    config_json = run_dir / "config.json"
    if not config_json.exists():
        raise FileNotFoundError(f"Missing `config.json` for `{run_dir = }`")
    checkpoint: Optional[Path] = run_dir / "checkpoints" / "latest-checkpoint.pt"
    if not checkpoint.exists():
        checkpoint = latest_checkpoint(run_dir)
    if checkpoint is None or not checkpoint.exists():
        raise FileNotFoundError(f"Missing checkpoint under {run_dir / 'checkpoints'}")

    model_cfg_dict = json.loads(config_json.read_text())["model"]
    model_cfg_dict.pop("vidlm_id", None)
    model_cfg_dict.pop("type", None)
    model_cfg = MERV_Base(**model_cfg_dict)
    overwatch.info(
        f"Found Config =>> Loading & Freezing {model_cfg.model_id} with:\n"
        f"             Video Backbones =>> {model_cfg.video_backbone_ids}\n"
        f"             LLM Backbone    =>> {model_cfg.llm_backbone_id}\n"
        f"             Arch Specifier  =>> {model_cfg.arch_specifier}\n"
        f"             Checkpoint Path =>> `{checkpoint}`"
    )

    video_backbones, _ = get_video_backbone_and_transform(
        model_cfg.video_backbone_ids, image_resize_strategy=model_cfg.image_resize_strategy,
        num_frames=model_cfg.num_frames, device=dev,
    )
    llm_backbone, _ = get_llm_backbone_and_tokenizer(
        model_cfg.llm_backbone_id, llm_max_length=model_cfg.llm_max_length, inference_mode=True, device=dev
    )
    vidlm = get_vidlm(
        model_cfg.model_id, model_cfg.arch_specifier, model_cfg.feature_fusion, video_backbones, llm_backbone,
        projector_token_length=model_cfg.projector_token_length,
        visual_feature_length=model_cfg.visual_feature_length, device=dev,
    )

    if checkpoint.suffix == ".pt":
        restored: Dict[str, Any] = import_merv_checkpoint(vidlm, checkpoint)
    else:
        restored = load_checkpoint(checkpoint)["model"]

    generator = make_generator(dev, RANDOM_INIT_SEED)
    # the LLM first, in its serving dtype (built so under inference_mode)
    llm = vidlm.llm_backbone
    if "llm_backbone" in restored:
        llm.load_state_dict(restored.pop("llm_backbone"))
    else:
        try:
            llm_dir = os.environ.get("MERV_TPU_LLM_DIR")
            if not llm_dir:
                raise FileNotFoundError("set MERV_TPU_LLM_DIR to a local safetensors dir for base LLM weights")
            llm.import_state_dict(load_safetensors_dir(Path(llm_dir)))
        except Exception as e:
            _unavailable("Base LLM weights", "Set MERV_TPU_LLM_DIR to a local safetensors dir", e,
                         allow_random_weights)
            init_weights(llm, generator)
    # merv_tpu's order: cast to the serving dtype (the LLM is built in it), pack, quantize (from those values:
    # quantizing fp32 weights would give other int8 values), then round what is left to the compute dtype.
    # One layer, or one Linear, at a time, each part freed as its copy is made: the peak stays near the
    # half-precision model's.
    if pack_llm and axis_size(mesh, TENSOR_AXIS) > 1:
        overwatch.info("Mesh has tensor>1: disabling packed serving layout (TP rules key on unpacked paths)")
    elif pack_llm:
        pack_serving_params(llm.decoder)
    if quantize_llm:
        quantize_tree(llm)
    round_to_compute_dtype(llm.decoder)
    # merv_tpu's placement: the LLM's Megatron splits after quantizing the whole weights (a row-split shard
    # keeps its rows' scales over the whole input dim), everything else whole
    shard_decoder(llm.decoder, mesh)

    # projectors and fusion keep the checkpoint's dtype
    modules = {"projectors": vidlm.projectors}
    if vidlm.feature_fusion is not None:
        modules["feature_fusion"] = vidlm.feature_fusion
    for key, module in modules.items():
        state = restored.get(key, {})
        if state:
            module.to(_float_dtype(state))
        module.load_state_dict(state)

    # frozen towers are hard-cast to their half precision
    for vb in vidlm.video_backbones:
        try:
            load_pretrained_tower(vb)
        except Exception as e:
            _unavailable(f"Pretrained weights for tower {vb.identifier!r}",
                         "Run scripts/export_towers.py to populate $MERV_TPU_TOWER_DIR", e, allow_random_weights)
            init_weights(vb, generator)
        vb.to(vb.half_precision_dtype)

    vidlm.eval()
    if get_model_cfg:
        return vidlm, model_cfg
    return vidlm
