"""Training entry point (counterpart of ``scripts/pretrain_video.py``).

    python -m merv_tpu_torch.cli.pretrain --model.type merv-base --stage align \
        --dataset.dataset_root_dir data [--model.video_backbone_ids [...]] [--device cpu] ...

Builds the model from its registry ids on random weights from ``--seed`` (no
weights are downloaded), freezes what the stage freezes, loads the stage's
starting weights (a finetune run takes the align projectors from
``--pretrained_checkpoint`` or from the align run beside its run directory,
``<model>+<scale>+stage-align+<seed>``), builds the stage's dataset and
collator, and trains through the stage's strategy with its recipe from the
model config (``{align,finetune}_*``), writing ``runs/<run_id>/`` as
``merv_tpu`` does: ``config.json``, the metrics' JSONL and
``checkpoints/step-...``. ``--resume_from_checkpoint`` continues a run from an
intermediate checkpoint, skipping the batches it had consumed.

Runs on the card unless ``--device cpu`` is given. The loss streams over
blocks of ``LOSS_CHUNK_SIZE`` tokens (``merv_tpu`` takes the whole logits; the
same loss up to fp32 summation order).

Many ranks: under ``torchrun`` (one process a rank, each on card
``LOCAL_RANK % cards``) the recipe's strategy shards the train state over the
mesh ``merv_tpu`` builds: every rank on ``fsdp`` by default,
``MeshConfig(data=1, fsdp=-1, tensor=1, seq=--mesh_seq, pipe=--mesh_pipe)``
with ``--mesh_seq N`` (the decoder's ring attention over N ranks) or
``--mesh_pipe N`` (GPipe over N stages, ``--pp_microbatches`` micro-batches,
0 for ``min(2 N, batch)``); the two are mutually exclusive, as in
``merv_tpu``. ``--dist_backend`` names the process-group backend (NCCL by
default on the card; two ranks on one card need gloo).

    python -m torch.distributed.run --nproc_per_node 2 -m merv_tpu_torch.cli.pretrain \
        --model.type merv-base --stage align --mesh_seq 2 --dist_backend gloo ...
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple, Union

import merv_tpu_torch.conf.registry as draccus
from merv_tpu_torch.conf import DatasetConfig, DatasetRegistry, ModelConfig, ModelRegistry
from merv_tpu_torch.device import make_generator, resolve_device
from merv_tpu_torch.models import get_llm_backbone_and_tokenizer, get_video_backbone_and_transform, get_vidlm
from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.parallel import MeshConfig, build_mesh, world
from merv_tpu_torch.preprocessing.materialize import get_dataset_and_collator
from merv_tpu_torch.training import Metrics, TrainingStrategy, get_train_strategy
from merv_tpu_torch.training.checkpointing import load_stage_weights
from merv_tpu_torch.util.seed_utils import set_global_seed

overwatch = initialize_overwatch(__name__)

# the loss's token block: a 7B micro-batch's whole logits ([16, 3072, 32000] in fp32, 6.3 GB, and as much again for
# their gradient) do not fit beside the model on one card
LOSS_CHUNK_SIZE = 256
DATALOADER_WORKERS = 2  # the dataloader's worker processes, as in merv_tpu


@dataclass
class PretrainConfig:
    # fmt: off
    model: ModelConfig = field(default_factory=ModelConfig.get_choice_class(ModelRegistry.MERV_BASE.model_id))
    dataset: DatasetConfig = field(default_factory=DatasetConfig.get_choice_class(DatasetRegistry.VIDEOLLAVA.dataset_id))

    # Pretraining Stage in < align | full-align | second_align | finetune | full-finetune | second_finetune >
    stage: str = "finetune"
    pretrained_checkpoint: Optional[Path] = None        # explicit checkpoint for `finetune` (else align-run discovery)
    resume_from_checkpoint: Optional[Path] = None       # intermediate checkpoint dir to resume from
    save_checkpoint_after: Optional[int] = 512

    # Run Arguments
    run_id: Optional[str] = None
    run_root_dir: Path = Path("runs")
    seed: int = 7
    device: Optional[str] = None                        # the card unless "cpu"

    # sequence parallelism: the ring size over the LLM's sequence (the mesh's sp axis; 1 = off)
    mesh_seq: int = 1
    # pipeline parallelism: GPipe stages over the LLM's depth (the mesh's pp axis; 1 = off; exclusive with mesh_seq);
    # pp_microbatches = 0 picks min(2 pp, batch)
    mesh_pipe: int = 1
    pp_microbatches: int = 0
    dist_backend: Optional[str] = None                  # process-group backend: nccl (card default) | gloo

    # HF Hub Credentials (accepted for merv_tpu's command lines; the port downloads nothing)
    hf_token: Union[str, Path] = Path(".hf_token")

    # Tracking Parameters (W&B disables itself where wandb is missing or offline)
    trackers: Tuple[str, ...] = ("jsonl", "wandb")
    wandb_project: str = "merv"
    wandb_entity: Optional[str] = None
    slurm_id: Optional[int] = -1
    # fmt: on

    def __post_init__(self) -> None:
        if self.stage.endswith("align"):
            prefix = "align"
        elif self.stage.endswith("finetune"):
            prefix = "finetune"
        else:
            raise ValueError(f"Stage `{self.stage}` is not supported!")

        for name in (
            "epochs", "max_steps", "global_batch_size", "per_device_batch_size",
            "learning_rate", "weight_decay", "max_grad_norm", "lr_scheduler_type",
            "warmup_ratio", "train_strategy",
        ):
            setattr(self, name, getattr(self.model, f"{prefix}_{name}"))

        assert len(self.model.num_frames) == len(self.model.video_backbone_ids), (
            f"Number of num_frames ({len(self.model.num_frames)}) must match backbones"
        )
        assert all(nf % min(self.model.num_frames) == 0 for nf in self.model.num_frames), (
            f"Number of frames should be multiple of the smallest num_frame. {self.model.num_frames}"
        )
        self.slurm_id = os.getenv("SLURM_JOB_ID", self.slurm_id)


@draccus.wrap()
def pretrain(cfg: PretrainConfig) -> TrainingStrategy:
    """Train one stage; returns the strategy (its ``vidlm`` holds the trained model)."""
    overwatch.info("MERV (PyTorch port) :: Pretraining")
    if cfg.mesh_seq > 1 and cfg.mesh_pipe > 1:
        raise ValueError("--mesh_seq and --mesh_pipe are mutually exclusive (pick one per run)")
    device = resolve_device(cfg.device)
    mesh = None
    if cfg.mesh_seq > 1 or cfg.mesh_pipe > 1 or world()[1] > 1:  # each rank takes its card first
        mesh = build_mesh(MeshConfig(data=1, fsdp=-1, tensor=1, seq=cfg.mesh_seq, pipe=cfg.mesh_pipe),
                          device_type=device.type, backend=cfg.dist_backend)
    worker_init_fn = set_global_seed(cfg.seed, get_worker_init_fn=True)

    model_id = cfg.model.model_id
    if cfg.run_id is None:
        cfg.run_id = f"{model_id}+stage-{cfg.stage}+x{cfg.seed}"
    run_dir = Path(cfg.run_root_dir) / cfg.run_id
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "checkpoints").mkdir(exist_ok=True)
    with open(run_dir / "config.json", "w") as f:
        json.dump({"model": draccus.encode(cfg.model), "dataset": draccus.encode(cfg.dataset)}, f, indent=2, default=str)

    # every module random-initialised from the seed, as merv_tpu's vidlm.init; the stage's weights follow
    generator = make_generator(device, cfg.seed)
    overwatch.info(f"Loading Video Backbones {cfg.model.video_backbone_ids}")
    video_backbones, video_transforms = get_video_backbone_and_transform(
        cfg.model.video_backbone_ids, cfg.model.image_resize_strategy, cfg.model.num_frames, device=device,
        generator=generator,
    )
    overwatch.info(f"Loading LLM Backbone {cfg.model.llm_backbone_id}")
    parallel = dict(sequence_parallel=True) if cfg.mesh_seq > 1 else {}  # the decoder's sp or pp path
    if cfg.mesh_pipe > 1:
        parallel = dict(pipeline_parallel=True, pp_microbatches=cfg.pp_microbatches)
    llm_backbone, tokenizer = get_llm_backbone_and_tokenizer(
        cfg.model.llm_backbone_id, llm_max_length=cfg.model.llm_max_length, device=device, generator=generator,
        **parallel,
    )
    vidlm = get_vidlm(
        model_id, cfg.model.arch_specifier, cfg.model.feature_fusion, video_backbones, llm_backbone,
        projector_token_length=cfg.model.projector_token_length,
        visual_feature_length=cfg.model.visual_feature_length, device=device, generator=generator,
    )
    vidlm.freeze_backbones(cfg.stage)
    load_stage_weights(vidlm, cfg.stage, run_dir, cfg.pretrained_checkpoint)

    overwatch.info(f"Building `{cfg.dataset.dataset_id}` => stage {cfg.stage}")
    dataset, collator = get_dataset_and_collator(
        cfg.stage, cfg.dataset, video_transforms, tokenizer,
        prompt_builder_fn=llm_backbone.prompt_builder_fn, num_frames=cfg.model.num_frames,
    )

    strategy = get_train_strategy(
        cfg.train_strategy, vidlm,
        stage=cfg.stage, epochs=cfg.epochs, max_steps=cfg.max_steps,
        global_batch_size=cfg.global_batch_size, per_device_batch_size=cfg.per_device_batch_size,
        learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
        lr_scheduler_type=cfg.lr_scheduler_type, warmup_ratio=cfg.warmup_ratio,
        enable_gradient_checkpointing=cfg.model.enable_gradient_checkpointing,
        enable_mixed_precision_training=cfg.model.enable_mixed_precision_training,
        worker_init_fn=worker_init_fn,
        save_checkpoint_after=cfg.save_checkpoint_after or 512,
        loss_chunk_size=LOSS_CHUNK_SIZE,
        mesh=mesh,
    )
    strategy.run_setup(
        run_dir, n_train_examples=len(dataset), video_transforms=video_transforms,
        resume_from_checkpoint=cfg.resume_from_checkpoint, seed=cfg.seed,
    )

    metrics = Metrics(
        cfg.trackers, cfg.run_id, run_dir, {"model": draccus.encode(cfg.model)}, cfg.stage,
        wandb_project=cfg.wandb_project, wandb_entity=cfg.wandb_entity,
        grad_accumulation_steps=strategy.grad_accumulation_steps, total_steps=strategy.total_steps,
    )

    overwatch.info("Starting Training Loop")
    strategy.run_training(dataset, collator, metrics, stage=cfg.stage, seed=cfg.seed, run_dir=run_dir,
                          num_workers=DATALOADER_WORKERS)

    metrics.finalize()
    overwatch.info("Done with Training =>> Finalizing Metrics")
    return strategy


def main() -> None:
    pretrain()


if __name__ == "__main__":
    main()
