"""Training- and serving-memory proof of the port, with no card (counterpart of ``scripts/memory_proof.py``).

    python -m merv_tpu_torch.cli.memory_proof [--stage align|finetune|both] [--model merv-full] [--llm 7b|13b]
        [--llm-layers 0] [--seq-len 2048] [--pdbs 0] [--loss-chunk 256] [--devices 8] [--mesh-seq 1]
        [--mesh-pipe 1] [--budget-gib 79.65] [--json-out PATH]
    python -m merv_tpu_torch.cli.memory_proof --stage serving [--llm 7b|13b] [--llm-layers 0] [--mesh-tensor 1]
        [--slots 8] [--max-len 2048] [--prefill-bucket 2048] [--spec-gamma 0] [--no-int8-weights] [--int8-kv]

``merv_tpu`` lowers its sharded train step for a virtual mesh and reads the
compiler's memory analysis. The port runs its own sharded train step, the
one ``cli/pretrain.py`` runs, on fake tensors over a fake world: a
``torch.distributed`` group of ``--devices`` ranks with the "fake" backend
(``torch.testing._internal.distributed.fake_pg``), the model built at full
width and depth by the registry's factories under ``FakeTensorMode`` (nothing
is allocated), the stage's strategy applied (``shard_train_state``: FSDP2 or
DDP on the mesh ``MeshConfig(data=1, fsdp=-1, tensor=1, seq=--mesh-seq,
pipe=--mesh-pipe)``), and two steps of the stage's per-device batch traced
under ``FSDPMemTracker`` (``MemTracker`` for DDP), which records every
tensor's bytes by category as the step allocates and frees it. It reports,
for rank 0 and for the first rank of each later pipeline stage, the peak
and its split (parameters sharded and gathered, gradients, optimizer
state, activations, temporaries, collectives' buffers) and the bytes the
rank keeps between steps (its parameters, gradients and AdamW moments). It
exits with 1 where a rank's peak exceeds ``--budget-gib``, by default the
NVIDIA H100 80GB HBM3's 81,559 MiB.

The kernels are represented by what they allocate: under the trace the
flash forward (K2) returns its output and fp32 LSE, its backward (K3) dq,
dk, dv, and K1 its output, with no score matrix, where their plain versions
(which the CPU would run) would materialise one. The LLM keeps the
registry's fp32 parameters, as ``cli/pretrain.py`` trains it (``merv_tpu``'s
proof stores its LLM in bf16). The batch is the collator's: ``--seq-len``
text tokens and uint8 frames at each tower's host geometry, normalised in
the step.

``--stage serving`` is the counterpart of ``merv_tpu``'s ``lower_serving``:
the engine's own programs, its decode chunk (``serving/engine.py::_decode_chunk``,
or ``_decode_chunk_spec`` at ``--spec-gamma``) and its bucket prefill
(``_llm_prefill``), run on fake tensors for rank 0 of a fake world of
``--mesh-tensor`` ranks, on the Llama-2 decoder at full depth in the serving
layout: bf16, packed at ``--mesh-tensor 1`` and unpacked above it (the
tensor-parallel rules key on the unpacked paths), int8 weights unless
``--no-int8-weights``, and cut to the rank's Megatron shards
(``parallel/sharding.py::shard_decoder``). The slot cache holds the rank's
key/value heads. It reports the rank's weight bytes, its cache, and the peak
of each program (the weights, the cache and the program's temporaries),
against the card's 79.65 GiB; a decode chunk runs the engine's default
number of steps. ``_PeakAllocations`` traces the temporaries, not
``MemTracker``: ``MemTracker`` hooks every parameter's gradient, which a
serving model's parameters refuse (they take none), and refuses a module
called twice in one trace, where a decode chunk calls the decoder once a
step. K4, K5 and K2 stand in by what they allocate (their outputs); above 64
rows an int8 Linear runs its plain form, a bf16 copy of the weight and a
GEMM, as it does on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import sys
import time
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

GIB = 1024 ** 3
CARD = "NVIDIA H100 80GB HBM3"
CARD_GIB = 81559 / 1024  # nvidia-smi's memory.total of the card, 81,559 MiB


@contextlib.contextmanager
def kernel_stand_ins():
    """K1, K2 and K3 replaced by what they allocate (see the module's text),
    and the decoder's check of the mask's right padding, a read back to the
    host that fake tensors cannot answer (the proof's mask is all ones), skipped."""
    import merv_tpu_torch.models.backbones.llm.transformer as T
    import merv_tpu_torch.ops.attention as A

    def flash_fwd(q, k, v, *, causal, kv_mask=None, scale=None, q_offset=None, return_lse=False):
        o = torch.empty_like(q)
        return (o, torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)) if return_lse else o

    def flash_bwd(q, k, v, o, lse, do, *, causal, kv_mask=None, scale=None):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def small_kt(q, kt, v, scale):
        return torch.empty_like(q)

    saved = {n: getattr(A, n) for n in ("flash_attention_forward", "flash_attention_backward", "small_attention_kt")}
    check = T.require_right_padding
    A.flash_attention_forward, A.flash_attention_backward, A.small_attention_kt = flash_fwd, flash_bwd, small_kt
    T.require_right_padding = lambda am: None
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(A, n, fn)
        T.require_right_padding = check


def stage_recipe(cfg: Any, stage: str) -> Dict[str, Any]:
    p = "align" if "align" in stage else "finetune"
    return {k: getattr(cfg, f"{p}_{k}") for k in (
        "global_batch_size", "per_device_batch_size", "learning_rate", "weight_decay", "max_grad_norm",
        "lr_scheduler_type", "warmup_ratio", "train_strategy")}


def build_model(model_id: str, llm: str, llm_layers: int, mesh_seq: int, mesh_pipe: int):
    """merv_tpu's flagship construction, with the port's factories (on the CPU; fake under the trace)."""
    from merv_tpu_torch.conf.models import ModelConfig
    from merv_tpu_torch.models.backbones.llm.base_llm import LLM_SPECS, LLMBackbone
    from merv_tpu_torch.models.materialize import get_video_backbone_and_transform, get_vidlm

    cfg = ModelConfig.get_choice_class(model_id)()
    towers, transforms = get_video_backbone_and_transform(cfg.video_backbone_ids, cfg.image_resize_strategy,
                                                          cfg.num_frames, device="cpu", param_dtype=torch.bfloat16)
    llm_id = f"llama2-{llm}-pure"
    spec = LLM_SPECS[llm_id]
    dec = dataclasses.replace(spec.decoder_config, num_layers=llm_layers or spec.decoder_config.num_layers,
                              sequence_parallel=mesh_seq > 1, pipeline_parallel=mesh_pipe > 1)
    backbone = LLMBackbone(llm_id, llm_max_length=cfg.llm_max_length, spec=dataclasses.replace(spec, decoder_config=dec),
                           device="cpu")
    model = get_vidlm(model_id, cfg.arch_specifier, cfg.feature_fusion, towers, backbone,
                      projector_token_length=cfg.projector_token_length,
                      visual_feature_length=cfg.visual_feature_length, device="cpu")
    return model, transforms, cfg


def _fsdp_tracker():
    """``FSDPMemTracker``, whose post-backward hook also takes a unit that never
    gathered its parameters in the step (a frozen tower layer runs only under
    ``no_grad``, a tower's skipped last layers not at all): it has no
    unsharded gradient to record."""
    from torch.distributed._tools.fsdp2_mem_tracker import FSDPMemTracker

    class Tracker(FSDPMemTracker):
        def _fsdp_param_group_post_backward(self, fsdp_mod, orig):
            inner = super()._fsdp_param_group_post_backward(fsdp_mod, orig)

            def guarded(*args, **kwargs):
                group = fsdp_mod._get_fsdp_state()._fsdp_param_group
                if group and any(not hasattr(p, "_unsharded_param") for p in group.fsdp_params):
                    return orig(*args, **kwargs)
                return inner(*args, **kwargs)

            return guarded

    return Tracker


def kept_bytes(model: torch.nn.Module, tx: Any) -> Dict[str, int]:
    """What the rank keeps between steps: its parameters (its shards of
    sharded ones), and for the trainable ones an fp32 gradient and two fp32
    AdamW moments of the same shard."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    params = sum(local(p).numel() * p.element_size() for p in model.parameters())
    trainable = sum(local(p).numel() * 4 for p in tx.params)
    return {"params": params, "grads": trainable, "optimizer": 2 * trainable}


def _batch(model: Any, rows: int, seq_len: int) -> Dict[str, Any]:
    ids = torch.ones((rows, seq_len), dtype=torch.long)
    return dict(input_ids=ids, attention_mask=torch.ones_like(ids), labels=ids.clone(),
                is_multimodal=torch.ones(rows, dtype=torch.bool),
                video_values=[torch.zeros((rows, vb.num_frames, vb.default_image_size, vb.default_image_size, 3),
                                          dtype=torch.uint8) for vb in model.video_backbones])


def trace_rank(args: argparse.Namespace, stage: str, rank: int) -> Dict[str, Any]:
    """One train step of rank ``rank`` of the fake world, traced."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from merv_tpu_torch.parallel.mesh import MESH_AXES, PIPE_AXIS, MeshConfig, axis_rank, batch_size
    from merv_tpu_torch.training import get_train_strategy

    dist.init_process_group("fake", rank=rank, world_size=args.devices, store=FakeStore())
    try:
        shape = MeshConfig(data=1, fsdp=-1, tensor=1, seq=args.mesh_seq, pipe=args.mesh_pipe).resolve(args.devices)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=MESH_AXES)
        t = time.perf_counter()
        with FakeTensorMode(), kernel_stand_ins():
            model, transforms, cfg = build_model(args.model, args.llm, args.llm_layers, args.mesh_seq, args.mesh_pipe)
            recipe = stage_recipe(cfg, stage)
            pdbs = args.pdbs or recipe["per_device_batch_size"]
            model.freeze_backbones(stage)
            strategy = get_train_strategy(
                recipe["train_strategy"], model, stage=stage, max_steps=1,
                global_batch_size=pdbs * batch_size(mesh), per_device_batch_size=pdbs,
                learning_rate=recipe["learning_rate"], weight_decay=recipe["weight_decay"],
                max_grad_norm=recipe["max_grad_norm"], lr_scheduler_type=recipe["lr_scheduler_type"],
                loss_chunk_size=args.loss_chunk or None, mesh=mesh)
            strategy.run_setup(None, n_train_examples=pdbs * batch_size(mesh), video_transforms=transforms)
            kept = kept_bytes(model, strategy.tx)
            if recipe["train_strategy"] == "ddp" or batch_size(mesh) == 1:
                from torch.distributed._tools.mem_tracker import MemTracker

                tracker = MemTracker()
                tracker.track_external(model, strategy.tx.adamw)
            else:
                tracker = _fsdp_tracker()(model, strategy.tx.adamw)
            batch = _batch(model, pdbs, args.seq_len)
            with tracker:  # two steps: the AdamW moments exist from the first step's update on
                for _ in range(2):
                    strategy.step_fn(batch)
                    if hasattr(tracker, "reset_mod_stats"):
                        tracker.reset_mod_stats()
            snapshot = tracker.get_tracker_snapshot("peak")
        peak = next(iter(snapshot.values()))
        split = {str(k).split(".")[-1].lower(): v / GIB for k, v in peak.items() if k != "Total" and v}
        return dict(rank=rank, pp_stage=axis_rank(mesh, PIPE_AXIS), strategy=recipe["train_strategy"],
                    mesh=dict(zip(MESH_AXES, shape)), per_device_batch_size=pdbs,
                    accumulation=recipe["global_batch_size"] // pdbs // batch_size(mesh),
                    kept_gib={k: v / GIB for k, v in kept.items()}, kept_bytes=kept,
                    peak_gib=peak["Total"] / GIB, peak_split_gib=split, trace_s=time.perf_counter() - t)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def serving_stand_ins():
    """K4 (``int8_linear``, at most 64 rows) and K5 (``decode_attention``)
    replaced by their outputs, on top of :func:`kernel_stand_ins` (K2)."""
    import merv_tpu_torch.ops.decode_attention as K5
    import merv_tpu_torch.ops.int8_linear as K4

    def int8_linear(x, weight_q, scale, bias=None):
        return x.new_empty(x.shape[:-1] + (weight_q.shape[0],))

    def decode_attention(q, k, v, k_scale=None, v_scale=None, **kw):
        o = torch.empty_like(q)
        return (o, torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)) if kw.get("return_lse") else o

    saved = (K4.int8_linear, K5.decode_attention)
    K4.int8_linear, K5.decode_attention = int8_linear, decode_attention
    try:
        with kernel_stand_ins():
            yield
    finally:
        K4.int8_linear, K5.decode_attention = saved


class _PeakAllocations(TorchDispatchMode):
    """The peak bytes of the storages that operators allocate while it is
    active, each counted until it is freed, beside the ``held`` tensors (a serving program's temporaries;
    parameters take no gradient hooks here, where ``MemTracker`` installs them)."""

    def __init__(self, held=()) -> None:
        super().__init__()
        self.live = self.peak = 0
        self.seen = WeakIdKeyDictionary()
        for t in held:  # tensors that exist already (an in-place write to them allocates nothing)
            self.seen[t.untyped_storage()] = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self.seen:
                    self.seen[st] = n = st.nbytes()
                    self.live += n
                    weakref.finalize(st, self._free, n)
                    self.peak = max(self.peak, self.live)
        return out


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def serving_rank(args: argparse.Namespace) -> Dict[str, Any]:
    """Rank 0 of a fake world of ``--mesh-tensor`` ranks: the serving decoder,
    its slot cache, and the peaks of the decode chunk and the bucket prefill."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from merv_tpu_torch.models.backbones.llm.transformer import (
        LLAMA2_7B, LLAMA2_13B, KVCache, LlamaDecoder, cache_dtype, pack_serving_params, round_to_compute_dtype,
    )
    from merv_tpu_torch.models.generation import GenerationConfig
    from merv_tpu_torch.nn.quantization import quantize_tree
    from merv_tpu_torch.parallel.mesh import MESH_AXES, MeshConfig
    from merv_tpu_torch.parallel.sharding import shard_decoder
    from merv_tpu_torch.serving.engine import (
        ContinuousBatchingEngine, _decode_chunk, _decode_chunk_spec, _DecodeState, _llm_prefill,
    )

    n = args.mesh_tensor
    base = LLAMA2_13B if args.llm == "13b" else LLAMA2_7B
    cfg = dataclasses.replace(base, num_layers=args.llm_layers or base.num_layers, param_dtype=torch.bfloat16)
    int8_weights = not args.no_int8_weights
    gcfg = GenerationConfig(max_new_tokens=128, eos_token_id=2, pad_token_id=0,
                            kv_cache_dtype="int8" if args.int8_kv else None)
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", MeshConfig(data=1, fsdp=1, tensor=n).resolve(n), mesh_dim_names=MESH_AXES)
        t = time.perf_counter()
        with FakeTensorMode(), serving_stand_ins(), torch.inference_mode():
            dec = LlamaDecoder(cfg, device="cpu")
            if n <= 1:
                pack_serving_params(dec)
            if int8_weights:
                quantize_tree(dec)
            round_to_compute_dtype(dec)
            shard_decoder(dec, mesh)
            weights = list(dec.parameters()) + list(dec.buffers())
            # the engine's rows: the spare verify rows and the per-slot scratch row
            gamma, slots = args.spec_gamma, args.slots
            rows = args.max_len + (max(gamma, 8) + 1 if gamma else 0) + 1
            cache = KVCache.create(cfg, slots, rows, cache_dtype(gcfg.kv_cache_dtype, cfg.compute_dtype), "cpu",
                                   tp=dec.tp)
            state = dict(k=cache.k, v=cache.v, k_scale=cache.k_scale, v_scale=cache.v_scale,
                         length=torch.zeros(slots, dtype=torch.long), done=torch.zeros(slots, dtype=torch.bool),
                         last_tok=torch.zeros(slots, dtype=torch.long))
            if gamma:
                hc = args.max_len + 2 * gamma + 2 + 8
                state.update(hist=torch.zeros((slots, hc), dtype=torch.long), hist_len=torch.zeros(slots, dtype=torch.long))
            st = _DecodeState(**state)
            weight_bytes = _tensor_bytes(weights)
            cache_bytes = _tensor_bytes((cache.k, cache.v, cache.k_scale, cache.v_scale))

            def peak(fn) -> float:
                """The weights, the cache and the peak of what ``fn`` allocates beside them (GiB)."""
                tracker = _PeakAllocations(weights + [t for t in vars(st).values() if isinstance(t, torch.Tensor)])
                with tracker:
                    fn()
                return (weight_bytes + cache_bytes + tracker.peak) / GIB

            steps = inspect.signature(ContinuousBatchingEngine).parameters["steps_per_sync"].default
            if gamma:
                wins = torch.zeros((steps, slots, gamma + 1), dtype=torch.long)
                emits = torch.zeros((steps, slots), dtype=torch.long)
                decode_gib = peak(lambda: _decode_chunk_spec(dec, st, gcfg, steps, gamma, 2, None, wins, emits))
            else:
                toks = torch.zeros((steps, slots), dtype=torch.long)
                decode_gib = peak(lambda: _decode_chunk(dec, st, gcfg, steps, None, toks))
            ids = torch.ones((1, args.prefill_bucket), dtype=torch.long)
            prefill_gib = peak(lambda: _llm_prefill(dec, gcfg, ids, torch.ones_like(ids), None))
        worst = max(decode_gib, prefill_gib)
        return {"stage": "serving", "llm": args.llm, "llm_layers": cfg.num_layers, "tensor": n, "rank": 0,
                "packed": n <= 1, "int8_weights": int8_weights, "int8_kv": args.int8_kv, "slots": slots,
                "max_len": args.max_len, "prefill_bucket": args.prefill_bucket, "spec_gamma": gamma,
                "weights_bytes": weight_bytes, "weights_gib": weight_bytes / GIB, "cache_gib": cache_bytes / GIB,
                "decode_chunk_gib": decode_gib, "prefill_gib": prefill_gib, "peak_gib": worst,
                "fits": worst <= args.budget_gib, "trace_s": time.perf_counter() - t}
    finally:
        dist.destroy_process_group()


def prove(args: argparse.Namespace) -> Dict[str, Any]:
    if args.stage == "serving":
        r = serving_rank(args)
        return {"card": CARD, "budget_gib": args.budget_gib, "devices": args.mesh_tensor, "llm": args.llm,
                "stages": {"serving": dict(ranks=[r], peak_gib=r["peak_gib"], fits=r["fits"])}, "fits": r["fits"]}
    if args.mesh_tensor > 1:
        raise ValueError("--mesh-tensor is a serving layout (--stage serving): every training entry point runs "
                         "tensor = 1, as merv_tpu's do")
    if args.mesh_seq > 1 and args.mesh_pipe > 1:
        raise ValueError("--mesh-seq and --mesh-pipe are mutually exclusive (pick one per run)")
    stages = ["align", "finetune"] if args.stage == "both" else [args.stage]
    out = {"card": CARD, "budget_gib": args.budget_gib, "devices": args.devices, "model": args.model,
           "llm": args.llm, "seq_len_text": args.seq_len, "stages": {}}
    for stage in stages:
        ranks = [trace_rank(args, stage, r) for r in range(args.mesh_pipe)]  # rank s is pipeline stage s's first
        out["stages"][stage] = dict(ranks=ranks, peak_gib=max(r["peak_gib"] for r in ranks),
                                    fits=all(r["peak_gib"] <= args.budget_gib for r in ranks))
    out["fits"] = all(s["fits"] for s in out["stages"].values())
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="both", choices=["align", "finetune", "both", "serving"])
    ap.add_argument("--model", default="merv-full")
    ap.add_argument("--llm", default="7b", choices=["7b", "13b"])
    ap.add_argument("--llm-layers", type=int, default=0, help="0 = the LLM's full depth")
    ap.add_argument("--seq-len", type=int, default=2048, help="text tokens of each example")
    ap.add_argument("--pdbs", type=int, default=0, help="per-device batch (0 = the recipe's)")
    ap.add_argument("--loss-chunk", type=int, default=256, help="the streamed loss's token block (0 = whole logits)")
    ap.add_argument("--devices", type=int, default=8, help="ranks of the fake world")
    ap.add_argument("--mesh-seq", type=int, default=1, help="sequence-parallel ring size (the sp axis)")
    ap.add_argument("--mesh-pipe", type=int, default=1, help="pipeline stages (the pp axis)")
    ap.add_argument("--mesh-tensor", type=int, default=1, help="serving: tensor-parallel width (ranks of the fake world)")
    ap.add_argument("--slots", type=int, default=8, help="serving: engine decode slots")
    ap.add_argument("--max-len", type=int, default=2048, help="serving: per-slot prompt+output bound")
    ap.add_argument("--prefill-bucket", type=int, default=2048, help="serving: largest prefill bucket")
    ap.add_argument("--spec-gamma", type=int, default=0, help="serving: speculative draft length")
    ap.add_argument("--no-int8-weights", action="store_true", help="serving: bf16 weights")
    ap.add_argument("--int8-kv", action="store_true", help="serving: int8 KV cache")
    ap.add_argument("--budget-gib", type=float, default=CARD_GIB, help=f"per-rank budget (default: the {CARD}'s)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    out = prove(args)
    for stage, s in out["stages"].items():
        for r in s["ranks"]:
            if stage == "serving":
                print(f"[memory_proof] serving rank 0 of tensor = {r['tensor']} (Llama-2-{r['llm']}, "
                      f"{r['llm_layers']} layers, {'packed' if r['packed'] else 'unpacked'}, "
                      f"{'int8' if r['int8_weights'] else 'bf16'} weights, {r['slots']} slots x {r['max_len']}): "
                      f"weights {r['weights_gib']:.2f} GiB, cache {r['cache_gib']:.2f} GiB, decode chunk "
                      f"{r['decode_chunk_gib']:.2f} GiB, prefill {r['prefill_gib']:.2f} GiB", file=sys.stderr)
                continue
            print(f"[memory_proof] {stage} rank {r['rank']} (pp stage {r['pp_stage']}, {r['strategy']}, "
                  f"mesh {r['mesh']}, per-device batch {r['per_device_batch_size']}): peak {r['peak_gib']:.2f} GiB "
                  f"{ {k: round(v, 2) for k, v in r['peak_split_gib'].items()} }; kept between steps "
                  f"{ {k: round(v, 2) for k, v in r['kept_gib'].items()} } GiB", file=sys.stderr)
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    if not out["fits"]:
        print(f"FAIL: a rank's peak exceeds the {args.budget_gib:.2f} GiB budget ({CARD})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
