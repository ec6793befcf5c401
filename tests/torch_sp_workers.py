"""Rank bodies of the port's process-group tests (spawned by
tests/test_torch_ring_attention.py and tests/test_torch_sp_serving.py).

Each function runs as one rank of a gloo world on the CPU, reads its inputs
from a file the parent wrote, and saves what it computed for the parent to
hold against merv_tpu and against the in-process exchange. This module
imports neither JAX nor merv_tpu: a rank is the port alone.
"""

import os
import sys


def _start(rank: int, world: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch

    torch.set_num_threads(1)


def _finish(out_dir: str, rank: int, results: dict) -> None:
    import torch
    import torch.distributed as dist

    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    loaded = [m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in ("jax", "merv_tpu")]
    assert not loaded, loaded


def ring_world(rank: int, world: int, port: int, inp_path: str, out_dir: str) -> None:
    """Ring, sharded cache, decoder, mesh and overwatch cases on a world of ``world`` ranks, sp = world."""
    _start(rank, world, port)
    import logging

    import torch

    import merv_tpu_torch.overwatch as ow
    from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder
    from merv_tpu_torch.ops.ring_attention import COLLECTIVES, ring_attention, sharded_cache_attention
    from merv_tpu_torch.parallel import MeshConfig, activation_mesh, build_mesh, mesh_shape

    inp = torch.load(inp_path, weights_only=False)
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, tensor=1, seq=world), device_type="cpu")
    mine = lambda x, dim=2: x.chunk(world, dim)[rank].contiguous()  # noqa: E731
    res = {"mesh_shape": mesh_shape(mesh)}

    for name, case in inp["ring"].items():
        q, k, v, do = (mine(case[t]) for t in ("q", "k", "v", "do"))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = ring_attention(q, k, v, mesh, causal=case["causal"], zigzag=case["zigzag"])
        out.backward(do)
        res[f"ring/{name}"] = dict(out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad)

    for name, case in inp["cache"].items():
        scales = {} if case.get("k_scale") is None else dict(k_scale=mine(case["k_scale"]),
                                                            v_scale=mine(case["v_scale"]))
        res[f"cache/{name}"] = sharded_cache_attention(
            case["q"], mine(case["k"]), mine(case["v"]), mine(case["mask"], 1), mesh, q_offset=case["q_offset"],
            **scales)

    dec = LlamaDecoder(inp["decoder"]["cfg"], device="cpu")
    dec.load_state_dict(inp["decoder"]["state"])
    ids, mask = inp["decoder"]["ids"], inp["decoder"]["mask"]
    with torch.no_grad(), activation_mesh(mesh):
        res["decoder/no_cache"] = dec(input_ids=ids, attention_mask=mask)[0]
        cache = KVCache.create(dec.cfg, 1, 16, torch.float32, "cpu", mesh=mesh)
        prefill, cache = dec(input_ids=ids[:1, :8], kv_cache=cache)
        step, _ = dec(input_ids=ids[:1, 8:9], kv_cache=cache)
        res["decoder/cache"] = dict(prefill=prefill, step=step, rows=cache.k.shape[3])

    w = ow.initialize_overwatch("merv_tpu_torch.sp_world")
    res["overwatch"] = dict(
        kind=type(w).__name__, rank=w.rank(), world_size=w.world_size(), rank_zero=w.is_rank_zero(),
        bare=w.rank_zero_only(lambda: rank)(), called=w.rank_zero_only()(lambda: rank)(),
        info=w.logger.isEnabledFor(logging.INFO), error=w.logger.isEnabledFor(logging.ERROR))
    res["collectives"] = dict(COLLECTIVES)
    _finish(out_dir, rank, res)


def serving_world(rank: int, world: int, port: int, inp_path: str, out_dir: str) -> None:
    """The tiny MERV at sp = world: generate_batch (with the prefill's logits),
    score_options, the engine and ``eval_openended --mesh_seq`` (group path
    and ``--use_engine``)."""
    _start(rank, world, port)
    import torch

    import merv_tpu_torch.cli.eval_mcq as port_mcq
    import merv_tpu_torch.cli.eval_openended as port_oe
    import merv_tpu_torch.models.generation as G
    from merv_tpu_torch.models.generation import GenerationConfig
    from merv_tpu_torch.parallel import MeshConfig, build_mesh
    from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

    inp = torch.load(inp_path, weights_only=False)
    pm = inp["model"]
    pm.llm_backbone.sequence_parallel = True
    mesh = build_mesh(MeshConfig(data=1, fsdp=-1, tensor=1, seq=world), device_type="cpu")
    res = {}
    seen = []
    prefill = G.prefill

    def recorded(*args, **kwargs):
        out = prefill(*args, **kwargs)
        seen.append((out[0].clone(), out[1].k.shape[3], out[1].sp is not None))
        return out

    G.prefill = recorded
    res["generate"] = pm.generate_batch(inp["videos"], inp["prompts"], max_new_tokens=inp["max_new"], mesh=mesh)
    G.prefill = prefill
    res["generate_logits"], res["generate_cache_rows"], res["generate_sharded"] = seen[0]
    res["score"] = pm.score_options(inp["videos"], inp["prompts"], inp["options"], mesh=mesh)
    gcfg = GenerationConfig(max_new_tokens=inp["max_new"], eos_token_id=pm.llm_backbone.stop_token_id,
                            pad_token_id=pm.llm_backbone.pad_token_id)
    engine = ContinuousBatchingEngine.for_vidlm(pm, slots=2, max_len=inp["engine_max_len"], length_bucket=8,
                                                config=gcfg, mesh=mesh)
    served = engine.run([Request(str(i), prompt_text=p, video=v, max_new_tokens=inp["max_new"])
                         for i, (v, p) in enumerate(zip(inp["videos"], inp["prompts"]))])
    res["engine"] = {k: r.token_ids.tolist() for k, r in served.items()}
    res["engine_rows"] = engine._state.k.shape[3]

    port_mcq.load_vid = lambda *a, **k: (pm, inp["model_cfg"])
    os.chdir(inp["cwd"])
    for label, extra in (("group", ["--batch_size", "2"]), ("engine", ["--use_engine", "true"])):
        root = os.path.join(inp["cwd"], f"oe_{label}")
        port_oe.evaluate(args=inp["eval_args"] + ["--eval_result_root", root, "--mesh_seq", str(world),
                                                  "--dist_backend", "gloo", "--device", "cpu"] + extra)
        res[f"eval/{label}"] = sorted(os.listdir(os.path.join(root, "tiny-run"))) if rank == 0 else None
    _finish(out_dir, rank, res)


def _fp32_towers() -> None:
    """Keep the towers in fp32 where the strategy casts them to their half
    precision: the merv_tpu step they are held against runs fp32 towers."""
    import torch

    from merv_tpu_torch.models.backbones.video.base_video import VideoBackbone

    VideoBackbone.half_precision_dtype = property(lambda self: torch.float32)


def rank_rows(batch: dict, accum: int, coord: int, ranks: int) -> dict:
    """A rank's part of a global batch: the rows of each of the ``accum``
    micro-batches at its batch coordinate (merv_tpu's [accum, micro] layout
    with micro sharded over the batch ranks)."""
    import torch

    n = next(v for v in batch.values() if not isinstance(v, list)).shape[0]
    micro = n // accum
    per = micro // ranks
    rows = torch.cat([torch.arange(i * micro + coord * per, i * micro + (coord + 1) * per) for i in range(accum)])

    def cut(x):
        return [cut(e) for e in x] if isinstance(x, list) else x[rows]

    return {k: cut(v) for k, v in batch.items()}


class _Items:
    """A dataset of ``n`` items with modality lengths (half multimodal) for the samplers."""

    def __init__(self, n: int) -> None:
        self.n = n

    def __len__(self) -> int:
        return self.n

    def get_modality_lengths(self):
        return [(i % 2 == 0, 10 + i) for i in range(self.n)]


def train_world(rank: int, world: int, port: int, inp_path: str, out_dir: str) -> None:
    """One train step of the tiny MERV under each layout of ``inp["layouts"]``
    on a world of ``world`` ranks: the strategy on its mesh, the rank's part of
    the global batch, a checkpoint written from the sharded state; then the
    checkpoint loaded back at this world size."""
    _start(rank, world, port)
    import copy
    import dataclasses

    import torch

    from merv_tpu_torch.parallel import MeshConfig, build_mesh
    from merv_tpu_torch.parallel.mesh import batch_rank, batch_size
    from merv_tpu_torch.training import get_train_strategy
    from merv_tpu_torch.training.checkpointing import latest_checkpoint, wait_for_checkpoints

    _fp32_towers()
    inp = torch.load(inp_path, weights_only=False)
    res = {}
    for name, lay in inp["layouts"].items():
        model = copy.deepcopy(inp["model"])
        dec = model.llm_backbone.decoder
        dec.cfg = dataclasses.replace(dec.cfg, sequence_parallel=lay["sp"] > 1, pipeline_parallel=lay["pp"] > 1)
        model.freeze_backbones("finetune")
        mesh = build_mesh(MeshConfig(data=1, fsdp=-1, tensor=1, seq=lay["sp"], pipe=lay["pp"]), device_type="cpu")
        strat = get_train_strategy(
            lay["strategy"], model, stage="finetune", max_steps=1, global_batch_size=inp["global_batch"],
            per_device_batch_size=lay["per_device"], learning_rate=inp["lr"], weight_decay=lay["wd"],
            max_grad_norm=inp["clip"], lr_scheduler_type="constant", enable_gradient_checkpointing=lay["remat"],
            mesh=mesh)
        run_dir = os.path.join(inp["root"], name)
        os.makedirs(run_dir, exist_ok=True)
        strat.run_setup(run_dir, n_train_examples=inp["global_batch"])
        b = rank_rows(inp["batch"], strat.grad_accumulation_steps, batch_rank(mesh), batch_size(mesh))
        out = strat.step_fn(b)
        strat.save_checkpoint(run_dir, 1, 0, float(out["loss"]))
        wait_for_checkpoints()
        torch.distributed.barrier()
        reloaded = copy.deepcopy(inp["model"])  # the checkpoint back into a fresh copy laid out the same way
        reloaded.llm_backbone.decoder.cfg = dec.cfg
        reloaded.freeze_backbones("finetune")
        again = get_train_strategy(
            lay["strategy"], reloaded, stage="finetune", max_steps=1, global_batch_size=inp["global_batch"],
            per_device_batch_size=lay["per_device"], learning_rate=inp["lr"], weight_decay=lay["wd"],
            max_grad_norm=inp["clip"], lr_scheduler_type="constant", mesh=mesh)
        again.run_setup(run_dir, n_train_examples=inp["global_batch"],
                        resume_from_checkpoint=latest_checkpoint(run_dir))
        same = all(torch.equal(a.full_tensor() if hasattr(a, "full_tensor") else a,
                               b.full_tensor() if hasattr(b, "full_tensor") else b)
                   for a, b in zip(model.parameters(), reloaded.parameters()))
        sampled = {}
        for stage in ("align", "finetune"):
            sampler = strat.sampler(_Items(inp["global_batch"] * 2), stage, seed=3)
            sampler.set_epoch(0)
            sampled[stage] = list(sampler)
        res[name] = dict(coords={a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}, sampled=sampled,
                         loss=float(out["loss"]), grad_norm=float(out["grad_norm"]), accum=strat.grad_accumulation_steps,
                         world_size=strat.world_size, reload_equal=same, count=again.tx.count,
                         kinds=sorted({type(p).__name__ for p in model.parameters()}))
    _finish(out_dir, rank, res)


def cli_world(rank: int, world: int, port: int, inp_path: str, out_dir: str) -> None:
    """``cli/pretrain.py`` on the tiny model at ``--mesh_seq 2`` (align) and
    ``--mesh_pipe 2`` (finetune from that align checkpoint, then resumed from
    its step-1 checkpoint), each 2 steps with a checkpoint a step."""
    _start(rank, world, port)
    import copy

    import torch

    import merv_tpu_torch.cli.pretrain as cli
    from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
    from merv_tpu_torch.models.materialize import get_vidlm

    inp = torch.load(inp_path, weights_only=False)

    def towers(ids, strategy, num_frames, device=None, generator=None):
        vbs = copy.deepcopy(inp["towers"])
        return vbs, [vb.get_video_transform() for vb in vbs]

    def llm(llm_id, llm_max_length=2048, device=None, generator=None, **parallel):
        backbone = tiny_llm_backbone(compute_dtype=torch.float32, vocab_size=inp["vocab"], device="cpu", **parallel)
        return backbone, backbone.tokenizer

    def vidlm(*args, **kw):
        model = get_vidlm(*args, **{**kw, "device": "cpu", "generator": None})
        model.load_state_dict(inp["state"], strict=True)
        return model

    cli.get_video_backbone_and_transform, cli.get_llm_backbone_and_tokenizer, cli.get_vidlm = towers, llm, vidlm
    cli.DATALOADER_WORKERS = 0
    from merv_tpu_torch.ops.ring_attention import COLLECTIVES as RING
    from merv_tpu_torch.parallel.pipeline import COLLECTIVES as PIPE

    res = {}
    for label, argv, resume_of in inp["runs"]:
        if resume_of is not None:  # the step-1 checkpoint of an earlier run
            ckpts = os.path.join(inp["root"], "runs", resume_of, "checkpoints")
            argv = argv + ["--resume_from_checkpoint",
                           os.path.join(ckpts, next(d for d in sorted(os.listdir(ckpts)) if d.startswith("step-000001")))]
        for counts in (RING, PIPE):
            for k in counts:
                counts[k] = 0
        strategy = cli.pretrain(args=argv + ["--dist_backend", "gloo", "--device", "cpu"])
        res[label] = dict(resume_step=strategy._resume_step, count=strategy.tx.count, world_size=strategy.world_size,
                          layers=[type(m).__name__ for m in strategy.vidlm.llm_backbone.decoder.layers],
                          collectives={**RING, **PIPE})
    _finish(out_dir, rank, res)


def _tiny_load_vid(inp: dict) -> None:
    """``load_vid``'s factories give copies of the parent's tiny towers (kept
    in fp32) and LLM (the run directory's config names merv-full's ids); the
    towers' files come from ``inp["tower_dir"]``."""
    import copy

    import merv_tpu_torch.models.load_vid as LV
    from merv_tpu_torch.models.vidlms import MERV

    _fp32_towers()
    os.environ["MERV_TPU_TOWER_DIR"] = inp["tower_dir"]
    os.environ.pop("MERV_TPU_LLM_DIR", None)
    LV.get_video_backbone_and_transform = lambda *a, device=None, **k: ([copy.deepcopy(t) for t in inp["towers"]], [])
    LV.get_llm_backbone_and_tokenizer = lambda *a, device=None, **k: (copy.deepcopy(inp["llm"]), None)
    LV.get_vidlm = lambda model_id, arch, fusion, vbs, llm, device=None, **k: MERV(
        model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion, device=device,
        projector_token_length=k["projector_token_length"], visual_feature_length=k["visual_feature_length"],
        text_embedding_dim=inp["text_embedding_dim"])


def _decode_step_counts(pm) -> dict:
    """The tensor collectives of one T = 1 decode step of ``pm``'s decoder."""
    import torch

    from merv_tpu_torch.models.backbones.llm.transformer import KVCache
    from merv_tpu_torch.parallel import tensor as TP

    dec = pm.llm_backbone.decoder
    cache = KVCache.create(dec.cfg, 1, 8, dec.cfg.compute_dtype, "cpu", tp=dec.tp)
    with torch.no_grad():
        _, cache = dec(input_ids=torch.ones(1, 4, dtype=torch.long), kv_cache=cache)
        TP.reset_counts()
        dec(input_ids=torch.ones(1, 1, dtype=torch.long), kv_cache=cache)
    return dict(TP.COUNTS)


def tp_world(rank: int, world: int, port: int, inp_path: str, out_dir: str) -> None:
    """The tiny MERV at tensor = world: ``load_vid`` from a run directory (bf16
    and int8 weights), the prefill's logits, ``generate_batch``,
    ``score_options``, the engine at gamma 0 and 2, a shared prefix, int8
    weights through the engine, and one decode step's collectives."""
    _start(rank, world, port)
    import torch

    from merv_tpu_torch import load_vid
    from merv_tpu_torch.models.generation import GenerationConfig, prefill
    from merv_tpu_torch.parallel import MeshConfig, build_mesh
    from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

    inp = torch.load(inp_path, weights_only=False)
    _tiny_load_vid(inp)
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, tensor=world), device_type="cpu")
    pm = load_vid(inp["run_dir"], device="cpu", mesh=mesh)
    dec = pm.llm_backbone.decoder
    res = {"state": {k: v.clone() for k, v in pm.state_dict().items()}, "kv_heads": dec.tp.kv_heads,
           "packed": "qkv_proj" in dec.layers[0].attn._modules}
    videos, prompts, nf = inp["videos"], inp["prompts"], inp["num_frames"]
    with torch.no_grad():
        ids, mask, vids, is_mm = pm._prepare_batch_inputs(videos, prompts, nf)
        embeds, emask = pm.build_inputs_embeds(ids, mask, vids, is_mm)
        res["prefill_logits"], cache, _ = prefill(dec, embeds, emask.long(), embeds.shape[1] + 4)
    res["prefill_cache_heads"] = cache.k.shape[2]
    res["generate"] = pm.generate_batch(videos, prompts, max_new_tokens=inp["max_new"], num_frames=nf, mesh=mesh)
    res["score"] = pm.score_options(videos, prompts, inp["options"], num_frames=nf, mesh=mesh)
    res["step_counts"] = _decode_step_counts(pm)
    gcfg = GenerationConfig(max_new_tokens=inp["max_new"], eos_token_id=pm.llm_backbone.stop_token_id,
                            pad_token_id=pm.llm_backbone.pad_token_id)

    def serve(model, gamma, prefix=False):
        engine = ContinuousBatchingEngine.for_vidlm(model, slots=2, max_len=inp["engine_max_len"], length_bucket=8,
                                                    config=gcfg, speculative_gamma=gamma, mesh=mesh)
        if prefix:
            engine.register_prefix_video("v0", videos[0], num_frames=nf)
        reqs = [Request(str(i), prompt_text=p, video=None if prefix else videos[0], max_new_tokens=inp["max_new"],
                        prefix_id="v0" if prefix else None) for i, p in enumerate(prompts)]
        out = engine.run(reqs)
        return {k: r.token_ids.tolist() for k, r in out.items()}, tuple(engine._state.k.shape)

    res["engine"] = {g: serve(pm, g) for g in (0, 2)}
    res["prefix"] = serve(pm, 0, prefix=True)
    del pm
    pm8 = load_vid(inp["run_dir"], device="cpu", mesh=mesh, quantize_llm=True)
    res["state8"] = {k: v.clone() for k, v in pm8.llm_backbone.decoder.state_dict().items()}
    res["engine8"] = serve(pm8, 0)
    _finish(out_dir, rank, res)


def tp_world4(rank: int, world: int, port: int, inp_path: str, out_dir: str) -> None:
    """A world of 4: (a) the tiny decoder at tensor 2 x sp 2 (the ring on each
    rank's heads, the sequence-sharded cache of its key/value heads) and (b) a
    Qwen-like tiny decoder (biases, tied head, 2 key/value heads, uneven
    vocabulary and MLP shards) at tensor 4, its key/value heads whole."""
    _start(rank, world, port)
    import copy

    import torch

    from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder
    from merv_tpu_torch.models.generation import GenerationConfig, generate
    from merv_tpu_torch.parallel import MeshConfig, activation_mesh, build_mesh, shard_decoder
    from merv_tpu_torch.serving import ContinuousBatchingEngine, Request

    inp = torch.load(inp_path, weights_only=False)
    res = {}
    a = inp["ring"]
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, tensor=2, seq=2), device_type="cpu")
    dec = LlamaDecoder(a["cfg"], device="cpu")
    dec.load_state_dict(a["state"])
    shard_decoder(dec, mesh)
    ids, mask = a["ids"], a["mask"]
    with torch.no_grad(), activation_mesh(mesh):
        res["ring/no_cache"] = dec(input_ids=ids, attention_mask=mask)[0]
        cache = KVCache.create(dec.cfg, 1, 16, torch.float32, "cpu", mesh=mesh, tp=dec.tp)
        prefill, cache = dec(input_ids=ids[:1, :8], kv_cache=cache)
        step, _ = dec(input_ids=ids[:1, 8:9], kv_cache=cache)
    res["ring/cache"] = dict(prefill=prefill, step=step, shape=tuple(cache.k.shape), sharded=cache.sp is not None)

    b = inp["kv_whole"]
    mesh4 = build_mesh(MeshConfig(data=1, fsdp=1, tensor=4), device_type="cpu")
    dec = LlamaDecoder(b["cfg"], device="cpu")
    dec.load_state_dict(b["state"])
    whole = copy.deepcopy(dec)
    shard_decoder(dec, mesh4)
    res["kv_whole/tp"] = dict(num_heads=dec.tp.num_heads, kv_heads=dec.tp.kv_heads, kv_attend=dec.tp.kv_attend,
                              vocab_range=dec.tp.vocab_range, q_rows=dec.layers[0].attn.q_proj.weight.shape[0],
                              k_rows=dec.layers[0].attn.k_proj.weight.shape[0],
                              gate_rows=dec.layers[0].mlp.gate_proj.weight.shape[0])
    gcfg = GenerationConfig(max_new_tokens=6, eos_token_id=1, pad_token_id=0)
    with torch.no_grad():
        res["kv_whole/logits"] = dec(input_ids=b["ids"])[0]
    res["kv_whole/generate"] = generate(dec, input_ids=b["ids"], config=gcfg)
    res["kv_whole/generate_whole"] = generate(whole, input_ids=b["ids"], config=gcfg)
    served = {}
    for name, d in (("tp", dec), ("whole", whole)):
        engine = ContinuousBatchingEngine(d, config=gcfg, slots=2, max_len=32, length_bucket=4, speculative_gamma=2)
        out = engine.run([Request(str(i), input_ids=row.numpy(), max_new_tokens=6) for i, row in enumerate(b["ids"])])
        served[name] = ({k: r.token_ids.tolist() for k, r in out.items()}, tuple(engine._state.k.shape))
    res["kv_whole/engine"] = served
    _finish(out_dir, rank, res)
