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
