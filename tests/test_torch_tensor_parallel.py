"""Tensor-parallel serving in the port (merv_tpu's Megatron splits,
``llm_tensor_parallel_rules``) against merv_tpu on its tensor = 2 mesh of
virtual CPU devices and against the port on one rank.

One spawned gloo world of 2 (rank bodies in tests/torch_sp_workers.py) loads
a tiny run directory that merv_tpu wrote with ``load_vid(mesh=)`` at tensor
= 2, in fp32 and in int8, and serves it: the prefill's logits,
``generate_batch``, ``score_options``, the engine at gamma 0 and 2, a shared
prefix, int8 weights through the engine, one decode step's collectives. One
world of 4 runs the tiny decoder at tensor 2 x sp 2 (the ring and the
sequence-sharded cache on each rank's heads) and a Qwen-like one (biases,
tied head) at tensor 4 with its 2 key/value heads whole. Without a world:
the rule table on all eleven LLM families' port names (int8 leaves
included), the split dims, and the memory proof's serving stage against
merv_tpu's per-device weight bytes. Tolerance: 1e-4 relative on fp32 logits;
tokens, picks and weight bits identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.models.load_vid as jax_load_vid_mod
import merv_tpu_torch.cli.memory_proof as MP
import merv_tpu_torch.models.load_vid as port_load_vid_mod
import torch_sp_workers
from merv_tpu.models.backbones.llm.base_llm import LLMBackbone as JaxLLMBackbone
from merv_tpu.models.backbones.llm.base_llm import LLMSpec as JaxLLMSpec
from merv_tpu.models.backbones.llm.prompting import PurePromptBuilder as JaxPurePromptBuilder
from merv_tpu.models.backbones.llm.transformer import LlamaDecoder as JaxDecoder
from merv_tpu.models.backbones.llm.transformer import tiny_decoder_config as jax_tiny_decoder
from merv_tpu.models.generation import GenerationConfig as JaxGenConfig
from merv_tpu.models.generation import generate as jax_generate
from merv_tpu.models.vidlms import MERV as JaxMERV
from merv_tpu.parallel import MeshConfig as JaxMeshConfig
from merv_tpu.parallel import build_mesh as jax_build_mesh
from merv_tpu.parallel import llm_tensor_parallel_rules as jax_rules
from merv_tpu.parallel.sharding import path_str as jax_path_str
from merv_tpu.serving import ContinuousBatchingEngine as JaxEngine
from merv_tpu.serving import Request as JaxRequest
from merv_tpu.training.checkpointing import save_checkpoint as jax_save_checkpoint
from merv_tpu_torch import load_vid
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.llm.base_llm import LLM_SPECS, LLMBackbone, LLMSpec
from merv_tpu_torch.models.backbones.llm.prompting import PurePromptBuilder
from merv_tpu_torch.models.backbones.llm.transformer import KVCache, LlamaDecoder, tiny_decoder_config
from merv_tpu_torch.models.generation import GenerationConfig, prefill
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn.quantization import quantize_tree
from merv_tpu_torch.parallel import sharding as PS
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request
from test_torch_load_vid import TOWERS, _jax_tower, _port_tower, _write_tower_dir
from test_torch_ring_attention import spawn_world

CPU = "cpu"
NAMES = ("dinov2", "siglip")
LLM = dict(vocab_size=320)  # tiny_decoder_config otherwise: hidden 64, 2 layers, 4 heads, 2 key/value heads, D 16
KW = dict(arch_specifier="3davg+linear", feature_fusion="cross_attention_avg_lq", projector_token_length=4,
          visual_feature_length=16, text_embedding_dim=32)
RUN_CONFIG = {
    "model_id": "merv-full", "arch_specifier": KW["arch_specifier"], "feature_fusion": KW["feature_fusion"],
    "video_backbone_ids": [TOWERS[n][2] for n in NAMES], "llm_backbone_id": "llama2-7b-pure",
    "image_resize_strategy": "resize-naive", "llm_max_length": 512, "num_frames": [4, 4],
    "projector_token_length": 4, "visual_feature_length": 16, "type": "merv-full",
}
PROMPTS = ["In: what is in this video?\nOut: ", "In: a?\nOut: ", "In: describe the motion in detail please.\nOut: "]
OPTIONS = [["A", "B"], ["A", "B", "C"], ["B", "C"]]
MAX_NEW = 6
ENGINE_MAX_LEN = 96
REL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_llm():
    spec = JaxLLMSpec("tiny", "__offline__/tiny", jax_tiny_decoder(compute_dtype=jnp.float32, **LLM),
                      JaxPurePromptBuilder, half_precision_dtype=jnp.float32, has_bos=True, pad_token_id=0,
                      eos_token_id=2)
    return JaxLLMBackbone("tiny-pure", llm_max_length=512, inference_mode=True, spec=spec)


def _port_llm():
    spec = LLMSpec("tiny", "__offline__/tiny", tiny_decoder_config(compute_dtype=torch.float32, **LLM),
                   PurePromptBuilder, half_precision_dtype=torch.float32, has_bos=True, pad_token_id=0, eos_token_id=2)
    return LLMBackbone("tiny-pure", llm_max_length=512, inference_mode=True, spec=spec, device=CPU)


def _videos(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(8, 40, 48, 3)).astype(np.uint8) for _ in range(n)]


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a), dtype=torch.float32), torch.as_tensor(np.asarray(b), dtype=torch.float32)
    return float((a - b).norm() / b.norm())


def _shard_of(arr, jmesh, rank):
    """The data merv_tpu places on a device at tensor coordinate ``rank``."""
    axis = jmesh.axis_names.index("tensor")
    for s in arr.addressable_shards:
        if int(np.argwhere(jmesh.devices == s.device)[0][axis]) == rank:
            return np.asarray(s.data)
    raise AssertionError("no shard at that tensor coordinate")


def _rank_state(jparams, jmesh, rank):
    """The port's names of merv_tpu's LLM leaves as placed on tensor coordinate ``rank``."""
    llm = jax.tree_util.tree_map(lambda a: _shard_of(a, jmesh, rank), jparams["llm_backbone"])
    return {k: v for k, v in state_dict_from_jax({"llm_backbone": llm}).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """merv_tpu writes the run directory; merv_tpu loads it on its tensor = 2
    mesh (fp32 and int8); the port loads it on one rank (unpacked) and on
    a spawned world of 2."""
    root = tmp_path_factory.mktemp("tp_run")
    run = root / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "config.json").write_text(json.dumps({"model": RUN_CONFIG}))
    _write_tower_dir(root / "towers", list(NAMES))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MERV_TPU_TOWER_DIR", str(root / "towers"))
        mp.delenv("MERV_TPU_LLM_DIR", raising=False)
        mp.setattr(jax_load_vid_mod, "get_video_backbone_and_transform",
                   lambda *a, **k: ([_jax_tower(n, jnp.float32) for n in NAMES], []))
        mp.setattr(jax_load_vid_mod, "get_llm_backbone_and_tokenizer", lambda *a, **k: (_jax_llm(), None))
        mp.setattr(jax_load_vid_mod, "get_vidlm", lambda model_id, arch, fusion, vbs, llm, **k: JaxMERV(
            model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion, projector_token_length=4,
            visual_feature_length=16, text_embedding_dim=32))
        mp.setattr(port_load_vid_mod, "get_video_backbone_and_transform",
                   lambda *a, device=None, **k: ([_port_tower(n, torch.float32, device) for n in NAMES], []))
        mp.setattr(port_load_vid_mod, "get_llm_backbone_and_tokenizer", lambda *a, device=None, **k: (_port_llm(), None))
        mp.setattr(port_load_vid_mod, "get_vidlm", lambda model_id, arch, fusion, vbs, llm, device=None, **k: MERV(
            model_id, vbs, llm, arch_specifier=arch, feature_fusion=fusion, device=device, **{
                key: KW[key] for key in ("projector_token_length", "visual_feature_length", "text_embedding_dim")}))
        jm0 = JaxMERV("tiny-merv", [_jax_tower(n, jnp.float32) for n in NAMES], _jax_llm(), **KW)
        params = _np_tree(jm0.init(jax.random.PRNGKey(12)))
        rng = np.random.default_rng(12)
        for k in ("projectors", "feature_fusion"):  # random everywhere: a zero bias would hide a misplaced one
            params[k] = jax.tree_util.tree_map(lambda x: rng.normal(0, 0.05, np.shape(x)).astype(np.float32),
                                               params[k])
        jax_save_checkpoint(run, 1, 0, 0.5, {k: params[k] for k in ("projectors", "feature_fusion", "llm_backbone")},
                            ["projectors", "feature_fusion", "llm_backbone"])
        jmesh = jax_build_mesh(JaxMeshConfig(data=1, fsdp=-1, tensor=2))
        jm, jparams = jax_load_vid_mod.load_vid(str(run), mesh=jmesh)
        _, jparams8 = jax_load_vid_mod.load_vid(str(run), mesh=jmesh, quantize_llm=True)
        pm = load_vid(run, device=CPU, pack_llm=False)
        pm8 = load_vid(run, device=CPU, pack_llm=False, quantize_llm=True)
        inp = dict(run_dir=str(run), tower_dir=str(root / "towers"), towers=[_port_tower(n) for n in NAMES],
                   llm=_port_llm(), text_embedding_dim=KW["text_embedding_dim"], videos=_videos(3), prompts=PROMPTS,
                   options=OPTIONS, num_frames=RUN_CONFIG["num_frames"], max_new=MAX_NEW,
                   engine_max_len=ENGINE_MAX_LEN)
        ranks = spawn_world(torch_sp_workers.tp_world, 2, inp, tmp_path_factory.mktemp("tp_world"))
    return dict(jm=jm, jparams=jparams, jparams8=jparams8, jmesh=jmesh, pm=pm, pm8=pm8, inp=inp, ranks=ranks)


def test_tp_load_vid_places_the_megatron_shards(world):
    """merv_tpu's test_load_vid_places_params_on_serve_mesh: packing is off,
    each rank holds merv_tpu's shard of every LLM leaf at its tensor
    coordinate (1/2 of each matrix, the norms whole), towers, projectors and
    fusion whole."""
    whole = world["pm"].state_dict()
    for r, rank in enumerate(world["ranks"]):
        assert not rank["packed"] and rank["kv_heads"] == 1
        want = _rank_state(world["jparams"], world["jmesh"], r)
        state = rank["state"]
        assert sorted(state) == sorted(whole)
        for name, t in state.items():
            if name.startswith("llm_backbone."):
                np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
                full = whole[name]
                share = t.numel() / full.numel()
                assert share == (1.0 if "norm" in name else 0.5), (name, share)
            else:
                assert torch.equal(t, whole[name]), name


def test_tp_int8_weights_are_merv_tpus_quantize_then_shard(world):
    for r, rank in enumerate(world["ranks"]):
        want = _rank_state(world["jparams8"], world["jmesh"], r)
        for name, t in rank["state8"].items():
            np.testing.assert_array_equal(t.numpy(), want[f"llm_backbone.decoder.{name}"], err_msg=name)
        assert rank["state8"]["layers.0.attn.o_proj.scale"].numel() == 64  # row-split: the whole output channels


def test_tp_prefill_logits_and_generate_match_merv_tpu(world):
    jm, jparams, jmesh, pm, inp = world["jm"], world["jparams"], world["jmesh"], world["pm"], world["inp"]
    nf = inp["num_frames"]
    jids, jmask, jvids, jis_mm = jm._prepare_batch_inputs(inp["videos"], PROMPTS, nf)
    ref = jm.forward(jparams, jids, jmask, jvids, is_multimodal=jis_mm)
    last = np.asarray(ref["attention_mask"]).sum(axis=1) - 1
    want_logits = np.asarray(ref["logits"])[np.arange(len(last)), last]
    ids, mask, vids, is_mm = pm._prepare_batch_inputs(inp["videos"], PROMPTS, nf)
    with torch.no_grad():
        embeds, emask = pm.build_inputs_embeds(ids, mask, vids, is_mm)
        one = prefill(pm.llm_backbone.decoder, embeds, emask.long(), embeds.shape[1] + 4)[0]
    want = jm.generate_batch(jparams, inp["videos"], PROMPTS, num_frames=nf, max_new_tokens=MAX_NEW, mesh=jmesh)
    assert pm.generate_batch(inp["videos"], PROMPTS, num_frames=nf, max_new_tokens=MAX_NEW) == want
    for rank in world["ranks"]:
        assert _rel(rank["prefill_logits"], want_logits) <= REL
        assert _rel(rank["prefill_logits"], one) <= REL
        assert rank["prefill_cache_heads"] == 1
        assert rank["generate"] == want


def test_tp_score_options_match_merv_tpu(world):
    jm, jparams, jmesh, inp = world["jm"], world["jparams"], world["jmesh"], world["inp"]
    want = jm.score_options(jparams, inp["videos"], PROMPTS, OPTIONS, num_frames=inp["num_frames"], mesh=jmesh)
    assert world["pm"].score_options(inp["videos"], PROMPTS, OPTIONS, num_frames=inp["num_frames"]) == want
    for rank in world["ranks"]:
        assert rank["score"] == want


def _jax_engine(world, params, gamma, **kw):
    jm, inp = world["jm"], world["inp"]
    cfg = JaxGenConfig(max_new_tokens=MAX_NEW, eos_token_id=jm.llm_backbone.stop_token_id,
                       pad_token_id=jm.llm_backbone.pad_token_id)
    engine = JaxEngine.for_vidlm(jm, params, slots=2, max_len=ENGINE_MAX_LEN, length_bucket=8, config=cfg,
                                 speculative_gamma=gamma, **kw)
    out = engine.run([JaxRequest(str(i), prompt_text=p, video=inp["videos"][0], max_new_tokens=MAX_NEW)
                      for i, p in enumerate(PROMPTS)])
    return {k: np.asarray(r.token_ids).tolist() for k, r in out.items()}


def _port_engine(world, pm, gamma):
    inp = world["inp"]
    cfg = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=pm.llm_backbone.stop_token_id,
                           pad_token_id=pm.llm_backbone.pad_token_id)
    engine = ContinuousBatchingEngine.for_vidlm(pm, slots=2, max_len=ENGINE_MAX_LEN, length_bucket=8, config=cfg,
                                                speculative_gamma=gamma)
    out = engine.run([Request(str(i), prompt_text=p, video=inp["videos"][0], max_new_tokens=MAX_NEW)
                      for i, p in enumerate(PROMPTS)])
    return {k: r.token_ids.tolist() for k, r in out.items()}, tuple(engine._state.k.shape)


@pytest.mark.parametrize("gamma", [0, 2])
def test_tp_engine_matches_merv_tpu_and_one_rank(world, gamma):
    want = _jax_engine(world, world["jparams"], gamma, mesh=world["jmesh"])
    one, shape = _port_engine(world, world["pm"], gamma)
    assert one == want
    tokens, tp_shape = world["ranks"][0]["engine"][gamma]
    assert tokens == want and world["ranks"][1]["engine"][gamma][0] == {}  # rank 0 returns the results
    assert tp_shape[2] * 2 == shape[2] and tp_shape[:2] + tp_shape[3:] == shape[:2] + shape[3:]  # kv heads split


def test_tp_shared_prefix_and_int8_engine(world):
    """A shared prefix serves what the full requests do; int8 weights at
    tensor = 2 serve what one rank serves on the same quantized weights."""
    full = world["ranks"][0]["engine"][0][0]
    assert world["ranks"][0]["prefix"][0] == full
    assert world["ranks"][0]["engine8"][0] == _port_engine(world, world["pm8"], 0)[0]


def test_tp_decode_step_collectives(world):
    """2 L + 1 sums (o and down a layer, the embedding) and one gather a step."""
    for rank in world["ranks"]:
        assert rank["step_counts"] == {"sum": 2 * 2 + 1, "gather": 1}


# ---------------------------------------------------------------------------
# the world of 4: tensor x sp, and key/value heads kept whole
# ---------------------------------------------------------------------------

QWEN_LIKE = dict(vocab_size=250, hidden_size=64, intermediate_size=130, num_layers=2, num_heads=8, num_kv_heads=2,
                 head_dim=16, attention_bias=True, tie_word_embeddings=True, max_position_embeddings=512)
RING = dict(head_dim=64, sequence_parallel=True)


def _decoder_pair(seed, **kw):
    jdec = JaxDecoder(jax_tiny_decoder(compute_dtype=jnp.float32, **kw))
    params = _np_tree(jdec.init(jax.random.PRNGKey(seed)))
    dec = LlamaDecoder(tiny_decoder_config(compute_dtype=torch.float32, **kw), device=CPU)
    dec.load_state_dict(state_dict_from_jax(params), strict=True)
    return jdec, params, dec


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.RandomState(5)
    jring, pring, ring = _decoder_pair(3, **RING)
    jq, pq, qwen = _decoder_pair(4, **QWEN_LIKE)
    ids = torch.from_numpy(rng.randint(3, 256, size=(2, 16))).long()
    mask = torch.tensor([[1] * 16, [1] * 11 + [0] * 5])
    qids = torch.from_numpy(rng.randint(3, 250, size=(2, 7))).long()
    inp = dict(ring=dict(cfg=ring.cfg, state=ring.state_dict(), ids=ids, mask=mask),
               kv_whole=dict(cfg=qwen.cfg, state=qwen.state_dict(), ids=qids))
    ranks = spawn_world(torch_sp_workers.tp_world4, 4, inp, tmp_path_factory.mktemp("tp_world4"))
    return dict(jring=jring, pring=pring, jq=jq, pq=pq, ring=ring, qwen=qwen, inp=inp, ranks=ranks)


def test_tensor_times_sp_ring_and_sharded_cache(world4):
    """Each rank's heads through the ring over its sp group, and the cache
    sharded on rows and heads (merv_tpu's P(None, None, tensor, sp, None)),
    as merv_tpu's decoder computes without a mesh."""
    jdec, params, inp = world4["jring"], world4["pring"], world4["inp"]["ring"]
    ids, mask = inp["ids"].numpy(), inp["mask"].numpy()
    want = np.asarray(jax.jit(lambda p, i, m: jdec(p, input_ids=i, attention_mask=m)[0])(params, ids, mask))
    with torch.no_grad():
        prefill_whole, cache = world4["ring"](input_ids=inp["ids"][:1, :8],
                                              kv_cache=KVCache.create(world4["ring"].cfg, 1, 16, torch.float32, CPU))
        step_whole, _ = world4["ring"](input_ids=inp["ids"][:1, 8:9], kv_cache=cache)
    for rank in world4["ranks"]:
        assert _rel(rank["ring/no_cache"], want) <= REL
        c = rank["ring/cache"]
        assert _rel(c["prefill"], prefill_whole) <= REL and _rel(c["step"], step_whole) <= REL
        assert c["sharded"] and c["shape"] == (2, 1, 1, 2 * (8 + 1) // 2, 64)  # 1 of 2 kv heads, 8 rows + scratch


def test_kv_heads_whole_when_they_do_not_split(world4):
    """Qwen-2.5-3B's case: 2 key/value heads over 4 ranks stay whole (and so
    does the cache), each rank's 2 query heads attend their group's head."""
    jdec, params, inp = world4["jq"], world4["pq"], world4["inp"]["kv_whole"]
    cfg = JaxGenConfig(max_new_tokens=6, eos_token_id=1, pad_token_id=0)
    want = np.asarray(jax_generate(jdec, params, input_ids=jnp.asarray(inp["ids"].numpy()), config=cfg))
    with torch.no_grad():
        whole = world4["qwen"](input_ids=inp["ids"])[0]
    for r, rank in enumerate(world4["ranks"]):
        tp = rank["kv_whole/tp"]
        assert (tp["num_heads"], tp["kv_heads"], tp["kv_attend"]) == (2, 2, (r // 2, r // 2 + 1))
        assert (tp["q_rows"], tp["k_rows"], tp["gate_rows"]) == (32, 32, 33 if r < 3 else 31)
        assert tp["vocab_range"] == (63 * r, min(63 * (r + 1), 250))
        assert _rel(rank["kv_whole/logits"], whole) <= REL
        np.testing.assert_array_equal(rank["kv_whole/generate"].numpy(), want)
        assert torch.equal(rank["kv_whole/generate"], rank["kv_whole/generate_whole"])
        (tokens, shape), (whole_tokens, whole_shape) = rank["kv_whole/engine"]["tp"], rank["kv_whole/engine"]["whole"]
        assert shape == whole_shape and shape[2] == 2  # the cache keeps both key/value heads
        if r == 0:
            assert tokens == whole_tokens
        else:
            assert tokens == {}


# ---------------------------------------------------------------------------
# the rules and the memory proof (no world)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("llm_id", sorted(LLM_SPECS))
def test_rule_table_on_every_family(llm_id):
    """merv_tpu's table on the port's names through jax_leaves, for every LLM
    family at its real widths (on the meta device), bf16 and int8 leaves: the
    same spec as merv_tpu's table gives merv_tpu's path, and the port's split
    dim is that spec's dim in torch's (out, in) layout."""
    spec = LLM_SPECS[llm_id]
    cfg = dataclasses.replace(spec.decoder_config, num_layers=2)
    dec = LlamaDecoder(cfg, device="meta")
    rules, jr = PS.llm_tensor_parallel_rules(), jax_rules()
    for quantized in (False, True):
        if quantized:
            for m in dec.modules():
                if type(m).__name__ == "Linear":
                    m.weight = None
                    m.register_buffer("weight_q", torch.empty(m.out_dim, m.in_dim, dtype=torch.int8, device="meta"))
                    m.register_buffer("scale", torch.empty(m.out_dim, device="meta"))
        leaves = PS.jax_leaves(dec)
        dims = PS.tensor_split_dims(dec, leaves)
        tensors = dict(dec.named_parameters())
        tensors.update(dec.named_buffers())
        for name, leaf in leaves.items():
            want = jr.spec_for(jax_path_str(leaf.path.split("/")))
            assert rules.spec_for(leaf.path) == (None if want is None else tuple(want)), name
            part = name.split(".")[-2]
            col = part in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head", "embed_tokens")
            row = part in ("o_proj", "down_proj") and name.endswith(("weight", "weight_q"))
            expect = 0 if col and not name.endswith("norm.weight") else 1 if row else None
            assert dims[name] == expect, (name, dims[name])
            if dims[name] is not None:
                assert tensors[name].shape[dims[name]] in (cfg.q_dim, cfg.kv_dim, cfg.intermediate_size,
                                                            cfg.vocab_size), name
        if cfg.tie_word_embeddings:
            assert "lm_head.weight" not in dims and dims["embed_tokens.weight"] == 0


def _jax_per_device_bytes(llm: str, tensor: int, layers: int) -> int:
    """merv_tpu's ``lower_serving`` weight bytes a device: its serving tree's
    shapes (``eval_shape``, packed at tensor 1, int8) under the rule table's
    shard shapes on a tensor mesh of virtual devices; no XLA compile."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from merv_tpu.models.backbones.llm.transformer import LLAMA2_7B, LLAMA2_13B, pack_serving_params
    from merv_tpu.nn.quantization import quantize_tree as jax_quantize_tree

    base = LLAMA2_13B if llm == "13b" else LLAMA2_7B
    cfg = dataclasses.replace(base, num_layers=layers, param_dtype=jnp.bfloat16)
    dec = JaxDecoder(cfg)

    def assemble(p):
        return jax_quantize_tree(pack_serving_params(p) if tensor <= 1 else p)

    tree = jax.eval_shape(lambda: assemble(dec.init(jax.random.PRNGKey(0))))
    mesh = jax_build_mesh(JaxMeshConfig(data=1, fsdp=-1, tensor=tensor))
    rules = jax_rules()
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        s = rules.spec_for(jax_path_str(path), leaf)
        shape = NamedSharding(mesh, s if s is not None else P()).shard_shape(leaf.shape)
        total += int(np.prod(shape)) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("llm, tensor", [("13b", 2), ("7b", 1)])
def test_serving_memory_proof_weights_match_merv_tpu(llm, tensor, tmp_path):
    layers = 2
    out = tmp_path / "proof.json"
    assert MP.main(["--stage", "serving", "--llm", llm, "--mesh-tensor", str(tensor), "--llm-layers", str(layers),
                    "--slots", "2", "--max-len", "128", "--prefill-bucket", "64", "--json-out", str(out)]) == 0
    r = json.loads(out.read_text())["stages"]["serving"]["ranks"][0]
    assert r["weights_bytes"] == _jax_per_device_bytes(llm, tensor, layers)
    assert r["packed"] == (tensor == 1) and r["int8_weights"]
    assert r["decode_chunk_gib"] > r["weights_gib"] + r["cache_gib"] and r["prefill_gib"] > r["weights_gib"]


def test_split_dims_of_a_quantized_decoder():
    """Column-split Linears split weight dim 0 with their bias and scale;
    row-split ones weight dim 1 with the scale whole."""
    dec = LlamaDecoder(tiny_decoder_config(attention_bias=True), device=CPU)
    quantize_tree(dec)
    dims = PS.tensor_split_dims(dec)
    assert dims["layers.0.attn.q_proj.weight_q"] == 0 and dims["layers.0.attn.q_proj.scale"] == 0
    assert dims["layers.0.attn.k_proj.bias"] == 0 and dims["layers.1.mlp.up_proj.scale"] == 0
    assert dims["layers.0.attn.o_proj.weight_q"] == 1 and dims["layers.0.attn.o_proj.scale"] is None
    assert dims["layers.1.mlp.down_proj.weight_q"] == 1 and dims["layers.1.mlp.down_proj.scale"] is None
    assert dims["lm_head.weight_q"] == 0 and dims["lm_head.scale"] == 0 and dims["embed_tokens.weight"] == 0
    assert dims["final_norm.weight"] is None and dims["layers.0.input_norm.weight"] is None
