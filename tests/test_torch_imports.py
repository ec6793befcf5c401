"""The port stands alone: it imports neither JAX nor merv_tpu, and its entry
points never carry on on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "merv_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]

_RUN_TINY_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np, torch
from merv_tpu_torch.device import make_generator
from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
from merv_tpu_torch.models.backbones.video import DinoV2VideoBackbone
from merv_tpu_torch.models.backbones.video.vit import tiny_vit_config
from merv_tpu_torch.models.vidlms import MERV
from merv_tpu_torch.nn.core import init_weights
import merv_tpu_torch.bridge, merv_tpu_torch.models.materialize, merv_tpu_torch.conf
import merv_tpu_torch.training, merv_tpu_torch.training.checkpointing, merv_tpu_torch.training.train_step
import merv_tpu_torch.util.batching_utils, merv_tpu_torch.util.data_utils, merv_tpu_torch.util.seed_utils
import merv_tpu_torch.ops.fused_vit_block, merv_tpu_torch.ops.attention
import merv_tpu_torch.native, merv_tpu_torch.preprocessing.video_io, merv_tpu_torch.quick_start
import merv_tpu_torch.models.load_vid, merv_tpu_torch.models.ckpt_import, merv_tpu_torch.models.registry
import merv_tpu_torch.models.backbones.video.vision_import, merv_tpu_torch.models.backbones.llm.hf_import
import merv_tpu_torch.util.safetensors_io
import merv_tpu_torch.cli.eval_mcq, merv_tpu_torch.cli.eval_openended, merv_tpu_torch.conf.registry
import merv_tpu_torch.util.prefetch, merv_tpu_torch.util.flops_utils
import merv_tpu_torch.serving, merv_tpu_torch.serving.engine, merv_tpu_torch.cli.serve
import merv_tpu_torch.nn.quantization, merv_tpu_torch.ops.int8_linear, merv_tpu_torch.ops.decode_attention
import merv_tpu_torch.benchkit, merv_tpu_torch.bench.decode, merv_tpu_torch.bench.train, merv_tpu_torch.bench.serving
import merv_tpu_torch.bench.breakdown, merv_tpu_torch.bench.tower_attn, merv_tpu_torch.bench.tower_ops
import merv_tpu_torch.bench.loader, merv_tpu_torch.bench.vidlm_prefix, merv_tpu_torch.cli.make_randinit_run
import merv_tpu_torch.cli.export_towers, merv_tpu_torch.cli.preprocess
import merv_tpu_torch.parallel, merv_tpu_torch.parallel.mesh, merv_tpu_torch.parallel.sharding
import merv_tpu_torch.ops.ring_attention
from merv_tpu_torch.parallel import VirtualMesh, activation_mesh
q = torch.randn(1, 2, 16, 8)
out = merv_tpu_torch.ops.ring_attention.ring_attention(q, q, q, VirtualMesh(2), causal=True, zigzag=True)
assert out.shape == q.shape
from merv_tpu_torch.models.generation import GenerationConfig
from merv_tpu_torch.serving import ContinuousBatchingEngine, Request
from merv_tpu_torch import available_models, load_vid
assert "merv-full" in available_models()

tower = DinoV2VideoBackbone("dinov2-video-all-tokens", "resize-naive", 32, 4,
                            vit_config=tiny_vit_config(num_cls_tokens=1, num_register_tokens=4), device="cpu")
model = MERV("tiny", [tower], tiny_llm_backbone(device="cpu"), arch_specifier="3davg+linear",
             projector_token_length=4, visual_feature_length=16, device="cpu")
init_weights(model, make_generator(torch.device("cpu"), 0))
video = np.random.default_rng(0).integers(0, 256, size=(8, 40, 48, 3), dtype=np.uint8)
text = model.generate(video, "In: hi\nOut:", max_new_tokens=4)
assert isinstance(text, str)
text = model.generate("assets/video_demo.mp4", "In: hi\nOut:", max_new_tokens=4, clip_end_sec=3.0)
assert isinstance(text, str)
texts = model.generate_batch_shared(video, ["In: hi\nOut:", "In: what?\nOut:"], max_new_tokens=3, pad_to_batch=3)
assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
picks = model.score_options([video, None], ["In: hi\nOut:", "In: a?\nOut:"], [["A", "B"], ["A", "B", "C"]])
assert picks[0] in ("A", "B") and picks[1] in ("A", "B", "C")
engine = ContinuousBatchingEngine.for_vidlm(model, slots=2, max_len=128, length_bucket=8, speculative_gamma=2)
engine.register_prefix_video("v", video)
served = engine.run([Request("a", prompt_text="In: hi\nOut:", prefix_id="v", max_new_tokens=3),
                     Request("b", prompt_text="In: what?\nOut:", max_new_tokens=3)])
assert sorted(served) == ["a", "b"] and all(r.finish_reason != "error" for r in served.values())
merv_tpu_torch.nn.quantization.quantize_tree(model.llm_backbone)
text = model.generate(video, "In: hi\nOut:", max_new_tokens=4, kv_cache_dtype="int8")
assert isinstance(text, str)
engine = ContinuousBatchingEngine.for_vidlm(model, slots=2, max_len=128, length_bucket=8,
                                            config=GenerationConfig(max_new_tokens=3, kv_cache_dtype="int8"))
served = engine.run([Request("c", prompt_text="In: hi\nOut:", video=video, max_new_tokens=3)])
assert served["c"].finish_reason != "error"
model.llm_backbone.sequence_parallel = True
with activation_mesh(VirtualMesh(2)):
    text = model.generate(video, "In: hi\nOut:", max_new_tokens=4, mesh=VirtualMesh(2))
assert isinstance(text, str)
loaded = [m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in ("jax", "merv_tpu")]
assert not loaded, loaded
print("OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_TINY_WITHOUT_JAX], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_merv_tpu_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "merv_tpu")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    from merv_tpu_torch import load_vid
    from merv_tpu_torch.device import resolve_device
    from merv_tpu_torch.models.backbones.llm.base_llm import tiny_llm_backbone
    from merv_tpu_torch.models.materialize import get_llm_backbone_and_tokenizer, get_video_backbone_and_transform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        get_video_backbone_and_transform(["dinov2-video-all-tokens"], "resize-naive", [16])
    with pytest.raises(RuntimeError):
        get_llm_backbone_and_tokenizer("llama2-7b-pure")
    with pytest.raises(RuntimeError):
        tiny_llm_backbone()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_vid(tmp_path)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from merv_tpu_torch.cli.serve import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(args=["--model_path", str(tmp_path), "--requests", str(tmp_path / "r.jsonl")])
    from merv_tpu_torch import benchkit
    from merv_tpu_torch.bench import breakdown, decode, loader, serving, tower_attn, tower_ops, train, vidlm_prefix
    from merv_tpu_torch.cli import export_towers, make_randinit_run

    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchkit.build_model(2)
    for mod in (decode, train, serving, breakdown, tower_attn, tower_ops, loader, vidlm_prefix):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_randinit_run.write_run_dir(tmp_path / "run")
    assert not (tmp_path / "run").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_towers.main(["--out", str(tmp_path / "towers")])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
