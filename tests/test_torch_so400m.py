"""SigLIP so400m's frames (hidden 1152, 16 heads of 72, 256 tokens at 224 px)
through the towers' "small" plan, in bf16: merv_tpu's ViT runs its Pallas
kernel B1 (``small_attention_kt``) in interpret mode, the port's ViT its K1
path (``SmallAttentionKt``), which takes the plain version on the CPU. Real
widths, 2 layers, 2 frames, weights from merv_tpu's init through the bridge,
frames from a numpy seed. Also the dispatch plans at head dims 64, 72 and
others against merv_tpu's.

bf16 tolerance: the two packages round the same products at other places
(XLA's fused bf16 GEMMs and softmax against torch's), so after 2 layers the
outputs (|x| up to 3.75 here) are held to a relative L2 difference <= 2e-2
and an elementwise |out - ref| <= 0.125 + 2^-5 |ref| (a few bf16 ulps of the
largest values); on this input the pair measured 6.8e-3 and at most 0.031
(0.19 of the elementwise limit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.models.backbones.video.vit as V
import merv_tpu.ops.attention as A
import merv_tpu_torch.ops.attention as PA
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.video import vit as PV


def test_so400m_frames_in_bf16_match_merv_tpus_small_kernel(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(V, "can_use_pallas", lambda: True)  # interpret mode keeps the Pallas kernel on the CPU
    cfg = dataclasses.replace(V.SIGLIP_SO400M_224, num_layers=2)
    assert (cfg.head_dim, cfg.seq_len) == (72, 256)
    vit = V.VisionTransformer(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(vit.init)(jax.random.PRNGKey(0)))
    calls = {"pallas": 0, "port": 0}
    pallas_kt = A.small_attention_kt

    def counted_pallas(*a):
        calls["pallas"] += 1
        return pallas_kt(*a)

    monkeypatch.setattr(V, "small_attention_kt", counted_pallas)
    frames = np.random.RandomState(0).randn(2, 3, 224, 224).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: vit(p, x))(params, jnp.asarray(frames)).astype(jnp.float32))
    assert calls["pallas"] == 1  # traced once inside the layer scan

    port = PV.VisionTransformer(dataclasses.replace(PV.SIGLIP_SO400M_224, num_layers=2), device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port_plain = PA.small_attention_kt_plain

    def counted_plain(*a):
        calls["port"] += 1
        return port_plain(*a)

    monkeypatch.setattr(PA, "small_attention_kt_plain", counted_plain)
    with torch.inference_mode():
        out = port(torch.from_numpy(frames)).float().numpy()
    assert calls["port"] == 2  # one K1 call a layer, on the CPU its plain version
    assert out.shape == ref.shape == (2, 256, 1152)
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel <= 2e-2, rel
    np.testing.assert_array_less(np.abs(out - ref), 0.125 + 2.0 ** -5 * np.abs(ref))


# (T, D): the towers' lengths around the small plan's bounds, at the head dims the kernels take and others
PLAN_ROWS = [(T, D) for T in (196, 223, 224, 229, 256, 257, 261, 512, 513) for D in (64, 72, 80, 96, 128)]


@pytest.mark.parametrize("T,D", PLAN_ROWS)
def test_small_plan_by_head_dim(T, D):
    """Self-shaped, unmasked, non-causal tower frames: "small" for 224 <= T <= 512
    at head dims 64 and 72, as merv_tpu plans it (it plans D <= 128); other head
    dims stay plain, where no registered tower reaches them."""
    kw = dict(causal=False, has_bias=False, self_shaped=True)
    want = A.dispatch_plan(T, T, D, has_q_offset=False, on_tpu=True, **kw)
    got = PA.dispatch_plan(T, T, D, **kw)
    if D in PA.SMALL_HEAD_DIMS:
        assert got == {"small": "small", "xla": "plain"}[want]
    else:
        assert got == "plain"
    assert PA.dispatch_plan(T, T, D, has_mask=True, **kw) == "plain"
