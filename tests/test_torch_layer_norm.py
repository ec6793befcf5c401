"""Where LayerNorm's forward goes: the one-pass kernel (K6) or the plain formula.

``ops.layer_norm.layer_norm`` sends a call to the kernel only for bf16 CUDA
tensors of the kernel's widths, fp32 or bf16 w and b, with no gradient to
compute; everything else keeps the plain formula. The CPU has no kernel, so
each case checks that on the CPU the output is the plain formula's bit for
bit with nothing counted and the kernel's wrapper refusing the call, then the
rule (``takes_kernel``) as the card would see the call and that
``layer_norm`` hands the kernel exactly those calls (its launcher stubbed by
the plain version); two tiny towers are held bit for
bit against themselves with every norm forced through the plain formula.
The kernel itself is held on the card (``tests/test_torch_kernels_cuda.py``).
"""

import contextlib

import numpy as np
import pytest
import torch

import merv_tpu_torch.ops.attention as A
import merv_tpu_torch.ops.layer_norm as LN
from merv_tpu_torch.device import make_generator
from merv_tpu_torch.models.backbones.video import DinoV2VideoBackbone, LangBindVideoBackbone
from merv_tpu_torch.models.backbones.video.vit import tiny_vit_config
from merv_tpu_torch.nn.core import LayerNorm, init_weights

CPU = torch.device("cpu")
BF16, FP32, FP16 = torch.bfloat16, torch.float32, torch.float16

# (id, x dtype, width, w and b dtypes, what needs a gradient, grad mode, whether the card takes the kernel)
CALLS = [
    ("bf16_768_fp32_weights", BF16, 768, (FP32, FP32), (), "grad", True),
    ("bf16_1024_fp32_weights", BF16, 1024, (FP32, FP32), (), "grad", True),
    ("bf16_1152_fp32_weights", BF16, 1152, (FP32, FP32), (), "grad", True),
    ("bf16_1024_bf16_weights", BF16, 1024, (BF16, BF16), (), "grad", True),
    ("bf16_1024_trainable_under_no_grad", BF16, 1024, (FP32, FP32), ("x", "weight"), "no_grad", True),
    ("bf16_768_trainable_under_inference_mode", BF16, 768, (FP32, FP32), ("weight",), "inference", True),
    ("fp32_x", FP32, 1024, (FP32, FP32), (), "grad", False),
    ("fp16_x", FP16, 1024, (FP32, FP32), (), "grad", False),
    ("width_64", BF16, 64, (FP32, FP32), (), "grad", False),
    ("width_512", BF16, 512, (FP32, FP32), (), "grad", False),
    ("width_1280", BF16, 1280, (FP32, FP32), (), "grad", False),
    ("x_needs_grad", BF16, 1024, (FP32, FP32), ("x",), "grad", False),
    ("weight_needs_grad", BF16, 768, (FP32, FP32), ("weight",), "grad", False),
    ("bias_needs_grad", BF16, 1152, (FP32, FP32), ("bias",), "grad", False),
    ("fp16_weights", BF16, 1024, (FP16, FP16), (), "grad", False),
    ("mixed_weights", BF16, 1024, (FP32, BF16), (), "grad", False),
]
TOWERS = ["tower_dinov2", "tower_languagebind"]


def _call(dtype, width, wdtypes, trainable, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((3, 5, width)).astype(np.float32) * 2 + 0.5).to(dtype)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(width).astype(np.float32)).to(wdtypes[0])
    b = torch.from_numpy(0.1 * rng.standard_normal(width).astype(np.float32)).to(wdtypes[1])
    for name, t in (("x", x), ("weight", w), ("bias", b)):
        t.requires_grad_(name in trainable)
    return x, w, b


def _mode(mode):
    return {"grad": contextlib.nullcontext, "no_grad": torch.no_grad, "inference": torch.inference_mode}[mode]()


def _tower(name):
    if name == "tower_dinov2":
        vb = DinoV2VideoBackbone("dinov2-video-all-tokens", "resize-naive", default_image_size=32, num_frames=4,
                                 vit_config=tiny_vit_config(num_cls_tokens=1, num_register_tokens=4, use_layerscale=True,
                                                            compute_dtype=BF16), device=CPU)
    else:
        vb = LangBindVideoBackbone("languagebind-video-noclass", "resize-naive", default_image_size=32, num_frames=4,
                                   vit_config=tiny_vit_config(num_cls_tokens=1, pre_norm=True, patch_bias=False,
                                                              temporal_attn=True, temporal_frames=4, act="quick_gelu",
                                                              compute_dtype=BF16), device=CPU)
    init_weights(vb, make_generator(CPU, 7))
    for m in vb.modules():  # norm scales and biases away from 1 and 0, so that the affine map counts
        if isinstance(m, LayerNorm):
            with torch.no_grad():
                m.weight.normal_(1.0, 0.1, generator=make_generator(CPU, 8))
                m.bias.normal_(0.0, 0.1, generator=make_generator(CPU, 9))
    video = torch.from_numpy(np.random.default_rng(1).standard_normal((2, *vb.default_video_resolution))
                             .astype(np.float32))
    return vb.eval(), video


@pytest.mark.parametrize("case", CALLS + TOWERS, ids=lambda c: c if isinstance(c, str) else c[0])
def test_layer_norm_route(case, monkeypatch):
    A.reset_launch_counts()
    if isinstance(case, str):  # a tower forward on the CPU: plain norms, nothing counted, the same bits
        vb, video = _tower(case)
        with torch.no_grad():
            out = vb(video)
            assert A.launch_counts()["layer_norm"] == 0
            monkeypatch.setattr(LayerNorm, "forward", lambda m, x: LN.layer_norm_plain(x, m.weight, m.bias, m.eps))
            ref = vb(video)
        assert out.dtype == BF16 and torch.equal(out, ref)
        return

    _, dtype, width, wdtypes, trainable, mode, kernel = case
    x, w, b = _call(dtype, width, wdtypes, trainable)
    needs_grad = mode == "grad" and bool(trainable)

    # on the CPU: the plain formula, bit for bit, nothing counted, autograd intact where asked for; the kernel's
    # wrapper refuses the call
    with _mode(mode):
        assert LN.takes_kernel(x, w, b) is False
        out = LN.layer_norm(x, w, b, 1e-6)
        ref = LN.layer_norm_plain(x, w, b, 1e-6)
        with pytest.raises(ValueError):
            LN.layer_norm_one_pass(x, w, b, 1e-6)
    assert out.dtype == dtype and torch.equal(out, ref)
    assert A.launch_counts()["layer_norm"] == 0
    assert (out.grad_fn is not None) is needs_grad

    # as the card would see the call (the rule's device taken to be this one): the rule, and the launcher gets
    # exactly the calls the rule gives it
    calls = []
    monkeypatch.setattr(LN, "_KERNEL_DEVICE", CPU.type)
    monkeypatch.setattr(LN, "layer_norm_one_pass", lambda *a: calls.append(a) or LN.layer_norm_plain(*a))
    with _mode(mode):
        assert LN.takes_kernel(x, w, b) is kernel
        assert torch.equal(LN.layer_norm(x, w, b, 1e-5), LN.layer_norm_plain(x, w, b, 1e-5))
    assert len(calls) == int(kernel)
    if kernel:
        assert calls[0][0] is x and calls[0][1] is w and calls[0][2] is b and calls[0][3] == 1e-5
