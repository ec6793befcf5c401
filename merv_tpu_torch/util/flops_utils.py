"""FLOPs and parameter accounting (counterpart of ``merv_tpu/util/flops_utils.py``).

``merv_tpu`` reads XLA's cost analysis of its compiled forward. The port
counts with ``torch.utils.flop_counter.FlopCounterMode`` over one eager
forward: 2·M·N·K for every matrix product and convolution, nothing for
elementwise work, softmax or normalisation, where XLA's count includes them.
The two counts therefore differ by definition; ``tests/test_torch_eval.py``
holds their ratio on a tiny model. The hand-written kernels are opaque to
the counter, so the forward runs the plain versions (``attn_impl="plain"``),
whose products it sees.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def get_statistics(
    vidlm: Any,
    num_frames: Optional[List[int]] = None,
    seq_len: Optional[int] = None,
    batch: int = 1,
) -> Tuple[float, int]:
    """(forward GFLOPs, total parameter count) of ``vidlm`` on its device, at
    ``llm_max_length`` (text tokens plus the visual tokens) unless ``seq_len``
    gives the text length, on zero videos at each tower's default resolution
    (which sets its frames; ``num_frames`` is accepted for ``merv_tpu``'s
    signature, which ignores it too)."""
    n_params = sum(p.numel() for p in vidlm.parameters())
    T = seq_len or vidlm.llm_backbone.llm_max_length - vidlm.visual_feature_length
    dev = vidlm.device
    input_ids = torch.ones((batch, T), dtype=torch.long, device=dev)
    attention_mask = torch.ones((batch, T), dtype=torch.long, device=dev)
    videos = [torch.zeros((batch, *vb.default_video_resolution), dtype=torch.float32, device=dev)
              for vb in vidlm.video_backbones]
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        vidlm.forward(input_ids, attention_mask, videos, attn_impl="plain")
    return counter.get_total_flops() / 1e9, n_params
