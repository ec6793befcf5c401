"""Seeding and dataloader-worker RNG isolation (counterpart of
``merv_tpu/util/seed_utils.py``): one global seed for python / numpy / torch,
and a ``worker_init_fn`` that derives independent, deterministic per-worker
seeds."""

from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np
import torch


def set_global_seed(seed: int, get_worker_init_fn: bool = False) -> Optional[Callable[[int], None]]:
    """Sets the seed of python, numpy and torch (CPU and every card)."""
    assert np.iinfo(np.uint32).min < seed < np.iinfo(np.uint32).max, "Seed outside the np.uint32 range!"
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return worker_init_function if get_worker_init_fn else None


def worker_init_function(worker_id: int) -> None:
    """Per-worker seeds from a SeedSequence over (base seed, worker id)."""
    process_seed = torch.initial_seed()
    base_seed = process_seed - worker_id
    seed_seq = np.random.SeedSequence([base_seed, worker_id])
    np.random.seed(seed_seq.generate_state(4))
    torch_seed_seq, random_seed_seq = seed_seq.spawn(2)
    torch.manual_seed(int(torch_seed_seq.generate_state(1, dtype=np.uint64)[0]))
    random_seed = (random_seed_seq.generate_state(2, dtype=np.uint64).astype(object) * [1 << 64, 1]).sum()
    random.seed(random_seed)
