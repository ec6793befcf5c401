"""Command-line entry points: the evaluation drivers ``python -m
merv_tpu_torch.cli.eval_mcq`` and ``python -m merv_tpu_torch.cli.eval_openended``
(counterparts of ``scripts/eval_mcq.py`` and ``scripts/eval_openended.py``),
the server ``python -m merv_tpu_torch.cli.serve`` and the trainer ``python -m
merv_tpu_torch.cli.pretrain`` (of ``scripts/pretrain_video.py``)."""
