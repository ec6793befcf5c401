"""Evaluation drivers: ``python -m merv_tpu_torch.cli.eval_mcq`` and
``python -m merv_tpu_torch.cli.eval_openended`` (counterparts of
``scripts/eval_mcq.py`` and ``scripts/eval_openended.py``)."""
