"""Training metrics and trackers (counterpart of ``merv_tpu/training/metrics.py``).

The ``Tracker`` protocol; :class:`JSONLinesTracker` (``run-metrics.jsonl``
with the hyperparameters, ``{run_id}.jsonl`` with one line per pushed step);
:class:`WeightsBiasesTracker`, import-gated (an air-gapped run disables it);
and :class:`Metrics`, with the smoothed loss over a 128-step window, the raw
loss, the step time, the learning rate and the hours left. In a multi-rank
world the trackers write on rank zero only (``merv_tpu``'s ``rank_zero_only``):
the loss every rank commits is the whole batch's.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Optional, Protocol, Tuple, Union

import numpy as np

from merv_tpu_torch.overwatch import initialize_overwatch
from merv_tpu_torch.parallel.mesh import world

overwatch = initialize_overwatch(__name__)


def rank_zero_only(fn):
    """``fn`` runs on rank zero of the world (read at the call), other ranks get None."""

    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs) if world()[0] == 0 else None

    return wrapped


class Tracker(Protocol):
    def write_hyperparameters(self) -> None: ...

    def write(self, global_step: int, metrics: Dict[str, Union[int, float]]) -> None: ...

    def finalize(self) -> None: ...


class JSONLinesTracker:
    def __init__(self, run_id: str, run_dir: Path, hparams: Dict[str, Any]) -> None:
        self.run_id, self.run_dir, self.hparams = run_id, Path(run_dir), hparams

    @rank_zero_only
    def write_hyperparameters(self) -> None:
        with open(self.run_dir / "run-metrics.jsonl", "w") as f:
            f.write(json.dumps({"run_id": self.run_id, "hparams": self.hparams}, sort_keys=True, default=str) + "\n")

    @rank_zero_only
    def write(self, _: int, metrics: Dict[str, Union[int, float]]) -> None:
        with open(self.run_dir / f"{self.run_id}.jsonl", "a") as f:
            f.write(json.dumps(metrics, sort_keys=True, default=str) + "\n")

    def finalize(self) -> None:
        return


class WeightsBiasesTracker:
    def __init__(
        self,
        run_id: str,
        run_dir: Path,
        hparams: Dict[str, Any],
        project: str = "merv",
        entity: Optional[str] = None,
        group: str = "align",
    ) -> None:
        self.run_id, self.run_dir, self.hparams = run_id, Path(run_dir), hparams
        self.project, self.entity, self.group = project, entity, group
        self._wandb = None
        if world()[0] != 0:  # rank zero logs
            return
        try:
            import wandb

            wandb.init(name=run_id, dir=str(self.run_dir), config=hparams, project=project, entity=entity, group=group)
            self._wandb = wandb
        except Exception as e:  # no package, or no network: the tracker is off
            overwatch.info(f"wandb unavailable ({type(e).__name__}); WeightsBiasesTracker disabled")

    def write_hyperparameters(self) -> None:
        if self._wandb is not None:
            self._wandb.config = self.hparams

    def write(self, global_step: int, metrics: Dict[str, Union[int, float]]) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=global_step)

    def finalize(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


class Metrics:
    def __init__(
        self,
        active_trackers: Tuple[str, ...],
        run_id: str,
        run_dir: Path,
        hparams: Dict[str, Any],
        stage: str,
        wandb_project: str = "merv",
        wandb_entity: Optional[str] = None,
        grad_accumulation_steps: int = 1,
        window_size: int = 128,
        total_steps: int = -1,
    ) -> None:
        self.run_id, self.run_dir, self.hparams, self.stage = run_id, Path(run_dir), hparams, stage
        self.total_steps = total_steps
        self.trackers = []
        for tracker_type in active_trackers:
            if tracker_type == "jsonl":
                tracker: Tracker = JSONLinesTracker(run_id, run_dir, hparams)
            elif tracker_type == "wandb":
                tracker = WeightsBiasesTracker(
                    run_id, run_dir, hparams, project=wandb_project, entity=wandb_entity, group=stage
                )
            else:
                raise ValueError(f"Tracker with type `{tracker_type}` is not supported!")
            tracker.write_hyperparameters()
            self.trackers.append(tracker)

        self.global_step, self.start_time, self.step_start_time = 0, time.time(), time.time()
        self.state: Dict[str, Any] = {
            "loss_raw": deque(maxlen=max(grad_accumulation_steps, 1)),
            "loss": deque(maxlen=window_size),
            "step_time": deque(maxlen=window_size),
            "lr": [],
        }

    def log(self, global_step: int, metrics: Dict[str, Union[int, float]]) -> None:
        for tracker in self.trackers:
            tracker.write(global_step, metrics)

    def get_status(self, loss: Optional[float] = None) -> str:
        lr = self.state["lr"][-1] if self.state["lr"] else 0
        if loss is None:
            return f"=>> [Global Step] {self.global_step:06d} =>> LR :: {lr:.6f}"
        return f"=>> [Global Step] {self.global_step:06d} =>> LR :: {lr:.6f} -- Loss :: {loss:.4f}"

    def commit(
        self, *, global_step: Optional[int] = None, lr: Optional[float] = None, update_step_time: bool = False, **kwargs
    ) -> None:
        if global_step is not None:
            self.global_step = global_step
        if lr is not None:
            self.state["lr"].append(float(lr))
        if update_step_time:
            self.state["step_time"].append(time.time() - self.step_start_time)
            self.step_start_time = time.time()
        for key, value in kwargs.items():
            value = float(value)
            if key == "loss":
                self.state["loss_raw"].append(value)
                self.state["loss"].append(value)
            else:
                self.state.setdefault(key, []).append(value)

    def push(self) -> str:
        loss_raw = float(np.mean(list(self.state["loss_raw"])))
        loss = float(np.mean(list(self.state["loss"])))
        step_time = float(np.mean(list(self.state["step_time"]))) if self.state["step_time"] else 0.0
        prefix = self.stage.capitalize()
        self.log(
            self.global_step,
            metrics={
                f"{prefix}/Step": self.global_step,
                f"{prefix}/Loss": loss,
                f"{prefix}/Loss (Raw)": loss_raw,
                f"{prefix}/Learning Rate": self.state["lr"][-1],
                f"{prefix}/Step Time": step_time,
                f"{prefix}/Left Time": (
                    (time.time() - self.start_time)
                    * ((self.total_steps - self.global_step) / (self.global_step + 0.01))
                ) / 3600,
            },
        )
        return self.get_status(loss)

    def finalize(self) -> None:
        for tracker in self.trackers:
            tracker.finalize()
