"""Checkpoint save / load / resume (counterpart of ``merv_tpu/training/checkpointing.py``).

The layout and names of ``merv_tpu``: ``<run_dir>/checkpoints/
step-{:06d}-epoch-{:02d}-loss={:.4f}/`` with a ``meta.json`` (step, epoch,
loss, module keys) and a ``latest-checkpoint`` symlink, written last so it
never points at a torn directory. The port's format inside the directory is
its own: one ``torch.save`` file, ``checkpoint.pt``, holding ``model`` (the
state dicts of the trainable top-level modules, by module key) and
``optimizer`` (the optimizer's state dict).

Saves block by default. ``save_checkpoint(..., blocking=False)`` (the
strategy's periodic saves, as in ``merv_tpu``) copies the tensors to host
memory, hands the write to a background thread and returns: at most one
write is in flight, and every save first waits for it. ``meta.json`` and the
``latest-checkpoint`` pointer are written only once the write is done
(:func:`wait_for_checkpoints`, or the next save), so the pointer never moves
backward and a directory torn by a crash (no ``meta.json``) is never picked by
:func:`latest_checkpoint`. Each async save's times are kept in
:data:`ASYNC_SAVES`.

:func:`load_checkpoint` also reads ``merv_tpu``'s Orbax checkpoints, without
JAX: ``_METADATA`` lists each leaf's key path, and each array is opened with
``tensorstore`` (zarr or zarr3, in an OCDBT store or one directory per
array, as ``_METADATA`` says). The parameter trees come back as the port's
``state_dict``s (by :mod:`merv_tpu_torch.bridge`), bf16 as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from merv_tpu_torch.bridge import module_state_dicts
from merv_tpu_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

_CKPT_RE = re.compile(r"step-(\d+)-epoch-(\d+)-loss=([0-9.]+)")
CKPT_FILE = "checkpoint.pt"


# The async save in flight: (directory, meta, writer thread, its error or
# None, its record in ASYNC_SAVES), finalized by wait_for_checkpoints.
_pending: Optional[Tuple[Path, Dict[str, Any], threading.Thread, List[BaseException], Dict[str, Any]]] = None
# One record per async save: the directory, ``copy_s`` (the host copy, which
# the caller waits for), ``write_s`` (the background write) and ``waited_s``
# (how long the next save or wait_for_checkpoints waited on it: 0 when the
# write was done by then, i.e. it overlapped the steps in between entirely).
ASYNC_SAVES: List[Dict[str, Any]] = []


def _host_copy(tree: Any) -> Any:
    """Every tensor of a nested dict / list / tuple copied to host memory (a
    copy even for a CPU tensor, which training may update in place while the
    write runs)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _finalize(target: Path, meta: Dict[str, Any]) -> None:
    with open(target / "meta.json", "w") as f:
        json.dump(meta, f)
    latest = target.parent / "latest-checkpoint"
    if latest.is_symlink() or latest.exists():
        latest.unlink() if latest.is_symlink() else shutil.rmtree(latest)
    latest.symlink_to(target.name)
    overwatch.info(f"Saved checkpoint {target}")


def wait_for_checkpoints() -> None:
    """Wait for the async save in flight, if any, then write its meta.json and
    point ``latest-checkpoint`` at it; raise if its write failed (the
    directory is then left without meta.json). Call before reading a
    checkpoint just saved async, and at the end of training."""
    global _pending
    if _pending is None:
        return
    target, meta, thread, errors, record = _pending
    _pending = None
    t = time.perf_counter()
    thread.join()
    record["waited_s"] = time.perf_counter() - t
    if errors:
        raise RuntimeError(f"the async write of checkpoint {target} failed") from errors[0]
    _finalize(target, meta)


def save_checkpoint(
    run_dir: Path,
    step: int,
    epoch: int,
    loss: float,
    model: nn.Module,
    trainable_keys: List[str],
    optimizer: Optional[Any] = None,
    blocking: bool = True,
) -> Path:
    """Write ``checkpoints/step-...-loss=.../`` and point ``latest-checkpoint`` at it.

    ``blocking=False`` copies the state to host memory and writes on a
    background thread; meta.json and the pointer follow in
    :func:`wait_for_checkpoints` or the next save."""
    global _pending
    ckpt_root = Path(run_dir) / "checkpoints"
    ckpt_root.mkdir(parents=True, exist_ok=True)
    target = ckpt_root / f"step-{step:06d}-epoch-{epoch:02d}-loss={loss:.4f}"
    modules = {k: m for k, m in model.named_children() if k in trainable_keys}
    meta = {"step": step, "epoch": epoch, "loss": loss, "module_keys": sorted(modules)}
    # the save in flight first, in both modes: a blocking save racing it would
    # let its later finalize move the pointer backward
    wait_for_checkpoints()
    if target.exists():
        shutil.rmtree(target)
    target.mkdir()
    t = time.perf_counter()
    tree: Dict[str, Any] = {"model": {k: _host_copy(m.state_dict()) for k, m in modules.items()}}
    if optimizer is not None:
        tree["optimizer"] = _host_copy(optimizer.state_dict())
    if blocking:
        torch.save(tree, target / CKPT_FILE)
        _finalize(target, meta)
        return target

    record: Dict[str, Any] = {"checkpoint": target.name, "copy_s": time.perf_counter() - t}
    errors: List[BaseException] = []

    def write() -> None:
        start = time.perf_counter()
        try:
            torch.save(tree, target / CKPT_FILE)
        except BaseException as e:  # reported by wait_for_checkpoints, on the caller's thread
            errors.append(e)
        record["write_s"] = time.perf_counter() - start

    thread = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=True)
    thread.start()
    _pending = (target, meta, thread, errors, record)
    ASYNC_SAVES.append(record)
    overwatch.info(f"Async checkpoint {target} dispatched", ctx_level=1)
    return target


def parse_checkpoint_name(path: Path) -> Tuple[int, int]:
    """(step, epoch) from the checkpoint's directory name, else its meta.json."""
    m = _CKPT_RE.search(Path(path).name)
    if m is None:
        meta = Path(path) / "meta.json"
        if meta.exists():
            d = json.loads(meta.read_text())
            return int(d["step"]), int(d["epoch"])
        raise ValueError(f"cannot parse step/epoch from {path}")
    return int(m.group(1)), int(m.group(2))


def latest_checkpoint(run_dir: Path) -> Optional[Path]:
    """The ``latest-checkpoint`` target, else the last directory with a
    meta.json (a directory without one is a write that did not finish)."""
    latest = Path(run_dir) / "checkpoints" / "latest-checkpoint"
    if latest.exists():
        return latest.resolve()
    candidates = sorted(
        (p for p in Path(run_dir, "checkpoints").glob("step-*") if (p / "meta.json").exists()),
        key=lambda p: p.name,
    )
    return candidates[-1] if candidates else None


def load_checkpoint(path: Path, map_location: Any = "cpu") -> Dict[str, Any]:
    """A checkpoint directory -> {"model": {key: state dict}, "optimizer": ..., "step", "epoch"}.

    The port's own ``checkpoint.pt``, or else a ``merv_tpu`` Orbax checkpoint:
    then ``model`` holds the port's state dicts of its modules (CPU tensors),
    and the optax optimizer state, which the port's optimizer cannot resume
    from, is not read."""
    path = Path(path).resolve()
    if (path / CKPT_FILE).exists():
        out = dict(torch.load(path / CKPT_FILE, map_location=map_location, weights_only=True))
    elif (path / "_METADATA").exists():
        out = {"model": module_state_dicts(read_orbax_tree(path, subtree="model").get("model", {}))}
    else:
        raise FileNotFoundError(f"{path} holds neither {CKPT_FILE} nor an Orbax checkpoint (_METADATA)")
    out["step"], out["epoch"] = parse_checkpoint_name(path)
    return out


def read_orbax_tree(path: Path, subtree: Optional[str] = None) -> Dict[str, Any]:
    """An Orbax checkpoint directory -> its tree (or only its top-level
    ``subtree``) as nested dicts of numpy arrays (bf16 as ml_dtypes'
    ``bfloat16``; list and tuple nodes become dicts keyed by index), read
    without JAX. Raises ``ImportError`` when ``tensorstore`` is missing."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(f"reading the Orbax checkpoint {path} needs the `tensorstore` package") from e
    path = Path(path).resolve()
    meta = json.loads((path / "_METADATA").read_text())
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if subtree is not None and keys[0] != subtree:
            continue
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):  # an empty dict / list, or None
            node[keys[-1]] = {} if value["value_type"] in ("Dict", "List", "Tuple") else None
            continue
        name = ".".join(keys)
        if meta.get("use_ocdbt"):
            kvstore = {"driver": "ocdbt", "base": f"file://{path}", "path": name}
        else:
            kvstore = {"driver": "file", "path": f"{path / name}/"}
        node[keys[-1]] = ts.open({"driver": driver, "kvstore": kvstore}).result().read().result()
    return tree


def discover_align_checkpoint(run_dir: Path) -> Path:
    """The latest checkpoint of the align run beside a finetune run directory
    (``<model>+<scale>+...+stage-align+<seed>``)."""
    run_dir = Path(run_dir)
    model, scale, _, seed = run_dir.name.split("+")
    align_dirs = [
        d for d in run_dir.parent.iterdir()
        if d.name.startswith(f"{model}+{scale}") and d.name.endswith(f"+stage-align+{seed}")
    ]
    assert len(align_dirs) == 1, "Multiple or No Valid Pretrained Directories Exist -- Double Check `runs`!"
    ckpt = latest_checkpoint(align_dirs[0])
    if ckpt is None:
        raise ValueError(f"Could not find valid `align` checkpoint under {align_dirs[0]}!")
    return ckpt


def load_stage_weights(model: Any, stage: str, run_dir: Path, pretrained_checkpoint: Optional[Path] = None) -> None:
    """Stage hand-off, in place: load the modules a stage starts from (the
    align projectors for a finetune run; the fusion and LLM too for
    ``second_finetune`` from an explicit checkpoint)."""
    assert stage in {"align", "second_align", "full-align", "finetune", "full-finetune", "second_finetune"}, (
        f"Stage {stage} is not supported!"
    )

    def load(key: str, restored: Dict[str, Any]) -> None:
        getattr(model, key).load_state_dict(restored[key], strict=True)

    if stage == "second_align":
        if pretrained_checkpoint is not None:
            restored = load_checkpoint(Path(pretrained_checkpoint))["model"]
            load("projectors", restored)
            if "feature_fusion" in restored and model.feature_fusion is not None:
                load("feature_fusion", restored)
        else:
            overwatch.info("Stage `second_align` without pretrained_checkpoint =>> fresh projector init", ctx_level=1)
        return
    if model.arch_specifier.startswith("no-align"):
        overwatch.info(f"MERV with arch_specifier = {model.arch_specifier!r} does not require pretrained weights!",
                       ctx_level=1)
        return
    if stage in ("align", "full-align"):
        overwatch.info("Stage `align` does not require pretrained weights =>> Starting Training", ctx_level=1)
        return

    overwatch.info("Stage `finetune` requires `align` pretrained weights", ctx_level=1)
    ckpt_path = Path(pretrained_checkpoint) if pretrained_checkpoint is not None else discover_align_checkpoint(run_dir)
    restored = load_checkpoint(ckpt_path)["model"]
    load("projectors", restored)
    if stage == "second_finetune" and pretrained_checkpoint is not None:
        assert "llm_backbone" in restored, "second_finetune expects `llm_backbone` in the checkpoint!"
        load("llm_backbone", restored)
        if model.feature_fusion is not None and "feature_fusion" in restored:
            load("feature_fusion", restored)
