"""Checkpoint save / load / resume (counterpart of ``merv_tpu/training/checkpointing.py``).

The layout and names of ``merv_tpu``: ``<run_dir>/checkpoints/
step-{:06d}-epoch-{:02d}-loss={:.4f}/`` with a ``meta.json`` (step, epoch,
loss, module keys) and a ``latest-checkpoint`` symlink, written last so it
never points at a torn directory. The port's format inside the directory is
its own: one ``torch.save`` file, ``checkpoint.pt``, holding ``model`` (the
state dicts of the trainable top-level modules, by module key) and
``optimizer`` (the optimizer's state dict).

A sharded run (a mesh over several ranks: FSDP2's sharded parameters, or a
pipeline stage's layers) writes the file a one-device run writes:
:func:`full_trainable_state` gathers the trainable modules' full tensors and
the AdamW moments, keyed as the one-device optimizer keys them, to rank 0,
which writes them; the other ranks wait at a barrier. Such a checkpoint loads
at any world size (:func:`load_sharded_state`).

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
    mesh: Any = None,
) -> Optional[Path]:
    """Write ``checkpoints/step-...-loss=.../`` and point ``latest-checkpoint`` at it.

    ``blocking=False`` copies the state to host memory and writes on a
    background thread; meta.json and the pointer follow in
    :func:`wait_for_checkpoints` or the next save. On a ``mesh`` of several
    ranks every rank calls this (the gather is collective); rank 0 writes,
    the others return None after a barrier."""
    global _pending
    sharded = _ranks(mesh) > 1
    t = time.perf_counter()
    if sharded:
        tree = full_trainable_state(model, trainable_keys, optimizer, mesh)
        if tree is None:  # not rank 0
            torch.distributed.barrier()
            return None
    ckpt_root = Path(run_dir) / "checkpoints"
    ckpt_root.mkdir(parents=True, exist_ok=True)
    target = ckpt_root / f"step-{step:06d}-epoch-{epoch:02d}-loss={loss:.4f}"
    keys = sorted(tree["model"]) if sharded else sorted(k for k, _ in model.named_children() if k in trainable_keys)
    meta = {"step": step, "epoch": epoch, "loss": loss, "module_keys": keys}
    # the save in flight first, in both modes: a blocking save racing it would
    # let its later finalize move the pointer backward
    wait_for_checkpoints()
    if target.exists():
        shutil.rmtree(target)
    target.mkdir()
    if not sharded:
        modules = {k: m for k, m in model.named_children() if k in trainable_keys}
        tree = {"model": {k: _host_copy(m.state_dict()) for k, m in modules.items()}}
        if optimizer is not None:
            tree["optimizer"] = _host_copy(optimizer.state_dict())
    if blocking:
        torch.save(tree, target / CKPT_FILE)
        _finalize(target, meta)
        if sharded:
            torch.distributed.barrier()
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
    if sharded:
        torch.distributed.barrier()
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


# ---------------------------------------------------------------------------
# Sharded state: gathered to rank 0 for a save, split again on a load
# ---------------------------------------------------------------------------


def _ranks(mesh: Any) -> int:
    if mesh is None or not hasattr(mesh, "mesh_dim_names"):
        return 1
    return mesh.size()


_LAYER = re.compile(r"^llm_backbone\.decoder\.layers\.(\d+)\.(.*)$")


def _full(t: torch.Tensor) -> torch.Tensor:
    """A parameter's (or moment's) whole tensor on the host: a sharded one is
    gathered (collective over its mesh)."""
    from merv_tpu_torch.parallel.sharding import full_tensor

    return full_tensor(t.detach()).to("cpu", copy=True)


def one_device_names(model: nn.Module, mesh: Any) -> List[str]:
    """The model's parameter names in the order a one-device model lists
    them: under ``pp`` the decoder's layers of every stage, in layer order
    (each stage holds its own; the names of a layer are every layer's)."""
    from merv_tpu_torch.parallel.mesh import PIPE_AXIS, axis_size

    names = [n for n, _ in model.named_parameters()]
    if axis_size(mesh, PIPE_AXIS) <= 1:
        return names
    local = [n for n in names if _LAYER.match(n)]
    if not local:
        return names
    first = _LAYER.match(local[0]).group(1)
    within = [_LAYER.match(n).group(2) for n in local if _LAYER.match(n).group(1) == first]
    cut = names.index(local[0])
    rest = [n for n in names if not _LAYER.match(n)]
    n_layers = model.llm_backbone.decoder.cfg.num_layers
    layers = [f"llm_backbone.decoder.layers.{i}.{w}" for i in range(n_layers) for w in within]
    head = [n for n in rest if names.index(n) < cut]
    return head + layers + [n for n in rest if names.index(n) > cut]


def _adamw_order(dims: Dict[str, int], weight_decay: float) -> Tuple[List[str], int]:
    """The parameter of each AdamW index in a one-device optimizer over
    ``dims``' names (in the model's order), and how many lead in the decay
    group (:class:`~merv_tpu_torch.training.optimizers.ClippedAdamW`'s groups:
    decayed, then the rest)."""
    decays = {n: weight_decay > 0 and d > 1 and n.rsplit(".", 1)[-1] != "bias" for n, d in dims.items()}
    decayed = [n for n in dims if decays[n]]
    return decayed + [n for n in dims if not decays[n]], len(decayed)


def _trainable_dims(model: nn.Module, optimizer: Any, mesh: Any) -> Dict[str, int]:
    """{one-device name: its number of dims} of the optimizer's parameters,
    every pipeline stage's layers included (a layer's are every layer's)."""
    dims = {n: p.dim() for n, p in optimizer.named_params.items()}
    within = {_LAYER.match(n).group(2): d for n, d in dims.items() if _LAYER.match(n)}
    keys = {n.split(".", 1)[0] for n in optimizer.named_params}
    for n in one_device_names(model, mesh):
        m = _LAYER.match(n)
        if m and n not in dims and "llm_backbone" in keys and m.group(2) in within:
            dims[n] = within[m.group(2)]
    return {n: dims[n] for n in one_device_names(model, mesh) if n in dims}


def _weight_decay(optimizer: Any) -> float:
    return max([g["weight_decay"] for g in optimizer.adamw.param_groups] + [0.0])


def full_trainable_state(model: nn.Module, trainable_keys: List[str], optimizer: Any, mesh: Any) -> Optional[dict]:
    """Collective over the mesh: the trainable modules' state dicts and the
    optimizer's, whole, on rank 0 (host tensors, in the one-device layout:
    AdamW's indices as a one-device optimizer numbers them); None elsewhere."""
    from merv_tpu_torch.parallel.mesh import PIPE_AXIS, axis_size

    dist = torch.distributed
    model_state = {n: _full(t) for n, t in list(model.named_parameters()) + list(model.named_buffers())
                   if n.split(".", 1)[0] in trainable_keys}
    opt_state = {}
    if optimizer is not None:
        by_id = {id(p): n for n, p in optimizer.named_params.items()}
        for p, st in optimizer.adamw.state.items():
            opt_state[by_id[id(p)]] = {k: _full(v) if v.dim() else v.detach().cpu().clone() for k, v in st.items()}
    pp = axis_size(mesh, PIPE_AXIS)
    if pp > 1:  # every stage's layers to rank 0
        mine = ({n: v for n, v in model_state.items() if _LAYER.match(n)},
                {n: v for n, v in opt_state.items() if _LAYER.match(n)})
        gathered = [None] * pp
        dist.all_gather_object(gathered, mine, group=mesh.get_group(PIPE_AXIS))
        for m, o in gathered:
            model_state.update(m)
            opt_state.update(o)
    if dist.get_rank() != 0:
        return None
    tree: Dict[str, Any] = {"model": {}}
    for n, v in model_state.items():
        key, rest = n.split(".", 1)
        tree["model"].setdefault(key, {})[rest] = v
    if optimizer is not None:
        wd = _weight_decay(optimizer)
        order, n_decay = _adamw_order(_trainable_dims(model, optimizer, mesh), wd)
        index = {n: i for i, n in enumerate(order)}
        hyper = {k: v for k, v in optimizer.adamw.param_groups[0].items() if k not in ("params", "weight_decay")}
        groups = [dict(hyper, weight_decay=w, params=list(ix)) for w, ix in
                  ((wd, range(n_decay)), (0.0, range(n_decay, len(order)))) if len(ix)]
        tree["optimizer"] = {"count": optimizer.count,
                             "adamw": {"state": {index[n]: st for n, st in opt_state.items()}, "param_groups": groups}}
    return tree


def _local_chunk(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of ``full`` a rank holds of a tensor laid out as ``like`` (an
    FSDP2 ``DTensor``: ``torch.chunk`` per sharded mesh dim, empty past the
    last chunk), or all of it."""
    if not hasattr(like, "placements"):
        return full
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            chunks = full.chunk(like.device_mesh.size(i), pl.dim)
            r = like.device_mesh.get_local_rank(i)
            full = chunks[r] if r < len(chunks) else full.narrow(pl.dim, 0, 0)
    return full


def load_sharded_state(model: nn.Module, optimizer: Any, restored: Dict[str, Any], mesh: Any) -> None:
    """Load a one-device checkpoint (:func:`load_checkpoint`'s dict) into a
    model and optimizer laid out on ``mesh`` (any world size): each rank
    takes its part of every tensor it holds."""
    params = dict(model.named_parameters())
    tensors = dict(params, **dict(model.named_buffers()))
    with torch.no_grad():
        for key, sd in restored["model"].items():
            for rest, full in sd.items():
                name = f"{key}.{rest}"
                if name not in tensors:
                    if _LAYER.match(name):  # another pipeline stage's layer
                        continue
                    raise KeyError(f"checkpoint tensor {name} has no place in the model")
                t = tensors[name]
                local = t.to_local() if hasattr(t, "to_local") else t
                local.copy_(_local_chunk(full, t).to(local.device, local.dtype))
    if optimizer is None or "optimizer" not in restored:
        return
    opt = restored["optimizer"]
    optimizer.count = int(opt["count"])
    order, _ = _adamw_order(_trainable_dims(model, optimizer, mesh), _weight_decay(optimizer))
    for i, st in opt["adamw"]["state"].items():
        name = order[int(i)]
        if name not in optimizer.named_params:  # another pipeline stage's layer
            continue
        p = optimizer.named_params[name]
        new = {}
        with torch.no_grad():
            for k, v in st.items():
                if v.dim() == 0:
                    new[k] = v.clone()
                    continue
                z = torch.zeros_like(p)
                zl = z.to_local() if hasattr(z, "to_local") else z
                zl.copy_(_local_chunk(v, p).to(zl.device, zl.dtype))
                new[k] = z
        optimizer.adamw.state[p] = new
