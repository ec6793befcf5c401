"""Parameter-sharding rules and the activation-mesh scope (counterpart of
``merv_tpu/parallel/sharding.py``).

The rules are ``merv_tpu``'s, in ``merv_tpu``'s terms: a spec is a tuple with
one mesh-axis name (or None) per dimension of the parameter as ``merv_tpu``
lays it out, its ``PartitionSpec``. :func:`jax_leaves` gives each port
parameter that layout: a ``Linear`` weight is stored ``(out, in)`` here and
``(in, out)`` there, and a parameter of a layer stack (``layers.<i>.``) is one
slice of ``merv_tpu``'s stacked ``[L, ...]`` leaf. So :func:`infer_fsdp_spec`
sees the same shape, breaks its tie toward the same logical axis, and
:func:`fsdp_specs` (with ``overrides`` and the ``pp`` layer-stack rule)
returns ``merv_tpu``'s specs for the port's parameters by name.

:func:`param_placement` gives the port dim of a parameter that carries a
spec's ``fsdp`` axis (a decoder layer's ``pp`` dim is the stage that holds
the layer, ``LlamaDecoder.keep_stage``). The strategy does not apply those
dims: FSDP2 (``fully_shard``) shards every parameter it manages on its dim 0,
its default, on every device (padded where dim 0 does not divide the mesh).
So every leaf whose ``merv_tpu`` spec is replicated (one below
``min_weight_size``, or none of whose dims divides the axis), sharded on
another dim, or sharded on its stack's layer dim, is laid out otherwise than
in ``merv_tpu``. The numbers do not depend on it: a sharded parameter is
gathered whole before each use.

The activation half: model code asks :func:`get_activation_mesh` for the mesh
a serving or training call runs on (the decoder takes its sequence-parallel
and pipeline paths from it). The scope is set for one call by
:func:`activation_mesh` and cleared when it exits, so a mesh never leaks into
a later call. :func:`constrain_batch_dim` stays where ``merv_tpu`` pins a
batch-leading activation to its data/fsdp axes: with one process a rank, each
rank holds its own batch already, so it returns its input.
:func:`global_token_count` is the other half of that pin: ``merv_tpu``'s loss
is a token mean over the whole (batch-sharded) micro-batch, so the port's
losses divide by the count summed over the mesh's batch ranks.

``llm_tensor_parallel_rules`` (tensor parallelism, ROADMAP A12 step 4) is not
ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from merv_tpu_torch.parallel.mesh import FSDP_AXIS, PIPE_AXIS, axis_size, batch_group

Spec = Tuple[Optional[str], ...]  # merv_tpu's PartitionSpec: an axis name (or None) per dim, trailing Nones dropped

_ACTIVATION_MESH = None


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def path_str(path: Any) -> str:
    """A parameter path as ``'a/b/c'``: a dotted port name, or a sequence of keys."""
    if isinstance(path, str):
        return path.replace(".", "/")
    return "/".join(str(k) for k in path)


class PartitionRules:
    """Ordered (regex, spec) table; the first match wins (``merv_tpu``'s)."""

    def __init__(self, rules: Sequence[Tuple[str, Spec]], default: Optional[Spec] = None) -> None:
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
        self.default = default

    def spec_for(self, path: str) -> Optional[Spec]:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return self.default


def infer_fsdp_spec(
    shape: Tuple[int, ...],
    fsdp_size: int,
    *,
    min_weight_size: int = 2 ** 16,
    axis_name: str = FSDP_AXIS,
) -> Spec:
    """ZeRO-3-style sharding of one parameter of ``shape`` (``merv_tpu``'s
    layout): the largest dim divisible by ``fsdp_size``, ties broken toward
    the trailing dim; a parameter smaller than ``min_weight_size`` replicates."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_weight_size:
        return ()
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True)
    for i in order:
        if shape[i] % fsdp_size == 0:
            spec: list = [None] * len(shape)
            spec[i] = axis_name
            return tuple(spec)
    return ()


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """Where a port parameter sits in ``merv_tpu``'s tree."""

    path: str  # merv_tpu's path, 'llm_backbone/layers/attn/q_proj/kernel'
    shape: Tuple[int, ...]  # merv_tpu's leaf shape (with the stack's layer dim first)
    layer: Optional[int]  # the index in a layer stack, else None
    transposed: bool  # a Linear weight: (out, in) here, (in, out) there


_LEAF = {"Linear": "kernel", "Embed": "embedding", "RMSNorm": "scale", "LayerNorm": "scale"}
_STACK = re.compile(r"^(.*?)\.layers\.(\d+)\.(.*)$")  # matched against "<module path>."


def _jax_prefix(name: str) -> str:
    """A port module path -> merv_tpu's: ``llm_backbone.decoder.`` is ``llm_backbone/``,
    a tower's ``.vit.`` / ``.model.`` is dropped."""
    name = re.sub(r"^llm_backbone\.decoder(\.|$)", r"llm_backbone\1", name)
    name = re.sub(r"^(video_backbones\.\d+)\.(vit|model)(\.|$)", r"\1\3", name)
    return name


def jax_leaves(model: nn.Module) -> Dict[str, JaxLeaf]:
    """{port parameter name: its :class:`JaxLeaf`} for a MERV, a decoder or a tower."""
    out: Dict[str, JaxLeaf] = {}
    stacks: Dict[str, int] = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, nn.ModuleList) and mname.endswith("layers"):
            stacks[mname] = len(mod)
    for mname, mod in model.named_modules():
        kind = type(mod).__name__
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            transposed = kind == "Linear" and pname == "weight" and p.dim() == 2
            leaf = _LEAF.get(kind, pname) if pname == "weight" else pname
            shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
            layer, jax_mod = None, _jax_prefix(mname)
            m = _STACK.match(f"{mname}.")
            if m is not None and f"{m.group(1)}.layers" in stacks:  # one slice of merv_tpu's [L, ...] leaf
                layer = int(m.group(2))
                shape = (stacks[f"{m.group(1)}.layers"],) + shape
                jax_mod = f"{_jax_prefix(m.group(1))}.layers" + (f".{m.group(3)[:-1]}" if m.group(3) else "")
            out[name] = JaxLeaf(path_str(f"{jax_mod}.{leaf}" if jax_mod else leaf), shape, layer, transposed)
    return out


def fsdp_specs(
    model: nn.Module,
    mesh,
    *,
    min_weight_size: int = 2 ** 16,
    overrides: Optional[PartitionRules] = None,
    leaves: Optional[Dict[str, JaxLeaf]] = None,
) -> Dict[str, Spec]:
    """{port parameter name: ``merv_tpu``'s spec} under the FSDP auto-policy.

    ``overrides`` take priority (a None from them falls through). With a
    ``pp`` axis above 1, the decoder's stacked layers (``llm_backbone/layers/``,
    not the towers' stacks) shard their layer dim over ``pp``, and ``fsdp``
    the rest: each stage holds only its layers."""
    fsdp_size = axis_size(mesh, FSDP_AXIS)
    pp_size = axis_size(mesh, PIPE_AXIS)
    layers_re = re.compile(r"(^|/)llm_backbone/layers/")
    leaves = jax_leaves(model) if leaves is None else leaves
    out: Dict[str, Spec] = {}
    for name, leaf in leaves.items():
        shape = leaf.shape
        stacked_pp = pp_size > 1 and layers_re.search(leaf.path) and leaf.layer is not None and shape[0] % pp_size == 0
        if overrides is not None:
            s = overrides.spec_for(leaf.path)
            if s is not None:
                if stacked_pp and (len(s) == 0 or s[0] is None):
                    s = (PIPE_AXIS,) + tuple(s)[1:]
                out[name] = s
                continue
        if stacked_pp:
            out[name] = (PIPE_AXIS,) + infer_fsdp_spec(shape[1:], fsdp_size, min_weight_size=min_weight_size)
        else:
            out[name] = infer_fsdp_spec(shape, fsdp_size, min_weight_size=min_weight_size)
    return out


def param_placement(leaf: JaxLeaf, spec: Spec) -> Optional[int]:
    """The port dim of the parameter that carries the spec's ``fsdp`` axis
    (the ``Shard(d)`` of ``merv_tpu``'s layout; the strategy's FSDP2 shards
    dim 0, see the module's text). None where ``merv_tpu`` replicates the
    leaf or shards its layer stack's dim over ``fsdp`` (a dim the port's
    per-layer modules do not have)."""
    dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
    if leaf.layer is not None:
        dims = dims[1:]
    if leaf.transposed:
        dims = dims[::-1]
    return dims.index(FSDP_AXIS) if FSDP_AXIS in dims else None


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of a tensor FSDP2 shards (a ``DTensor`` with ``Shard``
    placements), gathered on every rank of its mesh by c10d's
    ``all_gather_into_tensor``, each rank's ``torch.chunk`` padded to the
    first's (collective); any other tensor as it is. ``DTensor.full_tensor``
    goes through functional collectives, which crash under gloo on CUDA
    tensors."""
    if not hasattr(t, "placements"):
        return t
    out = t.to_local()
    for i, pl in enumerate(t.placements):
        if not pl.is_shard():
            continue
        n, size = t.device_mesh.size(i), t.shape[pl.dim]
        chunk = -(-size // n)
        x = out.movedim(pl.dim, 0)
        if x.shape[0] < chunk:
            x = torch.cat([x, x.new_zeros((chunk - x.shape[0],) + tuple(x.shape[1:]))])
        buf = x.new_empty((n * chunk,) + tuple(x.shape[1:]))
        torch.distributed.all_gather_into_tensor(buf, x.contiguous(), group=t.device_mesh.get_group(i))
        out = buf[:size].movedim(0, pl.dim)
    return out


# ---------------------------------------------------------------------------
# The activation mesh
# ---------------------------------------------------------------------------


def set_activation_mesh(mesh) -> None:
    """Register (or clear, with None) the activation mesh; prefer :func:`activation_mesh`."""
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh


def get_activation_mesh():
    """The mesh of the enclosing :func:`activation_mesh` scope, or None."""
    return _ACTIVATION_MESH


@contextlib.contextmanager
def activation_mesh(mesh):
    """Scope the activation mesh to a block; the previous one comes back after it."""
    global _ACTIVATION_MESH
    prev = _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh
    try:
        yield
    finally:
        _ACTIVATION_MESH = prev


def constrain_batch_dim(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``merv_tpu``'s batch-axis sharding constraint: a no-op here, where a
    rank's tensors are its own shard already."""
    return x


def global_token_count(count: torch.Tensor) -> torch.Tensor:
    """A loss's label-token count summed over the activation mesh's batch
    ranks (data x fsdp), so that each rank's loss is its share of the token
    mean over the whole micro-batch, as ``merv_tpu``'s loss over a
    batch-sharded micro-batch is. Unchanged off mesh or on one batch rank."""
    group = batch_group(_ACTIVATION_MESH)
    if group is None:
        return count
    count = count.detach().clone()
    torch.distributed.all_reduce(count, group=group)
    return count
