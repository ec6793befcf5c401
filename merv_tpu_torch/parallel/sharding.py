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

Tensor parallelism: :func:`llm_tensor_parallel_rules` is ``merv_tpu``'s
Megatron table, matched through :func:`jax_leaves` (int8 ``weight_q`` /
``scale`` buffers included, as ``kernel_q`` / ``scale``);
:func:`tensor_split_dims` gives each port parameter its split dim in torch's
``(out, in)`` layout (column-split: weight dim 0, the bias and the int8 scale;
row-split: weight dim 1, the scale whole; the embedding and the head: dim 0,
the vocabulary), and :func:`shard_decoder` cuts a decoder down to this rank's
shards in place (:mod:`merv_tpu_torch.parallel.tensor` has the collectives
its forward then issues).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from merv_tpu_torch.parallel.mesh import FSDP_AXIS, PIPE_AXIS, TENSOR_AXIS, axis_group, axis_rank, axis_size, batch_group

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
_INT8 = ("weight_q", "scale")  # a quantized Linear's buffers: merv_tpu's kernel_q [in, out] and scale [1, out]
_STACK = re.compile(r"^(?:(.*?)\.)?layers\.(\d+)\.(.*)$")  # matched against "<module path>."


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
        items = list(mod.named_parameters(recurse=False))
        if kind == "Linear":  # weight-only int8 serving: the int8 weight and its scales are buffers
            items += [(n, b) for n, b in mod.named_buffers(recurse=False) if n in _INT8]
        for pname, p in items:
            name = f"{mname}.{pname}" if mname else pname
            transposed = kind == "Linear" and pname in ("weight", "weight_q") and p.dim() == 2
            leaf = _LEAF.get(kind, pname) if pname == "weight" else "kernel_q" if pname == "weight_q" else pname
            shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
            if kind == "Linear" and pname == "scale":
                shape = (1,) + shape
            layer, jax_mod = None, _jax_prefix(mname)
            m = _STACK.match(f"{mname}.")
            stack = None if m is None else f"{m.group(1)}.layers" if m.group(1) else "layers"
            if stack in stacks:  # one slice of merv_tpu's [L, ...] leaf
                layer = int(m.group(2))
                shape = (stacks[stack],) + shape
                jax_mod = (f"{_jax_prefix(m.group(1))}." if m.group(1) else "") + "layers" + \
                    (f".{m.group(3)[:-1]}" if m.group(3) else "")
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


def _port_dim(leaf: JaxLeaf, spec: Spec, axis: str, ndim: int) -> Optional[int]:
    """The port dim of a parameter of ``ndim`` dims that carries ``spec``'s
    ``axis`` (None where it does not): the layer dim dropped, a Linear
    weight's dims reversed, and ``merv_tpu``'s leading 1 of an int8 scale
    ``[1, out]`` dropped for the port's ``[out]``."""
    dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
    if leaf.layer is not None:
        dims = dims[1:]
    if leaf.transposed:
        dims = dims[::-1]
    dims = dims[len(dims) - ndim:]
    return dims.index(axis) if axis in dims else None


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def llm_tensor_parallel_rules() -> PartitionRules:
    """``merv_tpu``'s Megatron column / row split of the decoder, on its
    paths (layer kernels stacked ``[L, in, out]``): q/k/v and gate/up split
    their output dim (with the q/k/v biases and the int8 scales), o and down
    their input dim (their scales replicate), the embedding and the head the
    vocabulary."""
    T = TENSOR_AXIS
    return PartitionRules(
        [
            (r"attn/(q|k|v)_proj/kernel(_q)?$", (None, None, T)),
            (r"attn/(q|k|v)_proj/bias$", (None, T)),
            (r"attn/o_proj/kernel(_q)?$", (None, T, None)),
            (r"mlp/(gate|up)_proj/kernel(_q)?$", (None, None, T)),
            (r"mlp/down_proj/kernel(_q)?$", (None, T, None)),
            (r"attn/(q|k|v)_proj/scale$", (None, None, T)),
            (r"mlp/(gate|up)_proj/scale$", (None, None, T)),
            (r"embed_tokens/embedding$", (T, None)),
            (r"lm_head/kernel(_q)?$", (None, T)),
            (r"lm_head/scale$", (None, T)),
        ],
        default=None,
    )


def tensor_split_dims(model: nn.Module, leaves: Optional[Dict[str, JaxLeaf]] = None) -> Dict[str, Optional[int]]:
    """{port parameter or int8 buffer name: the dim :func:`llm_tensor_parallel_rules`
    splits over ``tensor``, in the port's layout, or None (whole)} for a
    decoder, an LLM backbone or a MERV (whose towers, projectors and fusion
    match no rule and stay whole)."""
    rules = llm_tensor_parallel_rules()
    leaves = jax_leaves(model) if leaves is None else leaves
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    out: Dict[str, Optional[int]] = {}
    for name, leaf in leaves.items():
        spec = rules.spec_for(leaf.path)
        out[name] = None if spec is None else _port_dim(leaf, spec, TENSOR_AXIS, tensors[name].dim())
    return out


def shard_decoder(decoder: nn.Module, mesh) -> nn.Module:
    """Cut ``decoder`` (a :class:`~merv_tpu_torch.models.backbones.llm.transformer.LlamaDecoder`,
    unpacked, float or int8) down to this rank's shards over ``mesh``'s
    ``tensor`` group, in place, and give it and its layers their
    :class:`~merv_tpu_torch.parallel.tensor.TensorShards`. Quantize first:
    a row-split shard keeps its rows' scales, computed over the whole input
    dim (``merv_tpu``'s order, quantize then place). Key/value projections
    whose heads do not split over the group stay whole (see
    :func:`~merv_tpu_torch.parallel.tensor.tensor_shards`). A mesh without a
    tensor axis above 1 leaves the decoder as it is."""
    from merv_tpu_torch.models.generation import release_decode_runners
    from merv_tpu_torch.parallel.tensor import split_range, tensor_shards

    group = axis_group(mesh, TENSOR_AXIS)
    if group is None:
        return decoder
    if decoder.tp is not None:
        raise ValueError("shard_decoder: the decoder is cut already")
    if any("qkv_proj" in layer.attn._modules for layer in decoder.layers if hasattr(layer, "attn")):
        raise ValueError("shard_decoder: the tensor-parallel rules key on the unpacked q/k/v paths; "
                         "load the decoder unpacked (load_vid turns packing off under a tensor axis)")
    c = decoder.cfg
    n, rank = axis_size(mesh, TENSOR_AXIS), axis_rank(mesh, TENSOR_AXIS)
    tp = tensor_shards(c, group, n, rank)
    release_decode_runners(decoder)  # a captured step would keep reading the whole weights
    sizes = {"q_proj": c.q_dim, "k_proj": c.kv_dim, "v_proj": c.kv_dim, "gate_proj": c.intermediate_size,
             "up_proj": c.intermediate_size, "down_proj": c.intermediate_size, "o_proj": c.q_dim,
             "embed_tokens": c.vocab_size, "lm_head": c.vocab_size}
    modules = dict(decoder.named_modules())
    with torch.no_grad():
        for name, dim in tensor_split_dims(decoder).items():
            mname, _, pname = name.rpartition(".")
            part = mname.rpartition(".")[2]
            if dim is None or (part in ("k_proj", "v_proj") and tp.kv_attend is not None):
                continue
            lo, hi = tp.vocab_range if part in ("embed_tokens", "lm_head") else split_range(sizes[part], n, rank)
            mod = modules[mname]
            t = getattr(mod, pname)
            piece = t.narrow(dim, lo, hi - lo).clone()
            if isinstance(t, nn.Parameter):
                t.data = piece
            else:
                mod._buffers[pname] = piece
            if hasattr(mod, "in_dim"):
                mod.in_dim, mod.out_dim = (hi - lo, mod.out_dim) if (dim == 1 and pname != "scale") else \
                    (mod.in_dim, hi - lo)
    decoder.tp = tp
    for layer in decoder.layers:
        layer.tp = tp
    return decoder


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
