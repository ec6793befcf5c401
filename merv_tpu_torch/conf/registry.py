"""Choice registry and CLI config parsing (a copy of ``merv_tpu/conf/registry.py``, which the port may not import).

- ``ChoiceRegistry``: a dataclass base whose subclasses register under a string
  key (``register_subclass``) and can be looked up with ``get_choice_class``.
- ``parse`` / ``wrap``: build a (possibly nested) dataclass config from
  ``sys.argv``-style dotted overrides, with ``--x.type`` choosing the
  registered subclass for a ChoiceRegistry-typed field.
- ``encode`` / ``decode``: JSON-compatible round trip of a config instance.

The evaluation drivers (:mod:`merv_tpu_torch.cli`) parse their ``EvalConfig``
with :func:`wrap`, so both packages' drivers take the same command lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
from enum import Enum
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")

_MISSING = dataclasses.MISSING


class ChoiceRegistry:
    """Dataclass mixin giving each hierarchy a string-keyed subclass registry."""

    _registry: Dict[str, type]

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)

    @classmethod
    def _ensure_registry(cls) -> Dict[str, type]:
        # The registry lives on the *root* ChoiceRegistry subclass (e.g. ModelConfig),
        # shared by all of its variants.
        root = cls._registry_root()
        if "_registry" not in root.__dict__:
            root._registry = {}
        return root._registry

    @classmethod
    def _registry_root(cls) -> type:
        root = cls
        for base in cls.__mro__:
            if base is ChoiceRegistry:
                break
            if issubclass(base, ChoiceRegistry) and base is not ChoiceRegistry:
                root = base
        return root

    @classmethod
    def register_subclass(cls, name: str, subclass: Optional[type] = None):
        registry = cls._ensure_registry()

        def _register(sub: type) -> type:
            registry[name] = sub
            sub._choice_name = name
            return sub

        if subclass is not None:
            return _register(subclass)
        return _register

    @classmethod
    def get_choice_class(cls, name: str) -> type:
        registry = cls._ensure_registry()
        if name not in registry:
            raise KeyError(f"Unknown choice {name!r} for {cls.__name__}; known: {sorted(registry)}")
        return registry[name]

    @classmethod
    def get_choice_name(cls, subclass: type) -> str:
        for name, sub in cls._ensure_registry().items():
            if sub is subclass:
                return name
        raise KeyError(f"{subclass} is not registered under {cls.__name__}")

    @classmethod
    def known_choices(cls) -> List[str]:
        return sorted(cls._ensure_registry())


def _is_optional(tp: Any) -> bool:
    return get_origin(tp) is Union and type(None) in get_args(tp)


def _strip_optional(tp: Any) -> Any:
    if _is_optional(tp):
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
        return Union[tuple(args)]
    return tp


def _coerce(value: Any, tp: Any) -> Any:
    """Coerce a parsed value (string / json scalar / list) to the annotated type."""
    tp = _strip_optional(tp)
    if value is None:
        return None
    origin = get_origin(tp)
    if tp is Any:
        return value
    if origin in (list, List):
        (elem_tp,) = get_args(tp) or (Any,)
        if isinstance(value, str):
            value = _parse_listish(value)
        return [_coerce(v, elem_tp) for v in value]
    if origin in (tuple, Tuple):
        elem_tps = get_args(tp)
        if isinstance(value, str):
            value = _parse_listish(value)
        value = list(value)
        if len(elem_tps) == 2 and elem_tps[1] is Ellipsis:
            return tuple(_coerce(v, elem_tps[0]) for v in value)
        if elem_tps and len(elem_tps) == len(value):
            return tuple(_coerce(v, t) for v, t in zip(value, elem_tps))
        return tuple(value)
    if origin is Union:
        # e.g. Union[int, List[int]] for num_frames
        for cand in get_args(tp):
            try:
                return _coerce(value, cand)
            except (TypeError, ValueError):
                continue
        raise ValueError(f"Cannot coerce {value!r} to {tp}")
    if isinstance(tp, type) and issubclass(tp, Enum):
        return tp(value)
    if tp is bool:
        if isinstance(tp, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
            raise ValueError(f"Cannot parse bool from {value!r}")
        return bool(value)
    if tp is int:
        if isinstance(value, bool):
            raise ValueError("bool is not int")
        if isinstance(value, float) and not value.is_integer():
            raise ValueError(f"{value} is not an int")
        return int(value)
    if tp is float:
        return float(value)
    if tp is str:
        return str(value)
    if tp is Path:
        return Path(value)
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return decode(tp, value)
    return value


def _parse_listish(s: str) -> List[Any]:
    """Parse '[16,16,32,16]' or '16,16' into a python list (draccus CLI list syntax)."""
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        try:
            return json.loads(s)
        except json.JSONDecodeError:
            s = s[1:-1]
    if not s:
        return []
    return [_parse_scalar(v.strip()) for v in s.split(",")]


def _parse_scalar(s: str) -> Any:
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def encode(cfg: Any) -> Any:
    """Encode a (nested) dataclass config to a JSON-compatible structure."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        out: Dict[str, Any] = {}
        if isinstance(cfg, ChoiceRegistry) and hasattr(type(cfg), "_choice_name"):
            out["type"] = type(cfg)._choice_name
        for f in dataclasses.fields(cfg):
            out[f.name] = encode(getattr(cfg, f.name))
        return out
    if isinstance(cfg, Enum):
        return cfg.value
    if isinstance(cfg, Path):
        return str(cfg)
    if isinstance(cfg, (list, tuple)):
        return [encode(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: encode(v) for k, v in cfg.items()}
    return cfg


def decode(cls: Type[T], data: Dict[str, Any]) -> T:
    """Instantiate ``cls`` (or its registered 'type' choice) from encoded data."""
    data = dict(data)
    if isinstance(cls, type) and issubclass(cls, ChoiceRegistry) and "type" in data:
        cls = cls.get_choice_class(data.pop("type"))
    kwargs: Dict[str, Any] = {}
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    for name, value in data.items():
        if name not in field_map:
            continue  # forwards/backwards compat: ignore unknown keys
        f = field_map[name]
        tp = _resolve_type(cls, f)
        if dataclasses.is_dataclass(_strip_optional(tp)) and isinstance(value, dict):
            kwargs[name] = decode(_strip_optional(tp), value)
        else:
            kwargs[name] = _coerce(value, tp)
    return cls(**kwargs)  # type: ignore[call-arg]


@functools.lru_cache(maxsize=None)
def _type_hints(cls: type) -> Dict[str, Any]:
    import typing

    return typing.get_type_hints(cls)


def _resolve_type(cls: type, f: dataclasses.Field) -> Any:
    try:
        return _type_hints(cls)[f.name]
    except Exception:
        return f.type


# ---------------------------------------------------------------------------
# CLI parsing
# ---------------------------------------------------------------------------


def _default_instance(cls: Type[T]) -> T:
    """Instantiate a dataclass using declared defaults (fails if any are missing)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.default is not _MISSING:
            kwargs[f.name] = f.default
        elif f.default_factory is not _MISSING:  # type: ignore[misc]
            kwargs[f.name] = f.default_factory()  # type: ignore[misc]
        else:
            raise TypeError(f"{cls.__name__}.{f.name} has no default; specify it on the CLI")
    return cls(**kwargs)


def parse(config_class: Type[T], args: Optional[List[str]] = None) -> T:
    """Parse dotted CLI overrides into a config dataclass.

    Supports ``--a.b.c value``, ``--a.b.c=value``, ``--flag true`` and the
    ``--x.type choice-name`` subclass-selection convention of draccus.
    """
    if args is None:
        args = sys.argv[1:]

    # Tokenize into {dotted_key: raw_string}
    overrides: Dict[str, str] = {}
    i = 0
    while i < len(args):
        tok = args[i]
        if not tok.startswith("--"):
            raise SystemExit(f"Unexpected positional argument: {tok!r}")
        tok = tok[2:]
        if "=" in tok:
            key, val = tok.split("=", 1)
            overrides[key] = val
            i += 1
        else:
            if i + 1 >= len(args) or args[i + 1].startswith("--"):
                overrides[tok] = "true"  # bare flag
                i += 1
            else:
                overrides[tok] = args[i + 1]
                i += 2

    if "help" in overrides or "h" in overrides:
        _print_help(config_class)
        raise SystemExit(0)

    return build_config(config_class, overrides)


def build_config(config_class: Type[T], overrides: Dict[str, str]) -> T:
    # Group overrides by top-level field
    nested: Dict[str, Dict[str, str]] = {}
    top: Dict[str, str] = {}
    for key, val in overrides.items():
        if "." in key:
            head, rest = key.split(".", 1)
            nested.setdefault(head, {})[rest] = val
        else:
            top[key] = val

    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(config_class):
        tp = _strip_optional(_resolve_type(config_class, f))
        sub_over = nested.get(f.name, {})
        if isinstance(tp, type) and dataclasses.is_dataclass(tp):
            if issubclass(tp, ChoiceRegistry):
                choice = sub_over.pop("type", None)
                if choice is not None:
                    sub_cls = tp.get_choice_class(choice)
                elif f.default_factory is not _MISSING:  # type: ignore[misc]
                    sub_cls = type(f.default_factory())  # type: ignore[misc]
                else:
                    sub_cls = tp
            else:
                sub_cls = tp
            base = _default_instance(sub_cls)
            kwargs[f.name] = _apply_overrides(base, sub_over)
        else:
            if f.name in top:
                kwargs[f.name] = _coerce(top.pop(f.name), _resolve_type(config_class, f))
            elif f.default is not _MISSING:
                kwargs[f.name] = f.default
            elif f.default_factory is not _MISSING:  # type: ignore[misc]
                kwargs[f.name] = f.default_factory()  # type: ignore[misc]
            else:
                raise SystemExit(f"Missing required argument --{f.name}")
    unknown = set(top) | {f"{k}.{kk}" for k, v in nested.items() for kk in v if k not in {f.name for f in dataclasses.fields(config_class)}}
    unknown -= {f.name for f in dataclasses.fields(config_class)}
    if unknown:
        known = [f.name for f in dataclasses.fields(config_class)]
        raise SystemExit(f"Unknown arguments: {sorted(unknown)}; known top-level fields: {known}")
    return config_class(**kwargs)


def _apply_overrides(instance: T, overrides: Dict[str, str]) -> T:
    updates: Dict[str, Any] = {}
    field_map = {f.name: f for f in dataclasses.fields(instance)}
    for key, val in overrides.items():
        head = key.split(".", 1)[0]
        if head not in field_map:
            raise SystemExit(f"Unknown field {head!r} for {type(instance).__name__}; known: {sorted(field_map)}")
        if "." in key:
            _, rest = key.split(".", 1)
            sub = updates.get(head, getattr(instance, head))
            updates[head] = _apply_overrides(sub, {rest: val})
        else:
            updates[key] = _coerce(val, _resolve_type(type(instance), field_map[key]))
    return dataclasses.replace(instance, **updates)


def _print_help(config_class: type, prefix: str = "") -> None:
    for f in dataclasses.fields(config_class):
        tp = _strip_optional(_resolve_type(config_class, f))
        if isinstance(tp, type) and dataclasses.is_dataclass(tp):
            print(f"--{prefix}{f.name}.type <choice>" + (f" (choices: {tp.known_choices()})" if issubclass(tp, ChoiceRegistry) else ""))
            _print_help(tp, prefix=f"{prefix}{f.name}.")
        else:
            default = "" if f.default is _MISSING and f.default_factory is _MISSING else f" (default: {f.default if f.default is not _MISSING else f.default_factory()})"  # type: ignore[misc]
            print(f"--{prefix}{f.name} <{getattr(tp, '__name__', tp)}>{default}")


def wrap() -> Callable:
    """Decorator equivalent of ``@draccus.wrap()`` — parse CLI into the first arg."""

    def decorator(fn: Callable) -> Callable:
        import inspect

        sig = inspect.signature(fn)
        (param,) = [p for p in sig.parameters.values() if p.default is inspect.Parameter.empty or True][:1]
        config_class = param.annotation
        if isinstance(config_class, str):
            # `from __future__ import annotations` (every script here) makes
            # the annotation a STRING — resolve it against the function's
            # module, or CLI invocation of every entry point crashes
            import typing

            config_class = typing.get_type_hints(fn)[param.name]

        @functools.wraps(fn)
        def wrapper(cfg: Any = None, args: Optional[List[str]] = None):
            if cfg is None:
                cfg = parse(config_class, args=args)
            return fn(cfg)

        return wrapper

    return decorator
