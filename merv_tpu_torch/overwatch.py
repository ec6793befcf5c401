"""Logging shim standing in for ``merv_tpu.overwatch``.

Messages go to stderr through :mod:`logging`, so a script with a
machine-read stdout (``chip_smoke.py``) keeps its stdout clean.
``ctx_level`` is accepted for call-site compatibility and indents the message.

In a ``torchrun`` world (``WORLD_SIZE`` set) :func:`initialize_overwatch`
returns a :class:`DistributedOverwatch`: INFO on rank zero, ERROR on every
other rank, and ``rank()`` / ``world_size()`` / ``is_rank_zero()`` /
``rank_zero_only`` from the process group (or, before it starts, from
``RANK`` / ``WORLD_SIZE``). Without one, the single-process :class:`_Overwatch`.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Any, Callable, Optional


class _Overwatch:
    def __init__(self, name: str) -> None:
        self.logger = logging.getLogger(name)
        if not logging.getLogger().handlers and not self.logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(name)s :: %(message)s"))
            self.logger.addHandler(handler)
            self.logger.setLevel(logging.INFO)

    def info(self, msg: str, ctx_level: int = 0) -> None:
        self.logger.info("  " * ctx_level + msg)

    def warning(self, msg: str, ctx_level: int = 0) -> None:
        self.logger.warning("  " * ctx_level + msg)

    def error(self, msg: str, ctx_level: int = 0) -> None:
        self.logger.error("  " * ctx_level + msg)

    @staticmethod
    def rank() -> int:
        return 0

    @staticmethod
    def world_size() -> int:
        return 1

    @staticmethod
    def is_rank_zero() -> bool:
        return True

    @staticmethod
    def rank_zero_only(fn: Optional[Callable] = None) -> Callable:
        return _Overwatch.rank_zero_only if fn is None else fn


class DistributedOverwatch(_Overwatch):
    """The logger of one rank of a multi-process world."""

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self.logger.setLevel(logging.INFO if self.is_rank_zero() else logging.ERROR)

    @staticmethod
    def rank() -> int:
        from merv_tpu_torch.parallel.mesh import world

        return world()[0]

    @staticmethod
    def world_size() -> int:
        from merv_tpu_torch.parallel.mesh import world

        return world()[1]

    @classmethod
    def is_rank_zero(cls) -> bool:
        return cls.rank() == 0

    @classmethod
    def rank_zero_only(cls, fn: Optional[Callable] = None) -> Callable:
        """``@rank_zero_only`` or ``@rank_zero_only()``: ``fn`` runs on rank zero, other ranks get None."""
        if fn is None:
            return cls.rank_zero_only

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            return fn(*args, **kwargs) if cls.is_rank_zero() else None

        return wrapper


def initialize_overwatch(name: str) -> _Overwatch:
    return DistributedOverwatch(name) if "WORLD_SIZE" in os.environ else _Overwatch(name)
