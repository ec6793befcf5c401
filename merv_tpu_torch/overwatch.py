"""Minimal logging shim standing in for ``merv_tpu.overwatch``.

Single-process only: messages go to stderr through :mod:`logging` so a script
with a machine-read stdout (``chip_smoke.py``) keeps its stdout clean.
``ctx_level`` is accepted for call-site compatibility and indents the message.
"""

from __future__ import annotations

import logging
import sys


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


def initialize_overwatch(name: str) -> _Overwatch:
    return _Overwatch(name)
