"""Serving runtime (counterpart of ``merv_tpu/serving``): a continuous-batching
engine with per-slot KV-cache pointers, so finished slots are refilled while
the rest keep decoding."""

from merv_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    EngineStats,
    Request,
    RequestResult,
)

__all__ = ["ContinuousBatchingEngine", "EngineStats", "Request", "RequestResult"]
