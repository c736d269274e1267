"""The reference's `Config` with one more detection field."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.reference import config as base


@dataclass(frozen=True)
class DetectionConfig(base.DetectionConfig):
    # Epsilon of the LayerNorm the toy detector puts on the finest level.
    feature_norm_eps: float = 1e-6


@dataclass(frozen=True)
class Config(base.Config):
    detection: DetectionConfig = field(default_factory=DetectionConfig)
