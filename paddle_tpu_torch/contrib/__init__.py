"""High-level training APIs (reference: python/paddle/fluid/contrib/)."""

from paddle_tpu_torch.contrib.trainer import (  # noqa: F401
    BeginEpochEvent,
    BeginStepEvent,
    CheckpointConfig,
    EndEpochEvent,
    EndStepEvent,
    Trainer,
)
