"""Synthetic offline datasets (numpy only)."""

from paddle_tpu_torch.dataset import imagenet  # noqa: F401
