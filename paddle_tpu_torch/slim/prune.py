"""Structured (filter) pruning (reference:
contrib/slim/prune/prune_strategy.py:531 UniformPruneStrategy, :635
SensitivePruneStrategy, and prune/pruner.py StructurePruner).

As in the JAX package, pruning is a mask over output channels (dim 0),
chosen by filter L1 magnitude on the host, applied to the live
parameters in the Scope and applied again after optimizer steps
(``apply_masks``) so the pruned channels stay zero through training.
``apply_masks`` multiplies each parameter in place on its device: since
the Scope's tensors are the captured step's buffers (core/lowering.py),
the next replay reads the masked weights, with no copy to or from the
host.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.io import _to_numpy


class StructurePruner:
    """Magnitude pruner: output channels (dim 0) ranked by filter L1 norm
    (reference: prune/pruner.py StructurePruner, criterion 'l1_norm')."""

    def cal_pruned_idx(self, param: np.ndarray, ratio: float) -> np.ndarray:
        n_out = param.shape[0]
        n_prune = int(n_out * ratio)
        if n_prune == 0:
            return np.zeros((0,), np.int64)
        norms = np.abs(param.reshape(n_out, -1)).sum(axis=1)
        return np.argsort(norms)[:n_prune]

    def mask_for(self, param: np.ndarray, ratio: float) -> np.ndarray:
        mask = np.ones((param.shape[0],), param.dtype)
        mask[self.cal_pruned_idx(param, ratio)] = 0
        return mask


def _match_params(scope, pattern: str) -> List[str]:
    rx = re.compile(pattern)
    return [n for n in scope.var_names() if rx.fullmatch(n)]


def compute_masks(scope, ratios: Dict[str, float],
                  pruner: Optional[StructurePruner] = None
                  ) -> Dict[str, np.ndarray]:
    """Per-parameter channel masks ([n_out] 0/1) from live scope values."""
    pruner = pruner or StructurePruner()
    return {name: pruner.mask_for(_to_numpy(scope.find_var(name)), ratio)
            for name, ratio in ratios.items()}


def apply_masks(scope, masks: Dict[str, np.ndarray]):
    """Zero the pruned output channels in place (call after optimizer
    steps to keep them pruned)."""
    for name, mask in masks.items():
        arr = scope.find_var(name)
        shape = (-1,) + (1,) * (np.ndim(arr) - 1)
        if isinstance(arr, torch.Tensor):
            with torch.no_grad():
                arr.mul_(torch.as_tensor(mask, dtype=arr.dtype).to(
                    arr.device).reshape(shape))
        else:
            scope.set(name, np.asarray(arr) * mask.reshape(shape))


def _restore(scope, name: str, backup: np.ndarray):
    """Put a parameter's saved host copy back, in place where it lives on
    a device."""
    arr = scope.find_var(name)
    if isinstance(arr, torch.Tensor):
        arr.copy_(torch.from_numpy(backup))
    else:
        scope.set(name, backup.copy())


def pruned_ratio(scope, masks: Dict[str, np.ndarray]) -> float:
    """Fraction of weights zeroed across the masked parameters."""
    total = kept = 0
    for name, mask in masks.items():
        size = int(np.prod(np.shape(scope.find_var(name))))
        total += size
        kept += int(mask.sum()) * (size // mask.size)
    return 1.0 - kept / max(total, 1)


class UniformPruneStrategy:
    """Prune every matched parameter by the same ratio (reference:
    prune_strategy.py:531).

    Usage::

        strat = UniformPruneStrategy(target_ratio=0.5,
                                     pruned_params="conv.*_w.*")
        strat.on_compression_begin(scope)
        for epoch ...:
            train steps ...
            strat.on_batch_end(scope)      # re-zero pruned channels
    """

    def __init__(self, pruner: Optional[StructurePruner] = None,
                 start_epoch=0, end_epoch=0, target_ratio: float = 0.5,
                 metric_name=None, pruned_params: str = "conv.*_weights"):
        self.pruner = pruner or StructurePruner()
        self.target_ratio = target_ratio
        self.pruned_params = pruned_params
        self.masks: Dict[str, np.ndarray] = {}

    def on_compression_begin(self, scope):
        names = _match_params(scope, self.pruned_params)
        if not names:
            raise ValueError(
                f"no parameters match pattern '{self.pruned_params}'")
        self.masks = compute_masks(
            scope, {n: self.target_ratio for n in names}, self.pruner)
        apply_masks(scope, self.masks)
        return self.masks

    def on_batch_end(self, scope):
        apply_masks(scope, self.masks)


class SensitivePruneStrategy:
    """Per-parameter ratios from a sensitivity sweep (reference:
    prune_strategy.py:635): prune each parameter alone at increasing
    ratios, measure the metric's drop with ``eval_fn``, then take the
    largest per-parameter ratios whose metric loss stays within
    ``max_metric_loss``."""

    def __init__(self, pruner: Optional[StructurePruner] = None,
                 delta_rate: float = 0.2, target_ratio: float = 0.5,
                 pruned_params: str = "conv.*_weights",
                 max_metric_loss: float = 0.05):
        self.pruner = pruner or StructurePruner()
        self.delta_rate = delta_rate
        self.target_ratio = target_ratio
        self.pruned_params = pruned_params
        self.max_metric_loss = max_metric_loss
        self.sensitivities: Dict[str, Dict[float, float]] = {}
        self.masks: Dict[str, np.ndarray] = {}

    def compute_sensitivities(self, scope, eval_fn: Callable[[], float]):
        """``eval_fn``: the metric on the current scope (higher is
        better)."""
        names = _match_params(scope, self.pruned_params)
        base = float(eval_fn())
        ratios = [r for r in np.arange(self.delta_rate, 1.0,
                                       self.delta_rate)]
        for name in names:
            backup = _to_numpy(scope.find_var(name)).copy()
            curve = {}
            for r in ratios:
                apply_masks(scope,
                            compute_masks(scope, {name: float(r)},
                                          self.pruner))
                curve[float(r)] = base - float(eval_fn())
                _restore(scope, name, backup)
            self.sensitivities[name] = curve
        return self.sensitivities

    def prune(self, scope, eval_fn: Callable[[], float]):
        if not self.sensitivities:
            self.compute_sensitivities(scope, eval_fn)
        ratios = {}
        for name, curve in self.sensitivities.items():
            ok = [r for r, loss in sorted(curve.items())
                  if loss <= self.max_metric_loss]
            ratios[name] = min(max(ok, default=0.0), self.target_ratio)
        self.masks = compute_masks(
            scope, {n: r for n, r in ratios.items() if r > 0}, self.pruner)
        apply_masks(scope, self.masks)
        return ratios

    def on_batch_end(self, scope):
        apply_masks(scope, self.masks)
