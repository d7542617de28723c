"""bf16 mixed precision: a program marked ``_amp`` runs its matmul-heavy
ops in bf16 and keeps the activation stream between them in bf16 (the
op sets are in core/interp.py). bf16 needs no loss scaling; the JAX
package's ``AmpOptimizer`` / ``decorate`` (dynamic loss scaling) are not
ported yet."""

from __future__ import annotations

from paddle_tpu_torch.framework import default_main_program


def enable_amp(program=None):
    """Mark a program for bf16 execution of its matmul-heavy ops."""
    (program or default_main_program())._amp = True


def disable_amp(program=None):
    (program or default_main_program())._amp = False
