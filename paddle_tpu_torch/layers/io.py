"""Data layers.

``data`` declares a feed variable; there are no feed/fetch *ops* — the
executor binds feeds directly into the block's environment
(core/lowering.py).
"""

from __future__ import annotations

from typing import Sequence

from paddle_tpu_torch.framework import convert_np_dtype_to_dtype_, default_main_program

__all__ = ["data"]


def data(
    name: str,
    shape: Sequence[int],
    append_batch_size: bool = True,
    dtype: str = "float32",
    lod_level: int = 0,
    type=None,
    stop_gradient: bool = True,
):
    """Declare an input variable. ``lod_level`` is accepted for source
    compatibility; variable-length data is padded dense + mask."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(
        name=name,
        shape=shape,
        dtype=convert_np_dtype_to_dtype_(dtype),
        persistable=False,
        stop_gradient=stop_gradient,
    )
