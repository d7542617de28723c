"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Program IR and module names as the JAX package (a reader finds
each counterpart by name); ops are plain PyTorch functions run eagerly by
the executor, and the attention kernels the serving and training paths
need (forward with dropout, backward) are hand-written CUDA kernels for
Hopper (parallel/flash_attention.py, csrc/). Entry points run on
``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``.
"""

from paddle_tpu_torch import (  # noqa: F401
    amp,
    backward,
    clip,
    inference,
    initializer,
    io,
    layers,
    optimizer,
    regularizer,
    slim,
    unique_name,
)
from paddle_tpu_torch.executor import (  # noqa: F401
    Executor,
    Scope,
    global_scope,
    scope_guard,
)
from paddle_tpu_torch.framework import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)
from paddle_tpu_torch.param_attr import ParamAttr  # noqa: F401
