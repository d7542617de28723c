"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Program IR and module names as the JAX package (a reader finds
each counterpart by name); ops are plain PyTorch functions run eagerly by
the executor, and the attention kernels the serving and training paths
need (forward with dropout, backward) are hand-written CUDA kernels for
Hopper (parallel/flash_attention.py, csrc/). Entry points run on
``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``. The serving
planes (flags, faults, retry, monitor, numerics, serving_trace) are the
JAX package's, with the card's device reads; ``fleet_serving`` routes
requests over several supervised replicas on one card. ``contrib.Trainer``
trains from readers (``reader``, ``dataset``, ``data_feeder``) with a
prefetch loader onto the card and crash-consistent checkpoints
(``parallel.checkpoint``).
"""

from paddle_tpu_torch import (  # noqa: F401
    amp,
    backward,
    clip,
    dataset_api,
    faults,
    flags,
    fleet_serving,
    inference,
    initializer,
    io,
    layers,
    metrics,
    monitor,
    numerics,
    optimizer,
    profiler,
    regularizer,
    retry,
    serving,
    serving_trace,
    slim,
    unique_name,
)
from paddle_tpu_torch.backward import append_backward, gradients  # noqa: F401
from paddle_tpu_torch.dataset_api import DatasetFactory  # noqa: F401
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
