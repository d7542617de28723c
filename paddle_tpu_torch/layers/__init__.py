"""Layers API: the graph-building functions the ported models use."""

from paddle_tpu_torch.layers.io import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.layers.rnn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.more import *  # noqa: F401,F403
from paddle_tpu_torch.layers import detection  # noqa: F401
from paddle_tpu_torch.layers.detection import *  # noqa: F401,F403
from paddle_tpu_torch.layers.control_flow import (  # noqa: F401
    DynamicRNN,
    IfElse,
    Print,
    StaticRNN,
    Switch,
    While,
    array_fill,
    array_write_step,
    cond,
    while_loop,
)
from paddle_tpu_torch.layers import learning_rate_scheduler  # noqa: F401
from paddle_tpu_torch.layers.learning_rate_scheduler import (  # noqa: F401
    cosine_decay,
    exponential_decay,
    inverse_time_decay,
    natural_exp_decay,
    noam_decay,
    piecewise_decay,
    polynomial_decay,
)
