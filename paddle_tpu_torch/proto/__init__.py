"""The program schema (``framework.proto``) and its wire codec."""

from paddle_tpu_torch.proto import framework_wire  # noqa: F401
