"""Model compression (reference: python/paddle/fluid/contrib/slim/): the
port of the JAX package's ``slim/``, with the same exports."""

from paddle_tpu_torch.slim.distill import soft_label_distill_loss  # noqa: F401
from paddle_tpu_torch.slim.prune import (  # noqa: F401
    SensitivePruneStrategy,
    StructurePruner,
    UniformPruneStrategy,
    apply_masks,
    compute_masks,
    pruned_ratio,
)
from paddle_tpu_torch.slim.quantization import (  # noqa: F401
    QuantizationTransformPass,
    dequantize_weights,
    quantize_weights_int8,
)
