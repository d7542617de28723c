"""DeepFM CTR model, the port of the JAX package's models/deepfm.py.

Model (DeepFM, Guo et al. 2017): y = sigmoid(first_order + FM pairwise
interactions + deep MLP over the concatenated field embeddings).
``layers.embedding(is_distributed=True)`` marks the tables that the JAX
package row-shards over a mesh; on one device the lookup is the same (the
sharding, parallel/embedding.py, is not ported). ``is_sparse=True`` gives
the tables row-sparse gradients and lazy row updates (ops/sparse_ops.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.param_attr import ParamAttr


class DeepFMConfig:
    def __init__(
        self,
        num_fields: int = 26,
        vocab_size: int = 1024,
        embed_dim: int = 8,
        hidden: tuple = (64, 32),
    ):
        self.num_fields = num_fields
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden = tuple(hidden)


def build(cfg: Optional[DeepFMConfig] = None, is_distributed: bool = True,
          is_sparse: bool = True):
    """Builds the DeepFM graph in the current program.

    Feeds: feat_ids [b, F] int64 (one id per field), label [b, 1] f32.
    Returns {"feeds", "loss", "logit", "config"}.

    ``is_sparse``: row-sparse {rows, values} embedding gradients + lazy
    per-row optimizer updates instead of dense [V, D] scatter-adds — the
    CTR-scale capability the reference served with SelectedRows
    (ops/sparse_ops.py).
    """
    cfg = cfg or DeepFMConfig()
    f, k = cfg.num_fields, cfg.embed_dim
    ids = layers.data("feat_ids", shape=[f], dtype="int64")
    label = layers.data("label", shape=[1], dtype="float32")

    # first-order weights: [V, 1] table
    w1 = layers.embedding(
        ids, size=[cfg.vocab_size, 1], is_distributed=is_distributed,
        is_sparse=is_sparse,
        param_attr=ParamAttr(name="deepfm_first.w"),
    )  # [b, F, 1]
    first = layers.reduce_sum(w1, dim=1)  # [b, 1]

    # second-order factor table: [V, K]
    emb = layers.embedding(
        ids, size=[cfg.vocab_size, k], is_distributed=is_distributed,
        is_sparse=is_sparse,
        param_attr=ParamAttr(name="deepfm_factor.w"),
    )  # [b, F, K]
    summed = layers.reduce_sum(emb, dim=1)  # [b, K]
    sum_sq = layers.elementwise_mul(summed, summed)
    sq = layers.elementwise_mul(emb, emb)
    sq_sum = layers.reduce_sum(sq, dim=1)  # [b, K]
    fm = layers.scale(
        layers.reduce_sum(
            layers.elementwise_sub(sum_sq, sq_sum), dim=1, keep_dim=True
        ),
        scale=0.5,
    )  # [b, 1]

    # deep tower over the concatenated field embeddings
    deep = layers.reshape(emb, [-1, f * k])
    for i, h in enumerate(cfg.hidden):
        deep = layers.fc(
            deep, h, act="relu", num_flatten_dims=1,
            param_attr=ParamAttr(name=f"deepfm_mlp{i}.w"),
            bias_attr=ParamAttr(name=f"deepfm_mlp{i}.b"),
        )
    deep = layers.fc(
        deep, 1, num_flatten_dims=1,
        param_attr=ParamAttr(name="deepfm_out.w"),
        bias_attr=ParamAttr(name="deepfm_out.b"),
    )

    logit = layers.elementwise_add(layers.elementwise_add(first, fm), deep)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label)
    )
    return {"feeds": [ids, label], "loss": loss, "logit": logit,
            "config": cfg}


def make_batch(cfg: DeepFMConfig, batch: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic CTR batch: per-field ids hash into disjoint vocab ranges,
    labels from a fixed linear probe so the task is learnable."""
    r = np.random.RandomState(seed)
    per_field = cfg.vocab_size // cfg.num_fields
    ids = np.stack(
        [
            r.randint(i * per_field, (i + 1) * per_field, batch)
            for i in range(cfg.num_fields)
        ],
        axis=1,
    ).astype(np.int64)
    probe = np.sin(np.arange(cfg.vocab_size) * 0.7)
    score = probe[ids].sum(axis=1)
    label = (score > 0).astype(np.float32)[:, None]
    return {"feat_ids": ids, "label": label}
