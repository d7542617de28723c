"""Stacked dynamic-LSTM sentiment classifier, the port of the JAX
package's models/stacked_lstm.py (reference:
benchmark/fluid/models/stacked_dynamic_lstm.py: IMDB sentiment, an
embedding into ``stacked_num`` fc + lstm blocks, max-pooled over time
into a softmax). Sequences are padded [b, t] ids with their lengths; the
recurrences are the ``lstm`` op (ops/rnn_ops.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.layers import rnn as rnn_layers
from paddle_tpu_torch.param_attr import ParamAttr


class StackedLSTMConfig:
    def __init__(self, vocab_size: int = 5148, embed_dim: int = 128,
                 hidden_dim: int = 128, stacked_num: int = 3,
                 num_classes: int = 2, max_len: int = 128):
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.stacked_num = stacked_num
        self.num_classes = num_classes
        self.max_len = max_len


def build(cfg: Optional[StackedLSTMConfig] = None):
    """Feeds: words [b, t] int64, seq_len [b] int64, label [b, 1] int64."""
    cfg = cfg or StackedLSTMConfig()
    words = layers.data("words", shape=[cfg.max_len], dtype="int64")
    seq_len = layers.data("seq_len", shape=[], dtype="int64")
    label = layers.data("label", shape=[1], dtype="int64")

    x = layers.embedding(
        words, size=[cfg.vocab_size, cfg.embed_dim],
        param_attr=ParamAttr(name="slstm_emb.w"))
    for i in range(cfg.stacked_num):
        proj = layers.fc(x, cfg.hidden_dim * 4, num_flatten_dims=2,
                         param_attr=ParamAttr(name=f"slstm_fc{i}.w"),
                         bias_attr=ParamAttr(name=f"slstm_fc{i}.b"))
        x, _ = rnn_layers.dynamic_lstm(
            proj, cfg.hidden_dim * 4, length=seq_len,
            param_attr=ParamAttr(name=f"slstm_lstm{i}.w"),
            bias_attr=ParamAttr(name=f"slstm_lstm{i}.b"))
    # max over each row's live steps (padding cannot win the max)
    pooled = layers.sequence_pool(x, "max", length=seq_len)
    logits = layers.fc(pooled, cfg.num_classes, num_flatten_dims=1,
                       param_attr=ParamAttr(name="slstm_out.w"),
                       bias_attr=ParamAttr(name="slstm_out.b"))
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return {"feeds": [words, seq_len, label], "loss": loss, "acc": acc,
            "logits": logits, "config": cfg}


def make_batch(cfg: StackedLSTMConfig, batch: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """A synthetic batch with the imdb reader's signal: a positive row
    draws 70% of its tokens from the upper half of the vocabulary, a
    negative one 30%; lengths from max_len / 4 to max_len - 1."""
    r = np.random.RandomState(seed)
    half = cfg.vocab_size // 2
    words = np.zeros((batch, cfg.max_len), np.int64)
    lens = r.randint(cfg.max_len // 4, cfg.max_len, batch)
    labels = r.randint(0, 2, (batch, 1)).astype(np.int64)
    for i in range(batch):
        p_hi = 0.7 if labels[i, 0] else 0.3
        n = int(lens[i])
        hi = r.randint(half, cfg.vocab_size, n)
        lo = r.randint(2, half, n)
        pick = r.rand(n) < p_hi
        words[i, :n] = np.where(pick, hi, lo)
    return {"words": words, "seq_len": lens.astype(np.int64),
            "label": labels}
