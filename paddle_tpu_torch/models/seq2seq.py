"""LSTM encoder-decoder with dot attention, the port of the JAX package's
models/seq2seq.py (reference: benchmark/fluid/models/
machine_translation.py). Padded [B, T] batches with their lengths and
pad masks; each layer is an fc gate projection over all steps and the
``lstm`` op's recurrence (ops/rnn_ops.py); Luong dot attention is two
batched matmuls around a masked softmax.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from paddle_tpu_torch import initializer, layers
from paddle_tpu_torch.layers import rnn as rnn_layers
from paddle_tpu_torch.param_attr import ParamAttr


class Seq2SeqConfig:
    def __init__(
        self,
        src_vocab_size: int = 2000,
        trg_vocab_size: int = 2000,
        embed_dim: int = 128,
        hidden_dim: int = 256,
        num_layers: int = 2,
    ):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers


def _embed(ids, vocab, dim, name):
    return layers.embedding(
        ids, size=[vocab, dim],
        param_attr=ParamAttr(
            name=name, initializer=initializer.NormalInitializer(0.0, 0.1)))


def _lstm_stack(x, cfg, length, prefix, num_layers):
    """Stacked LSTM: an fc gate projection a layer ([B*T, D] x [D, 4H])
    and the recurrence."""
    h = cfg.hidden_dim
    for i in range(num_layers):
        gates = layers.fc(
            x, 4 * h, num_flatten_dims=2,
            param_attr=ParamAttr(name=f"{prefix}_l{i}_ih.w"),
            bias_attr=ParamAttr(name=f"{prefix}_l{i}_ih.b"))
        x, _ = rnn_layers.dynamic_lstm(
            gates, 4 * h, length=length,
            param_attr=ParamAttr(name=f"{prefix}_l{i}_hh.w"),
            bias_attr=ParamAttr(name=f"{prefix}_l{i}_hh.b"))
    return x


def _dot_attention(dec_h, enc_h, src_pad):
    """Luong dot attention: scores [B, Tt, Ts] in one matmul, -1e9 on the
    source's padding, softmax, the context in a second matmul."""
    scores = layers.matmul(dec_h, enc_h, transpose_y=True)
    neg = layers.scale(
        layers.unsqueeze(layers.elementwise_sub(
            layers.fill_constant_like(src_pad, 1.0), src_pad), [1]),
        scale=-1e9)  # [B, 1, Ts]
    weights = layers.softmax(layers.elementwise_add(scores, neg))
    return layers.matmul(weights, enc_h)  # [B, Tt, H]


def build(cfg: Optional[Seq2SeqConfig] = None):
    """Training graph. Feeds: src_ids [b, ts], trg_ids [b, tt], lbl_ids
    [b, tt], src_pad_mask [b, ts], trg_pad_mask [b, tt], src_len [b],
    trg_len [b]. The loss is the mean cross entropy over live target
    tokens."""
    cfg = cfg or Seq2SeqConfig()
    src = layers.data("src_ids", shape=[-1], dtype="int64")
    trg = layers.data("trg_ids", shape=[-1], dtype="int64")
    lbl = layers.data("lbl_ids", shape=[-1], dtype="int64")
    src_pad = layers.data("src_pad_mask", shape=[-1], dtype="float32")
    trg_pad = layers.data("trg_pad_mask", shape=[-1], dtype="float32")
    src_len = layers.data("src_len", shape=[], dtype="int64")
    trg_len = layers.data("trg_len", shape=[], dtype="int64")

    enc_in = _embed(src, cfg.src_vocab_size, cfg.embed_dim, "src_emb.w")
    enc_h = _lstm_stack(enc_in, cfg, src_len, "enc", cfg.num_layers)
    dec_in = _embed(trg, cfg.trg_vocab_size, cfg.embed_dim, "trg_emb.w")
    dec_h = _lstm_stack(dec_in, cfg, trg_len, "dec", cfg.num_layers)

    ctx = _dot_attention(dec_h, enc_h, src_pad)
    merged = layers.fc(
        layers.concat([dec_h, ctx], axis=-1), cfg.hidden_dim,
        num_flatten_dims=2, act="tanh",
        param_attr=ParamAttr(name="attn_merge.w"),
        bias_attr=ParamAttr(name="attn_merge.b"))
    logits = layers.fc(
        merged, cfg.trg_vocab_size, num_flatten_dims=2,
        param_attr=ParamAttr(name="proj.w"), bias_attr=False)

    ce = layers.softmax_with_cross_entropy(logits, layers.unsqueeze(lbl, [2]))
    masked = layers.elementwise_mul(layers.reshape(ce, [0, -1]), trg_pad)
    tokens = layers.elementwise_max(
        layers.reduce_sum(trg_pad),
        layers.fill_constant([], "float32", 1.0))
    loss = layers.elementwise_div(layers.reduce_sum(masked), tokens)
    return {
        "feeds": [src, trg, lbl, src_pad, trg_pad, src_len, trg_len],
        "loss": loss,
        "logits": logits,
        "config": cfg,
    }


def make_batch(cfg: Seq2SeqConfig, batch: int, src_len: int, trg_len: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """A synthetic copy-like batch: labels derive from the source (cycled
    when the target is longer), so the attention has a signal to learn;
    lengths from half the padded length to all of it."""
    r = np.random.RandomState(seed)
    src = r.randint(2, cfg.src_vocab_size, (batch, src_len)).astype(np.int64)
    trg = r.randint(2, cfg.trg_vocab_size, (batch, trg_len)).astype(np.int64)
    reps = -(-trg_len // src_len)  # ceil
    src_cycled = np.tile(src, (1, reps))[:, :trg_len]
    lbl = (src_cycled % (cfg.trg_vocab_size - 2) + 2).astype(np.int64)
    s_lens = r.randint(max(src_len // 2, 1), src_len + 1, batch)
    t_lens = r.randint(max(trg_len // 2, 1), trg_len + 1, batch)
    return {
        "src_ids": src,
        "trg_ids": trg,
        "lbl_ids": lbl,
        "src_pad_mask": (np.arange(src_len)[None] < s_lens[:, None]
                         ).astype(np.float32),
        "trg_pad_mask": (np.arange(trg_len)[None] < t_lens[:, None]
                         ).astype(np.float32),
        "src_len": s_lens.astype(np.int64),
        "trg_len": t_lens.astype(np.int64),
    }
