"""BERT-base pretraining: an encoder-only Transformer with masked-LM and
next-sentence heads, the port of the JAX package's models/bert.py.

It reuses the port's Transformer encoder layer (models/transformer.py:
the fused QKV projection and the sdpa op, whose hand-written attention
kernels run at t <= 512 on the small route), so the AMP policy is the
Transformer's. Parameter names are the JAX package's, so weights carry
across by name (``io.scope_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.param_attr import ParamAttr


class BertConfig:
    def __init__(
        self,
        vocab_size: int = 30522,
        max_position: int = 512,
        type_vocab_size: int = 2,
        d_model: int = 768,
        d_inner: int = 3072,
        n_head: int = 12,
        n_layer: int = 12,
        dropout: float = 0.1,
    ):
        self.vocab_size = vocab_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.dropout = dropout

    def encoder_cfg(self) -> T.TransformerConfig:
        return T.TransformerConfig(
            src_vocab_size=self.vocab_size,
            trg_vocab_size=self.vocab_size,
            max_length=self.max_position,
            d_model=self.d_model,
            d_inner=self.d_inner,
            n_head=self.n_head,
            n_layer=self.n_layer,
            dropout=self.dropout,
            label_smooth_eps=0.0,
        )


def base() -> BertConfig:
    return BertConfig()


def build(cfg: Optional[BertConfig] = None, is_test: bool = False):
    """Pretraining graph. Feeds: input_ids [b, t], token_type_ids [b, t],
    pad_mask [b, t] (1 = real), mlm_labels [b, t] (-1 = unmasked
    position), nsp_labels [b, 1]."""
    cfg = cfg or base()
    ecfg = cfg.encoder_cfg()

    ids = layers.data("input_ids", shape=[-1], dtype="int64")
    type_ids = layers.data("token_type_ids", shape=[-1], dtype="int64")
    pad = layers.data("pad_mask", shape=[-1], dtype="float32")
    mlm_lbl = layers.data("mlm_labels", shape=[-1], dtype="int64")
    nsp_lbl = layers.data("nsp_labels", shape=[1], dtype="int64")

    helper = LayerHelper("bert")
    bias = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("attn_bias", inputs={"PadMask": pad},
                     outputs={"Out": bias}, attrs={"causal": False})

    tok = layers.embedding(
        ids, size=[cfg.vocab_size, cfg.d_model],
        param_attr=ParamAttr(
            name="bert_tok_emb.w",
            initializer=fluid.initializer.NormalInitializer(0.0, 0.02)),
    )
    seg = layers.embedding(
        type_ids, size=[cfg.type_vocab_size, cfg.d_model],
        param_attr=ParamAttr(
            name="bert_seg_emb.w",
            initializer=fluid.initializer.NormalInitializer(0.0, 0.02)),
    )
    pos_ids = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("position_ids", inputs={"X": ids},
                     outputs={"Out": pos_ids})
    pos = layers.embedding(
        pos_ids, size=[cfg.max_position, cfg.d_model],
        param_attr=ParamAttr(
            name="bert_pos_emb.w",
            initializer=fluid.initializer.NormalInitializer(0.0, 0.02)),
    )
    x = layers.elementwise_add(layers.elementwise_add(tok, seg), pos)
    x = layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name="bert_emb_ln.scale"),
        bias_attr=ParamAttr(name="bert_emb_ln.bias"),
    )
    if cfg.dropout and not is_test:
        x = layers.dropout(x, cfg.dropout,
                           dropout_implementation="upscale_in_train")

    for i in range(cfg.n_layer):
        x = T.encoder_layer(x, bias, ecfg, i, is_test)
    x = T._ln(x, "enc_post")

    # MLM head: transform + vocab projection
    mlm = layers.fc(
        x, cfg.d_model, num_flatten_dims=2, act="gelu",
        param_attr=ParamAttr(name="mlm_tr_colp.w"),
        bias_attr=ParamAttr(name="mlm_tr_colp.b"),
    )
    mlm = layers.layer_norm(
        mlm, begin_norm_axis=2,
        param_attr=ParamAttr(name="mlm_ln.scale"),
        bias_attr=ParamAttr(name="mlm_ln.bias"),
    )
    mlm_logits = layers.fc(
        mlm, cfg.vocab_size, num_flatten_dims=2,
        param_attr=ParamAttr(name="mlm_proj_colp.w"), bias_attr=False,
    )

    # NSP head over the [CLS] (first) position
    cls = layers.squeeze(
        layers.slice(x, axes=[1], starts=[0], ends=[1]), [1])
    nsp_logits = layers.fc(
        cls, 2,
        param_attr=ParamAttr(name="nsp.w"),
        bias_attr=ParamAttr(name="nsp.b"),
    )

    # masked-LM loss over masked positions only (mlm_labels == -1 ignored)
    safe_lbl = layers.elementwise_max(
        mlm_lbl, layers.fill_constant_like(mlm_lbl, 0.0))
    ce = layers.softmax_with_cross_entropy(
        mlm_logits, layers.unsqueeze(safe_lbl, [2]))
    ce = layers.reshape(ce, [0, -1])
    is_masked = layers.cast(
        layers.greater_than(
            layers.cast(mlm_lbl, "float32"),
            layers.fill_constant_like(
                layers.cast(mlm_lbl, "float32"), -0.5)),
        "float32",
    )
    mlm_count = layers.elementwise_max(
        layers.reduce_sum(is_masked),
        layers.fill_constant([], "float32", 1.0))
    mlm_loss = layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(ce, is_masked)), mlm_count)

    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(nsp_logits, nsp_lbl))
    loss = layers.elementwise_add(mlm_loss, nsp_loss)
    return {
        "feeds": [ids, type_ids, pad, mlm_lbl, nsp_lbl],
        "loss": loss,
        "mlm_loss": mlm_loss,
        "nsp_loss": nsp_loss,
        "mlm_logits": mlm_logits,
        "config": cfg,
    }


def make_batch(cfg: BertConfig, batch: int, seq_len: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    r = np.random.RandomState(seed)
    ids = r.randint(4, cfg.vocab_size, (batch, seq_len)).astype(np.int64)
    type_ids = np.zeros((batch, seq_len), np.int64)
    half = seq_len // 2
    type_ids[:, half:] = 1
    pad = np.ones((batch, seq_len), np.float32)
    mlm = np.full((batch, seq_len), -1, np.int64)
    n_mask = max(1, int(seq_len * 0.15))
    for row in range(batch):
        pos = r.choice(seq_len, n_mask, replace=False)
        mlm[row, pos] = ids[row, pos]
        ids[row, pos] = 3  # [MASK]
    nsp = r.randint(0, 2, (batch, 1)).astype(np.int64)
    return {"input_ids": ids, "token_type_ids": type_ids, "pad_mask": pad,
            "mlm_labels": mlm, "nsp_labels": nsp}
