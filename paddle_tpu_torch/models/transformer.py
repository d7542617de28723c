"""Transformer NMT model (Transformer-base on WMT16 en-de by default).

The port of the JAX package's models/transformer.py for training and
serving: ``build(cfg)`` (training graph with dropout unless
``is_test=True``), ``make_batch``, beam-search translation
(``build_decode`` / ``translate``) and the serving programs
(``build_prefill`` / ``build_decode_step`` / ``build_slot_scrub``), and
``build_scan`` (the layer stacks as ``scan`` ops over stacked weights)
with ``stack_weights_from_layers``. The
programs, op sequences and parameter / state names match the JAX
package's, so weights carry across by name.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr


class TransformerConfig:
    """Transformer-base hyperparameters (matching the reference benchmark
    config in dist_transformer.py ModelHyperParams)."""

    def __init__(
        self,
        src_vocab_size: int = 10000,
        trg_vocab_size: int = 10000,
        max_length: int = 256,
        d_model: int = 512,
        d_inner: int = 2048,
        n_head: int = 8,
        n_layer: int = 6,
        dropout: float = 0.1,
        label_smooth_eps: float = 0.1,
        dtype: str = "float32",
    ):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.max_length = max_length
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps
        self.dtype = dtype

    @property
    def d_head(self):
        return self.d_model // self.n_head


def base() -> TransformerConfig:
    return TransformerConfig()


def _fc(x, size, prefix, kind, act=None, num_flatten_dims=2):
    return layers.fc(
        x,
        size,
        num_flatten_dims=num_flatten_dims,
        param_attr=ParamAttr(name=f"{prefix}_{kind}.w"),
        bias_attr=ParamAttr(name=f"{prefix}_{kind}.b"),
        act=act,
    )


def _positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal table (reference: dist_transformer.py position_encoding_init)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(d_model // 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * i / d_model)
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


def _multi_head_attention(q_in, kv_in, bias, cfg: TransformerConfig, prefix: str,
                          is_test: bool, causal: bool = False):
    h, dh, d = cfg.n_head, cfg.d_head, cfg.d_model

    # BTHD layout: [b, t, h, dh] straight off the projection reshape, the
    # layout the attention kernel reads (no head transpose around it)
    def split_heads(x):
        return layers.reshape(x, [0, 0, h, dh])

    if q_in is kv_in:
        # self-attention: one fused [d, 3d] projection (one GEMM instead
        # of three)
        qkv = _fc(q_in, 3 * d, f"{prefix}_qkv", "colp")
        q, k, v = layers.split(qkv, 3, dim=-1)
    else:
        q = _fc(q_in, d, f"{prefix}_q", "colp")
        k = _fc(kv_in, d, f"{prefix}_k", "colp")
        v = _fc(kv_in, d, f"{prefix}_v", "colp")
    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    helper = LayerHelper(f"{prefix}_sdpa")
    ctx = helper.create_variable_for_type_inference(dtype=cfg.dtype)
    # logsumexp rows (f32), saved for the attention backward
    lse = helper.create_variable_for_type_inference(dtype="float32")
    lse.stop_gradient = True
    inputs = {"Q": q, "K": k, "V": v}
    if bias is not None:
        inputs["Bias"] = bias
    helper.append_op(
        "scaled_dot_product_attention",
        inputs=inputs,
        outputs={"Out": ctx, "Lse": lse},
        attrs={
            "scale": 1.0 / math.sqrt(dh),
            "dropout_prob": float(cfg.dropout),
            "is_test": is_test,
            "layout": "bthd",
            # causal is an attr: the attention wrapper folds the future
            # mask into the additive bias on the small route and masks
            # it in-kernel on the long ones (parallel/flash_attention.py)
            "causal": causal,
        },
    )
    ctx = layers.reshape(ctx, [0, 0, d])
    return _fc(ctx, d, f"{prefix}_out", "rowp")


def _dropout(x, cfg: TransformerConfig, is_test: bool):
    if cfg.dropout and not is_test:
        x = layers.dropout(x, cfg.dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return x


def _ffn(x, cfg: TransformerConfig, prefix: str, is_test: bool):
    h = _fc(x, cfg.d_inner, f"{prefix}_ffn1", "colp", act="relu")
    h = _dropout(h, cfg, is_test)
    return _fc(h, cfg.d_model, f"{prefix}_ffn2", "rowp")


def _pre_post(x, residual, cfg, prefix, is_test):
    """Residual wiring (reference: preprocess 'n', postprocess 'da'):
    norm -> sublayer -> dropout (training only) -> add."""
    return layers.elementwise_add(_dropout(x, cfg, is_test), residual)


def _ln(x, prefix):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{prefix}_ln.scale"),
        bias_attr=ParamAttr(name=f"{prefix}_ln.bias"),
    )


def _embed(ids, vocab, cfg: TransformerConfig, name: str, pos_table_name: str,
           is_test: bool):
    emb = layers.embedding(
        ids, size=[vocab, cfg.d_model],
        param_attr=ParamAttr(
            name=name,
            initializer=fluid.initializer.NormalInitializer(
                0.0, cfg.d_model ** -0.5),
        ),
    )
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    pos = layers.embedding(
        _position_ids(ids), size=[cfg.max_length, cfg.d_model],
        param_attr=ParamAttr(
            name=pos_table_name,
            initializer=fluid.initializer.NumpyArrayInitializer(
                _positional_encoding(cfg.max_length, cfg.d_model)
            ),
            trainable=False,
        ),
    )
    return _dropout(layers.elementwise_add(emb, pos), cfg, is_test)


def _position_ids(ids):
    """[b, t] int positions built from an op."""
    helper = LayerHelper("pos_ids")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op("position_ids", inputs={"X": ids}, outputs={"Out": out})
    return out


def encoder_layer(x, bias, cfg, i, is_test):
    p = f"enc{i}"
    ln_x = _ln(x, f"{p}_preattn")
    attn = _multi_head_attention(ln_x, ln_x, bias, cfg, f"{p}_attn", is_test)
    x = _pre_post(attn, x, cfg, p, is_test)
    ff = _ffn(_ln(x, f"{p}_preffn"), cfg, p, is_test)
    return _pre_post(ff, x, cfg, p, is_test)


def decoder_layer(x, enc_out, self_bias, cross_bias, cfg, i, is_test):
    p = f"dec{i}"
    attn = _multi_head_attention(_ln(x, f"{p}_preself"), _ln(x, f"{p}_preself"),
                                 self_bias, cfg, f"{p}_self", is_test,
                                 causal=True)
    x = _pre_post(attn, x, cfg, p, is_test)
    ln_x = _ln(x, f"{p}_precross")
    cross = _multi_head_attention(ln_x, enc_out, cross_bias, cfg,
                                  f"{p}_cross", is_test)
    x = _pre_post(cross, x, cfg, p, is_test)
    ff = _ffn(_ln(x, f"{p}_preffn"), cfg, p, is_test)
    return _pre_post(ff, x, cfg, p, is_test)



def _train_feeds_and_biases():
    """Feed vars + attention biases for build()."""
    src = layers.data("src_ids", shape=[-1], dtype="int64",
                      append_batch_size=True)
    trg = layers.data("trg_ids", shape=[-1], dtype="int64")
    lbl = layers.data("lbl_ids", shape=[-1], dtype="int64")
    src_pad = layers.data("src_pad_mask", shape=[-1], dtype="float32")
    trg_pad = layers.data("trg_pad_mask", shape=[-1], dtype="float32")
    helper = LayerHelper("attn_bias")
    enc_bias = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("attn_bias", inputs={"PadMask": src_pad},
                     outputs={"Out": enc_bias}, attrs={"causal": False})
    dec_self_bias = helper.create_variable_for_type_inference("float32", True)
    # pad-only [b, 1, 1, t]: the causal future-mask comes from the
    # decoder self-attention's causal attr
    helper.append_op("attn_bias", inputs={"PadMask": trg_pad},
                     outputs={"Out": dec_self_bias}, attrs={"causal": False})
    return src, trg, lbl, src_pad, trg_pad, enc_bias, dec_self_bias


def _loss_head(dec, lbl, trg_pad, cfg):
    """Shared projection + (optionally label-smoothed) masked token loss."""
    logits = layers.fc(
        dec, cfg.trg_vocab_size, num_flatten_dims=2,
        param_attr=ParamAttr(name="proj_colp.w"), bias_attr=False,
    )
    if cfg.label_smooth_eps:
        smooth = layers.label_smooth(
            layers.one_hot(lbl, cfg.trg_vocab_size),
            epsilon=cfg.label_smooth_eps,
        )
        ce = layers.softmax_with_cross_entropy(logits, smooth,
                                               soft_label=True)
    else:
        ce = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(lbl, [2]))
    ce = layers.reshape(ce, [0, -1])
    masked = layers.elementwise_mul(ce, trg_pad)
    token_count = layers.reduce_sum(trg_pad)
    loss = layers.elementwise_div(
        layers.reduce_sum(masked), layers.elementwise_max(
            token_count, layers.fill_constant_like(token_count, 1.0))
    )
    return logits, token_count, loss


def build(cfg: Optional[TransformerConfig] = None, is_test: bool = False):
    """Builds the full model graph (logits and the masked token loss) in
    the current main/startup programs; with ``is_test=False`` (training)
    dropout runs on the embeddings, residual branches, FFN and attention.

    Feeds: src_ids[b,s], trg_ids[b,t], lbl_ids[b,t], src_pad_mask[b,s],
    trg_pad_mask[b,t] (1 = real token). Returns dict of key variables."""
    cfg = cfg or base()
    (src, trg, lbl, src_pad, trg_pad,
     enc_bias, dec_self_bias) = _train_feeds_and_biases()
    cross_bias = enc_bias  # same src padding bias, broadcast over query dim

    enc = _embed(src, cfg.src_vocab_size, cfg, "src_emb.w", "src_pos.w", is_test)
    for i in range(cfg.n_layer):
        enc = encoder_layer(enc, enc_bias, cfg, i, is_test)
    enc = _ln(enc, "enc_post")

    dec = _embed(trg, cfg.trg_vocab_size, cfg, "trg_emb.w", "trg_pos.w", is_test)
    for i in range(cfg.n_layer):
        dec = decoder_layer(dec, enc, dec_self_bias, cross_bias, cfg, i, is_test)
    dec = _ln(dec, "dec_post")

    logits, token_count, loss = _loss_head(dec, lbl, trg_pad, cfg)
    return {
        "feeds": [src, trg, lbl, src_pad, trg_pad],
        "loss": loss,
        "logits": logits,
        "token_count": token_count,
        "config": cfg,
    }


def make_batch(cfg: TransformerConfig, batch: int, src_len: int, trg_len: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic padded batch matching the feed contract (the JAX
    package's generator: the same seed gives the same arrays)."""
    r = np.random.RandomState(seed)
    src = r.randint(3, cfg.src_vocab_size, (batch, src_len)).astype(np.int64)
    trg = r.randint(3, cfg.trg_vocab_size, (batch, trg_len)).astype(np.int64)
    lbl = r.randint(3, cfg.trg_vocab_size, (batch, trg_len)).astype(np.int64)
    src_lens = r.randint(src_len // 2, src_len + 1, batch)
    trg_lens = r.randint(trg_len // 2, trg_len + 1, batch)
    src_pad = (np.arange(src_len)[None, :] < src_lens[:, None]).astype(
        np.float32)
    trg_pad = (np.arange(trg_len)[None, :] < trg_lens[:, None]).astype(
        np.float32)
    return {
        "src_ids": src * src_pad.astype(np.int64),
        "trg_ids": trg * trg_pad.astype(np.int64),
        "lbl_ids": lbl,
        "src_pad_mask": src_pad,
        "trg_pad_mask": trg_pad,
    }


def _encode_source(src, src_pad, cfg: TransformerConfig):
    """Encoder stack over a padded source batch (weights shared with
    build() by parameter name). Returns ``(enc [b, s, d], enc_bias
    [b, 1, 1, s])`` — the front half of the beam decode and the serving
    prefill."""
    helper = LayerHelper("encode_src")
    enc_bias = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("attn_bias", inputs={"PadMask": src_pad},
                     outputs={"Out": enc_bias}, attrs={"causal": False})
    enc = _embed(src, cfg.src_vocab_size, cfg, "src_emb.w", "src_pos.w",
                 True)
    for i in range(cfg.n_layer):
        enc = encoder_layer(enc, enc_bias, cfg, i, True)
    return _ln(enc, "enc_post"), enc_bias


# --- beam-search decoding: the whole decode loop is one `while` op whose
# body re-runs the decoder over the static-shape prefix each step; the
# encoder and the beam set-up run once around it ---


def build_decode(cfg: Optional[TransformerConfig] = None, beam_size: int = 4,
                 max_len: int = 32, src_len: int = 32, bos_id: int = 0,
                 end_id: int = 1):
    """Builds a beam-search translation graph in the current program.

    Feeds: src_ids [b, src_len] int64, src_pad_mask [b, src_len] f32
    (1 = real). Returns {"feeds", "ids" [b, K, max_len], "scores" [b, K],
    "config"}. ``src_len`` is static; pad or bucket sources to it. The
    loop re-runs the decoder over the full static-shape prefix each step
    (O(T^2) a step, like the reference's cache-less while-loop decoder)
    and stops once every hypothesis has emitted ``end_id`` or at
    ``max_len``. On the card, inside a cached executor call, the loop
    body runs as a captured CUDA graph (ops/control_flow_ops.py)."""
    cfg = cfg or base()
    k, t_max, s_len = int(beam_size), int(max_len), int(src_len)
    src = layers.data("src_ids", shape=[s_len], dtype="int64")
    src_pad = layers.data("src_pad_mask", shape=[s_len], dtype="float32")

    helper = LayerHelper("beam_decode")

    def _op(op_type, inputs, attrs=None, dtype="float32"):
        out = helper.create_variable_for_type_inference(dtype, True)
        helper.append_op(op_type, inputs=inputs, outputs={"Out": out},
                         attrs=attrs or {})
        return out

    # encoder (weights shared with build() by parameter name)
    enc, enc_bias = _encode_source(src, src_pad, cfg)

    # replicate the encoder state per beam: [b, s, d] -> [b*K, s, d]
    enc_beam = layers.reshape(
        layers.expand(layers.unsqueeze(enc, [1]), [1, k, 1, 1]),
        [-1, s_len, cfg.d_model],
    )
    cross_beam = layers.reshape(
        layers.expand(layers.unsqueeze(enc_bias, [1]), [1, k, 1, 1, 1]),
        [-1, 1, 1, s_len],
    )

    # beam state
    seed = _op("slice", {"X": src},
               {"axes": [1], "starts": [0], "ends": [1]}, dtype="int64")
    tmpl = layers.expand(layers.unsqueeze(seed, [2]), [1, k, t_max])
    ids = _op("fill_any_like", {"X": tmpl}, {"value": float(bos_id)},
              dtype="int64")
    zk = layers.cast(
        layers.squeeze(
            _op("slice", {"X": tmpl},
                {"axes": [2], "starts": [0], "ends": [1]}, dtype="int64"),
            [2]),
        "float32")
    zeros_bk = _op("fill_any_like", {"X": zk}, {"value": 0.0})
    beam_mask = _op(
        "assign_value", {},
        {"shape": [k], "dtype": "float32",
         "values": [0.0] + [-1e9] * (k - 1)})
    scores = layers.elementwise_add(zeros_bk, beam_mask)
    finished = layers.cast(zeros_bk, "bool")

    t = layers.fill_constant([1], "int64", 1)
    n_total = layers.reduce_sum(
        _op("fill_any_like", {"X": zeros_bk}, {"value": 1.0}))
    t_lim = layers.fill_constant([1], "int64", t_max)
    cond = layers.less_than(t, t_lim)

    from paddle_tpu_torch.layers.control_flow import While

    with While(cond).block():
        # time mask: positions < t are live
        tpos = _op("range", {}, {"start": 0, "end": t_max, "dtype": "int64"},
                   dtype="int64")
        live = layers.cast(layers.less_than(tpos, t), "float32")  # [T]
        ids_flat = layers.reshape(ids, [-1, t_max])
        trg_pad = layers.elementwise_mul(
            layers.cast(_op("fill_any_like", {"X": ids_flat}, {"value": 1.0},
                            dtype="int64"), "float32"),
            live)
        # pad-only bias: the causal mask is the sdpa op's causal attr
        self_bias = _op("attn_bias", {"PadMask": trg_pad},
                        {"causal": False})
        dec = _embed(ids_flat, cfg.trg_vocab_size, cfg, "trg_emb.w",
                     "trg_pos.w", True)
        for i in range(cfg.n_layer):
            dec = decoder_layer(dec, enc_beam, self_bias, cross_beam, cfg, i,
                                True)
        dec = _ln(dec, "dec_post")
        # logits at the last generated position (t - 1)
        tm1 = layers.increment(t, value=-1.0, in_place=False)
        dec_t = _op("dynamic_slice",
                    {"X": layers.transpose(dec, [1, 0, 2]), "Index": tm1})
        logits = layers.fc(
            dec_t, cfg.trg_vocab_size, num_flatten_dims=1,
            param_attr=ParamAttr(name="proj_colp.w"), bias_attr=False,
        )
        logp = layers.reshape(layers.log_softmax(logits),
                              [-1, k, cfg.trg_vocab_size])

        new_ids = helper.create_variable_for_type_inference("int64", True)
        new_scores = helper.create_variable_for_type_inference("float32", True)
        new_fin = helper.create_variable_for_type_inference("bool", True)
        parent = helper.create_variable_for_type_inference("int64", True)
        helper.append_op(
            "beam_search_step",
            inputs={"Ids": ids, "Scores": scores, "LogProbs": logp,
                    "Finished": finished, "StepIdx": t},
            outputs={"Ids": new_ids, "Scores": new_scores,
                     "Finished": new_fin, "Parent": parent},
            attrs={"end_id": end_id},
        )
        layers.assign(new_ids, output=ids)
        layers.assign(new_scores, output=scores)
        layers.assign(new_fin, output=finished)

        layers.increment(t, value=1.0, in_place=True)
        n_fin = layers.reduce_sum(layers.cast(finished, "float32"))
        layers.assign(
            layers.logical_and(layers.less_than(t, t_lim),
                               layers.less_than(n_fin, n_total)),
            output=cond)

    return {"feeds": [src, src_pad], "ids": ids, "scores": scores,
            "config": cfg}


_decode_prog_cache: Dict[tuple, tuple] = {}


def translate(exe, scope, src_ids: np.ndarray, src_pad: np.ndarray,
              cfg: Optional[TransformerConfig] = None, beam_size: int = 4,
              max_len: int = 32, bos_id: int = 0, end_id: int = 1):
    """Beam-decode a padded source batch with the weights in ``scope``.

    The decode Program is cached per (config, beam, lengths), so repeated
    calls reuse one program object and the executor's cached lowering
    and captured loop body. Returns (ids [b, K, max_len], scores [b, K])
    as numpy arrays."""
    from paddle_tpu_torch import executor as _executor

    cfg = cfg or base()
    key = (
        cfg.src_vocab_size, cfg.trg_vocab_size, cfg.d_model, cfg.d_inner,
        cfg.n_head, cfg.n_layer, cfg.max_length, cfg.dtype,
        beam_size, max_len, int(src_ids.shape[1]), bos_id, end_id,
    )
    cached = _decode_prog_cache.get(key)
    if cached is None:
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            dec = build_decode(cfg, beam_size=beam_size, max_len=max_len,
                               src_len=int(src_ids.shape[1]), bos_id=bos_id,
                               end_id=end_id)
        cached = _decode_prog_cache[key] = (prog, dec)
    prog, dec = cached
    with _executor.scope_guard(scope):
        ids, scores = exe.run(
            prog,
            feed={"src_ids": src_ids, "src_pad_mask": src_pad},
            fetch_list=[dec["ids"], dec["scores"]],
        )
    return ids, scores


def _w_sdpa(q, k, v, bias, cfg, is_test, causal=False):
    helper = LayerHelper("wsdpa")
    ctx = helper.create_variable_for_type_inference(dtype=cfg.dtype)
    lse = helper.create_variable_for_type_inference(dtype="float32")
    lse.stop_gradient = True
    inputs = {"Q": q, "K": k, "V": v}
    if bias is not None:
        inputs["Bias"] = bias
    helper.append_op(
        "scaled_dot_product_attention",
        inputs=inputs,
        outputs={"Out": ctx, "Lse": lse},
        attrs={
            "scale": 1.0 / math.sqrt(cfg.d_head),
            "dropout_prob": float(cfg.dropout),
            "is_test": is_test,
            "layout": "bthd",
            "causal": causal,
        },
    )
    return ctx


# --- scan-over-layers build ---
#
# build() unrolls n_layer copies of the same layer. This variant stacks
# each weight kind across layers ([L, ...] parameters) and runs ONE
# ``scan`` op a stack whose sub-block is a single layer, so the program
# is O(1) in depth; the scan's derived grad re-runs the layer loop under
# autograd (the attention and dropout kernels through their
# autograd.Functions, ops/attention_ops.py, ops/nn_ops.py). Same math as
# build(): ``stack_weights_from_layers`` maps build()'s per-layer weights
# onto the stacks.


def _w_fc(x, w, b=None, act=None):
    """fc with EXPLICIT weight vars (no parameter creation) — for scan
    sub-blocks where weights are per-layer slices."""
    helper = LayerHelper("wfc")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        "mul", inputs={"X": x, "Y": w}, outputs={"Out": out},
        attrs={"x_num_col_dims": 2, "y_num_col_dims": 1},
    )
    if b is not None:
        out2 = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(
            "elementwise_add", inputs={"X": out, "Y": b},
            outputs={"Out": out2}, attrs={"axis": 2},
        )
        out = out2
    if act:
        out = getattr(layers, act)(out)
    return out


def _w_ln(x, scale, bias):
    helper = LayerHelper("wln")
    y = helper.create_variable_for_type_inference(dtype=x.dtype)
    mean = helper.create_variable_for_type_inference(dtype="float32", stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype="float32", stop_gradient=True)
    helper.append_op(
        "layer_norm",
        inputs={"X": x, "Scale": scale, "Bias": bias},
        outputs={"Y": y, "Mean": mean, "Variance": var},
        attrs={"begin_norm_axis": 2, "epsilon": 1e-5},
    )
    return y


def _w_attention(q_in, kv_in, bias, cfg, weights, is_test, fused_qkv,
                 causal=False):
    h, dh, d = cfg.n_head, cfg.d_head, cfg.d_model

    def split_heads(z):
        return layers.reshape(z, [0, 0, h, dh])  # BTHD, see _multi_head_attention

    if fused_qkv:
        qkv = _w_fc(q_in, weights["qkv.w"], weights["qkv.b"])
        q, k, v = layers.split(qkv, 3, dim=-1)
    else:
        q = _w_fc(q_in, weights["q.w"], weights["q.b"])
        k = _w_fc(kv_in, weights["k.w"], weights["k.b"])
        v = _w_fc(kv_in, weights["v.w"], weights["v.b"])
    ctx = _w_sdpa(split_heads(q), split_heads(k), split_heads(v), bias,
                  cfg, is_test, causal=causal)
    ctx = layers.reshape(ctx, [0, 0, d])
    return _w_fc(ctx, weights["out.w"], weights["out.b"])


def _w_drop_add(x, residual, cfg, is_test):
    if cfg.dropout and not is_test:
        x = layers.dropout(x, cfg.dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.elementwise_add(x, residual)


# (slot key, per-layer shape fn, maps-from per-layer param name fn)
def _enc_weight_specs(cfg):
    d, di = cfg.d_model, cfg.d_inner
    return [
        ("preattn_ln.scale", [d], lambda i: f"enc{i}_preattn_ln.scale"),
        ("preattn_ln.bias", [d], lambda i: f"enc{i}_preattn_ln.bias"),
        ("qkv.w", [d, 3 * d], lambda i: f"enc{i}_attn_qkv_colp.w"),
        ("qkv.b", [3 * d], lambda i: f"enc{i}_attn_qkv_colp.b"),
        ("out.w", [d, d], lambda i: f"enc{i}_attn_out_rowp.w"),
        ("out.b", [d], lambda i: f"enc{i}_attn_out_rowp.b"),
        ("preffn_ln.scale", [d], lambda i: f"enc{i}_preffn_ln.scale"),
        ("preffn_ln.bias", [d], lambda i: f"enc{i}_preffn_ln.bias"),
        ("ffn1.w", [d, di], lambda i: f"enc{i}_ffn1_colp.w"),
        ("ffn1.b", [di], lambda i: f"enc{i}_ffn1_colp.b"),
        ("ffn2.w", [di, d], lambda i: f"enc{i}_ffn2_rowp.w"),
        ("ffn2.b", [d], lambda i: f"enc{i}_ffn2_rowp.b"),
    ]


def _dec_weight_specs(cfg):
    d, di = cfg.d_model, cfg.d_inner
    specs = [
        ("preself_ln.scale", [d], lambda i: f"dec{i}_preself_ln.scale"),
        ("preself_ln.bias", [d], lambda i: f"dec{i}_preself_ln.bias"),
        ("self_q.w", [d, d], lambda i: f"dec{i}_self_q_colp.w"),
        ("self_q.b", [d], lambda i: f"dec{i}_self_q_colp.b"),
        ("self_k.w", [d, d], lambda i: f"dec{i}_self_k_colp.w"),
        ("self_k.b", [d], lambda i: f"dec{i}_self_k_colp.b"),
        ("self_v.w", [d, d], lambda i: f"dec{i}_self_v_colp.w"),
        ("self_v.b", [d], lambda i: f"dec{i}_self_v_colp.b"),
        ("self_out.w", [d, d], lambda i: f"dec{i}_self_out_rowp.w"),
        ("self_out.b", [d], lambda i: f"dec{i}_self_out_rowp.b"),
        ("precross_ln.scale", [d], lambda i: f"dec{i}_precross_ln.scale"),
        ("precross_ln.bias", [d], lambda i: f"dec{i}_precross_ln.bias"),
        ("q.w", [d, d], lambda i: f"dec{i}_cross_q_colp.w"),
        ("q.b", [d], lambda i: f"dec{i}_cross_q_colp.b"),
        ("k.w", [d, d], lambda i: f"dec{i}_cross_k_colp.w"),
        ("k.b", [d], lambda i: f"dec{i}_cross_k_colp.b"),
        ("v.w", [d, d], lambda i: f"dec{i}_cross_v_colp.w"),
        ("v.b", [d], lambda i: f"dec{i}_cross_v_colp.b"),
        ("cross_out.w", [d, d], lambda i: f"dec{i}_cross_out_rowp.w"),
        ("cross_out.b", [d], lambda i: f"dec{i}_cross_out_rowp.b"),
        ("preffn_ln.scale", [d], lambda i: f"dec{i}_preffn_ln.scale"),
        ("preffn_ln.bias", [d], lambda i: f"dec{i}_preffn_ln.bias"),
        ("ffn1.w", [d, di], lambda i: f"dec{i}_ffn1_colp.w"),
        ("ffn1.b", [di], lambda i: f"dec{i}_ffn1_colp.b"),
        ("ffn2.w", [di, d], lambda i: f"dec{i}_ffn2_rowp.w"),
        ("ffn2.b", [d], lambda i: f"dec{i}_ffn2_rowp.b"),
    ]
    return specs


def _layer_scan(x, cfg, specs, body_fn, stack_prefix, is_test,
                batch_vars=(), unroll=1):
    """Run ``body_fn(x_var, weights)`` once per layer via the scan op,
    with each weight kind stacked [n_layer, ...] and scanned.

    ``batch_vars``: names of captured vars with the carry's batch dim
    (attention biases, the encoder output), recorded in the scan attr
    ``stream_names`` as in the JAX package, whose pipeline strategy
    microbatches them (the port runs a pipelinable scan as the plain
    scan: ops/control_flow_ops.py)."""
    from paddle_tpu_torch.layers.control_flow import _captured_names

    prog = fluid.default_main_program()
    parent = prog.current_block()
    helper = LayerHelper(stack_prefix)
    stacked = {}
    for key, shape, _src in specs:
        is_bias_like = len(shape) == 1
        if is_bias_like:
            init = fluid.initializer.ConstantInitializer(
                1.0 if key.endswith("ln.scale") else 0.0)
        else:
            # match build()'s LayerHelper default (Xavier over the
            # PER-LAYER fan, not the stacked shape) so from-scratch runs
            # start from the same distribution in both modes
            init = fluid.initializer.XavierInitializer(
                fan_in=shape[0], fan_out=shape[1])
        stacked[key] = helper.create_parameter(
            ParamAttr(name=f"{stack_prefix}_{key}_stacked",
                      initializer=init),
            shape=[cfg.n_layer] + shape,
            dtype=cfg.dtype,
        )

    sub = prog._create_block()
    try:
        slice_vars = {}
        for key, shape, _src in specs:
            slice_vars[key] = sub.create_var(
                name=unique_name.generate(f"{stack_prefix}_{key}_slice"),
                dtype=cfg.dtype, shape=tuple(shape),
            )
        x_in = sub.create_var(
            name=unique_name.generate(f"{stack_prefix}_carry"),
            dtype=x.dtype, shape=x.shape,
        )
        x_out = body_fn(x_in, slice_vars)
    finally:
        prog._rollback()

    x_names = [slice_vars[k].name for k, _s, _f in specs]
    captured = _captured_names(sub, parent, exclude=x_names + [x_in.name])
    final = parent.create_var(
        name=unique_name.generate(f"{stack_prefix}_out"),
        dtype=x.dtype, shape=x.shape,
    )
    parent.append_op(
        "scan",
        inputs={
            "X": [stacked[k].name for k, _s, _f in specs],
            "Init": [x.name],
            "Captured": captured,
        },
        outputs={"Y": [], "FinalState": [final.name]},
        attrs={
            "sub_block": sub,
            "x_names": x_names,
            "state_in_names": [x_in.name],
            "state_out_names": [x_out.name],
            "y_names": [],
            "captured_names": captured,
            # one scan step a LAYER with a single carried activation:
            # the JAX package's GPipe schedule takes it under a pipe axis
            "pipelinable": True,
            "unroll": int(unroll),
            "stream_names": [n for n in captured
                             if n in set(batch_vars)],
        },
    )
    return final


def build_scan(cfg: Optional[TransformerConfig] = None,
               is_test: bool = False, unroll: int = 1):
    """Same model as build() with the layer stacks rolled into scan ops.
    Parameters are stacked per weight kind (``enc_stack_*_stacked``
    [n_layer, ...]); use ``stack_weights_from_layers`` to map build()'s
    per-layer weights onto them for parity checks.

    ``unroll``: the JAX package's layers a scan-loop iteration; the
    port's scan is a Python loop of layers already, so every ``unroll``
    gives the same program but for the attr, and the same math."""
    cfg = cfg or base()
    (src, trg, lbl, src_pad, trg_pad,
     enc_bias, dec_self_bias) = _train_feeds_and_biases()

    enc_in = _embed(src, cfg.src_vocab_size, cfg, "src_emb.w", "src_pos.w",
                    is_test)

    def enc_body(x, w):
        attn = _w_attention(
            _w_ln(x, w["preattn_ln.scale"], w["preattn_ln.bias"]), None,
            enc_bias, cfg,
            {"qkv.w": w["qkv.w"], "qkv.b": w["qkv.b"],
             "out.w": w["out.w"], "out.b": w["out.b"]},
            is_test, fused_qkv=True)
        x = _w_drop_add(attn, x, cfg, is_test)
        ff = _w_fc(
            _w_ln(x, w["preffn_ln.scale"], w["preffn_ln.bias"]),
            w["ffn1.w"], w["ffn1.b"], act="relu")
        if cfg.dropout and not is_test:
            ff = layers.dropout(ff, cfg.dropout, is_test=is_test,
                                dropout_implementation="upscale_in_train")
        ff = _w_fc(ff, w["ffn2.w"], w["ffn2.b"])
        return _w_drop_add(ff, x, cfg, is_test)

    enc = _layer_scan(enc_in, cfg, _enc_weight_specs(cfg), enc_body,
                      "enc_stack", is_test,
                      batch_vars=(enc_bias.name,), unroll=unroll)
    enc = _ln(enc, "enc_post")

    dec_in = _embed(trg, cfg.trg_vocab_size, cfg, "trg_emb.w", "trg_pos.w",
                    is_test)

    def dec_body(x, w):
        # build()'s decoder self-attention projects q/k/v separately (its
        # two _ln calls are distinct vars, so the fused-qkv branch never
        # fires there) — mirror that exactly for weight-level parity
        ln_self = _w_ln(x, w["preself_ln.scale"], w["preself_ln.bias"])
        attn = _w_attention(
            ln_self, ln_self, dec_self_bias, cfg,
            {"q.w": w["self_q.w"], "q.b": w["self_q.b"],
             "k.w": w["self_k.w"], "k.b": w["self_k.b"],
             "v.w": w["self_v.w"], "v.b": w["self_v.b"],
             "out.w": w["self_out.w"], "out.b": w["self_out.b"]},
            is_test, fused_qkv=False, causal=True)
        x = _w_drop_add(attn, x, cfg, is_test)
        ln_x = _w_ln(x, w["precross_ln.scale"], w["precross_ln.bias"])
        cross = _w_attention(
            ln_x, enc, enc_bias, cfg,
            {"q.w": w["q.w"], "q.b": w["q.b"], "k.w": w["k.w"],
             "k.b": w["k.b"], "v.w": w["v.w"], "v.b": w["v.b"],
             "out.w": w["cross_out.w"], "out.b": w["cross_out.b"]},
            is_test, fused_qkv=False)
        x = _w_drop_add(cross, x, cfg, is_test)
        ff = _w_fc(
            _w_ln(x, w["preffn_ln.scale"], w["preffn_ln.bias"]),
            w["ffn1.w"], w["ffn1.b"], act="relu")
        if cfg.dropout and not is_test:
            ff = layers.dropout(ff, cfg.dropout, is_test=is_test,
                                dropout_implementation="upscale_in_train")
        ff = _w_fc(ff, w["ffn2.w"], w["ffn2.b"])
        return _w_drop_add(ff, x, cfg, is_test)

    dec = _layer_scan(dec_in, cfg, _dec_weight_specs(cfg), dec_body,
                      "dec_stack", is_test,
                      batch_vars=(dec_self_bias.name, enc_bias.name,
                                  enc.name), unroll=unroll)
    dec = _ln(dec, "dec_post")

    logits, token_count, loss = _loss_head(dec, lbl, trg_pad, cfg)
    return {
        "feeds": [src, trg, lbl, src_pad, trg_pad],
        "loss": loss,
        "logits": logits,
        "token_count": token_count,
        "config": cfg,
    }


# --- serving-plane programs: prefill + single-token KV-cache decode ---
#
# The serving split (serving.py ServingEngine) runs two programs per
# engine, plus a slot scrub:
#
# - build_prefill: admit ONE request into a batch *slot* — run the
#   encoder once, project every decoder layer's cross-attention K/V, and
#   write them (plus reset per-slot decode state) into slot-indexed
#   persistable cache tensors that stay device-resident between steps.
# - build_decode_step: ONE token for EVERY slot — embed each slot's
#   current token at its own position, append this step's self-attention
#   K/V rows to the on-device cache (ops/serving_ops.py kv_cache_write),
#   attend over the per-slot visible prefix (kv_step_bias), and emit the
#   greedy next token, all at fixed shapes. O(T) per token, one program
#   for any mix of in-flight requests.
#
# Cache state (per engine, shapes from serving_state_specs) carries
# through the executor's ordinary state path: the executor gathers the
# persistable vars from the serving scope and commits the tensors the
# block produced — the KV cache never round-trips through the host.


def serving_state_specs(cfg: TransformerConfig, slots: int, src_len: int,
                        max_len: int) -> Dict[str, tuple]:
    """name -> (shape, numpy dtype) for the engine's device-resident
    serving state. ``serve_k/v{i}`` are the decoder self-attention KV
    rings (slot x position), ``serve_ck/cv{i}`` the per-request
    cross-attention K/V written at prefill, plus per-slot scalars:
    current token, its position, and the live flag."""
    h, dh = cfg.n_head, cfg.d_head
    specs: Dict[str, tuple] = {
        "serve_cur_ids": ((slots,), "int64"),
        "serve_pos": ((slots,), "int64"),
        "serve_live": ((slots,), "bool"),
        "serve_cross_bias": ((slots, 1, 1, src_len), "float32"),
    }
    for i in range(cfg.n_layer):
        specs[f"serve_k{i}"] = ((slots, max_len, h, dh), cfg.dtype)
        specs[f"serve_v{i}"] = ((slots, max_len, h, dh), cfg.dtype)
        specs[f"serve_ck{i}"] = ((slots, src_len, h, dh), cfg.dtype)
        specs[f"serve_cv{i}"] = ((slots, src_len, h, dh), cfg.dtype)
    return specs


def _serve_state_vars(cfg, slots, src_len, max_len):
    """Declare the serving-state vars (persistable: the executor reads
    them from the engine's scope and commits them back) in the current
    program."""
    block = fluid.default_main_program().global_block()
    out = {}
    for name, (shape, dtype) in serving_state_specs(
            cfg, slots, src_len, max_len).items():
        out[name] = block.create_var(
            name=name, shape=list(shape), dtype=dtype, persistable=True,
            stop_gradient=True)
    return out


def build_prefill(cfg: Optional[TransformerConfig] = None, slots: int = 4,
                  src_len: int = 32, max_len: int = 32, bos_id: int = 0):
    """Admission program: encode one request and install it into a slot.

    Feeds: src_ids [1, src_len] int64, src_pad_mask [1, src_len] f32,
    slot [1] int64 (the batch slot this request occupies). Writes the
    slot's cross-attention K/V + bias rows and resets its decode state
    (cur=BOS at position 0, live). No fetches — admission is a pure
    device-state update."""
    cfg = cfg or base()
    if src_len > cfg.max_length or max_len > cfg.max_length:
        raise ValueError(
            f"src_len/max_len ({src_len}/{max_len}) exceed the position "
            f"table (max_length={cfg.max_length})")
    src = layers.data("src_ids", shape=[src_len], dtype="int64")
    src_pad = layers.data("src_pad_mask", shape=[src_len], dtype="float32")
    slot = layers.data("slot", shape=[1], dtype="int64",
                       append_batch_size=False)
    state = _serve_state_vars(cfg, slots, src_len, max_len)
    helper = LayerHelper("prefill")

    def _slot_update(cache_var, value):
        # cache[slot] = value (scalar slot index: the dynamic_update op)
        out = helper.create_variable_for_type_inference(cache_var.dtype,
                                                        True)
        helper.append_op(
            "dynamic_update",
            inputs={"X": cache_var, "Index": slot, "Value": value},
            outputs={"Out": out})
        layers.assign(out, output=cache_var)

    enc, enc_bias = _encode_source(src, src_pad, cfg)  # [1, s, d]
    h, dh = cfg.n_head, cfg.d_head
    for i in range(cfg.n_layer):
        # cross-attention K/V projected ONCE per request at admission
        # (build_decode recomputes them from enc every step)
        k = _fc(enc, cfg.d_model, f"dec{i}_cross_k", "colp")
        v = _fc(enc, cfg.d_model, f"dec{i}_cross_v", "colp")
        # [1, s, d] -> [s, h, dh] (batch is literally 1 at admission)
        k = layers.reshape(k, [-1, h, dh])
        v = layers.reshape(v, [-1, h, dh])
        _slot_update(state[f"serve_ck{i}"], k)
        _slot_update(state[f"serve_cv{i}"], v)
    _slot_update(state["serve_cross_bias"],
                 layers.reshape(enc_bias, [1, 1, -1]))  # [1, 1, s] row
    # slot decode state: BOS at position 0, live
    _scatter_reset = [
        ("serve_cur_ids", layers.fill_constant([1], "int64",
                                               float(bos_id))),
        ("serve_pos", layers.fill_constant([1], "int64", 0.0)),
        ("serve_live", layers.fill_constant([1], "bool", 1.0)),
    ]
    for name, updates in _scatter_reset:
        new = layers.scatter(state[name], slot, updates)
        layers.assign(new, output=state[name])
    return {"feeds": [src, src_pad, slot], "state": state, "config": cfg}


def build_decode_step(cfg: Optional[TransformerConfig] = None,
                      slots: int = 4, src_len: int = 32, max_len: int = 32,
                      end_id: int = 1):
    """One greedy decode token for every slot, against the on-device KV
    cache. Feed: active_mask [slots] bool (host-side admission/eviction
    control — a slot the host has evicted decodes as dead whatever the
    device live flag says). Fetches: emitted token [slots] int64, live
    [slots] bool (False = finished: EOS or length cap), position
    [slots] int64 of the emitted token, and max |logit| per slot
    (f32 — non-finite marks the slot poisoned; serving evicts it)."""
    cfg = cfg or base()
    d, h, dh = cfg.d_model, cfg.n_head, cfg.d_head
    active = layers.data("active_mask", shape=[slots], dtype="bool",
                         append_batch_size=False)
    state = _serve_state_vars(cfg, slots, src_len, max_len)
    cur, pos, live = (state["serve_cur_ids"], state["serve_pos"],
                      state["serve_live"])
    helper = LayerHelper("decode_step")

    # embed each slot's current token at its own position (the training
    # graph's _embed, with position_ids replaced by the per-slot pos)
    emb = layers.embedding(
        layers.unsqueeze(cur, [1]), size=[cfg.trg_vocab_size, d],
        param_attr=ParamAttr(
            name="trg_emb.w",
            initializer=fluid.initializer.NormalInitializer(
                0.0, cfg.d_model ** -0.5)))
    emb = layers.scale(emb, scale=d ** 0.5)
    pemb = layers.embedding(
        layers.unsqueeze(pos, [1]), size=[cfg.max_length, d],
        param_attr=ParamAttr(
            name="trg_pos.w",
            initializer=fluid.initializer.NumpyArrayInitializer(
                _positional_encoding(cfg.max_length, cfg.d_model)),
            trainable=False))
    x = layers.elementwise_add(emb, pemb)  # [S, 1, d]

    # per-slot causal bias over the self-attention cache: position j
    # visible iff j <= pos[s] (stale rows from a slot's previous
    # occupant sit above pos and stay masked)
    step_bias = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("kv_step_bias", inputs={"Pos": pos},
                     outputs={"Out": step_bias},
                     attrs={"length": int(max_len)})

    def split_heads(z):
        return layers.reshape(z, [0, 0, h, dh])

    def cache_append(cache_var, row):
        # cache[s, pos[s]] = row[s] — then attend the UPDATED cache so
        # the current token sees its own K/V (full-prefix semantics)
        out = helper.create_variable_for_type_inference(cache_var.dtype,
                                                        True)
        helper.append_op("kv_cache_write",
                         inputs={"Cache": cache_var, "New": row,
                                 "Pos": pos},
                         outputs={"Out": out})
        layers.assign(out, output=cache_var)
        return out

    for i in range(cfg.n_layer):
        p = f"dec{i}"
        # self-attention against the slot's KV ring
        ln_x = _ln(x, f"{p}_preself")
        q = split_heads(_fc(ln_x, d, f"{p}_self_q", "colp"))
        kc = cache_append(state[f"serve_k{i}"],
                          split_heads(_fc(ln_x, d, f"{p}_self_k", "colp")))
        vc = cache_append(state[f"serve_v{i}"],
                          split_heads(_fc(ln_x, d, f"{p}_self_v", "colp")))
        ctx = _w_sdpa(q, kc, vc, step_bias, cfg, True)
        attn = _fc(layers.reshape(ctx, [0, 0, d]), d, f"{p}_self_out",
                   "rowp")
        x = layers.elementwise_add(attn, x)
        # cross-attention against the prefill-cached encoder K/V
        ln_x = _ln(x, f"{p}_precross")
        q = split_heads(_fc(ln_x, d, f"{p}_cross_q", "colp"))
        ctx = _w_sdpa(q, state[f"serve_ck{i}"], state[f"serve_cv{i}"],
                      state["serve_cross_bias"], cfg, True)
        cross = _fc(layers.reshape(ctx, [0, 0, d]), d, f"{p}_cross_out",
                    "rowp")
        x = layers.elementwise_add(cross, x)
        ff = _ffn(_ln(x, f"{p}_preffn"), cfg, p, True)
        x = layers.elementwise_add(ff, x)
    x = _ln(x, "dec_post")
    logits = layers.fc(
        x, cfg.trg_vocab_size, num_flatten_dims=2,
        param_attr=ParamAttr(name="proj_colp.w"), bias_attr=False,
    )
    flat = layers.reshape(logits, [slots, cfg.trg_vocab_size])
    nxt = layers.argmax(flat, axis=-1)  # [S] int64, greedy
    # per-slot poison probe: max |logit| per slot (NaN/Inf propagate
    # through the max) — the serving plane checks np.isfinite on the
    # host and evicts ONLY the poisoned slot(s), the decode-path twin of
    # the numerics plane's nonfinite/maxabs reduction
    maxabs = layers.reduce_max(layers.abs(flat), dim=1)  # [S] f32
    # the greedy token's own logit (the row max — argmax's value): the
    # request-trace plane samples it onto decode-step trace events so a
    # request's track shows WHAT was emitted and how confident the head
    # was, without a second device round-trip
    score = layers.reduce_max(flat, dim=1)  # [S] f32

    # liveness: host mask AND device EOS/length tracking. A dead slot
    # freezes (emits end_id, position pinned) until the next prefill
    # re-arms it.
    end_const = layers.fill_constant([slots], "int64", float(end_id))
    live_now = layers.logical_and(live, active)
    emit = layers.where(live_now, nxt, end_const)
    new_live = layers.logical_and(
        live_now, layers.logical_not(layers.equal(emit, end_const)))
    limit = layers.fill_constant([slots], "int64", float(max_len - 1))
    new_live = layers.logical_and(new_live, layers.less_than(pos, limit))
    emit_pos = layers.elementwise_add(
        pos, layers.cast(live_now, "int64"))  # position the token holds
    layers.assign(emit, output=cur)
    layers.assign(emit_pos, output=pos)
    layers.assign(new_live, output=live)
    return {"feeds": [active], "emit": emit, "live": new_live,
            "pos": emit_pos, "maxabs": maxabs, "score": score,
            "state": state, "config": cfg}


def build_slot_scrub(cfg: Optional[TransformerConfig] = None,
                     slots: int = 4, src_len: int = 32,
                     max_len: int = 32):
    """Zero ONE slot's row in every device-resident serving tensor, on
    device (serving.py's poisoned-slot eviction: a stale non-finite K/V
    row would re-poison the slot's next occupant through the softmax
    mask, and a host round-trip of the full caches to zero one row
    would stall the decode loop). Feed: slot [1] int64. No fetches —
    like prefill, a pure device-state update."""
    cfg = cfg or base()
    slot = layers.data("slot", shape=[1], dtype="int64",
                       append_batch_size=False)
    state = _serve_state_vars(cfg, slots, src_len, max_len)
    helper = LayerHelper("slot_scrub")
    for name, (shape, dtype) in serving_state_specs(
            cfg, slots, src_len, max_len).items():
        var = state[name]
        if len(shape) == 1:
            # per-slot scalar (cur/pos/live): scatter one zero element
            new = layers.scatter(
                var, slot, layers.fill_constant([1], dtype, 0.0))
            layers.assign(new, output=var)
        else:
            # cache row: cache[slot] = zeros(shape[1:]) (the prefill
            # _slot_update idiom)
            zero = layers.fill_constant(list(shape[1:]), dtype, 0.0)
            out = helper.create_variable_for_type_inference(var.dtype,
                                                            True)
            helper.append_op(
                "dynamic_update",
                inputs={"X": var, "Index": slot, "Value": zero},
                outputs={"Out": out})
            layers.assign(out, output=var)
    return {"feeds": [slot], "state": state, "config": cfg}


_serving_prog_cache: Dict[tuple, dict] = {}


def build_serving(cfg: TransformerConfig, slots: int, src_len: int,
                  max_len: int, bos_id: int = 0, end_id: int = 1) -> dict:
    """Build (or return cached) the serving programs (prefill, decode
    step, slot scrub) for this (config, geometry). Engines sharing a
    geometry share program objects."""
    key = (
        cfg.src_vocab_size, cfg.trg_vocab_size, cfg.d_model, cfg.d_inner,
        cfg.n_head, cfg.n_layer, cfg.max_length, cfg.dtype,
        slots, src_len, max_len, bos_id, end_id,
    )
    cached = _serving_prog_cache.get(key)
    if cached is not None:
        return cached
    prefill_prog, decode_prog = fluid.Program(), fluid.Program()
    scrub_prog = fluid.Program()
    with fluid.program_guard(prefill_prog, fluid.Program()):
        prefill = build_prefill(cfg, slots=slots, src_len=src_len,
                                max_len=max_len, bos_id=bos_id)
    with fluid.program_guard(decode_prog, fluid.Program()):
        decode = build_decode_step(cfg, slots=slots, src_len=src_len,
                                   max_len=max_len, end_id=end_id)
    with fluid.program_guard(scrub_prog, fluid.Program()):
        scrub = build_slot_scrub(cfg, slots=slots, src_len=src_len,
                                 max_len=max_len)
    entry = {
        "prefill_program": prefill_prog, "prefill": prefill,
        "decode_program": decode_prog, "decode": decode,
        "scrub_program": scrub_prog, "scrub": scrub,
        "state_specs": serving_state_specs(cfg, slots, src_len, max_len),
        "config": cfg,
    }
    _serving_prog_cache[key] = entry
    return entry


def stack_weights_from_layers(cfg, per_layer_scope, scan_scope):
    """Copy build()-style per-layer weights into build_scan()'s stacked
    parameters (for parity tests / migration). The per-layer scope may
    hold tensors on any device, or arrays; the stacks are set as numpy
    arrays, which the next run moves to its device."""
    for prefix, specs in (("enc_stack", _enc_weight_specs(cfg)),
                          ("dec_stack", _dec_weight_specs(cfg))):
        for key, _shape, src_fn in specs:
            stack = np.stack([
                _host_array(per_layer_scope.find_var(src_fn(i)))
                for i in range(cfg.n_layer)
            ])
            scan_scope.set(f"{prefix}_{key}_stacked", stack)


def _host_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
