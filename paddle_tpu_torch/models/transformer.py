"""Transformer NMT model (Transformer-base on WMT16 en-de by default).

The port of the JAX package's models/transformer.py for training and
serving: ``build(cfg)`` (training graph with dropout unless
``is_test=True``), ``make_batch`` and the serving programs
(``build_prefill`` / ``build_decode_step`` / ``build_slot_scrub``). The
programs, op sequences and parameter / state names match the JAX
package's, so weights carry across by name.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
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
    [b, 1, 1, s])`` — the front half of the serving prefill."""
    helper = LayerHelper("encode_src")
    enc_bias = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("attn_bias", inputs={"PadMask": src_pad},
                     outputs={"Out": enc_bias}, attrs={"causal": False})
    enc = _embed(src, cfg.src_vocab_size, cfg, "src_emb.w", "src_pos.w",
                 True)
    for i in range(cfg.n_layer):
        enc = encoder_layer(enc, enc_bias, cfg, i, True)
    return _ln(enc, "enc_post"), enc_bias


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
