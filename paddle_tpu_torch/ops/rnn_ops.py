"""Recurrent ops: lstm, gru, gru_unit, lstm_unit, lstmp.

The reference's recurrent operators (operators/lstm_op.cc, gru_op.cc,
gru_unit_op.cc, lstm_unit_op.cc, lstmp_op.cc) over a padded batch
``[B, T, ...]`` and an optional ``Length`` (``[B]`` or ``[B, 1]``), as
the JAX package lays them out (``paddle_tpu/ops/rnn_ops.py``), where
each recurrence is a ``lax.scan`` that XLA fuses: there is no Pallas
source. Here each op is a loop of a fixed trip count T over plain tensor
ops inside the op, so a captured training step holds the whole
recurrence, a few kernels a time step, and the derived grad op
(core/autodiff.py) re-runs the loop under autograd.

The input-to-hidden projection is outside the op (an ``fc`` over all
steps at once), as in the JAX package; the op adds the hidden-to-hidden
product ``h @ W`` a step (``torch.addmm``).

Padding: at and beyond a row's length the state carries over unchanged
and ``Hidden`` is zero there, while ``Cell`` repeats the carried cell;
``LastH`` / ``LastC`` are the carried state. ``is_reverse`` walks
t = T - 1 ... 0 and still writes the outputs in time order, so a row's
padded tail comes first and leaves ``H0`` / ``C0`` untouched.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _opt(ins, slot):
    """Optional slot -> tensor or None (an empty list and [None] both mean
    absent)."""
    vals = ins.get(slot)
    return vals[0] if vals else None


def _live(ins, t):
    """[B, T] bool, step s of row b live (s < Length[b]); None without a
    Length."""
    length = _opt(ins, "Length")
    if length is None:
        return None
    if length.dim() > 1:
        length = length.squeeze(-1)
    return torch.arange(t, device=length.device)[None, :] < length[:, None]


def _steps(t, attrs):
    return range(t - 1, -1, -1) if attrs.get("is_reverse", False) \
        else range(t)


def _meta(x, shapes):
    """Shape inference (meta tensors): the outputs' shapes alone, without
    walking T steps."""
    return {slot: [torch.empty(s, dtype=x.dtype, device=x.device)]
            for slot, s in shapes.items()}


def _carry(live, s, new, old):
    """The state after step s: ``new`` where the step is live, ``old``
    (carried) where it is padding."""
    if live is None:
        return new
    return torch.where(live[:, s:s + 1], new, old)


def _emit(live, s, h):
    """The step's output: ``h`` where live, zero where padding."""
    if live is None:
        return h
    return torch.where(live[:, s:s + 1], h, 0.0)


@register_op("lstm", diff_inputs=("Input", "Weight", "Bias", "H0", "C0"))
def _lstm(ins, attrs, device):
    """LSTM over a projected input stream.

    inputs: Input [B, T, 4H] (x @ Wx, gate order i, f, c~, o), Weight
    [H, 4H], Bias [4H], H0 / C0 [B, H], Length; all but Input and Weight
    optional. outputs: Hidden, Cell [B, T, H], LastH, LastC [B, H].
    attrs: is_reverse, gate_activation, cell_activation,
    candidate_activation, forget_bias (added to f inside its gate
    activation)."""
    x, w = ins["Input"][0], ins["Weight"][0]
    b, t, four_h = x.shape
    h_dim = four_h // 4
    if x.is_meta:
        return _meta(x, {"Hidden": (b, t, h_dim), "Cell": (b, t, h_dim),
                         "LastH": (b, h_dim), "LastC": (b, h_dim)})
    h, c = _opt(ins, "H0"), _opt(ins, "C0")
    if h is None:
        h = x.new_zeros((b, h_dim))
    if c is None:
        c = x.new_zeros((b, h_dim))
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    forget_bias = attrs.get("forget_bias", 0.0)
    bias = _opt(ins, "Bias")
    if bias is not None:
        x = x + bias
    live = _live(ins, t)
    hs, cs = [None] * t, [None] * t
    for s in _steps(t, attrs):
        g = torch.addmm(x[:, s], h, w)
        i, f, c_hat, o = g.chunk(4, dim=1)
        if forget_bias:
            f = f + forget_bias
        c_new = gate_act(f) * c + gate_act(i) * cand_act(c_hat)
        h_new = gate_act(o) * cell_act(c_new)
        hs[s] = _emit(live, s, h_new)
        c = cs[s] = _carry(live, s, c_new, c)
        h = _carry(live, s, h_new, h)
    return {"Hidden": [torch.stack(hs, 1)], "Cell": [torch.stack(cs, 1)],
            "LastH": [h], "LastC": [c]}


@register_op("gru", diff_inputs=("Input", "Weight", "Bias", "H0"))
def _gru(ins, attrs, device):
    """GRU over a projected input stream.

    inputs: Input [B, T, 3H] (x @ Wx, gate order u, r, c), Weight
    [H, 3H], Bias [3H], H0 [B, H], Length; all but Input and Weight
    optional. outputs: Hidden [B, T, H], LastH [B, H]. attrs:
    is_reverse, gate_activation (u, r), activation (the candidate). The
    candidate multiplies ``r * h_prev`` by ``Weight[:, 2H:]`` after the
    gate product, as the JAX op does."""
    x, w = ins["Input"][0], ins["Weight"][0]
    b, t, three_h = x.shape
    h_dim = three_h // 3
    if x.is_meta:
        return _meta(x, {"Hidden": (b, t, h_dim), "LastH": (b, h_dim)})
    h = _opt(ins, "H0")
    if h is None:
        h = x.new_zeros((b, h_dim))
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACTS[attrs.get("activation", "tanh")]
    bias = _opt(ins, "Bias")
    if bias is not None:
        x = x + bias
    w_ur, w_c = w[:, :2 * h_dim], w[:, 2 * h_dim:]
    live = _live(ins, t)
    hs = [None] * t
    for s in _steps(t, attrs):
        g = x[:, s]
        u, r = gate_act(torch.addmm(g[:, :2 * h_dim], h, w_ur)).chunk(2, 1)
        cand = cand_act(torch.addmm(g[:, 2 * h_dim:], r * h, w_c))
        h_new = u * h + (1 - u) * cand
        hs[s] = _emit(live, s, h_new)
        h = _carry(live, s, h_new, h)
    return {"Hidden": [torch.stack(hs, 1)], "LastH": [h]}


@register_op("gru_unit", diff_inputs=("Input", "HiddenPrev", "Weight", "Bias"))
def _gru_unit(ins, attrs, device):
    """One GRU step (operators/gru_unit_op.cc). inputs: Input [B, 3H] (x
    projection, gate order u, r, c), HiddenPrev [B, H], Weight [H, 3H],
    Bias [3H] optional. outputs: Hidden [B, H], Gate [B, 3H] (u, r and
    the candidate after their activations), ResetHiddenPrev [B, H]."""
    x, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACTS[attrs.get("activation", "tanh")]
    hsz = h_prev.shape[-1]
    bias = _opt(ins, "Bias")
    if bias is not None:
        x = x + bias
    xu, xr, xc = x[:, :hsz], x[:, hsz:2 * hsz], x[:, 2 * hsz:]
    wu, wr, wc = w[:, :hsz], w[:, hsz:2 * hsz], w[:, 2 * hsz:]
    u = gate_act(torch.addmm(xu, h_prev, wu))
    r = gate_act(torch.addmm(xr, h_prev, wr))
    rh = r * h_prev
    c = cand_act(torch.addmm(xc, rh, wc))
    h = u * h_prev + (1.0 - u) * c
    return {"Hidden": [h], "Gate": [torch.cat([u, r, c], dim=-1)],
            "ResetHiddenPrev": [rh]}


@register_op("lstm_unit", diff_inputs=("X", "C_prev"))
def _lstm_unit(ins, attrs, device):
    """One LSTM cell step on projected gates (operators/lstm_unit_op.h),
    in caffe2's gate order **i, f, o, g**: slot 2 is the output gate, slot
    3 the tanh candidate. X [B, 4D], C_prev [B, D]; outputs C, H [B, D]."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    forget_bias = float(attrs.get("forget_bias", 0.0))
    i, f, o, g = x.chunk(4, dim=1)
    c_new = (torch.sigmoid(f + forget_bias) * c_prev
             + torch.sigmoid(i) * torch.tanh(g))
    return {"C": [c_new], "H": [torch.sigmoid(o) * torch.tanh(c_new)]}


@register_op("lstmp", diff_inputs=("Input", "Weight", "ProjWeight", "Bias"))
def _lstmp(ins, attrs, device):
    """LSTM with a recurrent projection (operators/lstmp_op.cc). Input
    [B, T, 4D] projected gates (i, f, c~, o), Weight [P, 4D] over the
    projected state, ProjWeight [D, P], Bias (its first 4D entries, added
    after the recurrent product). No Length; the state starts at zero
    (h [B, P], c [B, D]). outputs: Projection [B, T, P], Cell [B, T, D]."""
    x, w, w_proj = ins["Input"][0], ins["Weight"][0], ins["ProjWeight"][0]
    b, t, d4 = x.shape
    d, p = d4 // 4, w_proj.shape[1]
    if x.is_meta:
        return _meta(x, {"Projection": (b, t, p), "Cell": (b, t, d)})
    bias = _opt(ins, "Bias")
    if bias is not None:
        bias = bias.reshape(-1)[:d4]
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    proj_act = _ACTS[attrs.get("proj_activation", "tanh")]
    h, c = x.new_zeros((b, p)), x.new_zeros((b, d))
    hs, cs = [None] * t, [None] * t
    for s in _steps(t, attrs):
        gates = torch.addmm(x[:, s], h, w)
        if bias is not None:
            gates = gates + bias
        i, f, g, o = gates.chunk(4, dim=1)
        c = cs[s] = gate_act(f) * c + gate_act(i) * cand_act(g)
        h = hs[s] = proj_act(torch.matmul(gate_act(o) * cell_act(c),
                                          w_proj))
    return {"Projection": [torch.stack(hs, 1)], "Cell": [torch.stack(cs, 1)]}
