"""Host-callback and tail operators: py_func, print, hash, tree_conv.

The JAX package's ``ops/misc_ops.py`` (the reference's py_func_op.cc,
print_op.cc, hash_op.cc, tree_conv_op.cc):

- ``py_func`` runs a registered user callable on the host: its inputs
  are copied to numpy, its results back to the op's device with the
  shapes and dtypes declared at build time. The backward callable is a
  second ``py_func`` op, emitted by the same grad maker as the JAX
  package's.
- ``print`` is the identity with a host print of its input each time it
  runs (``first_n`` counted per op instance across steps); print_phase
  BACKWARD / BOTH prints the incoming gradient through a second print
  op.

  Both are ``host_callback`` ops: a block that holds one is never
  captured as a CUDA graph, so the callback runs at every step
  (core/lowering.py). On meta tensors (shape inference) neither calls
  back.
- ``hash`` is XXH64 of each row's first 4 bytes an element, ``num_hash``
  seeds, modulo ``mod_by``: the JAX package's bucket values under x64,
  bit for bit. The 64-bit arithmetic runs in int64 tensors (products
  wrap mod 2**64, right shifts are made logical: ``core/rng.py``
  ``_srl``), so it needs no unsigned 64-bit op on the card.
- ``tree_conv`` builds each tree's patch weights as three dense [n, n]
  matrices from ``max_depth`` adjacency products and applies the filter
  with batched matmuls (autodiff through the derived grad).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from paddle_tpu_torch.core.registry import get_op_def, register_op
from paddle_tpu_torch.core.rng import _srl, signed64
from paddle_tpu_torch.framework import torch_dtype


def _x(ins, slot="X", i=0):
    vals = ins.get(slot)
    return None if not vals else vals[i]


# --------------------------------------------------------------------------
# py_func
# --------------------------------------------------------------------------

_PY_FUNC_REGISTRY: List[Callable] = []


def register_py_func(fn: Callable) -> int:
    """Register a host callable; returns its id (the reference's
    ``PyFuncRegistry``, layers/nn.py:11004)."""
    _PY_FUNC_REGISTRY.append(fn)
    return len(_PY_FUNC_REGISTRY) - 1


def registered_py_func(idx: int) -> Callable:
    return _PY_FUNC_REGISTRY[idx]


def _normalize_results(res, shapes, dtypes):
    if res is None:
        res = ()
    if not isinstance(res, (tuple, list)):
        res = (res,)
    out = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        r = res[i] if i < len(res) else None
        if r is None:
            # None = "no gradient for this input" (the reference py_func
            # backward contract): a zero contribution
            out.append(np.zeros(shape, dtype))
        else:
            out.append(np.asarray(r).astype(dtype).reshape(shape))
    return out


def _py_func_grad_maker(op, block, out_grads, provide, should_skip):
    """Emit the backward py_func op (reference: py_func_op.cc grad maker:
    backward inputs are fwd X + fwd Out + Out grads minus skip vars;
    outputs are the X grads)."""
    bwd_id = int(op.attrs.get("backward_callable_id", -1))
    if bwd_id < 0:
        return []  # no backward_func: a non-differentiable boundary
    skip = set(op.attrs.get("backward_skip_vars") or [])
    xs = list(op.inputs.get("X") or [])
    outs = list(op.outputs.get("Out") or [])
    gs = list((out_grads.get("Out") or []))

    in_names, none_pos = [], []
    pos = 0
    for n in xs + outs:
        if n in skip:
            continue
        in_names.append(n)
        pos += 1
    for g in gs:
        if g:
            in_names.append(g)
        else:
            none_pos.append(pos)  # backward_func receives None here
        pos += 1

    opdef = get_op_def("py_func")
    g_out_names, g_shapes, g_dtypes = [], [], []
    for n in xs:
        src = block._find_var_recursive(n)
        if should_skip(n, "X", opdef):
            g_out_names.append("")
            g_shapes.append([1])
            g_dtypes.append("float32")
            continue
        if src is None or src.shape is None:
            raise ValueError(
                f"py_func backward needs a declared shape for input '{n}'")
        gname = provide(n)
        block.create_var(name=gname, shape=src.shape, dtype=src.dtype)
        g_out_names.append(gname)
        g_shapes.append([int(d) for d in src.shape])
        g_dtypes.append(str(src.dtype))
    if not any(g_out_names):
        return []
    return [dict(
        type="py_func",
        inputs={"X": in_names},
        outputs={"Out": g_out_names},
        attrs={
            "forward_callable_id": bwd_id,
            "backward_callable_id": -1,
            "out_shapes": g_shapes,
            "out_dtypes": g_dtypes,
            "none_positions": none_pos,
            # backward_func returns one grad per forward input; grads for
            # skipped (stop_gradient / int) inputs are dropped rather than
            # reshaped into the placeholder slots
            "drop_positions": [i for i, nm in enumerate(g_out_names)
                               if not nm],
        },
    )]


@register_op("py_func", grad_maker=_py_func_grad_maker, host_callback=True)
def _py_func(ins, attrs, device):
    """User Python on the host (reference: py_func_op.cc:105): the inputs
    as numpy arrays, the results as tensors of the declared shapes and
    dtypes on ``device``. Without outputs the callable runs for its
    effect (the reference's debug-print usage)."""
    xs = [x for x in (ins.get("X") or []) if x is not None]
    fid = int(attrs["forward_callable_id"])
    none_pos = set(int(p) for p in (attrs.get("none_positions") or []))
    shapes = [tuple(int(d) for d in s)
              for s in (attrs.get("out_shapes") or [])]
    dtypes = [np.dtype(d) for d in (attrs.get("out_dtypes") or [])]
    if device.type == "meta":
        return {"Out": [torch.empty(s, dtype=torch_dtype(str(d)),
                                    device=device)
                        for s, d in zip(shapes, dtypes)]} if shapes else {}
    arrs = [x.detach().cpu().numpy() for x in xs]
    it = iter(arrs)
    args = [None if i in none_pos else next(it)
            for i in range(len(arrs) + len(none_pos))]
    res = registered_py_func(fid)(*args)
    if not shapes:
        return {}
    drop = set(int(p) for p in (attrs.get("drop_positions") or []))
    if drop:
        if res is None:
            res = ()
        if not isinstance(res, (tuple, list)):
            res = (res,)
        res = [None if i in drop else r for i, r in enumerate(res)]
    outs = _normalize_results(res, shapes, dtypes)
    return {"Out": [torch.from_numpy(a).to(device) for a in outs]}


# --------------------------------------------------------------------------
# print
# --------------------------------------------------------------------------

_PRINT_COUNTS: Dict[int, int] = {}


def _print_grad_maker(op, block, out_grads, provide, should_skip):
    """print_phase BACKWARD / BOTH: print the incoming gradient through a
    second print op, then pass it on as In@GRAD (reference: print_op.cc
    print_phase attr)."""
    g = (out_grads.get("Out") or [""])[0]
    name = (op.inputs.get("In") or [""])[0]
    if not g or should_skip(name, "In", get_op_def("print")):
        return []
    src = block._find_var_recursive(name)
    gname = provide(name)
    block.create_var(name=gname, shape=src.shape if src else None,
                     dtype=src.dtype if src else "float32")
    phase = str(op.attrs.get("print_phase", "BOTH")).upper()
    attrs = dict(op.attrs)
    attrs["is_forward"] = False
    attrs["var_name"] = str(op.attrs.get("var_name", "")) + "@GRAD"
    # a first_n budget of its own (the negated uid keys a separate
    # _PRINT_COUNTS slot; layer uids start at 1)
    attrs["print_uid"] = -int(op.attrs.get("print_uid", 0))
    if phase == "FORWARD":
        # no backward printing: a plain identity pass-through
        return [dict(type="assign", inputs={"X": [g]},
                     outputs={"Out": [gname]}, attrs={})]
    return [dict(type="print", inputs={"In": [g]}, outputs={"Out": [gname]},
                 attrs=attrs)]


def _host_print(arr, attrs):
    first_n = int(attrs.get("first_n", -1))
    uid = int(attrs.get("print_uid", -1))
    if first_n >= 0:
        seen = _PRINT_COUNTS.get(uid, 0)
        if seen >= first_n:
            return
        _PRINT_COUNTS[uid] = seen + 1
    summarize = int(attrs.get("summarize", -1))
    var_name = str(attrs.get("var_name", ""))
    # wall clock is only the human-readable stamp on the printed line
    # (the reference print_op format); never differenced
    parts = [f"{int(time.time())}\t{attrs.get('message', '') or ''}\t"]
    if bool(attrs.get("print_tensor_name", True)) and var_name:
        parts.append(f"Tensor[{var_name}]")
    if bool(attrs.get("print_tensor_type", True)):
        parts.append(f"\n\tdtype: {arr.dtype}")
    if bool(attrs.get("print_tensor_shape", True)):
        parts.append(f"\n\tshape: {list(arr.shape)}")
    flat = arr.reshape(-1)
    if summarize >= 0:
        flat = flat[:summarize]
    parts.append(f"\n\tdata: {np.array2string(flat, threshold=1000)}")
    print("".join(parts), file=sys.stderr)


@register_op("print", grad_maker=_print_grad_maker, host_callback=True)
def _print(ins, attrs, device):
    """Identity + a host print (reference: operators/print_op.cc).
    first_n counts per op instance (the ``print_uid`` attr) across the
    steps run, on the host."""
    x = _x(ins, "In")
    phase = str(attrs.get("print_phase", "BOTH")).upper()
    is_forward = bool(attrs.get("is_forward", True))
    if device.type != "meta" and not (is_forward and phase == "BACKWARD"):
        a = x.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        _host_print(a.cpu().numpy(), attrs)
    return {"Out": [x]}


# --------------------------------------------------------------------------
# hash
# --------------------------------------------------------------------------

# xxHash64 primes (public-domain algorithm, Yann Collet), as int64 bits
_XXP1 = signed64(0x9E3779B185EBCA87)
_XXP2 = signed64(0xC2B2AE3D27D4EB4F)
_XXP3 = signed64(0x165667B19E3779F9)
_XXP4 = signed64(0x85EBCA77C2B2AE63)
_XXP5 = signed64(0x27D4EB2F165667C5)
_U32 = 0xFFFFFFFF


def _rotl64(x, r):
    return (x << r) | _srl(x, 64 - r)


def _xx_round(acc, lane):
    return _rotl64(acc + lane * _XXP2, 31) * _XXP1


def xxh64_words(words: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """XXH64 of a ``4 n``-byte stream given as little-endian 32-bit words
    ``[..., n]`` (int64 tensors holding uint32 values) for every seed in
    ``seeds`` [m]; returns ``[..., m]`` int64 holding the uint64 bits.
    The word count is static, so the stripes and lanes unroll into
    straight-line tensor ops over every row and seed at once; the input
    is always a whole number of words, so there is no byte tail."""
    n = words.shape[-1]
    w64 = words & _U32
    # 8-byte lanes: little-endian word pairs, broadcast against the seeds
    lanes = [(w64[..., 2 * k] | (w64[..., 2 * k + 1] << 32))[..., None]
             for k in range(n // 2)]
    seeds = seeds.expand(words.shape[:-1] + seeds.shape)
    n_stripes = n // 8
    if n_stripes:                                   # >= 32 bytes
        v1 = seeds + signed64(_XXP1 + _XXP2)
        v2 = seeds + _XXP2
        v3 = seeds + 0
        v4 = seeds - _XXP1
        for s in range(n_stripes):
            v1 = _xx_round(v1, lanes[4 * s])
            v2 = _xx_round(v2, lanes[4 * s + 1])
            v3 = _xx_round(v3, lanes[4 * s + 2])
            v4 = _xx_round(v4, lanes[4 * s + 3])
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
             + _rotl64(v4, 18))
        for v in (v1, v2, v3, v4):
            h = (h ^ _xx_round(torch.zeros_like(v), v)) * _XXP1 + _XXP4
    else:
        h = seeds + _XXP5
    h = h + 4 * n
    for k in range(n_stripes * 4, n // 2):          # leftover 8-byte lanes
        h = _rotl64(h ^ _xx_round(torch.zeros_like(h), lanes[k]), 27) \
            * _XXP1 + _XXP4
    if n % 2:                                       # a leftover 4-byte word
        h = _rotl64(h ^ (w64[..., -1:] * _XXP1), 23) * _XXP2 + _XXP3
    h = h ^ _srl(h, 33)
    h = h * _XXP2
    h = h ^ _srl(h, 29)
    h = h * _XXP3
    return h ^ _srl(h, 32)


def _umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """(uint64 bits of ``h``) mod ``m`` in int64 ops, m < 2**31: the two
    32-bit halves reduced apart, so no product passes 2**63."""
    hi, lo = _srl(h, 32), h & _U32
    return ((hi % m) * ((1 << 32) % m) + lo % m) % m


@register_op("hash", no_grad=True)
def _hash(ins, attrs, device):
    """Multi-seed feature hashing (reference: operators/hash_op.cc/.h):
    out[row, i] = XXH64(row bytes, 4 * last_dim, seed=i) % mod_by, out
    dims = in dims minus the last + [num_hash, 1]. Like the reference it
    hashes 4 bytes an element even for int64 rows: the first 4 * last_dim
    bytes of the row. The JAX package's bucket values under x64."""
    x = _x(ins)
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 100000))
    if not 0 < mod_by < 2 ** 31:
        raise ValueError(f"hash: mod_by {mod_by} (takes 0 < mod_by < 2**31)")
    d = x.shape[-1]
    if x.dtype == torch.int64:
        a = x
        # the row's byte stream as words, cut to 4 bytes an element
        words = torch.stack([a & _U32, _srl(a, 32)], dim=-1).reshape(
            x.shape[:-1] + (2 * d,))[..., :d]
    else:
        words = x.to(torch.int32).to(torch.int64) & _U32
    seeds = torch.arange(num_hash, dtype=torch.int64, device=x.device)
    h = xxh64_words(words, seeds)
    return {"Out": [_umod(h, mod_by).to(x.dtype)[..., None]]}


# --------------------------------------------------------------------------
# tree_conv
# --------------------------------------------------------------------------


def _tree_patch_weights(edges, n, max_depth):
    """Dense patch-weight matrices Wl, Wr, Wt [N, n, n] (W*[u, v] =
    eta_* of node v in the patch rooted at u; reference: math/tree2col.cc
    construct_patch + TreeNode::eta_{l,r,t}) and each node's existence
    [N, n], from adjacency powers: R_d[u, v] = v is a depth-d descendant
    of u, d < max_depth."""
    b = edges.shape[0]
    dev = edges.device
    u, v = edges[..., 0], edges[..., 1]
    valid = (u != 0) & (v != 0)
    # the reference's construct_tree stops at the first invalid edge
    valid = torch.cumprod(valid.to(torch.int64), dim=1).to(torch.bool)
    # 0-based; an invalid (or out-of-range) edge writes the dropped row n
    uz = torch.where(valid, u - 1, n).clamp(0, n)
    vz = torch.where(valid, v - 1, n).clamp(0, n)
    rows = torch.arange(b, device=dev)[:, None].expand_as(uz)
    adj = torch.zeros((b, n + 1, n + 1), dtype=torch.float32, device=dev)
    adj = adj.index_put((rows, uz, vz), torch.ones((), device=dev))
    adj = adj[:, :n, :n]

    # child position of v among parent u's children, in edge order
    same_parent = ((u[:, :, None] == u[:, None, :]) & valid[:, None, :]
                   & valid[:, :, None])
    before = torch.tril(same_parent, diagonal=-1)
    index = 1.0 + before.sum(2).to(torch.float32)          # 1-based
    pclen = same_parent.sum(2).to(torch.float32)
    temp_e = torch.where(pclen <= 1.0, 0.5,
                         (index - 1.0) / torch.clamp(pclen - 1.0, min=1.0))
    temp = torch.zeros((b, n + 1), dtype=torch.float32, device=dev)
    temp = temp.scatter(1, vz, temp_e)[:, :n]              # [N, n]

    md = float(max_depth)
    wl = torch.zeros((b, n, n), dtype=torch.float32, device=dev)
    wr, wt = torch.zeros_like(wl), torch.zeros_like(wl)
    r_d = torch.eye(n, dtype=torch.float32, device=dev).expand(b, n, n)
    for d in range(max_depth):
        eta_t = (md - d) / md
        one_m = 1.0 - eta_t
        eta_l_v = one_m * temp                             # [N, n]
        eta_r_v = one_m * (1.0 - eta_l_v)
        wt = wt + r_d * eta_t
        wl = wl + r_d * eta_l_v[:, None, :]
        wr = wr + r_d * eta_r_v[:, None, :]
        if d + 1 < max_depth:
            r_d = r_d @ adj
    node_count = valid.sum(1) + 1
    exists = (torch.arange(n, device=dev)[None, :]
              < node_count[:, None]).to(torch.float32)
    return wl, wr, wt, exists


@register_op("tree_conv", diff_inputs=("NodesVector", "Filter"))
def _tree_conv(ins, attrs, device):
    """Tree-based convolution (reference: tree_conv_op.cc; TBCNN,
    https://arxiv.org/abs/1409.5718). NodesVector [N, n, f], EdgeSet
    [N, e, 2] int 1-indexed parent->child ((0, 0) padding), Filter
    [f, 3, out_size, num_filters] (3 = eta_l / eta_r / eta_t, the
    reference's tree2col column layout), Out [N, n, out_size,
    num_filters]: batched matmuls end to end."""
    nodes = _x(ins, "NodesVector")
    edges = _x(ins, "EdgeSet").to(torch.int64)
    filt = _x(ins, "Filter")
    max_depth = int(attrs.get("max_depth", 2))
    n, f = nodes.shape[1], nodes.shape[2]
    assert filt.shape[0] == f and filt.shape[1] == 3
    wl, wr, wt, exists = _tree_patch_weights(edges, n, max_depth)
    feat = nodes.to(torch.float32)
    filt = filt.to(torch.float32)
    out = (torch.einsum("buv,bvf,fod->buod", wl, feat, filt[:, 0])
           + torch.einsum("buv,bvf,fod->buod", wr, feat, filt[:, 1])
           + torch.einsum("buv,bvf,fod->buod", wt, feat, filt[:, 2]))
    out = out * exists[:, :, None, None]
    return {"Out": [out.to(nodes.dtype)]}
