"""The plain versions of the three kernel studies
(paddle_tpu_torch/benchmarks) against the JAX package's benchmark
scripts, on the CPU at small shapes, from the same numpy inputs.

The JAX scripts reach ``pl.pallas_call`` without an ``interpret``
argument. They are loaded by path, and for the duration of a test
``jax.experimental.pallas.pallas_call`` is replaced by the same function
with ``interpret=True``; nothing in the scripts changes. Their plain
baselines (``xla_pair``, ``conv_ref``) and a float64 numpy attention are
held too.

Tolerances: bf16 outputs within one bf16 ulp (2^-7 relative) of the
largest output (both sides sum the same bf16 products in f32, in other
orders, and round once); dW (f32) within 1e-4 of its largest element (f32
sums of 1024 products in other orders; the JAX script asserts 1e-3)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu_torch import kernels
from paddle_tpu_torch.benchmarks import attn_ablate, conv_bwd, grouped_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP = 2.0 ** -7


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", os.path.join(ROOT, "benchmarks", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run every pallas_call of the loaded scripts in interpret mode, with
    64-bit types off as the scripts assume (their numpy scale constants
    would otherwise promote the f32 scores to f64; tests/conftest.py turns
    64-bit types on)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    with jax.enable_x64(False):
        yield


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tbf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close_bf16(got, want):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=0,
                               atol=ULP * np.abs(want).max())


@pytest.mark.parametrize("n,ci,co", [(1024, 64, 128), (512, 32, 256)])
def test_conv1x1_bwd_plain_matches_pallas_and_xla_pair(interpret_pallas,
                                                        n, ci, co):
    jmod = _load_script("conv_bwd_pallas")
    r = np.random.RandomState(0)
    x, dy, w = r.randn(n, ci), r.randn(n, co), r.randn(ci, co)
    dx_t, dw_t = conv_bwd.combined_conv1x1_bwd(_tbf(x), _tbf(dy), _tbf(w))
    assert dx_t.dtype == torch.bfloat16 and dw_t.dtype == torch.float32
    for jfn in (jmod.combined_conv1x1_bwd, jmod.xla_pair):
        dx_j, dw_j = jfn(_bf(x), _bf(dy), _bf(w))
        _close_bf16(dx_t, dx_j)
        dw_j = np.asarray(dw_j)
        np.testing.assert_allclose(dw_t.numpy(), dw_j, rtol=0,
                                   atol=1e-4 * np.abs(dw_j).max())
    dx_m, dw_m = conv_bwd.matmul_pair(_tbf(x), _tbf(dy), _tbf(w))
    _close_bf16(dx_m, dx_t)
    np.testing.assert_allclose(dw_m.numpy(), dw_t.numpy(), rtol=0,
                               atol=1e-4 * float(dw_t.abs().max()))


@pytest.mark.parametrize("n,ci,co,sms", [
    (401408, 64, 256, 132), (100352, 128, 512, 132), (25088, 256, 1024, 132),
    (1000, 32, 48, 132), (77, 64, 1024, 4), (5000, 48, 16, 1)])
def test_conv1x1_bwd_plan_covers_the_problem(n, ci, co, sms):
    """The split the wrapper hands the kernel: a block's dW^T [co_pad, cs]
    fits the 128 accumulator registers a thread of its two warpgroups
    keeps, slices tile ci, the dy chunks (of one block, or of the cluster
    pair that splits co) cover co, one block an SM at most, and the
    n-ranges cover every n-tile once."""
    cs, chunks, co_split, parts, tiles_per_part = conv_bwd.plan(n, ci, co,
                                                                 sms)
    assert cs in (16, 32, 64) and ci % cs == 0
    assert chunks in (1, 2, 4, 8) and co_split in (1, 2)
    cols = co_split * chunks * conv_bwd.CHUNK
    assert co <= cols and (cols == conv_bwd.CHUNK or cols // 2 < co)
    assert chunks * cs // 2 <= 128
    assert co_split == 1 or (cs >= 32 and chunks == 4)
    assert chunks < 8 or cs == 16
    blocks = ci // cs * co_split
    assert parts * blocks <= max(sms, blocks)
    ntiles = -(-n // conv_bwd.TN)
    assert (parts - 1) * tiles_per_part < ntiles <= parts * tiles_per_part


@pytest.mark.parametrize("n,ci,co,sms", [
    (401408, 64, 256, 132), (100352, 128, 512, 132), (25088, 256, 1024, 132),
    (1, 16, 16, 132), (129, 48, 16, 3), (3000, 128, 512, 7),
    (77, 64, 1024, 4), (25089, 256, 1008, 132), (640, 80, 272, 132)])
def test_conv1x1_bwd_plan_covers_each_row_and_channel_once(n, ci, co, sms):
    """Walk the grid the plan gives, block by block as the kernel does
    (blockIdx.x the ci slice, and with the co split the pair's rank;
    blockIdx.y the n-range; a 128-row n-tile and 128-column dy chunk loop
    inside): every (row, input channel) pair of dx sums over co exactly
    once, every (input channel, output channel) of dW is accumulated by
    exactly one block of each n-range, and no block walks a row past n or
    a channel past ci (ragged n, co not a multiple of 128)."""
    cs, chunks, co_split, parts, tiles_per_part = conv_bwd.plan(n, ci, co,
                                                                 sms)
    tn, ntiles, ck = conv_bwd.TN, -(-n // conv_bwd.TN), conv_bwd.CHUNK
    rows = np.zeros(n, np.int64)            # n-ranges covering each row
    dw = np.zeros((ci, co), np.int64)       # blocks of one n-range per dW
    for bx in range(ci // cs * co_split):
        c0, half = bx // co_split * cs, bx % co_split
        cbase = half * chunks * ck
        for c in range(chunks):            # the block's chunks, past co padded
            dw[c0:c0 + cs, cbase + c * ck:min(co, cbase + (c + 1) * ck)] += 1
    for part in range(parts):
        t0 = part * tiles_per_part
        t1 = min(t0 + tiles_per_part, ntiles)
        assert t1 > t0, "an n-range without tiles"
        rows[t0 * tn:min(t1 * tn, n)] += 1
    # dx[row, ch] contracts over every co once: dW's coverage is that sum's
    assert (rows == 1).all() and (dw == 1).all()


@pytest.mark.parametrize("shape,cg", [((2, 8, 8, 128), 4),
                                      ((1, 6, 10, 256), 8)])
def test_grouped_conv_plain_matches_pallas_and_conv_ref(interpret_pallas,
                                                        shape, cg):
    jmod = _load_script("grouped_conv_pallas")
    n, h, w, c = shape
    groups = c // cg
    r = np.random.RandomState(0)
    x = r.randn(n, h, w, c) * 0.5
    wg = r.randn(3, 3, cg, c) / np.sqrt(9 * cg)
    y_t = grouped_conv.grouped_conv(_tbf(x), _tbf(wg), groups)
    assert y_t.dtype == torch.bfloat16 and tuple(y_t.shape) == shape
    y_pl = jmod.grouped_conv_pallas(_bf(x), jmod.make_blockdiag(_bf(wg), c,
                                                                cg))
    y_ref = jmod.conv_ref(_bf(x), _bf(wg), groups)
    _close_bf16(y_t, y_pl)
    _close_bf16(y_t, y_ref)
    _close_bf16(grouped_conv.conv_ref(_tbf(x), _tbf(wg), groups), y_t)


def _attention_f64(q, k, v, variant):
    """float64 numpy attention of the bf16-rounded inputs (no rounding of
    the probabilities)."""
    q, k, v = (_f32(_tbf(a)).astype(np.float64) for a in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if variant == "matmul-floor":
        return np.einsum("bhqk,bhkd->bhqd", s, v)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("variant", attn_ablate.VARIANTS)
@pytest.mark.parametrize("b,h,t,dh,bk", [(2, 2, 64, 64, 64),
                                         (1, 2, 128, 32, 64)])
def test_attn_ablate_plain_matches_pallas_and_numpy(interpret_pallas,
                                                    variant, b, h, t, dh, bk):
    jmod = _load_script("attn_ablate")
    r = np.random.RandomState(0)
    q, k, v = (r.randn(b, h, t, dh) * 0.1 for _ in range(3))
    out_t = attn_ablate.make_fwd(variant, b, h, t, dh, t, bk)(
        _tbf(q), _tbf(k), _tbf(v))
    assert out_t.dtype == torch.bfloat16
    out_j = jmod.make_fwd(variant, b, h, t, dh, t, bk)(_bf(q), _bf(k), _bf(v))
    _close_bf16(out_t, out_j)
    # against float64: the bf16 rounding of p (2^-9 relative a term) and of
    # the output (2^-9) stay within one bf16 ulp of the largest output
    want = _attention_f64(q, k, v, variant)
    np.testing.assert_allclose(_f32(out_t), want, rtol=0,
                               atol=ULP * np.abs(want).max())


def test_make_fwd_refuses_what_the_jax_script_cannot_run():
    with pytest.raises(ValueError, match="variant"):
        attn_ablate.make_fwd("softmax", 1, 1, 64, 64, 64, 64)
    with pytest.raises(ValueError, match="bq"):
        attn_ablate.make_fwd("full", 1, 1, 64, 64, 32, 64)
    with pytest.raises(ValueError, match="bk"):
        attn_ablate.make_fwd("full", 1, 1, 64, 64, 64, 48)


def test_wrappers_check_their_inputs_on_the_cpu():
    x, dy, w = conv_bwd.make_inputs(32, 16, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        conv_bwd.combined_conv1x1_bwd(x.float(), dy, w)
    with pytest.raises(ValueError, match="do not agree"):
        conv_bwd.combined_conv1x1_bwd(x, dy[:16], w)
    xg, wg = grouped_conv.make_inputs(1, 4, 4, 32, groups=8)
    with pytest.raises(ValueError, match="expected"):
        grouped_conv.grouped_conv(xg, wg, 4)
    with pytest.raises(TypeError, match="bfloat16"):
        grouped_conv.grouped_conv(xg.float(), wg, 8)
    q, k, v = attn_ablate.make_inputs(1, 1, 64, 16)
    with pytest.raises(ValueError, match="expected"):
        attn_ablate.make_fwd("full", 1, 2, 64, 16, 64, 64)(q, k, v)
    sources = (conv_bwd.SOURCE, grouped_conv.SOURCE, attn_ablate.SOURCE)
    before = [kernels.launch_counts[s] for s in sources]
    conv_bwd.combined_conv1x1_bwd(x, dy, w)
    grouped_conv.grouped_conv(xg, wg, 8)
    attn_ablate.make_fwd("full", 1, 1, 64, 16, 64, 64)(q, k, v)
    # CPU tensors take the plain versions: no launch is counted
    assert before == [kernels.launch_counts[s] for s in sources]
