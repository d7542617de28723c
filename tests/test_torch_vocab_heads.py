"""The large-vocabulary heads of the port's op-library slice,
``hierarchical_sigmoid``, ``nce`` and ``sample_logits``, against the JAX
package's on the CPU (``run_both``: f32 forward within 1e-5, gradients
within 1e-4 of the largest |element| of the JAX value; f64 1e-12 /
1e-10), ``hierarchical_sigmoid`` also against the bit-by-bit path walk
at a power of two and at C = 2^20 (its integer bit length). ``nce`` and
``sample_logits`` draw their classes on the device from the op seed
(``rng.op_randint``): inside each test only, ``jax.random.randint`` as
the JAX op sees it returns the port's draws, and the two ops' outputs
and derived gradients are held as the deterministic ones; the draws are
held to uniformity by a chi-square test at p = 1e-3."""

import numpy as np
import pytest
import torch
from torch_model_parity import assert_match, run_both

import jax
import jax.numpy as jnp

from paddle_tpu.core.registry import get_op_def as jax_op_def

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.registry import get_op_def

_R = np.random.RandomState(24)


def _f(*shape, scale=1.0):
    return (_R.randn(*shape) * scale).astype(np.float32)


def _lbl(n, c):
    return _R.randint(0, c, (n, 1)).astype(np.int64)


_HX = _f(6, 5)
_CASES = {
    "hsigmoid_pow2": ("hierarchical_sigmoid", {
        "X": [_f(5, 4)], "W": [_f(7, 4)], "Bias": [_f(7)],
        "Label": [np.arange(5, dtype=np.int64)[:, None]]},
        {"num_classes": 8}),
    "hsigmoid_10": ("hierarchical_sigmoid", {
        "X": [_HX], "W": [_f(9, 5)], "Bias": [_f(1, 9)],
        "Label": [np.array([0, 9, 5, 1, 8, 3], np.int64)]},
        {"num_classes": 10}),
    "hsigmoid_no_bias": ("hierarchical_sigmoid", {
        "X": [_HX], "W": [_f(36, 5)],
        "Label": [np.array([[0], [36], [17], [31], [32], [3]], np.int64)]},
        {"num_classes": 37}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_hsigmoid_matches_jax(case):
    assert_match(*run_both(*_CASES[case]))


def test_hsigmoid_matches_jax_in_f64():
    op, ins, attrs = _CASES["hsigmoid_10"]
    ins64 = {k: [v.astype(np.float64) if v.dtype == np.float32 else v
                 for v in vs] for k, vs in ins.items()}
    assert_match(*run_both(op, ins64, attrs), tol_fwd=1e-12, tol_grad=1e-10)


def _hs_manual(x, w, bias, labels, c):
    """The per-node logistic losses of each label's path, by bits."""
    out = []
    for i, lab in enumerate(labels):
        code = int(lab) + c
        n = code.bit_length()
        loss = 0.0
        for j in range(n - 1):
            shift = n - 2 - j
            node = (code >> (shift + 1)) - 1
            bit = (code >> shift) & 1
            pre = float(x[i].astype(np.float64) @ w[node])
            if bias is not None:
                pre += float(bias[node])
            loss += np.logaddexp(0, pre) - bit * pre
        out.append(loss)
    return np.array(out)


def test_hsigmoid_power_of_two_matches_the_manual_path():
    _, ins, attrs = _CASES["hsigmoid_pow2"]
    got = get_op_def("hierarchical_sigmoid").compute(
        {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()},
        attrs, "cpu")
    want = _hs_manual(ins["X"][0], ins["W"][0], ins["Bias"][0],
                      ins["Label"][0][:, 0], 8)
    np.testing.assert_allclose(got["Out"][0].numpy()[:, 0], want, rtol=1e-5)
    # C = 8: every path has 3 nodes, PreOut's 4th column is zero
    assert got["PreOut"][0].shape == (5, 4)
    assert not got["PreOut"][0][:, 3].any()


def test_hsigmoid_large_vocab_boundary():
    """C = 2^20 with labels C - 1 and 0: the integer bit length gives
    their 20- and 19-node paths exactly (f32 log2 over-counts there);
    both packages agree with the manual path."""
    c, d = 1 << 20, 4
    r = np.random.RandomState(0)
    x = r.normal(0, 1, (2, d)).astype(np.float32)
    w = r.normal(0, 1, (c - 1, d)).astype(np.float32)
    lbl = np.array([[c - 1], [0]], np.int64)
    got = get_op_def("hierarchical_sigmoid").compute(
        {"X": [torch.from_numpy(x)], "W": [torch.from_numpy(w)],
         "Label": [torch.from_numpy(lbl)], "Bias": [None]},
        {"num_classes": c}, "cpu")["Out"][0].numpy()[:, 0]
    want = _hs_manual(x, w, None, [c - 1, 0], c)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    j = np.asarray(jax_op_def("hierarchical_sigmoid").compute(
        {"X": [x], "W": [w], "Label": [lbl], "Bias": [None]},
        {"num_classes": c})["Out"][0])[:, 0]
    np.testing.assert_allclose(got, j, rtol=1e-5)


def _seed(s=2024, idx=4):
    return rng.SeedHandle(torch.full((), s, dtype=torch.int64), idx)


def _patch_randint(monkeypatch, seed):
    """``jax.random.randint`` returning the port's draws of ``seed``."""

    def randint(key, shape, minval, maxval, dtype=jnp.int64):
        assert minval == 0
        d = rng.op_randint(seed, shape, int(maxval), torch.device("cpu"))
        return jnp.asarray(d.numpy()).astype(dtype)

    monkeypatch.setattr(jax.random, "randint", randint)


@pytest.mark.parametrize("bias", [True, False])
def test_nce_matches_jax_given_the_same_draws(monkeypatch, bias):
    b, d, c, k = 6, 5, 40, 7
    ins = {"Input": [_f(b, d)], "Label": [_lbl(b, c)],
           "Weight": [_f(c, d, scale=0.5)]}
    if bias:
        ins["Bias"] = [_f(c)]
    seed = _seed()
    _patch_randint(monkeypatch, seed)
    res = run_both("nce", ins, {"num_neg_samples": k},
                   rngs=(seed, jax.random.PRNGKey(0)))
    assert_match(*res)
    # the same op seed draws the same negatives in the grad op's re-run,
    # so the port's own derived gradient is that of its forward
    assert res[1]["Cost"][0].shape == (b, 1)


@pytest.mark.parametrize("hits", [True, False])
def test_sample_logits_matches_jax_given_the_same_draws(monkeypatch, hits):
    """Two true labels a row and 24 samples of 30 classes: accidental
    hits occur; with ``remove_accidental_hits`` they get -1e20."""
    b, c, t, s = 5, 30, 2, 24
    labels = np.stack([_R.choice(c, t, replace=False) for _ in range(b)]
                      ).astype(np.int64)
    ins = {"Logits": [_f(b, c)], "Labels": [labels]}
    seed = _seed(11, 1)
    _patch_randint(monkeypatch, seed)
    attrs = {"num_samples": s, "remove_accidental_hits": hits}
    jo, to, jg, tg = run_both("sample_logits", ins, attrs,
                              rngs=(seed, jax.random.PRNGKey(0)))
    assert_match(jo, to, jg, tg)
    hit = (to["Samples"][0][:, None, t:] == labels[:, :, None]).any(1)
    assert hit.any()
    assert (to["SampledLogits"][0][:, t:][hit] == -1e20).all() == hits


def test_random_heads_draw_uniformly_and_afresh():
    """The negatives of ``nce`` are uniform over the classes (chi-square,
    20 classes, p 1e-3: 43.82) and change with the step seed."""
    words = rng.op_randint(_seed(), (500, 40), 20, torch.device("cpu"))
    counts = np.bincount(words.numpy().ravel(), minlength=20)
    want = words.numel() / 20
    assert ((counts - want) ** 2 / want).sum() < 43.82
    assert 0 <= int(words.min()) and int(words.max()) < 20
    assert not torch.equal(words, rng.op_randint(_seed(2025), (500, 40), 20,
                                                 torch.device("cpu")))
