"""The math op types the port added in its op-library slice (losses,
comparisons, norms, the batch-size-like randoms) against the JAX
package's, on the CPU.

Each deterministic case runs both packages' compute on the same numpy
inputs (from a seed) and, for an op with a gradient, both packages'
derived grad op on the same random cotangents
(``torch_model_parity.run_both``): f32 forward outputs within 1e-5 and
gradients within 1e-4 of the largest |element| of the JAX value, f64
within 1e-12 / 1e-10; integer and bool outputs exactly. Inputs keep clear
of the losses' kinks (hinge, margin, huber), where the two libraries'
derivatives of ``max`` differ by convention.

The random ops draw on the device from the op seed (core/rng.py), bits
that cannot equal ``jax.random``'s: each is held to its arithmetic
(given the port's draws, the values the transform must give, computed
in numpy) and to its properties (range, uniformity by a chi-square test
at p = 1e-3, the normal's moments)."""

import numpy as np
import pytest
import torch
from torch_model_parity import assert_match, run_both

from paddle_tpu.core.registry import get_op_def as jax_op_def

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.registry import get_op_def

_R = np.random.RandomState(21)


def _f(*shape, scale=1.0, dtype=np.float32):
    return (_R.randn(*shape) * scale).astype(dtype)


def _away(x, kinks, gap=0.05):
    for k in kinks:
        near = np.abs(x - k) < gap
        x[near] = k + np.sign(x[near] - k + 1e-9) * gap * 2
    return x


def _bits(*shape):
    return _R.randint(0, 2, shape).astype(np.float32)


def _probs(*shape):
    p = _R.uniform(0.05, 1.0, shape)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


_LOGIT = _f(6, 1)
_Y01 = _bits(6, 1)
_X1 = _f(6, 1)
_Y_PM = np.where(_bits(6, 1) > 0, 1.0, -1.0).astype(np.float32)

_CASES = {
    "elementwise_mod": ("elementwise_mod", {
        "X": [np.array([[7, -7, 5], [-5, 9, 0]], np.int64)],
        "Y": [np.array([[3, 3, -3], [-3, 4, 5]], np.int64)]}, {}),
    "elementwise_mod_f32": ("elementwise_mod", {
        "X": [_f(3, 4, scale=5.0)],
        "Y": [np.array([2.5, -3.0, 1.5, -0.75], np.float32)]}, {}),
    "elementwise_mod_axis": ("elementwise_mod", {
        "X": [np.arange(-12, 12).reshape(2, 3, 4).astype(np.int32)],
        "Y": [np.array([5, -3, 7], np.int32)]}, {"axis": 1}),
    "not_equal": ("not_equal", {"X": [np.array([1., 2., 3.], np.float32)],
                                "Y": [np.array([1., 0., 3.], np.float32)]},
                  {}),
    "less_equal": ("less_equal", {"X": [_f(3, 4)], "Y": [_f(4)]}, {}),
    "logical_or": ("logical_or", {"X": [_bits(3, 4) > 0],
                                  "Y": [_bits(3, 4) > 0]}, {}),
    "logical_xor": ("logical_xor", {"X": [_bits(3, 4) > 0],
                                    "Y": [_bits(3, 4) > 0]}, {}),
    "p_norm": ("p_norm", {"X": [_away(_f(3, 5), (0.0,))]}, {"porder": 3.0,
                                                             "axis": 1}),
    "p_norm_all_keep": ("p_norm", {"X": [_away(_f(3, 5), (0.0,))]},
                        {"porder": 2.0, "keepdim": True, "axis": None}),
    "log_loss": ("log_loss", {
        "Predicted": [_R.uniform(0.05, 0.95, (6, 1)).astype(np.float32)],
        "Labels": [_Y01]}, {"epsilon": 1e-4}),
    "rank_loss": ("rank_loss", {"Label": [_Y01], "Left": [_f(6, 1)],
                                "Right": [_f(6, 1)]}, {}),
    "rank_loss_wide": ("rank_loss", {"Label": [_Y01],
                                     "Left": [_f(6, 1, scale=40.0)],
                                     "Right": [_f(6, 1)]}, {}),
    "margin_rank_loss": ("margin_rank_loss", {
        # x1 - x2 = y * d: the hinge margin - d stays off 0
        "Label": [_Y_PM], "X1": [_X1], "X2": [_X1 - _Y_PM * np.array(
            [[0.5], [-0.7], [1.2], [-0.3], [0.9], [-1.5]], np.float32)]},
        {"margin": 0.1}),
    "hinge_loss": ("hinge_loss", {
        "Logits": [np.array([[0.2], [-1.7], [2.5], [0.6], [-0.4], [1.3]],
                            np.float32)], "Labels": [_Y01]}, {}),
    "kldiv_loss_mean": ("kldiv_loss", {
        "X": [np.log(_probs(3, 5))],
        "Target": [np.where(_bits(3, 5) > 0, _probs(3, 5), 0.0)
                   .astype(np.float32)]}, {"reduction": "mean"}),
    "kldiv_loss_sum": ("kldiv_loss", {"X": [np.log(_probs(3, 5))],
                                      "Target": [_probs(3, 5)]},
                       {"reduction": "sum"}),
    "kldiv_loss_batchmean": ("kldiv_loss", {"X": [np.log(_probs(3, 5))],
                                            "Target": [_probs(3, 5)]},
                             {"reduction": "batchmean"}),
    "kldiv_loss_none": ("kldiv_loss", {"X": [np.log(_probs(3, 5))],
                                       "Target": [_probs(3, 5)]},
                        {"reduction": "none"}),
    "bpr_loss": ("bpr_loss", {"X": [_f(4, 6)],
                              "Label": [np.array([[1], [0], [5], [3]],
                                                 np.int64)]}, {}),
    "cos_sim": ("cos_sim", {"X": [_f(4, 5)], "Y": [_f(4, 5)]}, {}),
    "cos_sim_row": ("cos_sim", {"X": [_f(4, 5)], "Y": [_f(1, 5)]}, {}),
    "sign": ("sign", {"X": [np.array([[-2.0, 0.0, 3.5]], np.float32)]}, {}),
    "minus": ("minus", {"X": [_f(3, 4)], "Y": [_f(3, 4)]}, {}),
    "l1_norm": ("l1_norm", {"X": [_away(_f(3, 4), (0.0,))]}, {}),
    "squared_l2_distance": ("squared_l2_distance",
                            {"X": [_f(4, 3, 2)], "Y": [_f(4, 3, 2)]}, {}),
    "modified_huber_loss": ("modified_huber_loss", {
        "X": [np.array([[-2.0], [-0.5], [0.3], [1.6], [0.8], [-1.3]],
                       np.float32)], "Y": [_Y01]}, {}),
    "teacher_student_sigmoid_loss": ("teacher_student_sigmoid_loss", {
        "X": [np.array([[-20.0], [-0.5], [0.3], [1.6], [18.0], [-1.3]],
                       np.float32)],
        "Label": [np.array([[0.0], [-1.0], [0.4], [1.0], [0.7], [0.0]],
                           np.float32)]}, {}),
    "cvm": ("cvm", {"X": [np.abs(_f(4, 6)) * 3], "CVM": [_f(4, 2)]},
            {"use_cvm": True}),
    "cvm_strip": ("cvm", {"X": [_f(4, 6)], "CVM": [_f(4, 2)]},
                  {"use_cvm": False}),
    "data_norm": ("data_norm", {
        "X": [_f(5, 3)], "BatchSize": [np.full(3, 1e4, np.float32)],
        "BatchSum": [_f(3, scale=100.0)],
        "BatchSquareSum": [np.abs(_f(3, scale=1e4)) + 1e3]},
        {"epsilon": 1e-5}),
    "spectral_norm": ("spectral_norm", {
        "Weight": [_f(4, 3, 2)], "U": [_f(4)], "V": [_f(6)]},
        {"dim": 0, "power_iters": 2}),
    "spectral_norm_dim1": ("spectral_norm", {
        "Weight": [_f(4, 3, 2)], "U": [_f(3)], "V": [_f(8)]},
        {"dim": 1, "power_iters": 1}),
    "fsp": ("fsp", {"X": [_f(2, 3, 4, 5)], "Y": [_f(2, 4, 4, 5)]}, {}),
    "is_empty": ("is_empty", {"X": [_f(2, 3)]}, {}),
    "is_empty_yes": ("is_empty", {"X": [np.zeros((0, 3), np.float32)]}, {}),
    "fill": ("fill", {}, {"value": [1.5, -2.0, 3.25, 0.0, 7.0, 8.5],
                          "shape": [2, 3], "dtype": "float32"}),
    "fill_int": ("fill", {}, {"value": [4, 5, 6], "shape": [3],
                              "dtype": "int64"}),
    "cross_entropy2": ("cross_entropy2", {
        "X": [_probs(5, 4)],
        "Label": [np.array([[1], [3], [0], [2], [3]], np.int64)]},
        {"ignore_index": 0}),
    "cross_entropy2_3d": ("cross_entropy2", {
        "X": [_probs(2, 3, 4)],
        "Label": [np.array([[[1], [3], [0]], [[2], [2], [1]]], np.int64)]},
        {}),
    "fill_zeros_like2": ("fill_zeros_like2", {"X": [_f(3, 2)]}, {}),
    "reduce_all": ("reduce_all", {"X": [_bits(3, 4) > 0]}, {}),
    "reduce_all_dim": ("reduce_all", {"X": [np.array(
        [[True, True], [True, False], [True, True]])]},
        {"dim": [1], "keep_dim": True}),
    "reduce_any": ("reduce_any", {"X": [_f(3, 4) > 1.0]}, {"dim": [0]}),
    "reduce_any_float": ("reduce_any", {"X": [np.array(
        [[0.0, 0.0], [0.0, 2.0]], np.float32)]}, {}),
    "has_inf": ("has_inf", {"X": [np.array([1.0, np.inf], np.float32)]},
                {}),
    "has_inf_no": ("has_inf", {"X": [np.array([1.0, np.nan], np.float32)]},
                   {}),
    "has_nan": ("has_nan", {"X": [np.array([1.0, np.nan], np.float32)]},
                {}),
    "has_nan_no": ("has_nan", {"X": [_f(3)]}, {}),
}


def _run_both_fill(case):
    """``fill`` takes no input: both packages' outputs alone."""
    op, ins, attrs = _CASES[case]
    j = np.asarray(jax_op_def(op).compute(ins, dict(attrs))["Out"][0])
    t = get_op_def(op).compute(ins, dict(attrs), torch.device("cpu"))
    return {"Out": [j]}, {"Out": [t["Out"][0].numpy()]}, None, None


@pytest.mark.parametrize("case", sorted(_CASES))
def test_math_op_matches_jax(case):
    if case.startswith("fill") and case != "fill_zeros_like2":
        assert_match(*_run_both_fill(case))
        return
    assert_match(*run_both(*_CASES[case]))


@pytest.mark.parametrize("case", ["log_loss", "bpr_loss", "cos_sim",
                                  "spectral_norm", "data_norm",
                                  "teacher_student_sigmoid_loss",
                                  "kldiv_loss_mean", "fsp"])
def test_math_op_matches_jax_in_f64(case):
    op, ins, attrs = _CASES[case]
    ins64 = {k: [v.astype(np.float64) if v.dtype == np.float32 else v
                 for v in vs] for k, vs in ins.items()}
    assert_match(*run_both(op, ins64, attrs), tol_fwd=1e-12, tol_grad=1e-10)


def test_spectral_norm_power_iteration_converges_across_steps():
    """UOut / VOut fed back as U / V (the layer's in-place names) drive
    sigma to the largest singular value, as the JAX op's do."""
    w = _f(5, 4)
    u, v = _f(5), _f(4)
    jdef, tdef = jax_op_def("spectral_norm"), get_op_def("spectral_norm")
    ju, jv, tu, tv = u, v, torch.from_numpy(u), torch.from_numpy(v)
    for _ in range(30):
        jo = jdef.compute({"Weight": [w], "U": [ju], "V": [jv]},
                          {"power_iters": 1})
        to = tdef.compute({"Weight": [torch.from_numpy(w)], "U": [tu],
                           "V": [tv]}, {"power_iters": 1},
                          torch.device("cpu"))
        ju, jv = np.asarray(jo["UOut"][0]), np.asarray(jo["VOut"][0])
        tu, tv = to["UOut"][0], to["VOut"][0]
    np.testing.assert_allclose(tu.numpy(), ju, atol=1e-5)
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    np.testing.assert_allclose(np.linalg.svd(to["Out"][0].numpy(),
                                             compute_uv=False)[0], 1.0,
                               rtol=1e-4)
    np.testing.assert_allclose(w / to["Out"][0].numpy(), sigma, rtol=1e-4)


# --- the random ops ---------------------------------------------------------


def _seed(s=1234, idx=3):
    return rng.SeedHandle(torch.full((), s, dtype=torch.int64), idx)


def _run_port(op, ins, attrs, seed):
    t_ins = {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()}
    return get_op_def(op).compute(t_ins, attrs, torch.device("cpu"),
                                  seed=seed)


def test_batch_size_like_randoms_registered_as_in_jax():
    for op in ("uniform_random_batch_size_like",
               "gaussian_random_batch_size_like"):
        t, j = get_op_def(op), jax_op_def(op)
        assert (t.needs_rng, t.no_grad, t.host_rng) == (True, True, False)
        assert (j.needs_rng, j.no_grad) == (True, True)


def test_uniform_batch_size_like_arithmetic_and_properties():
    """Given the port's words, the values are lo + (hi - lo) (w + 0.5) /
    2^32 rounded once to f32; the shape takes Input's batch; the values
    lie in [lo, hi] and are uniform (chi-square over 20 bins, p 1e-3)."""
    ref = np.zeros((7, 5), np.float32)
    attrs = {"shape": [-1, 3000], "min": -2.0, "max": 3.0,
             "input_dim_idx": 0, "output_dim_idx": 0, "dtype": "float32"}
    seed = _seed()
    out = _run_port("uniform_random_batch_size_like", {"Input": [ref]},
                    attrs, seed)["Out"][0]
    assert out.shape == (7, 3000) and out.dtype == torch.float32
    words = rng.op_words(seed, (7, 3000), torch.device("cpu")).numpy()
    want = (-2.0 + 5.0 * ((words.astype(np.float64) + 0.5) / 2.0 ** 32)
            ).astype(np.float32)
    np.testing.assert_array_equal(out.numpy(), want)
    v = out.numpy().ravel()
    assert v.min() >= -2.0 and v.max() <= 3.0
    counts = np.histogram(v, bins=20, range=(-2.0, 3.0))[0]
    chi2 = ((counts - v.size / 20) ** 2 / (v.size / 20)).sum()
    assert chi2 < 43.8, chi2          # chi-square(19) at p = 1e-3
    again = _run_port("uniform_random_batch_size_like", {"Input": [ref]},
                      attrs, seed)["Out"][0]
    assert torch.equal(again, out)
    other = _run_port("uniform_random_batch_size_like", {"Input": [ref]},
                      attrs, _seed(1235))["Out"][0]
    assert not torch.equal(other, out)


def test_gaussian_batch_size_like_arithmetic_and_properties():
    """Box-Muller of lanes 1 and 2 in f64, mean + std * z rounded once;
    the sample's mean and std within 4 standard errors, and the
    transposed placement (input_dim_idx 1 -> output_dim_idx 1)."""
    ref = np.zeros((2, 9), np.float32)
    attrs = {"shape": [4000, -1], "mean": 1.5, "std": 0.5,
             "input_dim_idx": 1, "output_dim_idx": 1, "dtype": "float32"}
    seed = _seed(77, 0)
    out = _run_port("gaussian_random_batch_size_like", {"Input": [ref]},
                    attrs, seed)["Out"][0].numpy()
    assert out.shape == (4000, 9)
    u1, u2 = ((rng.op_words(seed, (4000, 9), torch.device("cpu"), lane=k)
               .numpy().astype(np.float64) + 0.5) / 2.0 ** 32 for k in (1, 2))
    z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    np.testing.assert_allclose(out, (1.5 + 0.5 * z).astype(np.float32),
                               rtol=0, atol=5e-7)
    n = out.size
    assert abs(out.mean() - 1.5) < 4 * 0.5 / np.sqrt(n)
    assert abs(out.std() - 0.5) < 4 * 0.5 / np.sqrt(2 * n)


def test_random_words_are_a_device_function_of_the_op_seed():
    """The words depend on the seed buffer's value through tensor ops
    only (a captured replay reads a new step seed): the handle's words
    equal those of the int op seed it mixes to."""
    buf = torch.full((), 99, dtype=torch.int64)
    h = rng.SeedHandle(buf, 5)
    a = rng.op_words(h, (3, 4), torch.device("cpu"))
    b = rng.op_words(rng.mix64(99, 5), (3, 4), torch.device("cpu"))
    assert torch.equal(a, b)
    buf.fill_(100)
    assert not torch.equal(rng.op_words(h, (3, 4), torch.device("cpu")), a)
