"""The tensor op types the port added in its op-library slice (shape
ops, gathers and scatters, pads, channel shuffles, the older op types of
the ``*2`` ops, ``anchor_generator``, ``sampling_id`` and
``truncated_gaussian_random``) against the JAX package's, on the CPU.

Deterministic cases as tests/test_torch_math_ops_more.py holds them
(``run_both``: f32 forward within 1e-5, gradients within 1e-4 of the
largest |element| of the JAX value, integers and bools exactly; f64
1e-12 / 1e-10). The semantics torch's defaults would get wrong are cases
of their own: ``argsort``'s ties in input order (ascending and
descending, -0.0 beside +0.0), ``arg_min``'s first index, ``cumsum``'s
``exclusive`` / ``reverse``, ``tile`` and ``gather`` with a 2-D index.
The random ops are held to their arithmetic given the port's draws and
to their properties (``sampling_id``: Gumbel-max over the port's noise
equals the JAX op's ``jax.random.categorical`` fed the same noise, and
the draw frequencies match the probabilities by a chi-square test at
p = 1e-3; ``truncated_gaussian_random``: within 2 sigma, mean and std of
the truncated normal)."""

import math

import numpy as np
import pytest
import torch
from torch_model_parity import assert_match, run_both

import jax
import jax.numpy as jnp

from paddle_tpu.core.registry import get_op_def as jax_op_def

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.ops import tensor_ops

_R = np.random.RandomState(22)


def _f(*shape, scale=1.0):
    return (_R.randn(*shape) * scale).astype(np.float32)


def _i(*idx):
    return np.array(idx, np.int64)


_TIES = np.array([[1.0, -0.0, 2.0, 0.0, 1.0, -1.0, 2.0]], np.float32)

_CASES = {
    "shape": ("shape", {"X": [_f(2, 3, 4)]}, {}),
    "stack": ("stack", {"X": [_f(2, 3), _f(2, 3), _f(2, 3)]}, {"axis": 1}),
    "stack_neg": ("stack", {"X": [_f(2, 3), _f(2, 3)]}, {"axis": -1}),
    "unstack": ("unstack", {"X": [_f(3, 4, 2)]}, {"axis": 1}),
    "expand_as": ("expand_as", {"X": [_f(3, 1)], "Y": [_f(3, 4)]}, {}),
    "gather": ("gather", {"X": [_f(5, 3)], "Index": [_i(4, 0, 4, 2)]}, {}),
    "gather_axis1": ("gather", {"X": [_f(2, 5, 3)], "Index": [_i(1, 1, 3)]},
                     {"axis": 1}),
    "gather_2d_index": ("gather", {"X": [_f(5, 3)],
                                   "Index": [np.array([[0, 4], [4, 1]],
                                                      np.int64)]}, {}),
    "arg_min": ("arg_min", {"X": [_f(3, 5)]}, {"axis": 1}),
    "arg_min_ties": ("arg_min", {"X": [np.array([[2, 1, 1, 3], [0, 0, 5, 0]],
                                                np.float32)]}, {"axis": -1}),
    "cumsum": ("cumsum", {"X": [_f(3, 5)]}, {"axis": 1}),
    "cumsum_exclusive": ("cumsum", {"X": [_f(3, 5)]},
                         {"axis": 1, "exclusive": True}),
    "cumsum_reverse": ("cumsum", {"X": [_f(3, 5)]},
                       {"axis": 0, "reverse": True}),
    "cumsum_both": ("cumsum", {"X": [_f(2, 3, 4)]},
                    {"axis": -1, "reverse": True, "exclusive": True}),
    "pad": ("pad", {"X": [_f(2, 3)]}, {"paddings": [1, 0, 2, 3],
                                       "pad_value": 0.5}),
    "tile": ("tile", {"X": [_f(2, 3)]}, {"repeat_times": [2, 1]}),
    "tile_short": ("tile", {"X": [_f(2, 3)]}, {"repeat_times": [3]}),
    "reverse": ("reverse", {"X": [_f(3, 4, 2)]}, {"axis": [0, 2]}),
    "argsort": ("argsort", {"X": [_f(3, 6)]}, {}),
    "argsort_ties": ("argsort", {"X": [_TIES]}, {}),
    "argsort_ties_desc": ("argsort", {"X": [_TIES]}, {"descending": True}),
    "argsort_axis0": ("argsort", {"X": [_f(4, 3)]}, {"axis": 0,
                                                      "descending": True}),
    "diag": ("diag", {"Diagonal": [_f(4)]}, {}),
    "linspace": ("linspace", {"Start": [np.float32([0.5])],
                              "Stop": [np.float32([3.0])]}, {"num": 7}),
    "linspace_one": ("linspace", {"Start": [np.float32([2.0])],
                                  "Stop": [np.float32([5.0])]}, {"num": 1}),
    "gather_nd": ("gather_nd", {"X": [_f(3, 4, 2)],
                                "Index": [np.array([[0, 1], [2, 3], [0, 1]],
                                                   np.int64)]}, {}),
    "gather_nd_full": ("gather_nd", {"X": [_f(3, 4)],
                                     "Index": [np.array([[[0, 1]], [[2, 3]]],
                                                        np.int64)]}, {}),
    "scatter_nd_add": ("scatter_nd_add", {
        "X": [_f(3, 4)], "Index": [np.array([[0, 1], [2, 3], [0, 1]],
                                            np.int64)],
        "Updates": [_f(3)]}, {}),
    "scatter_nd_add_rows": ("scatter_nd_add", {
        "X": [_f(3, 4)], "Index": [np.array([[2], [0], [2]], np.int64)],
        "Updates": [_f(3, 4)]}, {}),
    "pad2d_constant": ("pad2d", {"X": [_f(2, 3, 4, 5)]},
                       {"paddings": [1, 2, 0, 3], "pad_value": -1.0}),
    "pad2d_reflect": ("pad2d", {"X": [_f(2, 3, 4, 5)]},
                      {"paddings": [1, 2, 2, 1], "mode": "reflect"}),
    "pad2d_edge": ("pad2d", {"X": [_f(1, 2, 3, 3)]},
                   {"paddings": [2, 0, 1, 2], "mode": "edge"}),
    "pad_constant_like": ("pad_constant_like", {"X": [_f(4, 5)],
                                                "Y": [_f(2, 3)]},
                          {"pad_value": 1.5}),
    "crop": ("crop", {"X": [_f(3, 5, 4)]}, {"offsets": [1, 2, 0],
                                            "shape": [2, 2, 3]}),
    "shuffle_channel": ("shuffle_channel", {"X": [_f(2, 6, 2, 3)]},
                        {"group": 3}),
    "pixel_shuffle": ("pixel_shuffle", {"X": [_f(2, 8, 3, 2)]},
                      {"upscale_factor": 2}),
    "space_to_depth": ("space_to_depth", {"X": [_f(2, 3, 4, 6)]},
                       {"blocksize": 2}),
    "multiplex": ("multiplex", {"X": [_f(4, 3), _f(4, 3), _f(4, 3)],
                                "Ids": [np.array([[2], [0], [1], [2]],
                                                 np.int64)]}, {}),
    "shard_index": ("shard_index", {"X": [np.array([[1], [7], [15], [8]],
                                                   np.int64)]},
                    {"index_num": 16, "nshards": 2, "shard_id": 1,
                     "ignore_value": -1}),
    "shard_index_uneven": ("shard_index", {"X": [_i(0, 4, 5, 9, 10)]},
                           {"index_num": 11, "nshards": 3, "shard_id": 1,
                            "ignore_value": -7}),
    "flatten": ("flatten", {"X": [_f(2, 3, 4)]}, {"axis": 2}),
    "flatten_axis0": ("flatten", {"X": [_f(2, 3)]}, {"axis": 0}),
    "reshape": ("reshape", {"X": [_f(2, 3, 4)]}, {"shape": [0, -1, 2]}),
    "transpose": ("transpose", {"X": [_f(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    "squeeze": ("squeeze", {"X": [_f(2, 1, 3, 1)]}, {"axes": [1]}),
    "squeeze_all": ("squeeze", {"X": [_f(2, 1, 3, 1)]}, {}),
    "unsqueeze": ("unsqueeze", {"X": [_f(2, 3)]}, {"axes": [0, 2]}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_tensor_op_matches_jax(case):
    assert_match(*run_both(*_CASES[case]))


@pytest.mark.parametrize("case", ["gather_2d_index", "scatter_nd_add_rows",
                                  "pad2d_reflect", "space_to_depth",
                                  "cumsum_both", "gather_nd"])
def test_tensor_op_matches_jax_in_f64(case):
    op, ins, attrs = _CASES[case]
    ins64 = {k: [v.astype(np.float64) if v.dtype == np.float32 else v
                 for v in vs] for k, vs in ins.items()}
    assert_match(*run_both(op, ins64, attrs), tol_fwd=1e-12, tol_grad=1e-10)


def test_argsort_keeps_ties_in_input_order():
    out = run_both(*_CASES["argsort_ties"])[1]["Indices"][0]
    np.testing.assert_array_equal(out, [[5, 1, 3, 0, 4, 2, 6]])
    out = run_both(*_CASES["argsort_ties_desc"])[1]["Indices"][0]
    np.testing.assert_array_equal(out, [[2, 6, 0, 4, 1, 3, 5]])


def test_v1_ops_take_no_xshape_and_grads_need_x_only():
    """The older op types have one output and differentiate X alone."""
    for op in ("reshape", "transpose", "squeeze", "unsqueeze", "flatten"):
        outs = run_both(*_CASES[op])[1]
        assert sorted(outs) == ["Out"], (op, sorted(outs))
    for op in ("reshape", "transpose", "squeeze", "unsqueeze"):
        assert get_op_def(op).diff_inputs == ("X",)


def test_anchor_generator_matches_jax():
    """Anchors [H, W, A, 4] in pixels and their variances, the JAX op's
    values (f32 here, its x64 arithmetic rounded once)."""
    feat = np.zeros((1, 8, 3, 5), np.float32)
    attrs = {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
             "stride": [16.0, 8.0], "offset": 0.5,
             "variances": [0.1, 0.2, 0.3, 0.4]}
    j = jax_op_def("anchor_generator").compute({"Input": [feat]}, attrs)
    t = get_op_def("anchor_generator").compute(
        {"Input": [torch.from_numpy(feat)]}, attrs, torch.device("cpu"))
    for k in ("Anchors", "Variances"):
        a, b = np.asarray(j[k][0]), t[k][0].numpy()
        assert b.shape == a.shape == (3, 5, 6, 4) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(t["Anchors"][0][0, 0, 2].numpy(),
                               [8 - 16, 4 - 16, 8 + 16, 4 + 16])


def _seed(s=4321, idx=2):
    return rng.SeedHandle(torch.full((), s, dtype=torch.int64), idx)


def test_sampling_id_matches_jax_given_the_same_gumbel_noise(monkeypatch):
    """The JAX op's ``jax.random.categorical`` is Gumbel-max; fed the
    port's noise (the patch below, inside this test only), it picks the
    port's ids."""
    x = _R.uniform(0.01, 1.0, (64, 9)).astype(np.float32)
    x /= x.sum(1, keepdims=True)
    seed = _seed()
    port = get_op_def("sampling_id").compute(
        {"X": [torch.from_numpy(x)]}, {}, torch.device("cpu"),
        seed=seed)["Out"][0].numpy()
    g = tensor_ops.sampling_gumbel(seed, x.shape, torch.device("cpu")).numpy()

    def categorical(key, logits, axis=-1):
        return jnp.argmax(jnp.asarray(logits, jnp.float64) + g, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    j = np.asarray(jax_op_def("sampling_id").compute(
        {"X": [jnp.asarray(x)]}, {}, rng=jax.random.PRNGKey(0))["Out"][0])
    np.testing.assert_array_equal(port, j)
    assert port.dtype == j.dtype == np.int64


def test_sampling_id_frequencies_follow_the_probabilities():
    """20,000 rows of one distribution: the draw counts against the
    probabilities by chi-square (5 classes, 4 dof, p = 1e-3: 18.47)."""
    p = np.array([0.05, 0.1, 0.2, 0.25, 0.4], np.float32)
    x = np.tile(p, (20000, 1))
    ids = get_op_def("sampling_id").compute(
        {"X": [torch.from_numpy(x)]}, {}, torch.device("cpu"),
        seed=_seed(7, 0))["Out"][0].numpy()
    counts = np.bincount(ids, minlength=5)
    want = p * len(ids)
    assert ((counts - want) ** 2 / want).sum() < 18.47, counts


def test_sampling_id_and_truncated_gaussian_registered_as_in_jax():
    t, j = get_op_def("sampling_id"), jax_op_def("sampling_id")
    assert (t.needs_rng, t.no_grad, t.host_rng) == (True, True, False)
    assert (j.needs_rng, j.no_grad) == (True, True)
    t = get_op_def("truncated_gaussian_random")
    # an initializer: drawn by the host-seeded generator, as
    # gaussian_random / uniform_random
    assert (t.host_rng, t.no_grad, t.needs_rng) == (True, True, False)


def test_truncated_gaussian_random_properties():
    """Every value within mean +- 2 std; the sample's mean and std those
    of the normal truncated at 2 sigma (std 0.8796 sigma), within 4
    standard errors; the same generator seed draws the same values."""
    attrs = {"shape": [200, 300], "mean": 0.5, "std": 2.0,
             "dtype": "float32"}
    op = get_op_def("truncated_gaussian_random")

    def draw(s):
        g = torch.Generator().manual_seed(s)
        return op.compute({}, dict(attrs), torch.device("cpu"),
                          generator=g)["Out"][0].numpy()

    v = draw(5)
    assert v.shape == (200, 300) and v.dtype == np.float32
    assert v.min() >= 0.5 - 4.0 and v.max() <= 0.5 + 4.0
    a = 2.0
    phi = math.exp(-a * a / 2) / math.sqrt(2 * math.pi)
    z = math.erf(a / math.sqrt(2))
    sd = 2.0 * math.sqrt(1 - 2 * a * phi / z)
    n = v.size
    assert abs(v.mean() - 0.5) < 4 * sd / math.sqrt(n)
    assert abs(v.std() - sd) < 4 * sd / math.sqrt(2 * n), (v.std(), sd)
    np.testing.assert_array_equal(draw(5), v)
    assert not np.array_equal(draw(6), v)
