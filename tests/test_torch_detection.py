"""The detection slice in the port against the JAX package, on the CPU:
the box ops (``iou_similarity``, ``box_coder``, ``prior_box``), the
matching and mining ops (``bipartite_match``, ``target_assign``,
``mine_hard_examples``), ``multiclass_nms``, ``concat``, the fused
``ssd_loss`` (value and gradients), the detection layers, and SSD's
first three Momentum steps; SSD-300's program (8732 priors).

Tolerances. Index outputs (matches, mined negatives, NMS labels) are
compared exactly. The JAX package computes in f64 where the test session's
x64 promotes its Python constants (prior boxes, decoding), the port in f32
(prior boxes in f64, rounded once): boxes and encodings within 1e-6
(read <= 2.4e-7), the loss within 1e-6 relative (read 1.2e-7) and its
gradients within 1e-5 of their largest element (read 3.0e-7); SSD's step
losses within 1e-5 relative (read <= 8.9e-7; batch-normalized convs) and
detections within 1e-5 (read 2.2e-7)."""

import numpy as np
import pytest
import torch
from torch_model_parity import rel, same_programs, train_both

import paddle_tpu as pfluid
from paddle_tpu.core.registry import get_op_def as jax_op
from paddle_tpu.models import ssd as pssd

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.registry import get_op_def as torch_op
from paddle_tpu_torch.models import ssd as tssd


def _run_jax(op, ins, attrs):
    """The JAX op as one jitted program (eager JAX compiles each of its
    primitives on its own, which costs more here)."""
    import jax

    ins = {k: v for k, v in ins.items() if v is not None}

    def run(arrays):
        outs = jax_op(op).compute({k: [v] for k, v in arrays.items()},
                                  dict(attrs))
        return {k: v[0] for k, v in outs.items()}

    return {k: np.asarray(v) for k, v in jax.jit(run)(ins).items()}


def _run_torch(op, ins, attrs):
    outs = torch_op(op).compute(
        {k: [torch.from_numpy(np.ascontiguousarray(v))]
         for k, v in ins.items() if v is not None}, dict(attrs),
        torch.device("cpu"))
    return {k: v[0].numpy() for k, v in outs.items()}


def _both(op, ins, attrs):
    return _run_jax(op, ins, attrs), _run_torch(op, ins, attrs)


def _boxes(r, shape, lo=0.0, hi=1.0):
    a = r.uniform(lo, hi, shape + (2,))
    b = r.uniform(lo, hi, shape + (2,))
    return np.concatenate([np.minimum(a, b), np.maximum(a, b)],
                          -1).astype(np.float32)


# SSD-300's six maps (ssd300_net): (feature size, min, max, ratios, step)
_SSD300_MAPS = [(38, 30.0, 60.0, [2.0], 8.0), (19, 60.0, 111.0, [2.0, 3.0],
                                               16.0),
                (10, 111.0, 162.0, [2.0, 3.0], 32.0),
                (5, 162.0, 213.0, [2.0, 3.0], 64.0),
                (3, 213.0, 264.0, [2.0], 100.0), (1, 264.0, 315.0, [2.0],
                                                  300.0)]


def test_prior_box_matches_jax_at_ssd300_maps():
    """Bit for bit (the JAX op in f64 under x64, rounded to f32), clip
    off and on in turn."""
    total = 0
    for i, (fs, mn, mx, ars, step) in enumerate(_SSD300_MAPS):
        clip = i % 2 == 1
        ins = {"Input": np.zeros((1, 1, fs, fs), np.float32),
               "Image": np.zeros((1, 3, 300, 300), np.float32)}
        attrs = {"min_sizes": [mn], "max_sizes": [mx], "aspect_ratios": ars,
                 "variances": [0.1, 0.1, 0.2, 0.2], "flip": True,
                 "clip": clip, "step_w": step, "step_h": step,
                 "offset": 0.5}
        want, got = _both("prior_box", ins, attrs)
        for k in ("Boxes", "Variances"):
            assert got[k].shape == want[k].shape and got[k].dtype == \
                np.float32, k
            np.testing.assert_array_equal(got[k],
                                          want[k].astype(np.float32))
        total += got["Boxes"].shape[0] * got["Boxes"].shape[1] * \
            got["Boxes"].shape[2]
    assert total == 8732


@pytest.mark.parametrize("normalized", [True, False])
def test_iou_and_box_coder_match_jax(normalized):
    r = np.random.RandomState(0)
    prior = _boxes(r, (30,), 0.05, 0.95)
    pvar = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (30, 1))
    target = _boxes(r, (7,), 0.05, 0.95)
    want, got = _both("iou_similarity", {"X": target, "Y": prior}, {})
    assert rel(got["Out"], want["Out"]) <= 1e-6
    attrs = {"code_type": "encode_center_size",
             "box_normalized": normalized}
    for var in (pvar, None):
        want, got = _both("box_coder", {"PriorBox": prior,
                                        "PriorBoxVar": var,
                                        "TargetBox": target}, attrs)
        assert got["OutputBox"].shape == (7, 30, 4)
        assert rel(got["OutputBox"], want["OutputBox"]) <= 1e-6
    deltas = r.normal(0, 1, (3, 30, 4)).astype(np.float32)
    want, got = _both("box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                                    "TargetBox": deltas},
                      {"code_type": "decode_center_size",
                       "box_normalized": normalized})
    assert rel(got["OutputBox"], want["OutputBox"]) <= 1e-6
    want, got = _both("box_coder", {"PriorBox": prior, "TargetBox": deltas},
                      {"code_type": "decode_center_size",
                       "variance": [0.1, 0.1, 0.2, 0.2]})
    assert rel(got["OutputBox"], want["OutputBox"]) <= 1e-6


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_matches_jax(match_type):
    r = np.random.RandomState(1)
    dist = r.uniform(0, 1, (3, 5, 40)).astype(np.float32)
    dist[1, 4] = 0.0  # a row that never matches
    dist[2] = np.round(dist[2] * 4) / 4  # ties
    attrs = {"match_type": match_type, "dist_threshold": 0.5}
    want, got = _both("bipartite_match", {"DistMat": dist}, attrs)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    want, got = _both("bipartite_match", {"DistMat": dist[0]}, attrs)
    np.testing.assert_array_equal(got["ColToRowMatchIndices"],
                                  want["ColToRowMatchIndices"])


def test_target_assign_and_mining_match_jax():
    r = np.random.RandomState(2)
    n, g, p = 3, 4, 50
    match = r.randint(-1, g, (n, p)).astype(np.int32)
    match[0] = -1  # an image with no positives
    x = r.normal(0, 1, (n, g, 4)).astype(np.float32)
    neg = np.full((n, 10), -1, np.int32)
    neg[:, :6] = r.randint(0, p, (n, 6))
    want, got = _both("target_assign", {"X": x, "MatchIndices": match,
                                        "NegIndices": neg},
                      {"mismatch_value": 0.5})
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    loss = r.normal(0, 1, (n, p)).astype(np.float32)
    loss[:, :5] = 0.25  # tied losses keep index order
    dist = r.uniform(0, 1, (n, p)).astype(np.float32)
    for mining, ss in (("max_negative", 0), ("hard_example", 7)):
        ins = {"ClsLoss": loss, "LocLoss": np.abs(loss),
               "MatchIndices": match, "MatchDist": dist}
        attrs = {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                 "mining_type": mining, "sample_size": ss}
        want, got = _both("mine_hard_examples", ins, attrs)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("background", [0, -1])
def test_multiclass_nms_matches_jax(background):
    r = np.random.RandomState(3)
    n, m, c = 2, 24, 4
    centers = r.uniform(0.2, 0.8, (n, m, 2))
    sizes = r.uniform(0.1, 0.3, (n, m, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]  # a duplicate box, suppressed
    scores = r.uniform(0, 1, (n, c, m)).astype(np.float32)
    scores[:, :, 5] = scores[:, :, 6]  # tied scores
    attrs = {"score_threshold": 0.1, "nms_top_k": 16, "keep_top_k": 64,
             "nms_threshold": 0.3, "background_label": background}
    want, got = _both("multiclass_nms", {"BBoxes": boxes, "Scores": scores},
                      attrs)
    np.testing.assert_array_equal(got["Out"], want["Out"])
    labels = got["Out"][..., 0]
    assert (labels >= 0).any() and (labels == -1).any()


def test_concat_matches_jax():
    r = np.random.RandomState(4)
    xs = [r.normal(0, 1, (2, k, 3)).astype(np.float32) for k in (1, 4, 2)]
    import jax.numpy as jnp

    want = jax_op("concat").compute({"X": [jnp.asarray(x) for x in xs]},
                                    {"axis": 1})["Out"][0]
    got = torch_op("concat").compute({"X": [torch.from_numpy(x)
                                            for x in xs]}, {"axis": 1},
                                     torch.device("cpu"))["Out"][0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ssd_loss_inputs(seed=5, n=3, p=40, c=5, g=4):
    r = np.random.RandomState(seed)
    prior = _boxes(r, (p,), 0.05, 0.95)
    pvar = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32), (p, 1))
    gt = np.zeros((n, g, 4), np.float32)
    lbl = np.zeros((n, g), np.int64)
    for i in range(n):
        k = 1 + i  # 1..n valid rows, zero-area padding after
        gt[i, :k] = prior[r.choice(p, k, replace=False)] + r.normal(
            0, 0.02, (k, 4)).astype(np.float32)
        lbl[i, :k] = r.randint(1, c, k)
    loc = r.normal(0, 0.5, (n, p, 4)).astype(np.float32)
    conf = r.normal(0, 1, (n, p, c)).astype(np.float32)
    return {"Location": loc, "Confidence": conf, "GtBox": gt, "GtLabel": lbl,
            "PriorBox": prior, "PriorBoxVar": pvar}


@pytest.mark.parametrize("match_type", ["per_prediction", "bipartite"])
def test_ssd_loss_value_and_gradients_match_jax(match_type):
    import jax
    import jax.numpy as jnp

    ins = _ssd_loss_inputs()
    attrs = {"background_label": 0, "overlap_threshold": 0.5,
             "neg_pos_ratio": 3.0, "neg_overlap": 0.5,
             "loc_loss_weight": 1.0, "conf_loss_weight": 1.0,
             "match_type": match_type, "normalize": True}
    fwd = jax_op("ssd_loss").compute
    cot = np.random.RandomState(6).normal(0, 1, (3, 1)).astype(np.float32)

    def jloss(loc, conf):
        jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
        jins["Location"], jins["Confidence"] = [loc], [conf]
        return jnp.sum(fwd(jins, attrs)["Loss"][0] * cot)

    # one jitted program each (eager JAX compiles every op on its own)
    want = jax.jit(lambda loc, conf: fwd(
        {**{k: [jnp.asarray(v)] for k, v in ins.items()},
         "Location": [loc], "Confidence": [conf]}, attrs)["Loss"][0])(
        ins["Location"], ins["Confidence"])
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(ins["Location"]), jnp.asarray(ins["Confidence"]))
    tins = {k: torch.from_numpy(v) for k, v in ins.items()}
    loc = tins["Location"].clone().requires_grad_(True)
    conf = tins["Confidence"].clone().requires_grad_(True)
    tins["Location"], tins["Confidence"] = loc, conf
    with torch.enable_grad():
        got = torch_op("ssd_loss").compute(
            {k: [v] for k, v in tins.items()}, attrs,
            torch.device("cpu"))["Loss"][0]
        (got * torch.from_numpy(cot)).sum().backward()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    assert rel(loc.grad.numpy(), jg[0]) <= 1e-5
    assert rel(conf.grad.numpy(), jg[1]) <= 1e-5
    assert np.abs(loc.grad.numpy()).max() > 0


# --- the layers and SSD ---------------------------------------------------

_SSD = dict(image_shape=(3, 32, 32), num_classes=4, gt_capacity=4)


def _ssd_model(fluid):
    M = pssd if fluid is pfluid else tssd
    return M.get_model(batch_size=4, **_SSD)


def _momentum(fluid):
    return fluid.optimizer.Momentum(0.01, momentum=0.9)


def test_ssd_programs_match_and_ssd300_has_8732_priors():
    (jops, tops), (jp, tp) = same_programs(_ssd_model, _momentum)
    assert tops == jops and tp == jp
    for op in ("prior_box", "concat", "ssd_loss", "box_coder",
               "multiclass_nms"):
        assert op in tops, op
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        model = tssd.get_ssd300_model(21, 50)
    assert tuple(model["priors"].shape) == (8732, 4)
    assert tuple(model["confs"].shape)[1:] == (8732, 21)


def test_ssd_three_momentum_steps_match_jax():
    """SSD's toy detector (32 x 32 images, 4 classes, 4 gt rows, b 4):
    three Momentum steps from the JAX package's startup state, the loss
    and the NMS'd detections of each step, then every parameter, moving
    statistic and velocity."""
    feeds = [tssd.synthetic_batch(4, seed=s, **_SSD) for s in range(3)]
    want = pssd.synthetic_batch(4, seed=1, **_SSD)
    for k, v in want.items():
        np.testing.assert_array_equal(feeds[1][k], v)
    j, t, jf, tf, _ = train_both(
        _ssd_model, _momentum, feeds,
        lambda m: [m["loss"], m["detection"], m["locs"], m["confs"]])
    for step, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5, err_msg=step)
        det_a, det_b = a[1], b[1]
        assert det_b.shape == det_a.shape == (4, 16, 6)
        np.testing.assert_array_equal(det_b[..., 0], det_a[..., 0])
        np.testing.assert_allclose(det_b[..., 1:], det_a[..., 1:], rtol=0,
                                   atol=1e-5)
        assert rel(b[2], a[2]) <= 1e-5 and rel(b[3], a[3]) <= 1e-5
    assert sorted(tf) == sorted(jf)
    for n, v in jf.items():
        assert rel(tf[n], v) <= 1e-4, (n, rel(tf[n], v))
