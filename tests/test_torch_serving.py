"""The port's serving path (paddle_tpu_torch) against the JAX package's, on
the CPU, with the JAX package's weights carried across by name.

The config is tests/test_serving.py's tiny transformer with two layers
and src_len 16, so the prefill's encoder self-attention takes the small
kernel's route (tq = tk = 16). Tolerances: f32 state and fetches within
atol 1e-5 (the two frameworks sum in different orders); greedy tokens,
positions and live flags exact."""

import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu import framework as pframework
from paddle_tpu import serving as pserving
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import transformer as TT

_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=2, dropout=0.0,
            label_smooth_eps=0.0)
SLOTS, SRC_LEN, MAX_LEN = 4, 16, 12


@pytest.fixture(scope="module")
def weights():
    """JAX-initialized weights, and the same arrays in a port Scope."""
    cfg = PT.TransformerConfig(**_CFG)
    scope = pfluid.Scope()
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        PT.build(cfg, is_test=True)
    with pfluid.scope_guard(scope):
        pfluid.Executor(pfluid.CPUPlace()).run(startup)
    params = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}
    return cfg, scope, params, tio.scope_from_numpy(params, tfluid.CPUPlace())


def _srcs(seed=0, lens=(5, 3, 16, 4, 9, 2, 12, 7)):
    r = np.random.RandomState(seed)
    return [r.randint(2, 37, (n,)).astype(np.int64) for n in lens]


def _serve(mod, cfg, w, place, srcs, slots=SLOTS):
    """8 requests, staggered: 4 submitted (with mixed token budgets), two
    ticks, then the other 4 — the same call sequence on either engine."""
    eng = mod.ServingEngine(cfg, w, slots=slots, src_len=SRC_LEN,
                            max_len=MAX_LEN, place=place)
    hs = [eng.submit(s, max_new_tokens=m)
          for s, m in zip(srcs[:4], (11, 3, 6, 11))]
    eng.step()
    eng.step()
    hs += [eng.submit(s) for s in srcs[4:]]
    eng.run_until_idle()
    out = [(list(h.tokens), h.outcome) for h in hs]
    eng.close()
    return out


def test_port_tokens_equal_jax_tokens(weights):
    pcfg, pscope, _, tscope = weights
    srcs = _srcs()
    jax_out = _serve(pserving, pcfg, pscope, pfluid.CPUPlace(), srcs)
    port_out = _serve(tserving, TT.TransformerConfig(**_CFG), tscope,
                      tfluid.CPUPlace(), srcs)
    assert port_out == jax_out
    assert all(len(toks) > 0 for toks, _ in port_out)


def test_port_batched_equals_port_solo(weights):
    """Each request decoded alone through an engine of the same geometry
    gives the tokens it got in the staggered batched run."""
    _, _, _, tscope = weights
    cfg = TT.TransformerConfig(**_CFG)
    srcs = _srcs(seed=5)
    batched = _serve(tserving, cfg, tscope, tfluid.CPUPlace(), srcs)
    for i, src in enumerate(srcs):
        eng = tserving.ServingEngine(cfg, tscope, slots=SLOTS,
                                     src_len=SRC_LEN, max_len=MAX_LEN,
                                     place=tfluid.CPUPlace())
        h = eng.submit(src, max_new_tokens=(11, 3, 6, 11)[i] if i < 4
                       else None)
        eng.run_until_idle()
        eng.close()
        assert (list(h.tokens), h.outcome) == batched[i], i


def _zero_state(specs):
    return {n: np.zeros(shape, np.dtype(dt)) for n, (shape, dt) in specs.items()}


def test_prefill_state_and_decode_fetches_match_jax(weights):
    """Program level: prefill two requests into slots 0 and 2, compare
    every cross-attention K/V row and the cross bias (atol 1e-5), then
    five decode steps: emitted token, live flag and position exact, the
    per-step ``score`` (the greedy token's logit) and ``maxabs`` within
    atol 1e-5."""
    pcfg, _, params, tscope = weights
    tcfg = TT.TransformerConfig(**_CFG)
    pprogs = PT.build_serving(pcfg, SLOTS, SRC_LEN, MAX_LEN)
    tprogs = TT.build_serving(tcfg, SLOTS, SRC_LEN, MAX_LEN)
    pscope = pfluid.Scope()
    for n, a in {**params, **_zero_state(pprogs["state_specs"])}.items():
        pscope.set(n, a)
    tstate = tio.scope_from_numpy(_zero_state(tprogs["state_specs"]),
                                  tfluid.CPUPlace())
    for n in tscope.var_names():
        tstate.set(n, tscope.find_var(n))
    pexe = pfluid.Executor(pfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())

    def both(prog_key, feed, fetch_key=None):
        fetches = []
        for exe, scope, progs, guard in (
                (pexe, pscope, pprogs, pfluid.scope_guard),
                (texe, tstate, tprogs, tfluid.scope_guard)):
            spec = progs[prog_key.replace("_program", "")]
            names = [v.name for v in spec["feeds"]]
            fl = [spec[k] for k in fetch_key] if fetch_key else []
            with guard(scope):
                fetches.append(exe.run(progs[prog_key],
                                       feed=dict(zip(names, feed)),
                                       fetch_list=fl))
        return fetches

    for slot, src in ((0, _srcs()[2]), (2, _srcs()[4])):
        ids = np.zeros((1, SRC_LEN), np.int64)
        ids[0, :len(src)] = src
        pad = (np.arange(SRC_LEN) < len(src)).astype(np.float32)[None]
        both("prefill_program", [ids, pad, np.asarray([slot], np.int64)])
    for name in pprogs["state_specs"]:
        j = np.asarray(pscope.find_var(name))
        t = tstate.find_var(name).numpy()
        assert t.dtype == j.dtype, name
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)
    active = np.array([True, False, True, False])
    for _ in range(5):
        (pe, pl, pp, pm, ps), (te, tl, tp, tm, ts) = both(
            "decode_program", [active],
            ["emit", "live", "pos", "maxabs", "score"])
        np.testing.assert_array_equal(te, np.asarray(pe))
        np.testing.assert_array_equal(tl, np.asarray(pl))
        np.testing.assert_array_equal(tp, np.asarray(pp))
        np.testing.assert_allclose(ts, np.asarray(ps), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tm, np.asarray(pm), atol=1e-5, rtol=0)


def _op_signature(block):
    """(op type, output shapes, output dtypes) per op, in order."""
    sig = []
    for op in block.ops:
        outs = [block._find_var_recursive(n) for n in op.output_arg_names]
        sig.append((op.type, [v.shape for v in outs],
                    [v.dtype for v in outs]))
    return sig


def _persistables(program):
    return {v.name: (v.shape, v.dtype, v.is_parameter)
            for v in program.list_vars() if v.persistable}


def test_program_structure_matches_jax():
    """Same op sequence (with the same inferred output shapes and dtypes),
    the same parameter and state names, shapes and dtypes, in the serving
    programs and in build()'s main and startup programs."""
    pcfg, tcfg = PT.TransformerConfig(**_CFG), TT.TransformerConfig(**_CFG)
    pprogs = PT.build_serving(pcfg, SLOTS, SRC_LEN, MAX_LEN)
    tprogs = TT.build_serving(tcfg, SLOTS, SRC_LEN, MAX_LEN)
    pairs = [(pprogs[k], tprogs[k]) for k in
             ("prefill_program", "decode_program", "scrub_program")]
    built = []
    for fluid, T, cfg in ((pfluid, PT, pcfg), (tfluid, TT, tcfg)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            T.build(cfg, is_test=True)
        built.append((main, startup))
    pairs += [(built[0][0], built[1][0]), (built[0][1], built[1][1])]
    for p, t in pairs:
        assert _op_signature(t.global_block()) == \
            _op_signature(p.global_block())
        assert _persistables(t) == _persistables(p)
    assert tprogs["state_specs"] == pprogs["state_specs"]

    # shape inference gives up where the JAX package's does (the error
    # types of a failed evaluation differ between the frameworks)
    def kinds(gaps):
        return {(t, g.split(":")[0]) for t, g in gaps}

    assert kinds(tframework.shape_infer_gaps()) <= \
        kinds(pframework.shape_infer_gaps())


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_build_loss_and_logits_match_jax(weights, eps):
    """build(cfg, is_test=True) on one synthetic batch: logits and the
    masked (label-smoothed when eps > 0) token loss within atol 1e-5."""
    _, pscope, params, _ = weights
    feed = PT.make_batch(PT.TransformerConfig(**_CFG), batch=3, src_len=10,
                         trg_len=7, seed=2)
    outs = []
    for fluid, T, scope in (
            (pfluid, PT, pscope),
            (tfluid, TT, tio.scope_from_numpy(params, tfluid.CPUPlace()))):
        cfg = T.TransformerConfig(**{**_CFG, "label_smooth_eps": eps})
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            model = T.build(cfg, is_test=True)
        with fluid.scope_guard(scope):
            outs.append(fluid.Executor(fluid.CPUPlace()).run(
                main, feed=feed,
                fetch_list=[model["loss"], model["logits"],
                            model["token_count"]]))
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=0)


def test_nonfinite_slot_is_evicted_and_scrubbed(weights):
    """A slot whose logits go non-finite finishes with outcome 'error'
    and its device rows are zeroed; the other slot keeps decoding."""
    _, _, _, tscope = weights
    eng = tserving.ServingEngine(
        TT.TransformerConfig(**_CFG), tscope, slots=2, src_len=SRC_LEN,
        max_len=MAX_LEN, place=tfluid.CPUPlace())
    good = eng.submit(_srcs()[0], max_new_tokens=4)
    bad = eng.submit(_srcs()[1], max_new_tokens=4)
    eng._admit()  # both prefilled into slots 0 and 1, nothing decoded
    # poison slot 1's cross-attention values: its logits turn NaN
    cv = eng.scope.find_var("serve_cv0").clone()
    cv[1] = float("nan")
    eng.scope.set("serve_cv0", cv)
    eng.run_until_idle()
    assert bad.outcome == "error" and good.outcome == "length"
    assert len(good.tokens) == 4
    # the scrub zeroed the slot; later decode steps rewrite only its
    # self-attention ring (dead slots decode frozen), never these rows
    for name in ("serve_cv0", "serve_cv1", "serve_ck0", "serve_cross_bias"):
        assert not eng.scope.find_var(name)[1].any(), name
    assert not bool(eng.scope.find_var("serve_live")[1])
    eng.close()


def test_backpressure_and_drain(weights):
    _, _, _, tscope = weights
    eng = tserving.ServingEngine(TT.TransformerConfig(**_CFG), tscope,
                                 slots=1, src_len=SRC_LEN, max_len=MAX_LEN,
                                 place=tfluid.CPUPlace(), queue_depth=2)
    a, b = eng.submit([3, 4, 5]), eng.submit([6, 7])
    with pytest.raises(tserving.QueueFull):
        eng.submit([8])
    eng.step()  # a admitted; b still queued
    assert eng.drain()
    assert a.outcome in ("completed", "length") and b.outcome == "drained"
    with pytest.raises(tserving.EngineClosed):
        eng.submit([9])
    eng.close()
    assert eng.state == "closed"


def test_entry_points_default_to_cuda():
    """Without CUDA, every entry point raises unless given CPUPlace()."""
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device: the default works")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tio.scope_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tserving.ServingEngine(TT.TransformerConfig(**_CFG), tfluid.Scope(),
                               slots=1, src_len=SRC_LEN, max_len=MAX_LEN)
    assert tframework.resolve_device(tfluid.CPUPlace()).type == "cpu"


def test_load_params_reads_the_jax_params_file(weights, tmp_path):
    """paddle_tpu.io saves __params__.npz; the port reads it back."""
    from paddle_tpu import io as pio

    pcfg, pscope, params, _ = weights
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        PT.build(pcfg, is_test=True)
    with pfluid.scope_guard(pscope):
        pio.save_persistables(pfluid.Executor(pfluid.CPUPlace()),
                              str(tmp_path), main_program=main)
    scope = tio.load_params(str(tmp_path), tfluid.CPUPlace())
    assert sorted(scope.var_names()) == sorted(
        v.name for v in main.list_vars() if v.persistable)
    for n in scope.var_names():
        np.testing.assert_array_equal(scope.find_var(n).numpy(), params[n])
