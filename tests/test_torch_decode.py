"""The port's beam-search translation (``build_decode`` / ``translate``)
against the JAX package's, on the CPU.

The config is tests/test_decode.py's tiny Transformer (vocab 37 / 41,
d_model 16, one layer), JAX-initialized, its weights carried into the
port through ``io.scope_from_numpy``. One test, parametrized:

- beam 1, 2 and 4: the same ids, scores within 1e-5, the same ``Steps``;
- an ``end_id`` (13) that every hypothesis of these two sources emits
  early: the loop stops after 9 of at most 15 steps in both packages,
  every position it wrote after a hypothesis's end holds ``end_id``, and
  the positions past its last step keep ``bos_id``;
- ``translate``'s program cache: two calls reuse one program, the first
  runs the loop runner's warm-up and capture, the second replays, and
  both equal the JAX package's ``translate``.

Each port case runs uncached (the eager loop) and through the cached
executor call (the loop runner). Then the port's counterparts of
tests/test_decode.py: beam 1 equals a step-by-step argmax through the
port's own training program; each beam's score equals the
teacher-forced log-probability of its ids (rtol / atol 2e-4, as there)
and beams come sorted; a finished hypothesis stays ``end_id``."""

import numpy as np
import pytest

import paddle_tpu as pfluid
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import transformer as TT

BOS, EOS = 0, 1
_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=1, dropout=0.0,
            label_smooth_eps=0.0)


@pytest.fixture(scope="module")
def weights():
    """JAX-initialized weights, and the same arrays in a port Scope."""
    scope = pfluid.Scope()
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        PT.build(PT.TransformerConfig(**_CFG), is_test=True)
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pfluid.scope_guard(scope):
        exe.run(startup)
    params = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}
    return scope, exe, tio.scope_from_numpy(params, tfluid.CPUPlace())


def _src_batch(b=2, s=5, seed=0):
    r = np.random.RandomState(seed)
    return (r.randint(2, 37, (b, s)).astype(np.int64),
            np.ones((b, s), np.float32))


def _decode(fluid, T, exe, scope, beam, max_len, end_id, src, pad,
            cached=True):
    """ids, scores and the loop's Steps of a build_decode program."""
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        dec = T.build_decode(T.TransformerConfig(**_CFG), beam_size=beam,
                             max_len=max_len, src_len=src.shape[1],
                             bos_id=BOS, end_id=end_id)
    (loop,) = [op for op in prog.global_block().ops if op.type == "while"]
    fetch = [dec["ids"], dec["scores"], loop.outputs["Steps"][0]]
    feed = {"src_ids": src, "src_pad_mask": pad}
    with fluid.scope_guard(scope):
        if fluid is pfluid:
            return exe.run(prog, feed=feed, fetch_list=fetch)
        return [exe.run(prog, feed=feed, fetch_list=fetch,
                        use_program_cache=cached) for _ in range(2)]


# (beam, max_len, end_id, source seed, expected Steps or None)
_CASES = {"beam1": (1, 8, EOS, 0, None), "beam2": (2, 8, EOS, 0, None),
          "beam4": (4, 8, EOS, 0, None), "early_end": (4, 16, 13, 0, 9)}


def _held(t_ids, t_scores, j_ids, j_scores):
    np.testing.assert_array_equal(t_ids, np.asarray(j_ids))
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("case", sorted(_CASES) + ["translate_cache"])
def test_translate_matches_jax(weights, case):
    jscope, jexe, tscope = weights
    if case == "translate_cache":
        src, pad = _src_batch(seed=5)
        cfg = TT.TransformerConfig(**_CFG)
        want = PT.translate(jexe, jscope, src, pad, PT.TransformerConfig(
            **_CFG), beam_size=3, max_len=6)
        texe = tfluid.Executor(tfluid.CPUPlace())
        progs = set()
        for _ in range(2):
            got = TT.translate(texe, tscope, src, pad, cfg, beam_size=3,
                               max_len=6)
            _held(*got, *want)
            progs.update(id(p) for p, _ in TT._decode_prog_cache.values())
            assert got[0].shape == (2, 3, 6) and got[1].shape == (2, 3)
        (runner,) = texe._loop_runners.values()
        assert runner.loops == 2 and runner.captured
        assert len(texe._cache) == 1 and len(progs) == len(
            TT._decode_prog_cache)
        return
    beam, max_len, end_id, seed, steps = _CASES[case]
    src, pad = _src_batch(seed=seed)
    j_ids, j_scores, j_steps = _decode(pfluid, PT, jexe, jscope, beam,
                                       max_len, end_id, src, pad)
    if steps is not None:
        assert int(j_steps) == steps < max_len - 1
    for cached in (False, True):
        texe = tfluid.Executor(tfluid.CPUPlace())
        runs = _decode(tfluid, TT, texe, tscope, beam, max_len, end_id, src,
                       pad, cached)
        for t_ids, t_scores, t_steps in runs:
            _held(t_ids, t_scores, j_ids, j_scores)
            assert int(t_steps) == int(j_steps)
        if cached:
            (runner,) = texe._loop_runners.values()
            assert runner.captured and runner.loops == 2
    if steps is not None:
        # every position the loop wrote after a hypothesis's end holds
        # end_id; the positions past the last step keep bos_id
        for seq in j_ids.reshape(-1, max_len):
            first = list(seq[1:]).index(end_id) + 1
            assert (seq[first:steps + 1] == end_id).all(), seq
            assert (seq[steps + 1:] == BOS).all(), seq


# --- the port's counterparts of tests/test_decode.py ----------------------


@pytest.fixture(scope="module")
def port_model(weights):
    """The port's is_test training program on the JAX weights."""
    _, _, tscope = weights
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        model = TT.build(TT.TransformerConfig(**_CFG), is_test=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    return tscope, exe, main, model


def _port_decode(port_model, beam, src, pad, max_len):
    tscope, exe, _, _ = port_model
    ids, scores, _ = _decode(tfluid, TT, exe, tscope, beam, max_len, EOS,
                             src, pad)[0]
    return ids, scores


def _logits(port_model, src, pad, seq):
    tscope, exe, main, model = port_model
    t = len(seq)
    feed = {"src_ids": src, "trg_ids": np.asarray(seq, np.int64)[None, :],
            "lbl_ids": np.zeros((1, t), np.int64), "src_pad_mask": pad,
            "trg_pad_mask": np.ones((1, t), np.float32)}
    with tfluid.scope_guard(tscope):
        (logits,) = exe.run(main, feed=feed, fetch_list=[model["logits"]])
    return logits[0]


def test_greedy_parity_beam1(port_model):
    src, pad = _src_batch(b=2)
    max_len = 6
    ids, scores = _port_decode(port_model, 1, src, pad, max_len)
    assert ids.shape == (2, 1, max_len) and scores.shape == (2, 1)
    for row in range(2):
        seq = [BOS]
        for t in range(1, max_len):
            logits = _logits(port_model, src[row:row + 1], pad[row:row + 1],
                             seq)
            nxt = int(np.argmax(logits[t - 1]))
            seq.append(nxt)
            if nxt == EOS:
                break
        assert list(ids[row, 0][:len(seq)]) == seq, row


def _teacher_logp(port_model, src, pad, seq):
    """Sum of log-probs of ``seq`` (starts with BOS) under the training
    program's logits, up to and including the first EOS."""
    logits = _logits(port_model, src, pad, seq).astype(np.float64)
    m = logits.max(-1, keepdims=True)
    logp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
    total = 0.0
    for pos in range(len(seq) - 1):
        tok = seq[pos + 1]
        total += logp[pos, tok]
        if tok == EOS:
            break
    return total


def test_beam_scores_consistent_and_sorted(port_model):
    src, pad = _src_batch(b=2, seed=1)
    ids, scores = _port_decode(port_model, 4, src, pad, 6)
    assert ids.shape == (2, 4, 6) and scores.shape == (2, 4)
    assert (np.diff(scores, axis=1) <= 1e-5).all()
    assert (ids[:, :, 0] == BOS).all()
    for row in range(2):
        for beam in range(4):
            got = _teacher_logp(port_model, src[row:row + 1],
                                pad[row:row + 1], list(ids[row, beam]))
            np.testing.assert_allclose(got, scores[row, beam], rtol=2e-4,
                                       atol=2e-4)


def test_eos_padding_after_finish(port_model):
    src, pad = _src_batch(b=4, seed=3)
    ids, _ = _port_decode(port_model, 2, src, pad, 8)
    for seq in ids.reshape(-1, 8):
        seq = list(seq)
        if EOS in seq[1:]:
            first = seq[1:].index(EOS) + 1
            assert all(x == EOS for x in seq[first:]), seq
