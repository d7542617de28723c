"""The compiled step of the port (core/lowering.py ``StepRunner``,
executor.py) on the CPU, where the runner calls its step function
directly instead of a CUDA graph, with the same buffers, in-place
commits, device step counter and seeds: the step-seed stream, Scope
identities across runs and their rebinding after another program's or an
eager run's commit, and ``run_steps``'s feed rotation against the JAX
package's.

Tolerances: seeds, masks, losses and parameters of two runs of the port
are compared bit for bit; the port against the JAX package (dropout 0)
within atol 1e-5, as tests/test_torch_train.py holds f32 losses (the two
frameworks sum in different orders)."""

import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu import unique_name as punique
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import layers
from paddle_tpu_torch import unique_name as tunique
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import nn_ops

_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=2, label_smooth_eps=0.1)


def _feed(seed, dropout=0.0):
    return PT.make_batch(PT.TransformerConfig(**_CFG, dropout=dropout), 3,
                         10, 7, seed=seed)


def _build(fluid, T, unique, dropout, sgd=False):
    main, startup = fluid.Program(), fluid.Program()
    with unique.guard(), fluid.program_guard(main, startup):
        model = T.build(T.TransformerConfig(**_CFG, dropout=dropout))
        opt = fluid.optimizer.SGD(0.5) if sgd else fluid.optimizer.Adam(1e-2)
        opt.minimize(model["loss"])
    main.random_seed = startup.random_seed = 3
    return main, startup, model


def _train(dropout=0.1):
    return _build(tfluid, TT, tunique, dropout)


@pytest.mark.parametrize("base,idx", [(0, 0), (3, 1), (2**62 + 5, 17),
                                      (2**64 - 1, 2**20), (12345, 0)])
def test_mix64_tensor_gives_the_host_bits(base, idx):
    got = rng.mix64_tensor(torch.tensor(rng.signed64(base)), idx)
    assert int(got) == rng.mix64(base, idx)
    counter = torch.tensor(idx)
    assert int(rng.mix64_tensor(torch.tensor(rng.signed64(base)),
                                counter)) == rng.mix64(base, idx)
    # a step seed's op seeds through a handle
    buf = torch.tensor(rng.signed64(rng.step_seed(base, idx)))
    assert int(rng.SeedHandle(buf, 9).op_seed_tensor()) == rng.mix64(
        rng.step_seed(base, idx), 9)


def _dropout_program(p=0.3):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = layers.data("x", shape=[6, 50], append_batch_size=False)
        out = layers.dropout(x, p, dropout_implementation="upscale_in_train")
    main.random_seed = 11
    mask = main.global_block().ops[0].outputs["Mask"][0]
    return main, out, mask


def test_step_seed_stream_and_run_steps_equal_successive_runs():
    """Step s of a program draws its masks from step_seed(random_seed, s)
    mixed with the op's index, whichever path runs it: uncached eager
    runs, the runner's eager first call, its steps after binding, and a
    run_steps window."""
    main, out, mask = _dropout_program()
    x = np.random.RandomState(0).randn(6, 50).astype(np.float32)

    def want(step):
        seed = rng.SeedHandle(torch.tensor(rng.step_seed(11, step)), 0)
        return nn_ops.dropout_plain(torch.from_numpy(x), seed, 0.3,
                                    True)[1].numpy()

    for cached in (False, True):
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(tfluid.Scope()):
            got = [exe.run(main, feed={"x": x}, fetch_list=[mask],
                           use_program_cache=cached)[0] for _ in range(4)]
        for step, m in enumerate(got):
            np.testing.assert_array_equal(m, want(step), err_msg=step)
    assert not np.array_equal(want(0), want(1))
    # windows continue the executor's step count
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        (m2,) = exe.run_steps(main, [{"x": x}], 3, [mask])
        (m3,) = exe.run(main, feed={"x": x}, fetch_list=[mask])
        (m5,) = exe.run_steps(main, [{"x": x}], 2, [mask])
    for step, m in ((2, m2), (3, m3), (5, m5)):
        np.testing.assert_array_equal(m, want(step), err_msg=step)


def test_in_place_commit_keeps_scope_identities():
    """From the second call on, the Scope's state tensors are the runner's
    buffers: they keep their identity while their values move, and the
    losses equal those of uncached eager runs."""
    main, startup, model = _train()
    feeds = [_feed(0, 0.1), _feed(1, 0.1)]
    names = [p.name for p in main.all_parameters()]
    runs = {}
    for cached in (False, True):
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            exe.run(startup)
            losses, ids = [], []
            for i in range(4):
                (loss,) = exe.run(main, feed=feeds[i % 2],
                                  fetch_list=[model["loss"]],
                                  use_program_cache=cached)
                losses.append(loss)
                ids.append([id(scope.find_var(n)) for n in names])
        runs[cached] = (losses, ids,
                        {n: scope.find_var(n).clone() for n in names})
    (e_losses, e_ids, e_params), (c_losses, c_ids, c_params) = (
        runs[False], runs[True])
    assert e_losses == c_losses
    for n in names:
        assert torch.equal(e_params[n], c_params[n]), n
    # eager runs commit fresh tensors; bound runs write the same ones
    assert e_ids[1] != e_ids[2]
    assert c_ids[1] == c_ids[2] == c_ids[3]


def test_rebinding_after_another_commit():
    """Another program's commit, an eager run's and a value the caller
    sets all reach the bound step: the runner copies the Scope's tensor
    into its buffer once and binds the Scope to the buffer again."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        acc = layers.create_global_var([2], 0.0, "float32",
                                       persistable=True, name="acc")
        x = layers.data("x", shape=[2], append_batch_size=False)
        layers.assign(layers.elementwise_add(acc, x), acc)
    reset = tfluid.Program()
    with tfluid.program_guard(reset, tfluid.Program()):
        acc_r = layers.create_global_var([2], 0.0, "float32",
                                         persistable=True, name="acc")
        layers.assign(layers.scale(acc_r, 10.0), acc_r)
    one = {"x": np.ones(2, np.float32)}
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):  # eager, bind, bound
            exe.run(main, feed=one)
        buf = scope.find_var("acc")
        assert buf.tolist() == [3.0, 3.0]
        exe.run(reset)  # another program commits a new tensor: 30
        assert scope.find_var("acc") is not buf
        exe.run(main, feed=one)
        assert scope.find_var("acc") is buf and buf.tolist() == [31.0, 31.0]
        exe.run(main, feed=one, use_program_cache=False)  # eager: 32
        exe.run(main, feed=one)
        assert scope.find_var("acc") is buf and buf.tolist() == [33.0, 33.0]
        scope.set("acc", np.full(2, 5.0, np.float32))  # the caller's value
        exe.run(main, feed=one)
        assert scope.find_var("acc") is buf and buf.tolist() == [6.0, 6.0]
        # another feed shape is another runner, whose first call runs
        # eagerly; an op that fails is named
        with pytest.raises(RuntimeError, match="in op 0 .elementwise_add."):
            exe.run(main, feed={"x": np.ones(3, np.float32)})


def test_fetches_are_copies_the_next_run_leaves_alone():
    main, startup, model = _train()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        outs = [exe.run(main, feed=_feed(0, 0.1), fetch_list=[
            model["loss"], "src_emb.w"], return_numpy=False)
            for _ in range(4)]
    # a fetched parameter is a copy, not the Scope's buffer
    assert not torch.equal(outs[2][1], outs[3][1])
    assert len({float(o[0]) for o in outs}) == 4


def test_run_steps_rotation_matches_the_jax_package():
    """run_steps(5) over two feeds, dropout 0, SGD, from the JAX package's
    initial weights: the last loss and the parameters within atol 1e-5 of
    the JAX package's run_steps (one compiled window there, a step runner
    here). SGD, as tests/test_torch_train.py holds five steps: Adam moves
    a near-zero gradient element's update by up to its learning rate on
    f32 summation-order noise."""
    pmain, pstart, pm = _build(pfluid, PT, punique, 0.0, sgd=True)
    tmain, tstart, tm = _build(tfluid, TT, tunique, 0.0, sgd=True)
    feeds = [_feed(0), _feed(1)]
    pscope, tscope = pfluid.Scope(), tfluid.Scope()
    pexe = pfluid.Executor(pfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with pfluid.scope_guard(pscope):
        pexe.run(pstart)
    with tfluid.scope_guard(tscope):
        texe.run(tstart)
    names = [p.name for p in tmain.all_parameters()]
    for n in names:
        tscope.set(n, np.array(pscope.find_var(n)))
    with pfluid.scope_guard(pscope):
        (jl,) = pexe.run_steps(pmain, feeds, 5, [pm["loss"]])
    with tfluid.scope_guard(tscope):
        (tl,) = texe.run_steps(tmain, feeds, 5, [tm["loss"]])
    np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-5, rtol=0)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(pscope.find_var(n)),
                                   atol=1e-5, rtol=0, err_msg=n)


def test_host_rng_blocks_run_eagerly_every_call():
    """A startup program (gaussian / uniform fills from host-seeded
    generators) is never bound: every call commits fresh tensors, drawn
    from that step's seed."""
    main, startup, _ = _train()
    exe = tfluid.Executor(tfluid.CPUPlace())
    from paddle_tpu_torch.core import lowering

    lowered = lowering.lower_block(startup, 0, [], [], torch.device("cpu"))
    assert not lowered.capturable
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        firsts = []
        for _ in range(3):
            exe.run(startup)
            firsts.append(scope.find_var("src_emb.w"))
    assert firsts[0] is not firsts[1] is not firsts[2]
    assert not torch.equal(firsts[0], firsts[1])


def test_close_drops_the_runners():
    main, out, mask = _dropout_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    x = {"x": np.zeros((6, 50), np.float32)}
    with tfluid.scope_guard(tfluid.Scope()):
        for _ in range(2):
            exe.run(main, feed=x, fetch_list=[out])
        assert exe._runners and exe._cache
        exe.close()
        assert not exe._runners and not exe._cache
        exe.run(main, feed=x, fetch_list=[out])
