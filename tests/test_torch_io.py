"""Saving and loading a Scope's variables (``io.py``) against the JAX
package, on the CPU.

Both packages build the same program under ``unique_name.guard()`` (a
one-layer Transformer, d_model 32, dropout 0, trained by Momentum; and an
``fc`` net trained by AdamW through ``amp.decorate`` with dynamic loss
scaling, bf16 turned off again so both run in f32), so their
persistables have the same names: a ``__params__.npz`` that either
package saves loads into the other by name. Tolerances: the load gives
the saved values bit for bit; one more step in each package then gives
the same loss within 1e-6 relative and the same state within 1e-6 of
max(1, each variable's largest |element|) (the two frameworks sum in
different orders; the Transformer's cross-attention key biases have a
gradient of 0 up to that noise, which Adam would scale up to its
learning rate, hence Momentum there); a round trip inside the port is
bit-exact, bf16 included.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as pfluid
from paddle_tpu import amp as pamp
from paddle_tpu import io as pio
from paddle_tpu import unique_name as punique
from paddle_tpu.models import transformer as PT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import unique_name as tunique
from paddle_tpu_torch.models import transformer as TT

_PKGS = {"jax": (pfluid, pamp, pio, punique, PT),
         "torch": (tfluid, tamp, tio, tunique, TT)}
_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=32,
            d_inner=64, n_head=2, n_layer=1, dropout=0.0,
            label_smooth_eps=0.1)
_X = np.random.RandomState(0).randn(8, 6).astype(np.float32)
_Y = np.random.RandomState(1).randint(0, 3, (8, 1)).astype(np.int64)


def _transformer(fluid, amp, T):
    loss = T.build(T.TransformerConfig(**_CFG))["loss"]
    fluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return loss


def _fc_recipe(fluid, amp, T):
    layers = fluid.layers
    x = layers.data("x", shape=[6], dtype="float32")
    y = layers.data("y", shape=[1], dtype="int64")
    loss = layers.mean(layers.softmax_with_cross_entropy(
        layers.fc(layers.fc(x, 8, act="relu"), 3), y))
    amp.decorate(fluid.optimizer.AdamW(0.01), init_loss_scaling=8.0,
                 use_dynamic_loss_scaling=True,
                 incr_every_n_steps=1).minimize(loss)
    amp.disable_amp()
    return loss


_NETS = {
    "transformer": (_transformer, lambda: PT.make_batch(
        PT.TransformerConfig(**_CFG), 3, 10, 7, seed=4)),
    "fc, decorate(AdamW)": (_fc_recipe, lambda: {"x": _X, "y": _Y}),
}


class _Run:
    """``net`` built in package ``pkg`` (its program, scope, executor)."""

    def __init__(self, pkg, net):
        fluid, amp, self.io, unique, T = _PKGS[pkg]
        self.fluid = fluid
        self.main, startup = fluid.Program(), fluid.Program()
        with unique.guard(), fluid.program_guard(self.main, startup):
            self.loss = _NETS[net][0](fluid, amp, T)
        self.names = sorted(v.name for v in self.main.list_vars()
                            if v.persistable)
        self.scope = fluid.Scope()
        self.exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(self.scope):
            self.exe.run(startup)

    def step(self, feed):
        with self.fluid.scope_guard(self.scope):
            (loss,) = self.exe.run(self.main, feed=feed,
                                   fetch_list=[self.loss])
        return np.asarray(loss)

    def save(self, dirname):
        with self.fluid.scope_guard(self.scope):
            self.io.save_persistables(self.exe, dirname, self.main)

    def load(self, dirname):
        with self.fluid.scope_guard(self.scope):
            self.io.load_persistables(self.exe, dirname, self.main)

    def state(self):
        return {n: np.array(self.scope.find_var(n)) for n in self.names}


def _err(got, want, floor=1e-30):
    """max |got - want| over max(floor, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


@pytest.mark.parametrize("net", sorted(_NETS))
@pytest.mark.parametrize("saver,loader", [("jax", "torch"),
                                          ("torch", "jax")])
def test_save_in_one_package_load_in_the_other(tmp_path, net, saver,
                                               loader):
    """The saver takes two steps and saves its persistables; the loader,
    fresh from its own startup, loads them; then each takes the same
    third step: the same loss and state (tolerances above). The file
    holds exactly the program's persistables, under the same names in
    both packages."""
    src, dst = _Run(saver, net), _Run(loader, net)
    assert src.names == dst.names
    feed = _NETS[net][1]()
    for _ in range(2):
        src.step(feed)
    src.save(str(tmp_path))
    with np.load(tmp_path / "__params__.npz") as data:
        assert sorted(data.files) == src.names
    dst.load(str(tmp_path))
    for n, v in src.state().items():
        np.testing.assert_array_equal(dst.state()[n], v, err_msg=n)
    want, got = src.step(feed), dst.step(feed)
    assert _err(got, want) <= 1e-6, (got, want)
    after, theirs = dst.state(), src.state()
    for n in src.names:
        assert _err(after[n], theirs[n], floor=1.0) <= 1e-6, n


def test_a_file_missing_a_variable_is_refused(tmp_path):
    """load_persistables refuses a file without one of the program's
    persistables, as the JAX package's does, and loads none of the
    others (here all set to 7 in the file)."""
    run = _Run("torch", "fc, decorate(AdamW)")
    run.save(str(tmp_path))
    path = tmp_path / "__params__.npz"
    with np.load(path) as data:
        kept = {n: np.full_like(data[n], 7) for n in data.files[1:]}
    np.savez(path, **kept)
    before = run.state()
    for fluid, io, r in ((pfluid, pio, _Run("jax", "fc, decorate(AdamW)")),
                         (tfluid, tio, run)):
        with fluid.scope_guard(r.scope):
            with pytest.raises(RuntimeError, match="refusing to partially"):
                io.load_persistables(r.exe, str(tmp_path), r.main)
    for n, v in run.state().items():
        np.testing.assert_array_equal(v, before[n], err_msg=n)


def test_params_and_vars_round_trip_bit_exact(tmp_path):
    """save_params writes the parameters alone and load_params reads them
    back; save_vars / load_vars take an explicit list and a file name;
    every value comes back bit for bit."""
    run = _Run("torch", "fc, decorate(AdamW)")
    run.step({"x": _X, "y": _Y})
    params = [p.name for p in run.main.all_parameters()]
    saved = run.state()
    with tfluid.scope_guard(run.scope):
        tio.save_params(run.exe, str(tmp_path / "p"), run.main)
        scale = run.main.global_block().var(
            run.main._amp_scale_vars[0])
        tio.save_vars(run.exe, str(tmp_path / "v"), run.main, vars=[scale],
                      filename="scale.npz")
    with np.load(tmp_path / "p" / "__params__.npz") as data:
        assert sorted(data.files) == sorted(params)
    fresh = _Run("torch", "fc, decorate(AdamW)")
    with tfluid.scope_guard(fresh.scope):
        tio.load_params(fresh.exe, str(tmp_path / "p"), fresh.main)
        tio.load_vars(fresh.exe, str(tmp_path / "v"), fresh.main,
                      vars=[scale], filename="scale")
    got = fresh.state()
    for n in params + [scale.name]:
        np.testing.assert_array_equal(got[n], saved[n], err_msg=n)
    assert got[scale.name][0] == 16.0  # grown once from 8


def _bf16_program(fluid, unique):
    main, startup = fluid.Program(), fluid.Program()
    with unique.guard(), fluid.program_guard(main, startup):
        fluid.layers.create_global_var([5], 1.1, "bfloat16",
                                       persistable=True, name="bf16_state")
    return main, startup


def test_bf16_is_saved_as_the_jax_package_saves_it(tmp_path):
    """A bf16 persistable: the JAX package's file holds its bits as 2-byte
    numpy voids (numpy has no bf16); the port writes the same bits the
    same way, reads the JAX package's file into a bf16 tensor with the
    JAX package's bits, and reads its own back bit for bit."""
    files = {}
    for pkg in ("jax", "torch"):
        fluid, _, io, unique, _ = _PKGS[pkg]
        main, startup = _bf16_program(fluid, unique)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            io.save_persistables(exe, str(tmp_path / pkg), main)
        files[pkg] = str(tmp_path / pkg)
        with np.load(os.path.join(files[pkg], "__params__.npz")) as data:
            arr = data["bf16_state"]
            assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2, \
                arr.dtype
            bits = arr.view(np.uint16)
        if pkg == "jax":
            jax_bits = bits
    np.testing.assert_array_equal(bits, jax_bits)
    with zipfile.ZipFile(os.path.join(files["torch"], "__params__.npz")) \
            as z:
        assert z.namelist() == ["bf16_state.npy"]
    main, _ = _bf16_program(tfluid, tunique)
    for pkg in ("jax", "torch"):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            tio.load_persistables(exe, files[pkg], main)
        t = scope.find_var("bf16_state")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16), jax_bits)
