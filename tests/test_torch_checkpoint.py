"""The port's checkpoints (paddle_tpu_torch/parallel/checkpoint.py) against
the JAX package's, on the CPU: the manifest-v2 files cross between the
packages both ways, and the port keeps the crash-consistent commit
protocol.

Tolerance: none. Every value crosses bit for bit (f32, int64, bf16 as its
bits), a sharded JAX save over the 8 virtual CPU devices included.
"""

import json
import os
import zipfile

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as pfluid
from paddle_tpu import faults as pfaults
from paddle_tpu.parallel import checkpoint as pck

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import faults as tfaults
from paddle_tpu_torch.parallel import checkpoint as tck


@pytest.fixture(autouse=True)
def _disarm():
    tfaults.disarm()
    pfaults.disarm()
    yield
    tfaults.disarm()
    pfaults.disarm()


def _bits(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" or str(
            a.dtype) == "bfloat16":
        return a.view(np.uint16)
    return a


def _values(seed=0):
    r = np.random.RandomState(seed)
    return {"w": r.randn(8, 16).astype(np.float32),
            "b": r.randn(16).astype(np.float32),
            "step": np.array([7], np.int64),
            "emb/table": r.randn(4, 8).astype(np.float32)}


def test_jax_save_loads_in_the_port_bit_equal(tmp_path):
    vals = _values()
    bf = np.random.RandomState(3).randn(6, 4).astype(ml_dtypes.bfloat16)
    pck.save_checkpoint(str(tmp_path), {**vals, "h": bf}, step=3)
    step, got = tck.load_latest(str(tmp_path))
    assert step == 3 and sorted(got) == sorted([*vals, "h"])
    for n, v in vals.items():
        assert got[n].dtype == v.dtype
        np.testing.assert_array_equal(got[n], v, err_msg=n)
    np.testing.assert_array_equal(_bits(got["h"]), _bits(bf))
    # as a Scope value, the bf16 entry is a bf16 tensor with those bits
    t = tck.scope_value(got["h"])
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(
        np.uint16), _bits(bf))
    assert tck.validate_checkpoint(str(tmp_path), 3)


def test_sharded_jax_save_on_eight_devices_loads_whole(tmp_path):
    """A JAX save over a 2x4 mesh of the 8 virtual CPU devices writes
    ``"sharded": true`` entries; the port puts each value back together
    from its shards' index ranges."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    w = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    b = np.random.RandomState(1).randn(16).astype(np.float32)
    e = np.random.RandomState(2).randn(8, 4).astype(ml_dtypes.bfloat16)
    state = {"w": jax.device_put(w, NamedSharding(mesh, P(None, "model"))),
             "b": jax.device_put(b, NamedSharding(mesh, P("model"))),
             "e": jax.device_put(e, NamedSharding(mesh, P("data")))}
    pck.save_checkpoint(str(tmp_path), state, step=1)
    with open(tmp_path / "checkpoint_1" / "manifest.json.0") as f:
        man = json.load(f)
    assert man["w"]["sharded"] and len(man["w"]["shards"]) == 4
    got = tck.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(got["w"], w)
    np.testing.assert_array_equal(got["b"], b)
    np.testing.assert_array_equal(_bits(got["e"]), _bits(e))
    assert tck.validate_checkpoint(str(tmp_path), 1)
    # re-placing over a mesh waits for the port's parallel modules
    with pytest.raises(NotImplementedError, match="item 9"):
        tck.load_checkpoint(str(tmp_path), shardings={"w": object()})


def test_port_save_passes_jax_validation_and_loads_bit_equal(tmp_path):
    vals = _values(1)
    bf = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    state = {**vals, "t": torch.from_numpy(vals["w"] * 2), "h": bf}
    tck.save_checkpoint(str(tmp_path), state, step=4,
                        slots={"w": {"param": "p", "slot": "moment1"}})
    assert pck.validate_checkpoint(str(tmp_path), 4)
    assert pck.latest_step(str(tmp_path)) == 4
    got = pck.load_checkpoint(str(tmp_path))
    for n, v in vals.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)
    np.testing.assert_array_equal(got["t"], vals["w"] * 2)
    np.testing.assert_array_equal(
        _bits(got["h"]), bf.view(torch.int16).numpy().view(np.uint16))
    assert pck.manifest_slots(str(tmp_path), 4) == {
        "w": {"param": "p", "slot": "moment1"}}
    with open(tmp_path / "checkpoint_4" / "manifest.json.0") as f:
        man = json.load(f)
    assert man["h"]["dtype"] == "bfloat16"
    assert all(e["sharded"] is False and e["sharding"] is None
               for e in man.values())


def test_same_state_writes_the_same_manifest(tmp_path):
    """Byte-compatible manifests: the same host values give the same
    manifest JSON, COMMIT and shard keys in both packages."""
    vals = _values(2)
    pck.save_checkpoint(str(tmp_path / "jax"), vals, step=1,
                        slots={"b": {"param": "w", "slot": "v"}})
    tck.save_checkpoint(str(tmp_path / "port"), vals, step=1,
                        slots={"b": {"param": "w", "slot": "v"}})
    for fn in ("manifest.json.0", "COMMIT"):
        a = (tmp_path / "jax" / "checkpoint_1" / fn).read_bytes()
        b = (tmp_path / "port" / "checkpoint_1" / fn).read_bytes()
        assert a == b, fn
    with np.load(tmp_path / "jax" / "checkpoint_1" / "shards_0.npz") as a, \
            np.load(tmp_path / "port" / "checkpoint_1" / "shards_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_reshard_optimizer_state_rekeys_as_jax():
    values = {"p.w": np.ones(2), "m1_old": np.full(2, 3.0),
              "m2_old": np.full(2, 4.0), "gone": np.zeros(1)}
    saved = {"m1_old": {"param": "p.w", "slot": "moment1"},
             "m2_old": {"param": "p.w", "slot": "moment2"},
             "gone": {"param": "q.w", "slot": "moment1"}}
    target = {"m1_new": {"param": "p.w", "slot": "moment1"},
              "m2_old": {"param": "p.w", "slot": "moment2"}}
    want = pck.reshard_optimizer_state(values, saved, target)
    got = tck.reshard_optimizer_state(values, saved, target)
    assert sorted(got) == sorted(want) == ["m1_new", "m2_old", "p.w"]
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
    with pytest.raises(NotImplementedError, match="item 9"):
        tck.reshard_optimizer_state(values, saved, target,
                                    shardings={"m1_new": object()})


@pytest.mark.parametrize("site", ["ckpt.write_shards", "ckpt.commit"])
@pytest.mark.parametrize("async_save", [False, True])
def test_torn_save_leaves_the_previous_serial(tmp_path, site, async_save):
    first, second = _values(0), _values(5)
    tck.save_checkpoint(str(tmp_path), first, step=1)
    tfaults.arm(f"{site}:raise@1")
    with pytest.raises(tfaults.InjectedFault):
        h = tck.save_checkpoint(str(tmp_path), second, step=2,
                                async_save=async_save)
        if h is not None:
            h.wait()
    tfaults.disarm()
    assert (tmp_path / "checkpoint_2.tmp").exists()
    assert tck.available_steps(str(tmp_path)) == [1]
    assert tck.latest_step(str(tmp_path)) == 1
    assert (tmp_path / "latest").read_text() == "1"
    assert tck.validate_checkpoint(str(tmp_path), 1)
    got = tck.load_checkpoint(str(tmp_path))
    for n, v in first.items():
        np.testing.assert_array_equal(got[n], v)
    # the next commit sweeps the torn staging dir of an older serial
    tck.save_checkpoint(str(tmp_path), second, step=3)
    assert not (tmp_path / "checkpoint_2.tmp").exists()


def test_truncated_shard_and_read_fault_fall_back(tmp_path):
    tck.save_checkpoint(str(tmp_path), _values(0), step=1)
    tfaults.arm("ckpt.write_shards:truncate(20)@1")
    tck.save_checkpoint(str(tmp_path), _values(1), step=2)
    tfaults.disarm()
    # committed, but torn: validation and resume skip it
    assert tck.available_steps(str(tmp_path)) == [1, 2]
    assert not tck.validate_checkpoint(str(tmp_path), 2)
    assert tck.latest_step(str(tmp_path)) == 1
    assert tck.load_latest(str(tmp_path))[0] == 1
    # every read torn: nothing loads (the JAX package's rule)
    tfaults.arm("ckpt.read:raise@p1")
    assert tck.load_latest(str(tmp_path)) is None
    tfaults.disarm()
    # an explicit load of the torn serial raises, as in the JAX package
    with pytest.raises(zipfile.BadZipFile):
        pck.load_checkpoint(str(tmp_path), step=2)
    with pytest.raises(zipfile.BadZipFile):
        tck.load_checkpoint(str(tmp_path), step=2)


def test_foreign_and_empty_dirs_are_tolerated(tmp_path):
    tck.save_checkpoint(str(tmp_path), _values(0), step=1)
    os.makedirs(tmp_path / "checkpoint_9")          # empty, newest
    os.makedirs(tmp_path / "checkpoint_best")       # foreign name
    (tmp_path / "notes.txt").write_text("x")
    assert tck.available_steps(str(tmp_path)) == [1, 9]
    assert tck.latest_step(str(tmp_path)) == 1
    assert tck.load_latest(str(tmp_path))[0] == 1
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(str(tmp_path / "none"))


def test_async_snapshot_owns_its_bytes(tmp_path):
    """The caller may write the state in place as soon as an async save
    returns (as a captured step does): the payload is the snapshot."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    want = t.clone().numpy()
    h = tck.save_checkpoint(str(tmp_path), {"t": t}, step=1,
                            async_save=True)
    t.add_(100.0)
    h.wait()
    assert h.write_s is not None and h.write_s >= 0
    np.testing.assert_array_equal(tck.load_checkpoint(str(tmp_path))["t"],
                                  want)


def test_save_and_restore_scope_round_trip(tmp_path):
    scope = tfluid.Scope()
    scope.set("a", torch.arange(4, dtype=torch.float32))
    scope.set("b", torch.ones(2, dtype=torch.bfloat16) * 1.5)
    scope.set("c", np.array([3], np.int64))
    tck.save_scope(str(tmp_path), scope, step=2)
    other = tfluid.Scope()
    names = tck.restore_scope(str(tmp_path), other)
    assert sorted(names) == ["a", "b", "c"]
    np.testing.assert_array_equal(np.asarray(other.find_var("a")),
                                  np.arange(4, dtype=np.float32))
    assert other.find_var("b").dtype == torch.bfloat16
    assert torch.equal(other.find_var("b"), scope.find_var("b"))
    np.testing.assert_array_equal(other.find_var("c"), [3])


def test_fleet_and_mesh_features_wait_for_item_9(tmp_path):
    with pytest.raises(NotImplementedError, match="item 9"):
        tck.FleetCommitCoordinator()
    with pytest.raises(NotImplementedError, match="item 9"):
        tck.save_checkpoint(str(tmp_path), _values(), step=1,
                            coordinator=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        tck.restore_scope(str(tmp_path), tfluid.Scope(),
                          shardings={"w": object()})


def test_every_site_is_declared_and_wired():
    for s in ("ckpt.write_shards", "ckpt.commit", "ckpt.read"):
        assert s in tfaults.BUILTIN_SITES
        assert s not in tfaults.UNWIRED_SITES
    assert pfluid is not None
