"""Saving and loading a Scope's variables, and weights carried across
from the JAX package.

The file format is the JAX package's (``paddle_tpu/io.py``): one
``__params__.npz`` (or ``filename``) holding one array per variable,
keyed by the variable's name. ``save_vars`` / ``save_persistables`` /
``save_params`` write it, ``load_vars`` / ``load_persistables`` /
``load_params`` read it into the current Scope on the executor's device,
and refuse a file that lacks any requested variable rather than leave
part of the state at its initialization. Both packages name variables
alike under ``unique_name.guard()``, so a file saved by either loads into
the other. A bf16 tensor is written as the JAX package writes one (numpy
holds it as 2-byte void elements, the bf16 bits) and read back into a
bf16 tensor.

``save_inference_model`` exports the JAX package's ``__model__`` format:
the program pruned to what the fetches need from the feeds
(``clone(for_test=True)`` first), its ``ProgramDesc`` bytes in
``__model__``, the feed and fetch names in ``__meta__.json`` and the
persistables the pruned program reads in ``__params__.npz``; either
package's ``load_inference_model`` reads what the other wrote. The
export is staged in ``<dirname>.tmp``, every file fsynced, and published
by rename; an earlier export is parked at ``<dirname>.old.tmp`` during
the swap, and the next save or load recovers a parked copy that a crash
left behind.

``scope_from_numpy`` builds a Scope from a JAX-package scope's arrays
(``{n: np.asarray(scope.find_var(n))}``); ``scope_from_params_file``
reads a saved file into a new Scope. Optimizer state moves by
(parameter, kind) where var names differ between builds:
``rekey_optimizer_state`` maps them through both optimizers'
``slot_descriptor()``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch.core.lowering import GATE, as_tensor
from paddle_tpu_torch.executor import Scope, global_scope
from paddle_tpu_torch.framework import (
    Program,
    Variable,
    default_main_program,
    resolve_device,
)

# the JAX package's file names (paddle_tpu/io.py)
PARAMS_FILE = "__params__.npz"
_MODEL_FILE = "__model__"
_META_FILE = "__meta__.json"
# how numpy holds a bf16 array it has no dtype for: 2-byte void elements
_BF16_VOID = np.dtype("V2")

# chaos hook (faults.py): an export torn between the model and parameter
# writes must publish nothing
_F_EXPORT = _faults.site("io.export")


def _to_numpy(value) -> np.ndarray:
    """A scope value on the host, bf16 as its bits in 2-byte voids."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    t = value.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_VOID)
    return t.numpy()


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A saved array as a tensor on ``device`` (2-byte voids as bf16);
    the copy to the card holds the capture gate shared."""
    arr = np.asarray(arr)
    with GATE.shared():
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).to(device)
        return as_tensor(arr, device)


def _is_persistable(var) -> bool:
    return bool(var.persistable)


def _is_parameter(var) -> bool:
    return bool(getattr(var, "is_parameter", False))


def _collect(program, predicate):
    return [v for v in program.list_vars() if predicate(v)]


def save_vars(executor, dirname: str, main_program=None,
              vars: Optional[Sequence] = None, predicate=None,
              filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> None:
    """Write ``vars`` (or the program's vars that ``predicate`` selects,
    the persistable ones when None) from ``scope`` (the current one when
    None) to ``dirname/filename`` (``__params__.npz`` when None). The
    device is synchronized once, so every queued step has written its
    state, and each tensor is then copied to the host once."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = _collect(program, predicate or _is_persistable)
    os.makedirs(dirname, exist_ok=True)
    values, missing = {}, []
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            missing.append(v.name)
            continue
        values[v.name] = val
    if missing:
        raise RuntimeError(
            f"save_vars: {len(missing)} requested variables are not "
            f"initialized in the scope (e.g. {missing[:5]}); run the "
            f"startup program first")
    with GATE.shared():  # a synchronize: never during a capture
        if executor.device.type == "cuda":
            torch.cuda.synchronize(executor.device)
        arrays = {n: _to_numpy(val) for n, val in values.items()}
    np.savez(os.path.join(dirname, filename or PARAMS_FILE), **arrays)


def load_vars(executor, dirname: str, main_program=None,
              vars: Optional[Sequence] = None, predicate=None,
              filename: Optional[str] = None,
              scope: Optional[Scope] = None) -> None:
    """Read ``vars`` (or the program's vars that ``predicate`` selects,
    the persistable ones when None) from ``dirname/filename`` into
    ``scope`` (the current one when None), as tensors on ``executor``'s
    device. Raises, and loads nothing, when the file lacks any of them."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = _collect(program, predicate or _is_persistable)
    vars = list(vars)
    path = os.path.join(dirname, filename or PARAMS_FILE)
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as data:
        names = set(data.files)
        missing = [v.name for v in vars if v.name not in names]
        if missing:
            raise RuntimeError(
                f"checkpoint '{path}' is missing {len(missing)} of "
                f"{len(vars)} requested variables (e.g. {missing[:5]}); "
                f"refusing to partially load")
        for v in vars:
            scope.set(v.name, _to_tensor(data[v.name], executor.device))


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Every persistable var of the program: parameters and optimizer,
    learning-rate and loss-scaling state (reference: io.py:462)."""
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    """(reference: io.py:698)"""
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def load_params(executor, dirname, main_program=None, filename=None):
    """The parameters of ``main_program`` (the default main program when
    None) from ``dirname/filename`` into the current scope."""
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def _fsync_file(path: str):
    """Flush an already-written file's data to disk."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    """Durably record a rename or create in its directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse a directory fsync
    finally:
        os.close(fd)


def _prune_for_inference(program: Program, feeded_var_names, target_vars):
    """The program's test clone keeping only the ops the targets need
    from the feeds."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = {v.name if isinstance(v, Variable) else str(v)
              for v in target_vars}
    feeds = set(feeded_var_names)
    keep = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if any(n in needed for n in op.output_arg_names):
            keep.append(idx)
            needed.update(n for n in op.input_arg_names if n not in feeds)
    keep.reverse()
    block.ops = [block.ops[i] for i in keep]
    pruned._bump_version()
    return pruned


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence, executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         export_for_deployment: bool = True) -> List[str]:
    """Export the pruned program, the feed / fetch names and the
    persistables of the current Scope to ``dirname`` (reference:
    io.py:903); returns the fetch names. The export owns ``dirname``:
    re-exporting replaces the whole directory. It is staged in
    ``<dirname>.tmp`` and published by rename once every file is on
    disk, so a crash leaves the previous complete export (perhaps parked
    at ``<dirname>.old.tmp``, which the next save or load restores) or
    none. ``export_for_deployment`` is taken for the JAX package's
    signature and changes nothing, as there."""
    # The JAX package's "io.export" fault site sits between the model and
    # the parameter writes; the port has no faults plane yet.
    program = main_program or default_main_program()
    pruned = _prune_for_inference(program, feeded_var_names, target_vars)
    base = dirname.rstrip("/\\")
    stage, old = base + ".tmp", base + ".old.tmp"
    if not os.path.isdir(dirname) and os.path.isdir(old):
        # an earlier export crashed between the two publish renames:
        # bring the complete old export back before replacing it
        try:
            os.rename(old, dirname)
        except OSError:
            pass  # a concurrent recoverer won the rename
    if os.path.isdir(stage):  # what an earlier crashed export left
        shutil.rmtree(stage)
    os.makedirs(stage)
    with open(os.path.join(stage, model_filename or _MODEL_FILE), "wb") as f:
        f.write(pruned.desc_str())
    meta = {
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name if isinstance(v, Variable) else str(v)
                        for v in target_vars],
    }
    with open(os.path.join(stage, _META_FILE), "w") as f:
        json.dump(meta, f)
    # the model-written / parameters-missing window (the path lets a
    # truncate plan tear the staged __model__)
    _F_EXPORT.hit(path=os.path.join(stage, model_filename or _MODEL_FILE))
    save_persistables(executor, stage, pruned, filename=params_filename)
    # durable before published: a rename can reach the disk before the
    # staged files' data does
    for fn in os.listdir(stage):
        _fsync_file(os.path.join(stage, fn))
    # publish: swap the staged dir in (atomic when dirname is absent; an
    # existing export is parked first, then dropped). Tried twice: a
    # concurrent loader's recovery can recreate dirname between the two
    # renames, and the new export must win.
    for attempt in range(2):
        if os.path.isdir(dirname):
            shutil.rmtree(old, ignore_errors=True)
            os.rename(dirname, old)
        try:
            os.rename(stage, dirname)
            break
        except OSError:
            if attempt:
                raise
    _fsync_dir(os.path.dirname(base) or ".")
    shutil.rmtree(old, ignore_errors=True)
    return meta["fetch_names"]


def load_inference_model(dirname: str, executor,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """(reference: io.py:1083) -> (program, feed_names, fetch_vars), the
    persistables loaded into the current Scope on ``executor``'s device.
    Recovers an export that a crash in ``save_inference_model``'s swap
    left parked at ``<dirname>.old.tmp``."""
    base = dirname.rstrip("/\\")
    if not os.path.isdir(dirname) and os.path.isdir(base + ".old.tmp"):
        # a live exporter's swap passes through this state for a few
        # microseconds: wait a beat before taking the parked copy for a
        # crash's leftover
        time.sleep(0.05)
        if not os.path.isdir(dirname):
            try:
                os.rename(base + ".old.tmp", dirname)
            except OSError:
                pass  # a concurrent loader or exporter recovered it
    with open(os.path.join(dirname, model_filename or _MODEL_FILE),
              "rb") as f:
        program = Program.parse_from_string(f.read())
    with open(os.path.join(dirname, _META_FILE)) as f:
        meta = json.load(f)
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def scope_from_numpy(params: Dict[str, np.ndarray], place=None) -> Scope:
    """A Scope holding ``params`` as tensors on ``place``'s device
    (``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``)."""
    device = resolve_device(place)
    scope = Scope()
    for name, arr in params.items():
        scope.set(name, _to_tensor(arr, device))
    return scope


def scope_from_params_file(dirname: str, place=None) -> Scope:
    """Read every array of ``dirname/__params__.npz`` into a new Scope on
    ``place``'s device (the ServingEngine's weights)."""
    with np.load(os.path.join(dirname, PARAMS_FILE)) as data:
        return scope_from_numpy({n: data[n] for n in data.files}, place)


def rekey_optimizer_state(values: Mapping[str, np.ndarray],
                          saved_slots: Mapping[str, dict],
                          target_slots: Mapping[str, dict]
                          ) -> Dict[str, np.ndarray]:
    """Re-key optimizer slot state from the saving optimizer's var names
    (``saved_slots``: its ``slot_descriptor()``) onto the restoring
    optimizer's (``target_slots``), joined on (param, kind). Entries that
    are not slots (parameters) pass through by name; a saved slot with no
    target is dropped, and a target slot with no saved value is left to
    the restoring startup program. Returns a new dict."""
    by_key = {(d["param"], d["slot"]): name
              for name, d in saved_slots.items()}
    out = {n: v for n, v in values.items() if n not in saved_slots}
    for tname, d in target_slots.items():
        sname = by_key.get((d["param"], d["slot"]))
        if sname is not None and sname in values:
            out[tname] = values[sname]
    return out
