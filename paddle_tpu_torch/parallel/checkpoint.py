"""Crash-consistent, optionally-async checkpoints in the JAX package's
format (manifest v2), on one process.

The JAX package's module writes each process's addressable shards of its
sharded arrays plus a manifest fragment (``paddle_tpu/parallel/
checkpoint.py``); this port writes the same files, so a checkpoint
written by either package restores in the other:

- **saving** writes every value whole: ``"sharded": false`` entries
  with ``"sharding": null``, in one ``shards_0.npz`` and one
  ``manifest.json.0``. bf16 is written as the JAX package writes it,
  2-byte void elements holding the bf16 bits, with ``"dtype":
  "bfloat16"`` in the manifest;
- **loading** also reads ``"sharded": true`` entries: a JAX checkpoint
  saved over a device mesh is put back together in numpy from its shard
  index ranges (a partial file subset is accepted where the shards
  present still cover every element, as in the JAX package) and handed
  over whole; the caller places it on its one device. Loaded values are
  numpy arrays, bf16 as 2-byte voids (``scope_value`` turns one into a
  bf16 tensor);
- **async save** (``async_save=True``) issues every device-to-host copy
  into pinned host memory with ``non_blocking=True`` in the caller's
  thread, under the capture gate, synchronizes once and returns: the
  captured step writes the state tensors in place (core/lowering.py), so
  no device tensor may be read after ``save_checkpoint`` returns. The
  checksums, serialization and commit run on a background thread that
  makes no CUDA call; the pinned snapshot belongs to that save until its
  commit ends. The caller-blocking part is timed into
  ``pt_ckpt_snapshot_seconds``.

Crash-consistent commit protocol (the orbax commit-marker pattern)::

    write  checkpoint_<N>.tmp/shards_<pid>.npz      (fsync)
    write  checkpoint_<N>.tmp/manifest.json.<pid>   (fsync)
    write  checkpoint_<N>.tmp/COMMIT                (fsync)
    rename checkpoint_<N>.tmp -> checkpoint_<N>     (atomic publish)
    write  latest.tmp; rename -> latest             (atomic pointer)

A crash at any point leaves either a ``.tmp`` staging dir (ignored by
``available_steps`` / ``latest_step``, swept by a later commit) or a
fully committed serial. ``validate_checkpoint`` proves a serial's
integrity (COMMIT marker, coverage of every array by the shards present,
crc32 match) and ``latest_step`` / ``load_latest`` skip invalid serials,
counting them into ``pt_ckpt_invalid_skipped_total``.

A multi-process commit (the JAX package's ``FleetCommitCoordinator``)
and re-sharding onto a mesh wait for the port's parallel modules
(ROADMAP.md Queue 1, item 9): they raise ``NotImplementedError``.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import threading
import time as _time
import warnings
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch.core.lowering import GATE

_MANIFEST = "manifest.json"
_LATEST = "latest"
_COMMIT = "COMMIT"
_STAGING_SUFFIX = ".tmp"
_FORMAT = 2
# how numpy holds a bf16 array it has no dtype for: 2-byte void elements
_BF16_VOID = np.dtype("V2")
_ITEM_9 = "the port's parallel modules (ROADMAP.md Queue 1, item 9)"

_M_COMMIT_S = _monitor.histogram(
    "pt_ckpt_commit_seconds",
    "checkpoint commit-protocol duration (multi-host ack collection + "
    "COMMIT marker -> published latest pointer)")
_M_SNAPSHOT_S = _monitor.histogram(
    "pt_ckpt_snapshot_seconds",
    "device->host checkpoint snapshot duration (all copies issued "
    "asynchronously up front, then materialized)")
_M_INVALID_SKIPS = _monitor.counter(
    "pt_ckpt_invalid_skipped_total",
    "uncommitted/corrupt checkpoint serials skipped while resolving the "
    "newest valid one")
_M_ASYNC_ERRS = _monitor.counter(
    "pt_ckpt_async_errors_total",
    "background checkpoint-save failures surfaced outside wait()")
_M_PARTIAL = _monitor.counter(
    "pt_ckpt_partial_restores_total",
    "arrays reassembled from a partial shard-file subset whose surviving "
    "shards still covered every element")
_M_SLOT_REKEYS = _monitor.counter(
    "pt_ckpt_slot_rekeys_total",
    "optimizer slot-state entries re-keyed onto a differently-built "
    "restoring program's slot names via the manifest's (param, kind) "
    "descriptors (reshard_optimizer_state)")

_F_WRITE = _faults.site("ckpt.write_shards")
_F_COMMIT = _faults.site("ckpt.commit")
_F_READ = _faults.site("ckpt.read")


def _fsync_dir(path: str):
    """Durably record a rename/create in its parent directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; rename is still atomic
    finally:
        os.close(fd)


def _checksum(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _np_dtype(name: str) -> np.dtype:
    """A manifest dtype name as the numpy dtype its payload has."""
    return _BF16_VOID if name == "bfloat16" else np.dtype(name)


def _fkey_file(fkey: str) -> str:
    """Shard file that holds a manifest shard key (``name::pid::i``)."""
    try:
        pid = fkey.rsplit("::", 2)[1]
        return f"shards_{pid}.npz"
    except IndexError:
        return "shards_0.npz"


def scope_value(arr):
    """A loaded array as a Scope value: bf16 (2-byte voids) as a bf16
    CPU tensor, anything else as it is (the executor moves it to its
    device on first use)."""
    arr = np.asarray(arr)
    if arr.dtype == _BF16_VOID:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


class FleetCommitCoordinator:
    """The JAX package's multi-process commit barrier over the fleet KV
    store. The port has no fleet yet."""

    def __init__(self, fleet=None, timeout_ms: Optional[int] = None):
        raise NotImplementedError(
            f"FleetCommitCoordinator needs {_ITEM_9}")


# ---------------------------------------------------------------------------
# async handles: a failed background save must never vanish
# ---------------------------------------------------------------------------

_HANDLES_LOCK = threading.Lock()
_async_handles: List["_AsyncHandle"] = []


class _AsyncHandle:
    __slots__ = ("_thread", "error", "step", "_surfaced", "write_s")

    def __init__(self, step: int):
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.step = step
        self._surfaced = False
        # the background write's wall seconds, once it ended
        self.write_s: Optional[float] = None

    def done(self) -> bool:
        # ident is None until the thread starts — and is_alive() is
        # False then too, so without the ident check a reap racing the
        # handle's registration would drop it (and its eventual error)
        t = self._thread
        return t is not None and t.ident is not None and not t.is_alive()

    def wait(self):
        """Join the background write; raises its error. Idempotent —
        each call re-raises a stored error rather than losing it."""
        t = self._thread
        if t is not None:
            t.join()
        self._surfaced = True
        if self.error is not None:
            raise self.error


def _reap_async(final: bool = False):
    """Surface errors of finished handles nobody ``wait()``ed (called at
    every save and at exit, so a failed background save is loud at most
    one save later). ``final`` joins still-running writers first."""
    with _HANDLES_LOCK:
        handles = list(_async_handles)
    for h in handles:
        if final and h._thread is not None:
            h._thread.join(timeout=30.0)
        if not h.done():
            continue
        with _HANDLES_LOCK:
            if h in _async_handles:
                _async_handles.remove(h)
        if h.error is not None and not h._surfaced:
            h._surfaced = True
            _M_ASYNC_ERRS.inc()
            warnings.warn(
                f"async checkpoint save (step {h.step}) failed and was "
                f"never wait()ed: {h.error!r}", RuntimeWarning)


atexit.register(_reap_async, final=True)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def _snapshot(state: Dict[str, object], own: bool) -> Dict[str, np.ndarray]:
    """{name: host array} of ``state``: a CUDA tensor is copied into
    pinned host memory with ``non_blocking=True`` (all copies issued
    first, then one synchronize, under the capture gate); a CPU tensor or
    numpy value is copied when ``own`` (an async save must own its bytes:
    the next step writes the state tensors in place). bf16 comes back as
    2-byte voids."""
    pinned: Dict[str, torch.Tensor] = {}
    out: Dict[str, np.ndarray] = {}
    devices = set()
    cuda = [n for n, v in state.items()
            if isinstance(v, torch.Tensor) and v.is_cuda]
    if cuda:
        with GATE.shared():
            for n in cuda:
                v = state[n].detach()
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
                pinned[n] = h
                devices.add(v.device)
            for d in devices:
                torch.cuda.synchronize(d)
    for n, v in state.items():
        if n in pinned:
            t = pinned[n]
        elif isinstance(v, torch.Tensor):
            t = v.detach()
            if own:
                t = t.clone()
        else:
            a = np.asarray(v)
            out[n] = np.array(a, copy=True) if own and not a.flags.owndata \
                else a
            continue
        out[n] = (t.view(torch.int16).numpy().view(_BF16_VOID)
                  if t.dtype == torch.bfloat16 else t.numpy())
    return out


def save_checkpoint(
    dirname: str,
    state: Dict[str, object],
    step: int = 0,
    async_save: bool = False,
    coordinator="auto",
    process_index: Optional[int] = None,
    slots: Optional[Dict[str, dict]] = None,
):
    """Write ``state`` (name -> tensor or array) to
    ``dirname/checkpoint_<step>`` via the staging-dir commit protocol
    (module docstring). Every value is written whole by this process
    (``process_index`` names the shard file and manifest fragment, 0 by
    default; only writer 0 commits). ``coordinator`` is taken for the
    JAX package's signature: ``"auto"`` and None mean the single-process
    protocol, a coordinator object raises ``NotImplementedError``.
    Returns an ``_AsyncHandle`` when ``async_save`` (call ``.wait()``
    before relying on the files), else None.

    ``slots`` ({var name -> {"param": ..., "slot": ...}}, an
    ``Optimizer.slot_descriptor()``) records the optimizer slot-state
    descriptor on each covered manifest entry, so a restore into a
    differently-built program can re-key the state through
    ``reshard_optimizer_state``."""
    if coordinator not in ("auto", None):
        raise NotImplementedError(
            f"save_checkpoint(coordinator=...) commits across processes; "
            f"that needs {_ITEM_9}")
    _reap_async()
    ckpt_dir = os.path.join(dirname, f"checkpoint_{step}")
    stage_dir = ckpt_dir + _STAGING_SUFFIX
    pid = int(process_index) if process_index is not None else 0

    manifest: Dict[str, dict] = {}
    keys: Dict[str, str] = {}
    for name in state:
        key = name.replace("/", "__")
        keys[name] = key
        manifest[name] = {"sharded": False, "file_key": key,
                          "sharding": None}
        if slots and name in slots:
            manifest[name]["slot"] = dict(slots[name])

    # the snapshot IN THE CALLER'S THREAD: the next captured step writes
    # these tensors in place, so none may be read after we return
    t_snap = _time.perf_counter()
    host = _snapshot(state, own=async_save)
    payload = {keys[n]: a for n, a in host.items()}
    _M_SNAPSHOT_S.observe(_time.perf_counter() - t_snap)
    for name, entry in manifest.items():
        a = payload[entry["file_key"]]
        entry["shape"] = list(a.shape)
        entry["dtype"] = ("bfloat16" if a.dtype == _BF16_VOID
                          else str(a.dtype))

    def _write():
        # checksums are serialize-side work: under async_save they run
        # here, off-thread, over the host-resident snapshot
        for entry in manifest.values():
            entry["checksum"] = _checksum(payload[entry["file_key"]])
        target = stage_dir
        if pid != 0 and os.path.isdir(ckpt_dir):
            target = ckpt_dir
        os.makedirs(target, exist_ok=True)
        shard_path = os.path.join(target, f"shards_{pid}.npz")
        with open(shard_path, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        # chaos hook: raise here = crash after the (possibly partial)
        # shard write, before commit; truncate = torn shard file
        _F_WRITE.hit(path=shard_path)
        with open(os.path.join(target, f"{_MANIFEST}.{pid}"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if pid != 0:
            return
        t0 = _time.perf_counter()
        _F_COMMIT.hit()
        with open(os.path.join(target, _COMMIT), "w") as f:
            json.dump({"step": step, "format": _FORMAT}, f)
            f.flush()
            os.fsync(f.fileno())
        old_dir = ckpt_dir + ".old" + _STAGING_SUFFIX
        # Re-save of the same serial: park the committed old copy aside
        # instead of rmtree-before-replace — a crash in this window must
        # not lose the only copy (_recover_displaced renames it back).
        # Retried once because a concurrent reader's recovery can
        # recreate ckpt_dir between the two renames.
        for attempt in range(2):
            if os.path.isdir(ckpt_dir):
                shutil.rmtree(old_dir, ignore_errors=True)
                os.rename(ckpt_dir, old_dir)
            try:
                os.replace(stage_dir, ckpt_dir)
                break
            except OSError:
                if attempt:
                    raise
        shutil.rmtree(old_dir, ignore_errors=True)
        _fsync_dir(dirname)
        latest_tmp = os.path.join(dirname, _LATEST + _STAGING_SUFFIX)
        with open(latest_tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(dirname, _LATEST))
        _fsync_dir(dirname)
        _M_COMMIT_S.observe(_time.perf_counter() - t0)
        _sweep_stale_staging(dirname, step)

    if async_save:
        handle = _AsyncHandle(step)

        def _run():
            t0 = _time.perf_counter()
            try:
                _write()
            except BaseException as e:  # surfaced by wait() / next reap
                handle.error = e
            finally:
                handle.write_s = _time.perf_counter() - t0

        handle._thread = threading.Thread(target=_run, daemon=True,
                                          name="pt-ckpt-writer")
        with _HANDLES_LOCK:
            _async_handles.append(handle)
        handle._thread.start()
        return handle
    _write()
    return None


# ---------------------------------------------------------------------------
# discovery + validation
# ---------------------------------------------------------------------------


def _sweep_stale_staging(dirname: str, committed_step: int):
    """Garbage-collect `.tmp` staging dirs left by crashed saves of
    older serials and `.old.tmp` parked copies whose serial exists
    again. Staging dirs of in-flight async saves are left alone."""
    with _HANDLES_LOCK:
        live = {h.step for h in _async_handles if not h.done()}
    try:
        entries = os.listdir(dirname)
    except OSError:
        return
    for d in entries:
        m = re.match(r"checkpoint_(\d+)\.tmp$", d)
        if m and int(m.group(1)) < committed_step \
                and int(m.group(1)) not in live:
            shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)
            continue
        m = re.match(r"checkpoint_(\d+)\.old\.tmp$", d)
        if m and os.path.isdir(
                os.path.join(dirname, f"checkpoint_{m.group(1)}")):
            shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)


def _recover_displaced(dirname: str):
    """Crash recovery for the re-save window: a serial parked at
    ``checkpoint_<n>.old.tmp`` whose main dir is missing was displaced
    by a save that died before publishing — rename it back."""
    try:
        entries = os.listdir(dirname)
    except OSError:
        return
    for d in entries:
        m = re.match(r"checkpoint_(\d+)\.old\.tmp$", d)
        if m:
            main = os.path.join(dirname, f"checkpoint_{m.group(1)}")
            if not os.path.isdir(main):
                try:
                    os.rename(os.path.join(dirname, d), main)
                except OSError:
                    pass


def _pointer_step(dirname: str) -> Optional[int]:
    try:
        with open(os.path.join(dirname, _LATEST)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def available_steps(dirname: str) -> List[int]:
    out = []
    try:
        for d in os.listdir(dirname):
            m = re.match(r"checkpoint_(\d+)$", d)  # excludes .tmp staging
            if m:
                out.append(int(m.group(1)))
    except OSError:
        pass
    return sorted(out)


def validate_checkpoint(dirname: str, step: int,
                        verify_checksums: bool = True) -> bool:
    """True iff ``checkpoint_<step>`` is committed and internally
    consistent: COMMIT marker present and parseable (or a markerless
    pre-protocol dir that is structurally complete, as the JAX package
    accepts), manifest fragments parse, the shards present cover every
    element of every array, and (by default) every present array's
    crc32 matches its manifest record."""
    ckpt_dir = os.path.join(dirname, f"checkpoint_{step}")
    try:
        marker = os.path.join(ckpt_dir, _COMMIT)
        if os.path.exists(marker):
            with open(marker) as f:
                json.load(f)
        elif not os.path.isdir(ckpt_dir):
            return False
        manifest, payload = _read_raw(ckpt_dir,
                                      load_payload=verify_checksums)
        if not manifest:
            return False
        for entry in manifest.values():
            if entry.get("sharded"):
                present = [k for k in entry["shards"] if k in payload]
                sums = entry.get("checksums", {})
                if set(present) != set(entry["shards"]) and \
                        not _covers(entry, present):
                    return False
            else:
                present = ([entry["file_key"]]
                           if entry["file_key"] in payload else [])
                if not present:
                    return False
                sums = {entry["file_key"]: entry.get("checksum")}
            for k in present:
                want = sums.get(k) if verify_checksums else None
                if want is not None and _checksum(payload[k]) != want:
                    return False
        return True
    except Exception:  # noqa: BLE001 — any torn-file failure = invalid
        return False


def _covers(entry: dict, present: List[str]) -> bool:
    """Do the PRESENT shards of a manifest entry cover every element?"""
    seen = np.zeros(entry["shape"], dtype=bool)
    for fkey in present:
        seen[tuple(slice(a, b) for a, b in entry["shards"][fkey])] = True
    return bool(seen.all())


def latest_step(dirname: str,
                verify_checksums: bool = True) -> Optional[int]:
    """Newest VALID committed serial, scanning the serial dirs on disk
    newest-first (not the ``latest`` pointer, which a crash between the
    rename and the pointer update leaves one serial behind). Invalid
    serials count into ``pt_ckpt_invalid_skipped_total`` and are
    skipped. ``verify_checksums=False`` is the cheap structural probe."""
    _recover_displaced(dirname)
    for s in reversed(available_steps(dirname)):
        if validate_checkpoint(dirname, s, verify_checksums):
            return s
        _M_INVALID_SKIPS.inc()
    return None


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def load_latest(dirname: str, shardings: Optional[dict] = None):
    """``(step, {name -> array})`` of the newest loadable serial, or
    None, in one read a candidate (``_load_one`` verifies coverage and
    crc32 as it reads). Unloadable serials count into
    ``pt_ckpt_invalid_skipped_total``. ``shardings`` must be empty (see
    ``reshard``)."""
    _recover_displaced(dirname)
    for s in reversed(available_steps(dirname)):
        try:
            values = _load_one(dirname, s)
        except Exception:  # noqa: BLE001 — torn/corrupt: try the next
            _M_INVALID_SKIPS.inc()
            continue
        if shardings:
            values = reshard(values, shardings)
        return s, values
    return None


def load_checkpoint(dirname: str, step: Optional[int] = None,
                    shardings: Optional[dict] = None) -> Dict[str, object]:
    """{name -> full array} of ``checkpoint_<step>`` (default: the
    newest VALID serial), whatever topology saved it."""
    if step is not None:
        values = _load_one(dirname, step)
        return reshard(values, shardings) if shardings else values
    loaded = load_latest(dirname, shardings=shardings)
    if loaded is None:
        if _pointer_step(dirname) is None and not available_steps(dirname):
            raise FileNotFoundError(f"no checkpoint in {dirname}")
        raise IOError(
            f"no valid committed checkpoint in {dirname} "
            f"(serials on disk: {available_steps(dirname)})")
    return loaded[1]


def reshard(values: Dict[str, object], shardings: dict) -> Dict[str, object]:
    """The JAX package places restored arrays onto target shardings. The
    port has one device and no mesh: an empty ``shardings`` returns the
    values as they are, anything else raises."""
    if shardings:
        raise NotImplementedError(
            f"reshard(shardings=...) places values over a device mesh; "
            f"that needs {_ITEM_9}")
    return dict(values)


def manifest_slots(dirname: str, step: int) -> Dict[str, dict]:
    """{var name -> {"param": ..., "slot": ...}} recorded by
    ``save_checkpoint(slots=)`` for ``checkpoint_<step>``, merged across
    every manifest fragment (no array data is read)."""
    ckpt_dir = os.path.join(dirname, f"checkpoint_{step}")
    out: Dict[str, dict] = {}
    for fn in sorted(os.listdir(ckpt_dir)):
        if fn.startswith(_MANIFEST):
            path = os.path.join(ckpt_dir, fn)
            _F_READ.hit(path=path)
            with open(path) as f:
                frag = json.load(f)
            for name, entry in frag.items():
                if "slot" in entry:
                    out.setdefault(name, entry["slot"])
    return out


def reshard_optimizer_state(
    values: Dict[str, object],
    saved_slots: Dict[str, dict],
    target_slots: Dict[str, dict],
    shardings: Optional[dict] = None,
    strategy=None,
) -> Dict[str, object]:
    """Re-key saved optimizer slot state onto the restoring program's
    slot variables by their stable (param, kind) identity: slot var
    names come from unique-name counters and drift between builds, and a
    by-name restore would silently leave the moments at zero.

    - a matched slot moves to the restoring name (counted into
      ``pt_ckpt_slot_rekeys_total`` when the name changed);
    - a saved slot with no target is dropped;
    - non-slot entries pass through.

    Re-placing onto ``shardings`` / ``strategy`` raises: that needs the
    port's mesh. Returns a new dict; ``values`` is not mutated."""
    if shardings or strategy is not None:
        raise NotImplementedError(
            f"reshard_optimizer_state(shardings=/strategy=) places state "
            f"over a device mesh; that needs {_ITEM_9}")
    saved_slots = saved_slots or {}
    target_slots = target_slots or {}
    by_key = {}
    for name, d in saved_slots.items():
        by_key[(d.get("param"), d.get("slot"))] = name
    out = {n: v for n, v in values.items() if n not in saved_slots}
    rekeyed = 0
    for tname, d in target_slots.items():
        sname = by_key.get((d.get("param"), d.get("slot")))
        if sname is None or sname not in values:
            continue  # nothing saved for this slot: leave initialized
        out[tname] = values[sname]
        if tname != sname:
            rekeyed += 1
    if rekeyed:
        _M_SLOT_REKEYS.inc(rekeyed)
    return out


def _read_raw(ckpt_dir: str, load_payload: bool = True):
    """(merged manifest, {file key -> array}) straight off disk. With
    ``load_payload=False`` the payload maps every key present in the
    npz indexes to None (header read only). Manifest parses and shard
    reads pass through the ``ckpt.read`` fault site."""
    manifest: Dict[str, dict] = {}
    for fn in sorted(os.listdir(ckpt_dir)):
        if fn.startswith(_MANIFEST):
            path = os.path.join(ckpt_dir, fn)
            _F_READ.hit(path=path)
            with open(path) as f:
                frag = json.load(f)
            for name, entry in frag.items():
                if name in manifest and entry.get("sharded"):
                    manifest[name]["shards"].update(entry["shards"])
                    manifest[name].setdefault("checksums", {}).update(
                        entry.get("checksums", {}))
                else:
                    manifest.setdefault(name, entry)

    payload: Dict[str, Optional[np.ndarray]] = {}
    for fn in sorted(os.listdir(ckpt_dir)):
        if fn.startswith("shards_") and fn.endswith(".npz"):
            path = os.path.join(ckpt_dir, fn)
            _F_READ.hit(path=path)
            with np.load(path) as z:
                if load_payload:
                    for k in z.files:
                        payload[k] = z[k]
                else:
                    payload.update(dict.fromkeys(z.files))
    return manifest, payload


def _load_one(dirname: str, step: int) -> Dict[str, np.ndarray]:
    ckpt_dir = os.path.join(dirname, f"checkpoint_{step}")
    manifest, payload = _read_raw(ckpt_dir)
    if not manifest:
        # an empty/foreign dir must not load as (step, {}) — resume
        # would pick it over an older REAL checkpoint
        raise IOError(f"checkpoint_{step}: no manifest fragments")

    out: Dict[str, np.ndarray] = {}
    for name, entry in manifest.items():
        if not entry["sharded"]:
            k = entry["file_key"]
            if k not in payload:
                raise IOError(
                    f"checkpoint_{step}: variable '{name}' is missing "
                    f"(shard file '{_fkey_file(k)}' absent, no replica "
                    f"coverage — reassembly impossible)")
            want = entry.get("checksum")
            if want is not None and _checksum(payload[k]) != want:
                raise IOError(
                    f"checkpoint_{step}: checksum mismatch for '{name}' "
                    f"— corrupt shard file")
            out[name] = payload[k]
            continue
        # a JAX save over a mesh: put the value back together from its
        # shards' index ranges
        full = np.zeros(entry["shape"], dtype=_np_dtype(entry["dtype"]))
        seen = np.zeros(entry["shape"], dtype=bool)
        sums = entry.get("checksums", {})
        absent = [k for k in entry["shards"] if k not in payload]
        for fkey, index in entry["shards"].items():
            if fkey in absent:
                continue
            want = sums.get(fkey)
            if want is not None and _checksum(payload[fkey]) != want:
                raise IOError(
                    f"checkpoint_{step}: checksum mismatch for shard "
                    f"'{fkey}' of '{name}' — corrupt shard file")
            sl = tuple(slice(a, b) for a, b in index)
            full[sl] = payload[fkey]
            seen[sl] = True
        if not seen.all():
            files = sorted({_fkey_file(k) for k in absent})
            raise IOError(
                f"checkpoint_{step}: variable '{name}' is missing shards "
                f"({int((~seen).sum())} of {seen.size} elements uncovered; "
                f"absent shards: {sorted(absent)[:4]} from files {files}) "
                f"— replica coverage does NOT permit reassembly; restore "
                f"the missing processes' shard files")
        if absent:
            _M_PARTIAL.inc()
        out[name] = full
    return out


def save_scope(dirname: str, scope=None, step: int = 0,
               async_save: bool = False, names=None,
               slots: Optional[Dict[str, dict]] = None):
    """Checkpoint a Scope's state (default: every var in the scope).
    ``slots`` records optimizer slot descriptors in the manifest."""
    from paddle_tpu_torch.executor import global_scope

    scope = scope or global_scope()
    names = list(names) if names is not None else scope.var_names()
    state = {n: scope.find_var(n) for n in names}
    return save_checkpoint(dirname, state, step=step,
                           async_save=async_save, slots=slots)


def restore_scope(dirname: str, scope=None, step: Optional[int] = None,
                  strict: bool = True, shardings: Optional[dict] = None,
                  strategy=None):
    """Load a checkpoint back into a Scope (bf16 as bf16 tensors; the
    executor moves each value to its device on first use). With
    ``strict`` an empty checkpoint raises; a missing one always does.
    ``shardings`` / ``strategy`` raise: placing over a mesh needs the
    port's parallel modules."""
    from paddle_tpu_torch.executor import global_scope

    if shardings or strategy is not None:
        raise NotImplementedError(
            f"restore_scope(shardings=/strategy=) places values over a "
            f"device mesh; that needs {_ITEM_9}")
    scope = scope or global_scope()
    values = load_checkpoint(dirname, step=step)
    if strict and not values:
        raise IOError(f"empty checkpoint in {dirname}")
    for n, v in values.items():
        scope.set(n, scope_value(v))
    return list(values)
