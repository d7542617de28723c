"""High-level Trainer with epoch checkpoints and auto-resume
(reference: python/paddle/fluid/contrib/trainer.py:379 ``Trainer.train``,
CheckpointConfig :100, serial checkpoint dirs + resume :580,285).

The JAX package's Trainer on the port's executor. The train loop is the
reference's event-driven shape (Begin/EndEpoch, Begin/EndStep events, an
``event_handler`` callback, ``trainer.stop()``); persistence rides
parallel/checkpoint.py, whose files either package restores. A batch
reaches the step through a ``DeviceLoader`` that stages the next batch on
the card while the current step runs (``prefetch_depth`` > 0, with the
fetches read back lazily) or through synchronous ``DataFeeder`` staging
(``prefetch_depth`` 0); both give the same losses.

A resume restores the executor's step counter (``__trainer_rng_step__``
in the checkpoint), from which every step's dropout seeds derive, so a
resumed run draws the masks an uninterrupted run draws; the restored
values reach an already captured step because its runner copies a
Scope entry that is not its own state buffer into that buffer before
the next replay (core/lowering.py ``StepRunner``).

Waiting for the port's parallel modules (ROADMAP.md Queue 1, item 9):
``parallel=True`` and ``strategy=`` (``compiler.py``). The build-time
static lint waits for ``analysis.py`` (item 10).
"""

from __future__ import annotations

import os
import shutil
import time
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch import io as _io
from paddle_tpu_torch import monitor as _monitor
from paddle_tpu_torch import numerics as _numerics
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.executor import Executor, Scope, scope_guard
from paddle_tpu_torch.framework import Program, program_guard
from paddle_tpu_torch.parallel import checkpoint as _ckpt
from paddle_tpu_torch.reader.pipeline import DeviceLoader

# Epoch/step events feed the metrics plane; spans put them on the same
# chrome-trace timeline as the executor's spans.
_M_EPOCHS = _monitor.counter(
    "pt_trainer_epochs_total", "completed training epochs")
_M_TRAIN_STEPS = _monitor.counter(
    "pt_trainer_steps_total", "trainer steps run")
_M_CKPTS = _monitor.counter(
    "pt_trainer_checkpoints_total", "checkpoints saved")
_M_LOSS = _monitor.gauge(
    "pt_trainer_last_loss", "loss fetched at the most recent step")
_M_RESUMES = _monitor.counter(
    "pt_trainer_auto_resumes_total",
    "training failures auto-recovered by restoring the last valid "
    "checkpoint (CheckpointConfig.max_resume_retries), by whether the "
    "world size changed since the save (resized)")

# chaos hook: armed plans can fail the Nth batch fetch, driving the
# auto-resume loop deterministically
_F_READER_NEXT = _faults.site("reader.next")


_RNG_STEP_KEY = "__trainer_rng_step__"
_WORLD_KEY = "__trainer_world__"
_ITEM_9 = ("compiler.py, which waits for the port's parallel modules "
           "(ROADMAP.md Queue 1, item 9)")


def _current_world() -> int:
    """Data-parallel world size of this run, saved into every checkpoint
    so a resume onto another world can re-derive its cursor. The port
    runs one process on one card."""
    return 1


class BeginEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id: int, step_id: int):
        self.epoch = epoch_id
        self.step = step_id


class EndStepEvent:
    def __init__(self, epoch_id: int, step_id: int, metrics: List):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """reference: contrib/trainer.py:100. Checkpoints are epoch-granular
    (resume replays from an epoch boundary; there is no mid-epoch data
    cursor, so a step_interval would silently re-read data on resume).

    ``max_resume_retries``: on a training failure (a raising step,
    reader, or event handler), ``Trainer.train`` restores the newest
    VALID checkpoint and continues from its epoch, at most this many
    times per ``train()`` call. 0 (default) = fail fast.

    ``async_save``: overlap checkpoint serialization + commit with the
    next epoch's training steps (the device->host snapshot still happens
    in the caller, so the next step may write the state in place). The
    previous save is waited on before the next one starts and at the end
    of ``train()``, so a failed background save surfaces within one
    checkpoint interval and the auto-resume loop sees it like any other
    training failure."""

    def __init__(
        self,
        checkpoint_dir: str,
        epoch_interval: int = 1,
        max_num_checkpoints: int = 3,
        max_resume_retries: int = 0,
        async_save: bool = False,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.epoch_interval = max(1, int(epoch_interval))
        self.max_num_checkpoints = max(1, int(max_num_checkpoints))
        self.max_resume_retries = max(0, int(max_resume_retries))
        self.async_save = bool(async_save)


class Trainer:
    """train_func builds the forward graph and returns [loss, ...metrics];
    optimizer_func returns the Optimizer (reference Trainer contract).
    ``place`` defaults to ``CUDAPlace(0)``; pass ``CPUPlace()`` for the
    CPU. ``save_log`` holds one record a checkpoint: its serial, the
    caller-blocking seconds (the snapshot, ``snapshot_s``), the
    background write's seconds (``write_s``, once it ended) and how long
    the next save or the end of ``train`` waited for it (``waited_s``)."""

    def __init__(
        self,
        train_func: Callable,
        optimizer_func: Callable,
        place=None,
        parallel: bool = False,
        checkpoint_config: Optional[CheckpointConfig] = None,
        strategy=None,
    ):
        if parallel or strategy is not None:
            raise NotImplementedError(
                f"Trainer(parallel=True) / Trainer(strategy=...) needs "
                f"{_ITEM_9}")
        self._ckpt_cfg = checkpoint_config
        self.scope = Scope()
        self.main_program, self.startup_program = Program(), Program()
        with program_guard(self.main_program, self.startup_program):
            outs = train_func()
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            self.train_outputs = list(outs)
            self.loss = self.train_outputs[0]
            self.test_program = self.main_program.clone(for_test=True)
            # keep the instance: its slot_descriptor() is what lets a
            # resume re-key saved moments onto THIS build's slot names
            # (checkpoint.reshard_optimizer_state)
            self._optimizer = optimizer_func()
            self._optimizer.minimize(self.loss)
        if _numerics.active():
            # numerics plane on at build time: instrument the train
            # program so every trainer step feeds tensor stats + NaN
            # provenance (filtered by the numerics_vars flag)
            _numerics.instrument(self.main_program)
        self.place = place
        self.exe = Executor(place)

        self._stopped = False
        self._start_epoch = 0
        self._pending_save = None  # (serial, _AsyncHandle, record)
        self._last_resume_resized = False
        self.save_log: List[dict] = []
        # the latest epoch's DeviceLoader (its ``stats``), or None
        self.loader: Optional[DeviceLoader] = None
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            self._maybe_resume()

    # --- checkpoint/resume (reference: contrib/trainer.py:285,580) ---

    def _maybe_resume(self):
        """Restore the newest VALID checkpoint into the scope; returns
        its serial, or None when there is nothing to resume. Single
        read: load_latest verifies commit/coverage/checksums in the
        same pass that yields the values."""
        cfg = self._ckpt_cfg
        if cfg is None:
            return None
        loaded = _ckpt.load_latest(cfg.checkpoint_dir)
        if loaded is None:
            return None
        step, values = loaded
        saved_slots = _ckpt.manifest_slots(cfg.checkpoint_dir, step)
        if saved_slots and self._optimizer is not None:
            # optimizer slot state restores by (param, kind), not by
            # name: a rebuilt program's slot names drift with its
            # unique-name counters
            values = _ckpt.reshard_optimizer_state(
                values, saved_slots, self._optimizer.slot_descriptor())
        for n, v in values.items():
            self.scope.set(n, _ckpt.scope_value(v))
        names = set(values)
        # Every parameter of THIS program must be covered, or training
        # would silently continue from re-initialized values
        missing = [
            p.name
            for p in self.main_program.all_parameters()
            if p.name not in names
        ]
        if missing:
            raise IOError(
                f"checkpoint_{step} does not cover {len(missing)} program "
                f"parameters (e.g. {missing[:4]}); parameter names differ "
                f"from the run that saved it"
            )
        # restore the executor's step counter, from which the dropout
        # seeds derive, so stochastic ops replay the uninterrupted run.
        # After a resize the cursor is re-derived for the new world, as
        # in the JAX package (old_steps * old_world / new_world).
        rng_step = self.scope.find_var(_RNG_STEP_KEY)
        saved_world = self.scope.find_var(_WORLD_KEY)
        world = _current_world()
        resized = (saved_world is not None
                   and int(np.asarray(saved_world)) != world)
        if rng_step is not None:
            cursor = int(np.asarray(rng_step))
            if resized:
                cursor = (cursor * int(np.asarray(saved_world))) // world
            self.exe._step = cursor
            self.scope.drop(_RNG_STEP_KEY)
        if saved_world is not None:
            self.scope.drop(_WORLD_KEY)
        self._last_resume_resized = resized
        if resized:
            _M_RESUMES.inc(labels={"resized": "true"})
            warnings.warn(
                f"resumed checkpoint_{step} saved by a "
                f"{int(np.asarray(saved_world))}-worker world onto "
                f"{world} workers; RNG cursor re-derived to "
                f"{self.exe._step}", RuntimeWarning)
        self._start_epoch = step  # serial number = next epoch to run
        return step

    def _wait_pending_save(self):
        """Land the in-flight overlapped save, if any: surfaces its
        error into the train loop (-> auto-resume budget) and runs the
        pruning deferred until its commit."""
        pending = self._pending_save
        if pending is None:
            return
        self._pending_save = None
        serial, handle, rec = pending
        t0 = time.perf_counter()
        try:
            handle.wait()
        finally:
            rec["waited_s"] = time.perf_counter() - t0
            rec["write_s"] = handle.write_s
        self._prune(serial)

    def _settle_pending_save(self):
        """Land an in-flight overlapped save before a RESUME decision,
        without burning a second resume retry on its failure: a commit
        that lands makes its serial the restore point, and the restore's
        directory scan must not race the background rename. A
        pending-save failure is warned, not raised."""
        pending = self._pending_save
        if pending is None:
            return
        self._pending_save = None
        serial, handle, rec = pending
        try:
            handle.wait()
        except Exception as e:  # noqa: BLE001 — subsumed by the resume
            warnings.warn(
                f"overlapped save of checkpoint_{serial} failed during "
                f"auto-resume ({type(e).__name__}: {e}); resuming from "
                f"the newest valid serial", RuntimeWarning)
            return
        finally:
            rec["write_s"] = handle.write_s
        self._prune(serial)

    def _save_checkpoint(self, serial: int):
        cfg = self._ckpt_cfg
        self._wait_pending_save()
        self.scope.set(_RNG_STEP_KEY, np.int64(self.exe._step))
        self.scope.set(_WORLD_KEY, np.int64(_current_world()))
        rec = {"serial": serial, "snapshot_s": None, "write_s": None,
               "waited_s": None}
        t0 = time.perf_counter()
        try:
            handle = _ckpt.save_scope(cfg.checkpoint_dir, self.scope,
                                      step=serial,
                                      async_save=cfg.async_save,
                                      slots=self._optimizer
                                      .slot_descriptor())
        finally:
            # safe even under async_save: the device->host snapshot is
            # complete before save_scope returns
            self.scope.drop(_RNG_STEP_KEY)
            self.scope.drop(_WORLD_KEY)
        self.save_log.append(rec)
        if handle is not None:
            rec["snapshot_s"] = time.perf_counter() - t0
            # overlapped save: checksum + serialize + commit run while
            # the next epoch trains; pruning waits for the commit
            self._pending_save = (serial, handle, rec)
            return
        rec["write_s"] = time.perf_counter() - t0
        self._prune(serial)

    def _prune(self, serial: int):
        cfg = self._ckpt_cfg
        # Prune serial dirs beyond max_num_checkpoints — only AFTER the
        # new checkpoint committed, and never the last resumable state:
        # the keep window holds the newest VALID serials, and invalid
        # serials are reclaimed only when a NEWER valid one exists.
        # Foreign entries like checkpoint_best are not ours to touch.
        # The just-written serial is first proven with checksums; if
        # even it fails, keep everything.
        if not _ckpt.validate_checkpoint(cfg.checkpoint_dir, serial):
            warnings.warn(
                f"checkpoint_{serial} failed checksum validation right "
                f"after commit; skipping pruning", RuntimeWarning)
            return
        serials = sorted(
            _ckpt.available_steps(cfg.checkpoint_dir), reverse=True)
        valid = [s for s in serials
                 if _ckpt.validate_checkpoint(cfg.checkpoint_dir, s,
                                              verify_checksums=False)]
        keep = set(valid[:cfg.max_num_checkpoints])
        keep.add(serial)
        newest_valid = valid[0] if valid else None
        for s in serials:
            if s in keep:
                continue
            if s in valid or (newest_valid is not None
                              and s < newest_valid):
                shutil.rmtree(
                    os.path.join(cfg.checkpoint_dir, f"checkpoint_{s}"),
                    ignore_errors=True,
                )

    # --- the loop (reference: contrib/trainer.py:379) ---

    def stop(self):
        self._stopped = True

    def _prefetch_depth(self) -> int:
        """The step loop's DeviceLoader depth; 0 = synchronous
        DataFeeder staging."""
        return max(0, int(_flags.get_flag("prefetch_depth")))

    def _batches(self, reader, feeder, feed_order, depth):
        """One epoch's feed-dict stream: a DeviceLoader staging
        ``depth`` batches ahead on the executor's device (batch N+1's
        copy overlaps batch N's step; batch assembly runs in the worker
        OFF the verdict's critical path), or the synchronous DataFeeder
        path when prefetch is off. Returns (iterator, loader-or-None);
        the caller must close the loader."""
        if depth <= 0:
            return (feeder.feed(b) for b in reader()), None
        loader = DeviceLoader(
            lambda: (feeder.feed(b, critical_path=False)
                     for b in reader()),
            list(feed_order), depth=depth, place=self.place)
        self.loader = loader
        return iter(loader), loader

    def train(
        self,
        num_epochs: int,
        event_handler: Optional[Callable] = None,
        reader: Optional[Callable] = None,
        feed_order: Optional[Sequence[str]] = None,
        log_time_attribution: bool = True,
    ):
        if reader is None or feed_order is None:
            raise ValueError(
                "Trainer.train needs `reader` (a callable returning an "
                "iterable of batches) and `feed_order` (feed var names)"
            )
        cfg = self._ckpt_cfg
        retries = cfg.max_resume_retries if cfg is not None else 0
        while True:
            try:
                return self._train_impl(
                    num_epochs, event_handler, reader, feed_order,
                    log_time_attribution)
            except (KeyboardInterrupt, SystemExit):
                # deliberately NOT settled: an interrupt should not block
                # on a background commit; the staging protocol already
                # guarantees valid-or-absent serials
                raise
            except Exception as e:  # noqa: BLE001 — auto-resume budget
                if retries <= 0:
                    # land the overlapped save before handing control to
                    # the caller: its directory scan must not race the
                    # background rename
                    self._settle_pending_save()
                    raise
                retries -= 1
                self._start_epoch = 0
                self._stopped = False
                self._settle_pending_save()
                with scope_guard(self.scope):
                    step = self._maybe_resume()
                if step is None:
                    raise  # nothing valid to resume from
                warnings.warn(
                    f"training failed ({type(e).__name__}: {e}); "
                    f"auto-resuming from checkpoint_{step} "
                    f"({retries} retries left)", RuntimeWarning)
                if not self._last_resume_resized:
                    _M_RESUMES.inc(labels={"resized": "false"})

    def _train_impl(
        self,
        num_epochs: int,
        event_handler: Optional[Callable],
        reader: Callable,
        feed_order: Sequence[str],
        log_time_attribution: bool,
    ):
        handler = event_handler or (lambda e: None)
        feeder = DataFeeder(
            [self.main_program.global_block().var(n) for n in feed_order]
        )
        fetch = [self.loss] + self.train_outputs[1:]
        depth = self._prefetch_depth()
        lazy = depth > 0  # prefetch on: fetches materialize lazily too
        with scope_guard(self.scope):
            for epoch in range(self._start_epoch, num_epochs):
                if self._stopped:
                    break
                handler(BeginEpochEvent(epoch))
                metrics = None
                batches, loader = self._batches(reader, feeder,
                                                feed_order, depth)
                try:
                    with _monitor.span("trainer.epoch"):
                        for step, feed in enumerate(batches):
                            if self._stopped:
                                break
                            _F_READER_NEXT.hit()
                            handler(BeginStepEvent(epoch, step))
                            with _monitor.span("trainer.step"), \
                                    _monitor.stall_guard("trainer.step"):
                                metrics = self.exe.run(
                                    self.main_program,
                                    feed=feed,
                                    fetch_list=fetch,
                                    async_fetch=lazy,
                                )
                            handler(EndStepEvent(epoch, step, metrics))
                            if _monitor.enabled():
                                _M_TRAIN_STEPS.inc()
                                # the loss gauge forces the deferred
                                # fetch to land: with async fetch it
                                # rides the sampled cadence (or a fixed
                                # period with phases off) so unsampled
                                # steps keep the overlap
                                if metrics and (
                                        not lazy
                                        or getattr(metrics, "ready",
                                                   True)
                                        or _monitor.phases_sampled(
                                            self.exe._step - 1)
                                        or (not _monitor.phases_active()
                                            and step % 16 == 0)):
                                    v = np.asarray(metrics[0])
                                    if v.size:
                                        _M_LOSS.set(float(v.ravel()[0]))
                        if lazy and metrics is not None:
                            # epoch boundary: land the last deferred
                            # fetch so a deferred device error surfaces
                            # inside the epoch's failure budget
                            metrics.wait()
                finally:
                    if loader is not None:
                        # a raising step / stop() must release the
                        # prefetch worker and its staged batches
                        loader.close()
                if self._stopped:
                    # stopped mid-epoch: the epoch did NOT complete — no
                    # EndEpochEvent and no checkpoint, or resume would
                    # silently skip the untrained remainder of it
                    break
                handler(EndEpochEvent(epoch))
                _M_EPOCHS.inc()
                if log_time_attribution and _monitor.enabled():
                    # which side of the machine the last window of steps
                    # spent its wall time on (None unless the
                    # step_phases plane is producing verdicts)
                    b = _monitor.boundedness()
                    if b is not None:
                        s = b["shares"]
                        print(
                            f"[trainer] epoch {epoch} time attribution: "
                            f"{b['verdict']} (input {s['input']:.0%}, "
                            f"dispatch {s['dispatch']:.0%}, device "
                            f"{s['device']:.0%} over last {b['steps']} "
                            f"steps)")
                if _monitor.enabled():
                    # one fleet-summary line per epoch (None for a
                    # single-worker job); never fails an epoch for a
                    # telemetry hiccup
                    try:
                        from paddle_tpu_torch import fleet_monitor as _fm

                        line = _fm.epoch_summary_line()
                        if line:
                            print(f"[trainer] epoch {epoch} {line}")
                    except Exception as e:  # noqa: BLE001
                        warnings.warn(
                            f"fleet epoch summary skipped: {e!r}",
                            RuntimeWarning)
                if (
                    self._ckpt_cfg is not None
                    and (epoch + 1) % self._ckpt_cfg.epoch_interval == 0
                ):
                    with _monitor.span("trainer.checkpoint"):
                        self._save_checkpoint(epoch + 1)
                    _M_CKPTS.inc()
            # train() returns only with every overlapped save durable —
            # a background failure surfaces HERE, inside the auto-resume
            # budget
            self._wait_pending_save()

    def test(self, reader, feed_order: Sequence[str]):
        feeder = DataFeeder(
            [self.main_program.global_block().var(n) for n in feed_order]
        )
        fetch = [self.loss] + self.train_outputs[1:]
        depth = self._prefetch_depth()
        totals = None
        count = 0
        with scope_guard(self.scope):
            batches, loader = self._batches(reader, feeder, feed_order,
                                            depth)
            try:
                for feed in batches:
                    vals = self.exe.run(
                        self.test_program, feed=feed,
                        fetch_list=fetch,
                    )
                    vals = [np.asarray(v, dtype=np.float64) for v in vals]
                    totals = (
                        vals
                        if totals is None
                        else [t + v for t, v in zip(totals, vals)]
                    )
                    count += 1
            finally:
                if loader is not None:
                    loader.close()
        if totals is None:
            return []
        return [float(t / count) for t in totals]

    def save_params(self, dirname: str):
        with scope_guard(self.scope):
            _io.save_persistables(self.exe, dirname, self.main_program)

    def save_inference_model(self, dirname: str, feeded_var_names,
                             target_vars):
        with scope_guard(self.scope):
            _io.save_inference_model(
                dirname, feeded_var_names, target_vars, self.exe,
                self.test_program,
            )
