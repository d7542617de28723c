"""Device timing for the kernel studies' ``main()`` and chip_smoke.py."""

from __future__ import annotations

import subprocess

import torch


def require_card() -> torch.device:
    """The first CUDA device; raises when there is none (a study's
    numbers are device numbers)."""
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark measures device time and needs "
                           "one CUDA device")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def matches(name: str, match) -> bool:
    """Does a kernel name contain ``match`` (a string, or any of a
    tuple of strings)?"""
    return any(m in name for m in
               ((match,) if isinstance(match, str) else match))


_MARKER = "spin_kernel"  # the kernel torch.cuda._sleep launches
# markers that open a window: H100 traces of training steps lost the
# window's first one or two kernels after a single marker
_MARKERS = 8
# kernels whose count a call varies from call to call
_VARIES = ("nchwToNhwc", "nhwcToNchw")


def _int64_elementwise(name: str) -> bool:
    """PyTorch's vectorized int64 elementwise kernels: a training step
    opens with them (its seed written with ``fill_``, or derived from the
    step counter inside a CUDA graph, one element each), and H100 traces
    of two steps counted them 1 or 3 times, trace after trace, where the
    calls launched 2 or 4: a count of the trace, not of the calls."""
    return "vectorized_elementwise_kernel<2," in name and "<long>" in name


def device_times(fn, iters: int = 20, expect=None, tries: int = 5,
                 counts=None, replay: bool = False, trace=None):
    """{kernel name: device ms per call of ``fn``} from a torch.profiler
    trace of ``iters`` calls after one untraced call: the device's busy
    time, without the host's launch overhead.

    A trace can lose kernels (H100 traces have lost a few of theirs, all
    of them, and, trace after trace, the first kernel or two of the
    window: marker kernels, ``torch.cuda._sleep``'s ``spin_kernel``, now
    open the window and are left out), so it is held against what the
    calls launched: some device work, and every kernel's event count a
    multiple of ``iters`` (each call launches the same kernels; copies and
    cuDNN's layout conversions may differ); ``expect`` ({name part or
    tuple of parts: launches a call}) fixes the count of the kernels that
    match. A trace that fails is taken again, ``tries`` times in all,
    then this raises. ``counts``, a dict, receives {kernel name: launches
    a call} of the trace it returns.

    ``replay``: each call replays CUDA graphs, whose launches were fixed
    when they were captured; only then may the trace be one launch short
    of one kernel (H100 traces of replays dropped a step's first kernel,
    755 of 756 bf16 casts, five traces running): a call cannot have
    launched fewer. ``trace``, a dict, receives what the returned trace
    was let off, for the caller's record: ``short``, the kernel it was one
    launch short of (or None), and ``int64``, {name: launches traced} of
    the one-element int64 kernels whose count was no multiple of
    ``iters`` (their time is the trace's, not the calls')."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(_MARKERS):
                torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # device work only, without the markers: the trace also lists host
        # runtime calls (cudaDeviceSynchronize, buffer requests)
        events = [evt for evt in prof.key_averages()
                  if getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0)) > 0
                  and _MARKER not in evt.key]
        counts_now = {evt.key: evt.count for evt in events}
        # left out of the rule: copies (a step may stage a host value every
        # other call), cuDNN's layout conversions, which it runs on some
        # calls of a step and not on others (an H100 read 715 over two
        # ResNet-50 steps, alike in five traces), and the one-element int64
        # kernels that open a step (``_int64_elementwise``)
        bad = {k: n for k, n in counts_now.items()
               if n % iters and not k.startswith(("Memcpy", "Memset"))
               and not matches(k, _VARIES)}
        int64 = {k: n for k, n in bad.items() if _int64_elementwise(k)}
        bad = {k: n for k, n in bad.items() if k not in int64}
        # one launch of one kernel short, in a trace of graph replays: the
        # first kernel of a call, which the trace dropped
        short = None
        if replay and len(bad) == 1:
            (k, n), = bad.items()
            if n % iters == iters - 1:
                short, bad = k, {}
        for match, per_call in (expect or {}).items():
            got = sum(n for k, n in counts_now.items()
                      if matches(k, match))
            if got != per_call * iters:
                bad[str(match)] = got
        if events and not bad:
            if counts is not None:
                counts.update({k: n / iters for k, n in counts_now.items()})
            if trace is not None:
                trace.update(short=short, int64=int64)
            return {evt.key: getattr(evt, "device_time_total",
                                     getattr(evt, "cuda_time_total", 0.0))
                    / iters / 1e3 for evt in events}
        print(f"device trace of {iters} calls lost kernels "
              f"({bad or 'no device work'}); taking it again", flush=True)
    raise RuntimeError(f"the profiler trace lost kernels {tries} times")


def device_us(fn, iters: int = 20) -> float:
    """Device microseconds per call of ``fn`` (``device_times``, every
    kernel)."""
    return sum(device_times(fn, iters).values()) * 1e3
