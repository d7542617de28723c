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
# cycles a marker spins for a millisecond (an H100 spun 2e6 in 1.007 ms)
_CYCLES_PER_MS = 2_000_000
# the ms of markers on each side of a window, one entry a try, the last
# repeated: traces on an H100 lost more of a short window's kernels the
# longer the process had run, and fewer behind longer markers (PERF.md §7)
_MARKER_MS = (10, 20, 40, 80)
# kernels whose count a call varies from call to call
_VARIES = ("nchwToNhwc", "nhwcToNchw")


def _int64_elementwise(name: str) -> bool:
    """PyTorch's vectorized int64 elementwise kernels: a training step
    opens with them (its seed written with ``fill_``, or derived from the
    step counter inside a CUDA graph, one element each), and H100 traces
    of two steps counted them 1 or 3 times, trace after trace, where the
    calls launched 2 or 4: a count of the trace, not of the calls. A
    functor over int64 operands prints as ``<long, long, long, ...``
    (the seed derivation's shifts: an H100 trace of three replays of the
    recipe step counted one 10 times, where they launched 9)."""
    return ("vectorized_elementwise_kernel<2," in name
            and ("<long>" in name or "<long, long" in name))


def device_times(fn, iters: int = 20, expect=None, tries: int = 6,
                 counts=None, replay: bool = False, trace=None):
    """{kernel name: device ms per call of ``fn``} from a torch.profiler
    trace of ``iters`` calls after one untraced call: the device's busy
    time, without the host's launch overhead.

    A trace can lose kernels (H100 traces have lost a few of theirs, all
    of them, and, trace after trace, the first kernels of the window: so
    each trace opens with a warm-up step, one call whose events the
    profiler drops, and marker kernels, ``torch.cuda._sleep``'s
    ``spin_kernel``, open and close each window and are left out; a
    retry's markers spin longer, ``_MARKER_MS``), so it is held against
    what the calls launched: some device work, and every kernel's event
    count a multiple of ``iters`` (each call launches the same kernels;
    copies and cuDNN's layout conversions may differ); ``expect`` ({name part or
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
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        ms = _MARKER_MS[min(attempt, len(_MARKER_MS) - 1)]
        side = (8, ms * _CYCLES_PER_MS // 8)
        events = _trace(fn, iters, side, side)
        bad, short, int64 = _verdict(events, iters, expect, replay)
        if events and not bad:
            if counts is not None:
                counts.update({evt.key: evt.count / iters for evt in events})
            if trace is not None:
                trace.update(short=short, int64=int64)
            return {evt.key: _device_us(evt) / iters / 1e3 for evt in events}
        print(f"device trace of {iters} calls lost kernels "
              f"({bad or 'no device work'}); taking it again", flush=True)
    raise RuntimeError(f"the profiler trace lost kernels {tries} times")


def _device_us(evt) -> float:
    return getattr(evt, "device_time_total",
                   getattr(evt, "cuda_time_total", 0.0))


def _markers(n: int, cycles: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(cycles)


def _trace(fn, iters: int, lead, tail) -> list:
    """The profiler's events of ``iters`` calls of ``fn`` that ran on the
    device, the markers left out; ``lead`` and ``tail`` (launches, cycles
    each): the markers before and after the calls of each window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    # step 0 warms the trace up (one call, its events dropped: an H100
    # trace of two ResNet-50 replays lost the first call's first three
    # kernels, five traces running); step 1 is the window read
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.append(p.key_averages())) \
            as prof:
        for calls in (1, iters):
            _markers(*lead)
            for _ in range(calls):
                fn()
            _markers(*tail)
            torch.cuda.synchronize()
            prof.step()
    # device work only: the trace also lists host runtime calls
    # (cudaDeviceSynchronize, buffer requests)
    return [evt for evt in (got[0] if got else [])
            if _device_us(evt) > 0 and _MARKER not in evt.key]


def _verdict(events, iters: int, expect, replay: bool):
    """(the kernels whose traced count the calls cannot have launched:
    {name: count}, the kernel a replay trace was let off one launch of or
    None, the one-element int64 kernels off the multiple: {name: count})."""
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
        got = sum(n for k, n in counts_now.items() if matches(k, match))
        if got != per_call * iters:
            bad[str(match)] = got
    return bad, short, int64


def device_us(fn, iters: int = 20) -> float:
    """Device microseconds per call of ``fn`` (``device_times``, every
    kernel)."""
    return sum(device_times(fn, iters).values()) * 1e3
