"""Device timing for the kernel studies' ``main()``."""

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


def device_us(fn, iters: int = 20) -> float:
    """Device microseconds per call of ``fn``: the summed kernel time of
    a ``torch.profiler`` trace of ``iters`` calls after one untraced
    call, so the host's launch overhead is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(evt, "device_time_total",
                        getattr(evt, "cuda_time_total", 0.0))
                for evt in prof.key_averages())
    if not total:
        raise RuntimeError("the profiler trace holds no device time")
    return total / iters
