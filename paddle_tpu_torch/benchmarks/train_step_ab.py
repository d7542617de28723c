"""Two checkouts of the port alternately on one card, on one of
chip_smoke.py's paths: the Transformer-base training step (``train``:
bf16 AMP, Adam, dropout 0.1, batch 64 x seq 256, phase 5) or the serving
engine at src_len = max_len = 128 (``decode``: 16 requests on 8 slots,
phase 4, whose decode step ms is the inter-token latency).

    python3 -m paddle_tpu_torch.benchmarks.train_step_ab OTHER_ROOT
    python3 -m paddle_tpu_torch.benchmarks.train_step_ab --path decode \\
        OTHER_ROOT

OTHER_ROOT is another checkout of the repository (for example the parent
commit unpacked with ``git archive``). The kernel sources the path needs
are built first in both checkouts at once. Each run is then a fresh
process that imports ``chip_smoke.py`` and ``paddle_tpu_torch`` from its
own checkout and calls that checkout's copy of the phase, so each side
runs its own kernels and its own copy of the phase. The order is other,
this, this, other, twice over, so a drift of the shared host during the
call falls on both sides alike. Prints one JSON line a run and a last
line with each side's readings, run by run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_PREAMBLE = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import flash_attention as fa
assert fluid.__file__.startswith(root), fluid.__file__
"""

_WORKERS = {
    "train": _PREAMBLE + r"""
r = chip_smoke.train(torch, np, fluid, T, fa, seq=chip_smoke.TRAIN_T,
                     batch=chip_smoke.TRAIN_B, route="small")
keep = ("step_ms", "step_device_ms", "idle_share", "target_tokens_per_s",
        "fwd_kernel_device_ms", "bwd_passes_device_ms", "last_loss",
        "launches_per_step")
print("RESULT " + json.dumps({k: r.get(k) for k in keep}), flush=True)
""",
    "decode": _PREAMBLE + r"""
from paddle_tpu_torch import serving
r = chip_smoke.serve(torch, np, fluid, T, fa, serving, cfg=T.base(),
                     slots=8, src_len=128, max_len=128, n_req=16,
                     new_tokens=32, min_len=16)
keep = ("decode_step_ms", "decode_device_ms", "prefill_ms",
        "prefill_device_ms", "tokens_per_s", "greedy_tokens_sha1")
print("RESULT " + json.dumps({k: r.get(k) for k in keep}), flush=True)
""",
}

# the kernel sources each path launches, and the readings its last line
# lists
_SOURCES = {"train": ("flash_attention_bthd_fwd", "flash_attention_bthd_bwd",
                      "dropout_mask"),
            "decode": ("flash_attention_bthd_fwd",)}
_READINGS = {"train": ("step_ms", "step_device_ms"),
             "decode": ("decode_step_ms", "decode_device_ms",
                        "tokens_per_s")}

_BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch import kernels
for name in sys.argv[2:]:
    kernels.build(name)
"""

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_both(roots, sources):
    """Build ``sources`` in every checkout of ``roots``, all at once."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, root,
                               *sources], cwd=root,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for root in roots]
    for root, proc in zip(roots, procs):
        out, _ = proc.communicate(timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"build in {root} failed:\n{out[-4000:]}")


def run_one(path, root):
    """One run of ``path`` in a fresh process from ``root``: its result."""
    proc = subprocess.run([sys.executable, "-c", _WORKERS[path], root],
                          capture_output=True, text=True, cwd=root,
                          timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"run from {root} failed:\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--path", choices=sorted(_WORKERS), default="train",
                    help="the phase both sides run (default: train)")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    sides = {"other": other, "this": THIS_ROOT}
    build_both(list(sides.values()), _SOURCES[args.path])
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other") * 2:
        r = run_one(args.path, sides[side])
        runs[side].append(r)
        print(json.dumps({"side": side, "root": sides[side], **r}),
              flush=True)
    print(json.dumps({side: {k: [r[k] for r in rs]
                             for k in _READINGS[args.path]}
                      for side, rs in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
