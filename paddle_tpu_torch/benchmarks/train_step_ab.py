"""Step wall of the Transformer-base training step (bf16 AMP, Adam,
dropout 0.1, batch 64 x seq 256: chip_smoke.py's phase 5), two checkouts
of the port alternately on one card.

    python3 -m paddle_tpu_torch.benchmarks.train_step_ab OTHER_ROOT

OTHER_ROOT is another checkout of the repository (for example the parent
commit unpacked with ``git archive``). Each run is a fresh process that
imports ``chip_smoke.py`` and ``paddle_tpu_torch`` from its own checkout
and calls that checkout's ``train`` (phase 5 of chip_smoke.py: startup,
repeated-batch steps, then the timed window of ``run_steps``), so each
side builds and runs its own kernels and its own copy of phase 5. The
order is other, this, this, other, twice over, so a drift of the
shared host during the call falls on both sides alike. Prints one
JSON line a run and a last line with each side's step wall and
device-busy ms, run by run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_WORKER = r"""
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
r = chip_smoke.train(torch, np, fluid, T, fa, seq=chip_smoke.TRAIN_T,
                     batch=chip_smoke.TRAIN_B, route="small")
keep = ("step_ms", "step_device_ms", "idle_share", "target_tokens_per_s",
        "fwd_kernel_device_ms", "bwd_passes_device_ms", "last_loss",
        "launches_per_step")
print("RESULT " + json.dumps({k: r.get(k) for k in keep}), flush=True)
"""

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_one(root):
    """One training run in a fresh process from ``root``: its result."""
    proc = subprocess.run([sys.executable, "-c", _WORKER, root],
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
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    sides = {"other": other, "this": THIS_ROOT}
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other") * 2:
        r = run_one(sides[side])
        runs[side].append(r)
        print(json.dumps({"side": side, "root": sides[side], **r}),
              flush=True)
    print(json.dumps({side: {
        "step_ms": [r["step_ms"] for r in rs],
        "step_device_ms": [r["step_device_ms"] for r in rs]}
        for side, rs in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
