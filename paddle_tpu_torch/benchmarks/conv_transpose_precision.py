"""How precisely the f32 transposed convolution runs on the card under
each cuDNN setting, and what that does to a step of the DCGAN generator
(chip_smoke.py phase 17c). Three readings:

1. ``conv2d_transpose``'s output and its two gradients at the
   generator's four layers' shapes, batch 8 (against the CPU in f64) and
   128 (against the card in f64), each relative to its largest element,
   with the CUDA kernels each setting runs and, at 128, its ms a call;
2. the execution plans cuDNN's frontend logs for one layer (engine,
   numerical notes), from a child process run with its log switched on;
3. one f32 step of the generator at batch 8 on the card under each
   setting against the CPU's f64 step from the same state: the loss, the
   relu gates that flip sign and each gradient (``chip_smoke.hold_vs_f64``
   with no limit).

One JSON line a reading, from the repository root:

    python3 -m paddle_tpu_torch.benchmarks.conv_transpose_precision
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

# (C_in, C_out, side in) of the generator's conv2d_transpose layers
LAYERS = ((1024, 512, 4), (512, 256, 8), (256, 128, 16), (128, 3, 32))
SETTINGS = {"default": {}, "deterministic": {"deterministic": True},
            "benchmark": {"benchmark": True}, "cudnn_off": {"enabled": False}}
SEED = 1234


def _flags(torch, name):
    kw = dict(enabled=True, benchmark=False, deterministic=False,
              allow_tf32=False)
    kw.update(SETTINGS[name])
    return torch.backends.cudnn.flags(**kw)


def _case(np, b, cin, cout, side, seed):
    r = np.random.RandomState(seed)
    return (r.normal(0, 1, (b, cin, side, side)),
            r.normal(0, 0.02, (cin, cout, 4, 4)),
            r.normal(0, 1, (b, cout, 2 * side, 2 * side)))


def _fwd_bwd(torch, x, w, g):
    import torch.nn.functional as F

    y = F.conv_transpose2d(x, w, stride=2, padding=1)
    return (y,) + torch.autograd.grad(y, (x, w), g)


def _run(torch, arrays, device, dtype):
    x, w, g = (torch.tensor(a, dtype=dtype, device=device) for a in arrays)
    x.requires_grad_(True)
    w.requires_grad_(True)
    return [t.detach().cpu().double().numpy()
            for t in _fwd_bwd(torch, x, w, g)]


def _rel(np, got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _kernels_and_ms(torch, arrays):
    """The CUDA kernels of one f32 call (forward and both gradients) and
    its ms a call over 20 calls (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    x, w, g = (torch.tensor(a, dtype=torch.float32, device="cuda")
               for a in arrays)
    x.requires_grad_(True)
    w.requires_grad_(True)
    for _ in range(3):
        _fwd_bwd(torch, x, w, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _fwd_bwd(torch, x, w, g)
        torch.cuda.synchronize()
    names = sorted({e.key[:100] for e in prof.key_averages()
                    if e.device_type.name == "CUDA"})
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        _fwd_bwd(torch, x, w, g)
    end.record()
    torch.cuda.synchronize()
    return names, start.elapsed_time(end) / 20


def ops(torch, np):
    for i, layer in enumerate(LAYERS):
        for b in (8, 128):
            arrays = _case(np, b, *layer, SEED + i)
            ref = _run(torch, arrays, "cpu" if b == 8 else "cuda",
                       torch.float64)
            for name in SETTINGS:
                with _flags(torch, name):
                    got = _run(torch, arrays, "cuda", torch.float32)
                    row = {"layer": i, "batch": b, "setting": name,
                           "rel_err_y_dx_dw": [_rel(np, a, c)
                                               for a, c in zip(got, ref)]}
                    if b == 128:
                        row["kernels"], row["ms"] = _kernels_and_ms(torch,
                                                                    arrays)
                print("op " + json.dumps(row), flush=True)


def plans():
    """cuDNN's frontend log of one f32 call of layer 2 at batch 8 under
    the default setting: its execution plans' lines."""
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "cudnn_fe.log")
        env = dict(os.environ, CUDNN_FRONTEND_LOG_INFO="1",
                   CUDNN_FRONTEND_LOG_FILE=log)
        subprocess.run([sys.executable, "-m", __spec__.name, "--one"],
                       env=env, check=True, timeout=300)
        with open(log, errors="replace") as f:
            lines = [ln.strip() for ln in f if "EXECUTION_PLAN" in ln]
    print("plans " + json.dumps(lines), flush=True)


def dcgan_step(torch, np):
    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as tio

    def build():
        return cs.dcgan_generator(fluid)

    def make_opt():
        return fluid.optimizer.Adam(cs.DCGAN_LR, beta1=cs.DCGAN_BETA1)

    main_prog, startup, model, _ = cs._family_program(fluid, build,
                                                      make_opt, False)
    names = [p.name for p in main_prog.all_parameters() if p.trainable]
    fetch = ([model["loss"].name] + [n + "@GRAD" for n in names]
             + [n for _, n in cs._relu_gates(main_prog)])
    state = cs.card_startup_state(fluid, startup)
    feed = cs.dcgan_feeds(np, cs.DCGAN_CPU_B, 1, SEED + 1)[0]

    def wide(d):
        return {k: v.astype(np.float64) if v.dtype == np.float32 else v
                for k, v in d.items()}
    with fluid.scope_guard(tio.scope_from_numpy(wide(state),
                                                fluid.CPUPlace())):
        ref = fluid.Executor(fluid.CPUPlace()).run(
            main_prog, feed=wide(feed), fetch_list=fetch)
    inf = float("inf")
    for name in SETTINGS:
        with _flags(torch, name):
            got = cs.run_captured(fluid, main_prog, state, feed, fetch)
        row = cs.hold_vs_f64(np, main_prog, names, ref, got,
                             tol=(inf, inf, inf))
        print("dcgan_step " + json.dumps({"setting": name, **row}),
              flush=True)


def main(argv):
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv == ["--one"]:
        arrays = _case(np, 8, *LAYERS[2], SEED + 2)
        with _flags(torch, "default"):
            _run(torch, arrays, "cuda", torch.float32)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cudnn "
          f"{torch.backends.cudnn.version()}", flush=True)
    ops(torch, np)
    plans()
    dcgan_step(torch, np)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
