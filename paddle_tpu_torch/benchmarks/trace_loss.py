"""How often a torch.profiler trace loses kernels as a process ages, for
several layouts of the marker kernels around the window read
(``timing._trace``): one call of a one-kernel function, and two replays
of MNIST's captured MLP training step at batch 32 (chip_smoke.py phase
15d's step). Every round traces each case three times in each layout;
between rounds the step runs eagerly and captured for 15 s, as the
smoke's phases keep the card busy between traces. One JSON line a round
({case: {layout: {"ok" | "none" | "bad": traces}}}), and a total.

    python3 -m paddle_tpu_torch.benchmarks.trace_loss [seconds]
"""

from __future__ import annotations

import collections
import json
import sys
import time

# (leading, trailing) markers: (launches, cycles each); 2e6 cycles spun
# 1.007 ms on an H100
LAYOUTS = {"A_old": ((8, 1000), (0, 0)),
           "B_10ms_both": ((1, 20_000_000), (1, 20_000_000)),
           "C_short_both": ((8, 1000), (8, 1000)),
           "D_10ms_lead": ((1, 20_000_000), (0, 0))}
SEED, BATCH = 1234, 32


def mnist_step(fluid, np, torch, device):
    """(eager call, captured call) of MNIST's MLP training step under
    Adam(1e-3), captured from its second call."""
    from paddle_tpu_torch.models import mnist

    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        model = mnist.get_model(batch_size=BATCH, use_conv=False)
        fluid.optimizer.Adam(1e-3).minimize(model["loss"])
    startup.random_seed = main_prog.random_seed = SEED
    loss = model["loss"]
    feeds = []
    for s in range(4):
        r = np.random.RandomState(SEED + s)
        feeds.append({
            "pixel": torch.from_numpy(r.normal(0, 1, (BATCH, 784))
                                      .astype(np.float32)).to(device),
            "label": torch.from_numpy(r.randint(0, 10, (BATCH, 1))
                                      .astype(np.int64)).to(device)})
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run_steps(main_prog, feeds, 2, [loss])

    def eager():
        with fluid.scope_guard(scope):
            exe.run(main_prog, feed=feeds[0], fetch_list=[loss],
                    use_program_cache=False)

    def captured():
        with fluid.scope_guard(scope):
            exe.run_steps(main_prog, feeds[:1], 1, [loss])

    return eager, captured


def main():
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.benchmarks import timing

    total_s = float(sys.argv[1]) if len(sys.argv) > 1 else 600.0
    device = timing.require_card()
    print(f"card: {timing.card_line()}", flush=True)
    eager, captured = mnist_step(fluid, np, torch, device)
    x = torch.zeros(1024, device=device)
    cases = {"one_add_x1": (lambda: x.add_(1), 1, False),
             "mnist_mlp_captured_x2": (captured, 2, True)}

    def tally():
        return {c: {v: collections.Counter() for v in LAYOUTS}
                for c in cases}

    t0, total = time.perf_counter(), tally()
    while time.perf_counter() - t0 < total_s:
        row = tally()
        for _ in range(3):
            for c, (fn, iters, replay) in cases.items():
                for v, (lead, tail) in LAYOUTS.items():
                    events = timing._trace(fn, iters, lead, tail)
                    bad, _, _ = timing._verdict(events, iters, None, replay)
                    r = "none" if not events else "bad" if bad else "ok"
                    row[c][v][r] += 1
                    total[c][v][r] += 1
        print(json.dumps({"t_s": round(time.perf_counter() - t0, 1),
                          **{c: {v: dict(n) for v, n in d.items()}
                             for c, d in row.items()}}), flush=True)
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 15:
            eager()
            captured()
        torch.cuda.synchronize()
    print("total", json.dumps({c: {v: dict(n) for v, n in d.items()}
                               for c, d in total.items()}), flush=True)


if __name__ == "__main__":
    main()
