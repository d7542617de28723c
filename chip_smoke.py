#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero; no phase is caught):

1. the card: name and power limit (nvidia-smi), torch's device name;
2. build the CUDA kernel from csrc/ and print ptxas' register /
   shared-memory report and the build's seconds (or that it was cached);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and a few more, with stated
   tolerances, and time kernel, plain version and the one PyTorch library
   call that computes the same function (the yardstick, never used by
   the package);
4. serve Transformer-base (base() widths, random weights from a seeded
   generator) through ServingEngine on CUDAPlace(0): 16 requests on 8
   slots, with every kernel's launch count read from that run alone;
   check that two requests decoded alone through an engine of the same
   geometry give the same tokens, and that one request's prefill state
   agrees with the same program run on the CPU;
5. print the kernels' JSON line, the card line, and the result line.

Exits non-zero without a result when CUDA is unavailable or when the
package is not next to this script.
"""

import json
import os
import subprocess
import sys
import time

SEED = 1234
# Tolerances of kernel vs plain version (max abs error). Both sum in f32,
# in different orders; on an H100 out read <= 7.2e-7 in f32 and lse
# <= 4.8e-7 in both dtypes. In bf16 both round out to bf16 once at the
# end, so they may differ by one bf16 ulp of the output: 3.9e-3 read at
# these shapes (|out| in [0.5, 1)); the limit is one ulp below 2.
TOL_OUT = {"float32": 5e-6, "bfloat16": 8e-3}
TOL_LSE = 5e-6  # lse is f32 for every input dtype
# GPU prefill state vs the same program on the CPU (f32; read 3.0e-6)
TOL_STATE = 1e-5
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores; HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters=100, warmup=10):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, match="", iters=20):
    """Device time per call of ``fn`` spent in the kernels whose name
    contains ``match`` (every kernel and copy when empty), from a
    torch.profiler trace; None when the trace holds no such kernel. The
    device's busy time, without the host's launch overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if match in evt.key:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
    return total / iters / 1e3 if total else None


def _attention_case(fa, dtype, b, tq, tk, h, dh, bias_kind, fused, gen):
    """Inputs for one attention comparison: (q, k, v, bias, causal).
    ``fused``: q, k, v are the strided [b, t, h, dh] views of one fused
    [b, t, 3*h*dh] projection, as the encoder's self-attention gives them."""
    import torch

    dev = torch.device("cuda", 0)
    if fused:
        qkv = torch.randn(b, tq, 3 * h * dh, generator=gen, device=dev)
        q, k, v = (x.reshape(b, tq, h, dh)
                   for x in qkv.to(dtype).split(h * dh, dim=-1))
    else:
        q, k, v = (torch.randn(b, t, h, dh, generator=gen,
                               device=dev).to(dtype) for t in (tq, tk, tk))
    causal = bias_kind == "causal"
    bias = None
    if bias_kind == "pad":
        n_real = tk - tk // 8
        mask = (torch.arange(tk, device=dev) < n_real).float()
        bias = ((1.0 - mask) * -1e9)[None, None, None, :]
    return q, k, v, bias, causal


def check_attention_kernel(fa, case, gen):
    """Kernel vs plain version on one case; returns the measurements."""
    import torch
    import torch.nn.functional as F

    name, dtype, b, tq, tk, h, dh, bias_kind, fused = case
    q, k, v, bias, causal = _attention_case(fa, dtype, b, tq, tk, h, dh,
                                            bias_kind, fused, gen)
    scale = 1.0 / dh ** 0.5
    eff_bias = (fa._combined_causal_bias(bias, tq, tk, q.device)
                if causal else bias)
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_out, ref_lse = fa.attention_bthd_plain(q, k, v, eff_bias, scale)
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    dname = str(dtype).split(".")[-1]
    tol = TOL_OUT[dname]
    assert out.shape == q.shape and lse.shape == (b, tq, h, 1), name
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert err_out <= tol and err_lse <= TOL_LSE, (
        f"{name}: kernel vs plain max abs err out={err_out} (tol {tol}) "
        f"lse={err_lse} (tol {TOL_LSE})")

    ms = _time_ms(lambda: fa.flash_attention_bthd_fwd(q, k, v, bias, scale,
                                                      causal))
    plain_ms = _time_ms(lambda: fa.attention_bthd_plain(q, k, v, eff_bias,
                                                        scale))
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    mask = None if eff_bias is None else eff_bias.to(dtype)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale))
    device_ms = _device_ms(
        lambda: fa.flash_attention_bthd_fwd(q, k, v, bias, scale, causal),
        "fwd_kernel")

    # bound: each input read once, each output written once (HBM), and
    # the 4*b*h*tq*tk*dh operations at the input dtype's peak. The causal
    # mask is the wrapper's own, not an input: its bytes are not counted.
    flops = 4.0 * b * h * tq * tk * dh
    nbytes = (q.element_size() * (2 * b * tq * h * dh + 2 * b * tk * h * dh)
              + 4 * b * tq * h
              + (0 if bias is None else 4 * bias.numel()))
    op_ms = flops / PEAK_FLOPS[dname] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "case": name, "dtype": dname,
        "shape": [b, tq, tk, h, dh], "bias": bias_kind,
        "err_out": err_out, "err_lse": err_lse, "tol_out": tol,
        "tol_lse": TOL_LSE,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
    }


def serve(torch, np, fluid, T, fa, serving):
    """Phase 4: Transformer-base through ServingEngine on the card."""
    cfg = T.base()
    dev_place = fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        T.build(cfg, is_test=True)
    startup.random_seed = SEED  # the executor's generator for this seed
    scope = fluid.Scope()
    exe = fluid.Executor(dev_place)
    with fluid.scope_guard(scope):
        exe.run(startup)

    slots, src_len, max_len, n_req, new_tokens = 8, 128, 128, 16, 32
    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, src_len + 1, n_req)
    srcs = [rng.randint(3, cfg.src_vocab_size, n).astype(np.int64)
            for n in lens]

    eng = serving.ServingEngine(cfg, scope, slots=slots, src_len=src_len,
                                max_len=max_len, place=dev_place)
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    handles = [eng.submit(s, max_new_tokens=new_tokens) for s in srcs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_bthd_fwd": fa.launches}
    outcomes = [h.outcome for h in handles]
    assert all(o in ("completed", "length") for o in outcomes), outcomes
    assert launches["flash_attention_bthd_fwd"] >= n_req * cfg.n_layer, launches
    tokens = [list(h.tokens) for h in handles]
    assert all(0 <= t < cfg.trg_vocab_size for ts in tokens for t in ts)
    n_tokens = sum(len(ts) for ts in tokens)
    decode_steps = eng.decode_steps

    # prefill and decode-step device times, measured on the idle engine
    pre, dec = eng._progs["prefill"], eng._progs["decode"]

    def prefill_once(i):
        """One admission of request i into slot i % slots (no fetch)."""
        with fluid.scope_guard(eng.scope):
            eng._exe.run(eng._progs["prefill_program"], feed={
                pre["feeds"][0].name: np.pad(srcs[i], (0, src_len - lens[i]))[None],
                pre["feeds"][1].name: (np.arange(src_len) < lens[i])
                .astype(np.float32)[None],
                pre["feeds"][2].name: np.asarray([i % slots], np.int64)})

    for i in range(slots):
        prefill_once(i)  # every slot live: the decode timing runs full
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(slots):
        prefill_once(i)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) / slots * 1e3
    active = np.ones(slots, bool)

    def decode_once():
        """One decode step over all slots, its tokens fetched (synced)."""
        with fluid.scope_guard(eng.scope):
            eng._exe.run(eng._progs["decode_program"],
                         feed={dec["feeds"][0].name: active},
                         fetch_list=[dec["emit"]])

    t1 = time.perf_counter()
    n_steps = 16
    for _ in range(n_steps):
        decode_once()
    decode_ms = (time.perf_counter() - t1) / n_steps * 1e3
    # device busy time per step/admission: the rest of the wall is host
    decode_device_ms = _device_ms(decode_once, iters=8)
    prefill_device_ms = _device_ms(lambda: prefill_once(0), iters=8)

    # the prefill state against the same program on the CPU (plain path)
    cpu_params = {n: scope.find_var(n).cpu().numpy()
                  for n in scope.var_names()}
    from paddle_tpu_torch import io as tio

    cpu_scope = tio.scope_from_numpy(cpu_params, fluid.CPUPlace())
    for name, (shape, dtype) in eng._progs["state_specs"].items():
        cpu_scope.set(name, np.zeros(shape, np.dtype(dtype)))
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(cpu_scope):
        cpu_exe.run(eng._progs["prefill_program"], feed={
            pre["feeds"][0].name: np.pad(srcs[0], (0, src_len - lens[0]))[None],
            pre["feeds"][1].name: (np.arange(src_len) < lens[0])
            .astype(np.float32)[None],
            pre["feeds"][2].name: np.asarray([0], np.int64)})
    last = cfg.n_layer - 1
    state_err = max(
        float(np.abs(eng.scope.find_var(f"serve_{kind}{last}")[0].cpu().numpy()
                     - cpu_scope.find_var(f"serve_{kind}{last}")[0].numpy()).max())
        for kind in ("ck", "cv"))
    assert state_err <= TOL_STATE, (
        f"prefill state GPU vs CPU max abs err {state_err} > {TOL_STATE}")
    eng.close()

    # two requests decoded alone through an engine of the same geometry
    for i in (0, n_req - 1):
        solo = serving.ServingEngine(cfg, scope, slots=slots, src_len=src_len,
                                     max_len=max_len, place=dev_place)
        h = solo.submit(srcs[i], max_new_tokens=new_tokens)
        solo.run_until_idle()
        solo.close()
        assert list(h.tokens) == tokens[i], (i, list(h.tokens), tokens[i])

    return {
        "requests": n_req, "slots": slots, "src_len": src_len,
        "max_len": max_len, "max_new_tokens": new_tokens,
        "tokens": n_tokens, "decode_steps": decode_steps,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_step_ms": decode_ms, "prefill_ms": prefill_ms,
        "decode_device_ms": decode_device_ms,
        "prefill_device_ms": prefill_device_ms,
        "prefill_state_err": state_err, "launches": launches,
    }


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import numpy as np
        import torch

        import paddle_tpu_torch as fluid
        from paddle_tpu_torch import kernels, serving
        from paddle_tpu_torch.models import transformer as T
        from paddle_tpu_torch.parallel import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              f"repository root", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA device", file=sys.stderr)
        return 3

    # 1. the card
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | device {kind}", flush=True)

    # 2. build the kernel
    built = kernels.build(fa._SOURCE)
    if built is None:
        print(f"build {fa._SOURCE}: cached", flush=True)
    else:
        log, seconds = built
        print(f"build {fa._SOURCE}: {seconds:.2f} s\n{log.strip()}",
              flush=True)

    # 3. kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        # the encoder self-attention of the serving prefill (src_len 128)
        ("prefill f32 pad", torch.float32, 1, 128, 128, 8, 64, "pad", True),
        ("bf16 causal", torch.bfloat16, 8, 256, 256, 8, 64, "causal", False),
        ("cross f32", torch.float32, 2, 64, 128, 8, 64, "pad", False),
        ("ragged f32", torch.float32, 2, 100, 77, 8, 64, "none", False),
        # both head-width instantiations of the kernel (dh <= 64, <= 128)
        ("dh128 f32", torch.float32, 2, 128, 128, 4, 128, "pad", False),
        ("dh32 bf16", torch.bfloat16, 2, 96, 200, 4, 32, "pad", False),
    ]
    results = []
    for case in cases:
        r = check_attention_kernel(fa, case, gen)
        results.append(r)
        print("attention " + json.dumps(r), flush=True)

    # 4. the serving path
    s = serve(torch, np, fluid, T, fa, serving)
    print("serve " + json.dumps(s), flush=True)
    print(f"serving Transformer-base on {card}: {s['tokens_per_s']:.1f} "
          f"tokens/s, decode step {s['decode_step_ms']:.3f} ms "
          f"({s['slots']} slots), prefill {s['prefill_ms']:.3f} ms "
          f"(src_len {s['src_len']})", flush=True)

    main_case = results[0]
    kernels_line = {"kernels": [{
        "name": "flash_attention_bthd_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_bthd_fwd.cu",
        "replaces": "paddle_tpu/parallel/flash_attention.py:808",
        "launches": s["launches"]["flash_attention_bthd_fwd"],
        "max_abs_err": max(main_case["err_out"], main_case["err_lse"]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
