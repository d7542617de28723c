#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero; no phase is caught):

1. the card: name and power limit (nvidia-smi), torch's device name;
2. build every CUDA source in csrc/ (one nvcc per source, all started
   together) and print ptxas' register / shared-memory report and each
   build's seconds (or that it was cached);
3. hold each kernel against its plain PyTorch version on the card, with
   stated tolerances, and time kernel, plain version and the one PyTorch
   library call that computes the same function (the yardstick, never
   used by the package): the attention forward at the serving shapes and,
   with dropout, at the training shapes; the attention backward at the
   training shapes; the dropout-mask dump, bit for bit;
4. serve Transformer-base (base() widths, random weights from a seeded
   generator) through ServingEngine on CUDAPlace(0): 16 requests on 8
   slots, with every kernel's launch count read from that run alone;
   check that two requests decoded alone through an engine of the same
   geometry give the same tokens, and that one request's prefill state
   agrees with the same program run on the CPU;
5. train Transformer-base (full depth, dropout 0.1, label smoothing 0.1,
   Adam 1e-4, bf16 AMP) at batch 64 x seq 256 through Executor.run_steps:
   finite loss every step, lower loss after a few steps on a repeated
   batch, the kernels' launches per step from the timed window alone,
   step wall / device-busy ms, target tokens/s and peak memory;
6. one f32 training step (dropout 0, batch 2, seq 32, full widths) on the
   card against the same step on the CPU: loss and a named set of
   parameter gradients;
7. print the kernels' JSON line, the card line, and the result line.

Exits non-zero without a result when CUDA is unavailable or when the
package is not next to this script.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 1234
# Tolerances of kernel vs plain version (max abs error). Both sum in f32,
# in different orders; on an H100 out read <= 7.2e-7 in f32 and lse
# <= 4.8e-7 in both dtypes. In bf16 both round out to bf16 once at the
# end, so they may differ by one bf16 ulp of the output: 3.9e-3 read at
# these shapes (|out| in [0.5, 1)); the limit is one ulp below 2.
TOL_OUT = {"float32": 5e-6, "bfloat16": 8e-3}
TOL_LSE = 5e-6  # lse is f32 for every input dtype
# Backward kernel vs plain backward, relative to the largest |gradient|
# of the reference: both compute in f32 from the same inputs, in other
# orders (f32: a few ulps of the sums, read <= 1.6e-7 on an H100); in
# bf16 both round dq/dk/dv to bf16 once at the end, so one bf16 ulp
# (2^-8 relative) of the largest element bounds it (read 1.7e-3).
TOL_GRAD_REL = {"float32": 1e-5, "bfloat16": 8e-3}
# GPU prefill state vs the same program on the CPU (f32; read 3.0e-6)
TOL_STATE = 1e-5
# One f32 training step on the card vs on the CPU (phase 6): the loss,
# and each named gradient relative to its largest |element| (the card
# runs the kernels and cuBLAS, the CPU the plain versions and MKL; f32
# sums in other orders through 12 layers). Read on an H100: loss equal,
# gradients within 2.1e-6; the limits are ~10x the reading.
TOL_STEP_LOSS = 2e-5
TOL_STEP_GRAD_REL = 2e-5
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores; HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
# the training shape of bench.py's Transformer-base run
TRAIN_B, TRAIN_T = 64, 256


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


def _device_times(fn, iters):
    """{kernel name: device ms per call of ``fn``} from a torch.profiler
    trace of ``iters`` calls after one untraced call: the device's busy
    time, without the host's launch overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {evt.key: getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
            / iters / 1e3 for evt in prof.key_averages()}


def _device_ms(fn, match="", iters=20):
    """Device time per call of ``fn`` spent in the kernels whose name
    contains ``match`` (every kernel and copy when empty); None when the
    trace holds no such kernel."""
    total = sum(ms for name, ms in _device_times(fn, iters).items()
                if match in name)
    return total or None


def _attention_case(fa, dtype, b, tq, tk, h, dh, bias_kind, fused, gen):
    """Inputs for one attention comparison: (q, k, v, bias, causal).
    ``fused``: q, k, v are the strided [b, t, h, dh] views of one fused
    [b, t, 3*h*dh] projection, as the encoder's self-attention gives them.
    ``bias_kind``: none; pad ([1, 1, 1, tk], the last tk/8 keys padded);
    pad_b ([b, 1, 1, tk], per-row lengths in [tk/2, tk], as make_batch
    pads); causal; causal_pad (causal over pad_b)."""
    import torch

    dev = torch.device("cuda", 0)
    if fused:
        qkv = torch.randn(b, tq, 3 * h * dh, generator=gen, device=dev)
        q, k, v = (x.reshape(b, tq, h, dh)
                   for x in qkv.to(dtype).split(h * dh, dim=-1))
    else:
        q, k, v = (torch.randn(b, t, h, dh, generator=gen,
                               device=dev).to(dtype) for t in (tq, tk, tk))
    causal = bias_kind.startswith("causal")
    bias = None
    if bias_kind == "pad":
        n_real = tk - tk // 8
        mask = (torch.arange(tk, device=dev) < n_real).float()
        bias = ((1.0 - mask) * -1e9)[None, None, None, :]
    elif bias_kind in ("pad_b", "causal_pad"):
        lens = torch.randint(tk // 2, tk + 1, (b, 1), generator=gen,
                             device=dev)
        mask = (torch.arange(tk, device=dev)[None, :] < lens).float()
        bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    return q, k, v, bias, causal


def _bound(flops, nbytes, dname):
    op_ms = flops / PEAK_FLOPS[dname] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms
                                 else "bytes")


def check_attention_kernel(fa, case, gen):
    """Forward kernel vs plain version on one case (with dropout when the
    case's p_drop > 0: the plain version rebuilds the kernel's mask);
    returns the measurements."""
    import torch
    import torch.nn.functional as F

    name, dtype, b, tq, tk, h, dh, bias_kind, fused, p_drop = case
    q, k, v, bias, causal = _attention_case(fa, dtype, b, tq, tk, h, dh,
                                            bias_kind, fused, gen)
    scale = 1.0 / dh ** 0.5
    seed = SEED + 17 if p_drop > 0 else None
    eff_bias = (fa._combined_causal_bias(bias, tq, tk, q.device)
                if causal else bias)

    def kernel():
        return fa.flash_attention_bthd_fwd(q, k, v, bias, scale, causal,
                                           seed=seed, p_drop=p_drop)

    def plain():
        return fa.attention_bthd_plain(q, k, v, eff_bias, scale, seed,
                                       p_drop)

    out, lse = kernel()
    torch.cuda.synchronize()
    ref_out, ref_lse = plain()
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    dname = str(dtype).split(".")[-1]
    tol = TOL_OUT[dname]
    assert out.shape == q.shape and lse.shape == (b, tq, h, 1), name
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert err_out <= tol and err_lse <= TOL_LSE, (
        f"{name}: kernel vs plain max abs err out={err_out} (tol {tol}) "
        f"lse={err_lse} (tol {TOL_LSE})")

    iters = 100 if b * tq * tk <= 1 << 20 else 20
    ms = _time_ms(kernel, iters)
    plain_ms = _time_ms(plain, iters)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    mask = None if eff_bias is None else eff_bias.to(dtype)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, dropout_p=p_drop, scale=scale), iters)
    device_ms = _device_ms(kernel, "fwd_kernel")

    # bound: each input read once, each output written once (HBM), and
    # the 4*b*h*tq*tk*dh operations at the input dtype's peak. The causal
    # mask is the wrapper's own, not an input: its bytes are not counted.
    bound_ms, bound_by = _bound(
        4.0 * b * h * tq * tk * dh,
        q.element_size() * (2 * b * tq * h * dh + 2 * b * tk * h * dh)
        + 4 * b * tq * h + (0 if bias is None else 4 * bias.numel()), dname)
    return {
        "case": name, "dtype": dname, "p_drop": p_drop,
        "shape": [b, tq, tk, h, dh], "bias": bias_kind,
        "err_out": err_out, "err_lse": err_lse, "tol_out": tol,
        "tol_lse": TOL_LSE,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_attention_bwd(fa, case, gen):
    """Backward kernel vs plain backward on one case, both fed the
    kernel forward's (out, lse) and one output gradient; returns the
    measurements."""
    import torch
    import torch.nn.functional as F

    name, dtype, b, tq, tk, h, dh, bias_kind, fused, p_drop = case
    q, k, v, bias, causal = _attention_case(fa, dtype, b, tq, tk, h, dh,
                                            bias_kind, fused, gen)
    scale = 1.0 / dh ** 0.5
    seed = SEED + 29 if p_drop > 0 else None
    eff_bias = (fa._combined_causal_bias(bias, tq, tk, q.device)
                if causal else bias)
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, bias, scale, causal,
                                           seed=seed, p_drop=p_drop)
    g = torch.randn(out.shape, generator=gen, device=out.device).to(dtype)

    def kernel():
        return fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out, lse, g,
                                           scale, p_drop, causal)

    def plain():
        return fa.attention_bthd_bwd_plain(q, k, v, eff_bias, seed, out, lse,
                                           g, scale, p_drop)

    before = fa.bwd_launches
    grads = kernel()
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1, name
    refs = plain()
    dname = str(dtype).split(".")[-1]
    errs, rels = [], []
    for nm, got, ref, x in zip("qkv", grads, refs, (q, k, v)):
        assert got.shape == x.shape and got.dtype == x.dtype, (name, nm)
        assert torch.isfinite(got.float()).all(), (name, nm)
        err = (got.float() - ref.float()).abs().max().item()
        errs.append(err)
        rels.append(err / max(ref.float().abs().max().item(), 1e-30))
    assert max(rels) <= TOL_GRAD_REL[dname], (
        f"{name}: backward kernel vs plain, max abs err dq/dk/dv {errs}, "
        f"relative {rels} (tol {TOL_GRAD_REL[dname]})")

    iters = 100 if b * tq * tk <= 1 << 20 else 20
    ms = _time_ms(kernel, iters)
    plain_ms = _time_ms(plain, iters)
    # library: the backward of F.scaled_dot_product_attention on the same
    # inputs, timed as (forward + backward) - forward
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gh = g.transpose(1, 2)
    mask = None if eff_bias is None else eff_bias.to(dtype)

    def lib_fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              dropout_p=p_drop, scale=scale)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (qh, kh, vh), gh)

    library_ms = _time_ms(lib_fwd_bwd, iters) - _time_ms(lib_fwd, iters)
    device_ms = _device_ms(kernel, "bwd_")

    # bound: 10*b*h*tq*tk*dh operations (5 matrix products); bytes of q,
    # k, v, dout, out, lse, delta, dq, dk, dv and the caller's bias
    bound_ms, bound_by = _bound(
        10.0 * b * h * tq * tk * dh,
        q.element_size() * (4 * b * tq * h * dh + 4 * b * tk * h * dh)
        + 2 * 4 * b * tq * h + (0 if bias is None else 4 * bias.numel()),
        dname)
    return {
        "case": name, "dtype": dname, "p_drop": p_drop,
        "shape": [b, tq, tk, h, dh], "bias": bias_kind,
        "err_dq_dk_dv": errs, "rel_err_dq_dk_dv": rels,
        "tol_rel": TOL_GRAD_REL[dname],
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_mask_dump(fa, b, tq, h, tk, p_drop):
    """The dump kernel's keep mask equals dropout_keep_mask_plain bit for
    bit; its keep rate is within 4 standard deviations of 1 - p."""
    import torch

    dev = torch.device("cuda", 0)
    seed = SEED + 41

    def kernel():
        return fa.dropout_keep_mask(seed, b, h, tq, tk, p_drop, dev)

    def plain():
        return fa.dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop, dev)

    before = fa.mask_launches
    got = kernel()
    torch.cuda.synchronize()
    assert fa.mask_launches == before + 1
    ref = plain().permute(0, 2, 1, 3)
    mismatched = int((got != ref).sum().item())
    assert mismatched == 0, f"mask dump: {mismatched} elements differ"
    n = got.numel()
    keep = (got > 0).float().mean().item()
    sd = (p_drop * (1 - p_drop) / n) ** 0.5
    assert abs(keep - (1 - p_drop)) <= 4 * sd, (keep, 1 - p_drop, sd)
    bound_ms, bound_by = _bound(0.0, 4.0 * n, "float32")
    return {
        "case": "mask dump", "shape": [b, tq, h, tk], "p_drop": p_drop,
        "mismatched": mismatched, "keep_rate": keep,
        "ms": _time_ms(kernel, 20), "device_ms": _device_ms(kernel,
                                                            "mask_kernel"),
        "plain_ms": _time_ms(plain, 20), "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
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


def train(torch, np, fluid, T, fa):
    """Phase 5: train Transformer-base through Executor.run_steps."""
    cfg = T.base()  # dropout 0.1, label smoothing 0.1
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        model = T.build(cfg)
        fluid.optimizer.Adam(1e-4).minimize(model["loss"])
    fluid.amp.enable_amp(main_prog)
    startup.random_seed = main_prog.random_seed = SEED
    loss = model["loss"]
    feeds = [T.make_batch(cfg, TRAIN_B, TRAIN_T, TRAIN_T, seed=SEED + i)
             for i in range(4)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0

        # a repeated batch: the loss of every step, and lower at the end
        repeated = []
        for _ in range(8):
            (value,) = exe.run_steps(main_prog, feeds[:1], 1, [loss])
            repeated.append(float(value))
        assert all(np.isfinite(repeated)), repeated
        assert repeated[-1] < repeated[0], repeated

        # the timed window, rotating over four batches; launch counts
        # from this window alone
        steps = 8
        torch.cuda.synchronize()
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        (value,) = exe.run_steps(main_prog, feeds, steps, [loss])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention_bthd_fwd": fa.launches,
                    "flash_attention_bthd_bwd": fa.bwd_launches}
        # a non-finite loss in any step of the window would have reached
        # the parameters through Adam
        assert np.isfinite(value), value
        assert all(torch.isfinite(scope.find_var(p.name)).all()
                   for p in main_prog.all_parameters()), "non-finite weights"
        per_step = {n: c / steps for n, c in launches.items()}
        # 6 encoder self, 6 decoder self and 6 cross attentions a step
        assert min(per_step.values()) >= 3 * cfg.n_layer, per_step
        times = _device_times(
            lambda: exe.run_steps(main_prog, feeds[:1], 1, [loss]), iters=2)
    device_ms = sum(times.values()) or None
    top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(float(feeds[i % len(feeds)]["trg_pad_mask"].sum())
                 for i in range(steps))
    step_ms = wall / steps * 1e3
    return {
        "batch": TRAIN_B, "seq": TRAIN_T, "amp": True, "dropout": cfg.dropout,
        "startup_s": startup_s, "repeated_batch_losses": repeated,
        "window_steps": steps, "last_loss": float(value),
        "step_ms": step_ms, "step_device_ms": device_ms,
        "idle_share": None if device_ms is None else 1 - device_ms / step_ms,
        "target_tokens_per_s": tokens / wall,
        "peak_mem_gib": peak / 2**30,
        "launches": launches, "launches_per_step": per_step,
        "top_kernels_ms": [[name[:80], ms] for name, ms in top],
    }


def train_vs_cpu(torch, np, fluid, T):
    """Phase 6: one f32 training step (dropout 0, Adam) on the card
    against the same step, from the same state, on the CPU."""
    cfg = T.TransformerConfig(dropout=0.0)  # base() widths, full depth
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        model = T.build(cfg)
        fluid.optimizer.Adam(1e-4).minimize(model["loss"])
    startup.random_seed = SEED
    feed = T.make_batch(cfg, 2, 32, 32, seed=SEED)
    # every kind of attention backward feeds one of these
    last = cfg.n_layer - 1
    names = ["src_emb.w", "trg_emb.w", "proj_colp.w", "enc0_attn_qkv_colp.w",
             f"enc{last}_attn_qkv_colp.w", "dec0_self_q_colp.w",
             f"dec{last}_self_v_colp.w", "dec0_cross_q_colp.w",
             "dec0_cross_k_colp.w", f"dec{last}_cross_v_colp.w",
             "enc_post_ln.scale", "dec_post_ln.scale"]
    fetch = [model["loss"]] + [n + "@GRAD" for n in names]
    gpu_scope = fluid.Scope()
    with fluid.scope_guard(gpu_scope):
        gpu_exe = fluid.Executor(fluid.CUDAPlace(0))
        gpu_exe.run(startup)
        state = {n: gpu_scope.find_var(n).cpu().numpy()
                 for n in gpu_scope.var_names()}
        gpu = gpu_exe.run(main_prog, feed=feed, fetch_list=fetch)
    from paddle_tpu_torch import io as tio

    cpu_scope = tio.scope_from_numpy(state, fluid.CPUPlace())
    with fluid.scope_guard(cpu_scope):
        cpu = fluid.Executor(fluid.CPUPlace()).run(main_prog, feed=feed,
                                                   fetch_list=fetch)
    loss_err = abs(float(gpu[0]) - float(cpu[0]))
    assert loss_err <= TOL_STEP_LOSS, (float(gpu[0]), float(cpu[0]))
    rel = {}
    for n, g, c in zip(names, gpu[1:], cpu[1:]):
        assert g.shape == c.shape and np.isfinite(g).all(), n
        rel[n] = float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
    assert max(rel.values()) <= TOL_STEP_GRAD_REL, rel
    return {"loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
            "loss_err": loss_err, "grad_rel_err": rel}


def _kernel_entry(name, source, replaces, launches, row, err):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel source, one nvcc each, all started together
    sources = [fa._FWD_SOURCE, fa._BWD_SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(kernels.build, sources))
    for source, built in zip(sources, builds):
        if built is None:
            print(f"build {source}: cached", flush=True)
        else:
            log, seconds = built
            print(f"build {source}: {seconds:.2f} s\n{log.strip()}",
                  flush=True)

    # 3. kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    tb, tt = TRAIN_B, TRAIN_T
    # (name, dtype, b, tq, tk, h, dh, bias, fused qkv, p_drop)
    fwd_cases = [
        # the encoder self-attention of the serving prefill (src_len 128),
        # without and with dropout
        ("prefill f32 pad", f32, 1, 128, 128, 8, 64, "pad", True, 0.0),
        ("prefill f32 pad drop", f32, 1, 128, 128, 8, 64, "pad", True, 0.1),
        ("bf16 causal", bf16, 8, 256, 256, 8, 64, "causal", False, 0.0),
        ("cross f32", f32, 2, 64, 128, 8, 64, "pad", False, 0.0),
        ("ragged f32", f32, 2, 100, 77, 8, 64, "none", False, 0.0),
        # both head-width instantiations of the kernel (dh <= 64, <= 128)
        ("dh128 f32", f32, 2, 128, 128, 4, 128, "pad", False, 0.0),
        ("dh32 bf16", bf16, 2, 96, 200, 4, 32, "pad", False, 0.0),
        # the training step's three attentions (encoder self, decoder
        # self, cross), with its dropout
        ("train bf16 pad drop", bf16, tb, tt, tt, 8, 64, "pad_b", True, 0.1),
        ("train bf16 causal+pad drop", bf16, tb, tt, tt, 8, 64,
         "causal_pad", True, 0.1),
        ("train bf16 cross drop", bf16, tb, tt, tt, 8, 64, "pad_b", False,
         0.1),
        ("train f32 pad drop", f32, tb, tt, tt, 8, 64, "pad_b", True, 0.1),
        ("train f32 causal+pad drop", f32, tb, tt, tt, 8, 64, "causal_pad",
         True, 0.1),
        ("train f32 cross drop", f32, tb, tt, tt, 8, 64, "pad_b", False,
         0.1),
    ]
    fwd_results = {}
    for case in fwd_cases:
        r = check_attention_kernel(fa, case, gen)
        fwd_results[r["case"]] = r
        print("attention " + json.dumps(r), flush=True)
    bwd_cases = [c for c in fwd_cases if c[0].startswith("train")] + [
        ("ragged f32", f32, 2, 100, 77, 8, 64, "none", False, 0.0),
        ("dh128 f32 drop", f32, 2, 128, 128, 4, 128, "pad", False, 0.2),
        ("dh32 bf16", bf16, 2, 96, 200, 4, 32, "pad", False, 0.0),
        ("bf16 causal", bf16, 8, 256, 256, 8, 64, "causal", False, 0.0),
    ]
    bwd_results = {}
    for case in bwd_cases:
        r = check_attention_bwd(fa, case, gen)
        bwd_results[r["case"]] = r
        print("attention_bwd " + json.dumps(r), flush=True)
    fa.mask_launches = 0
    mask = check_mask_dump(fa, tb, tt, 8, tt, 0.1)
    mask_launches = fa.mask_launches
    print("mask " + json.dumps(mask), flush=True)

    # 4. the serving path
    s = serve(torch, np, fluid, T, fa, serving)
    print("serve " + json.dumps(s), flush=True)
    print(f"serving Transformer-base on {card}: {s['tokens_per_s']:.1f} "
          f"tokens/s, decode step {s['decode_step_ms']:.3f} ms "
          f"({s['slots']} slots), prefill {s['prefill_ms']:.3f} ms "
          f"(src_len {s['src_len']})", flush=True)

    # 5. the training path
    t = train(torch, np, fluid, T, fa)
    print("train " + json.dumps(t), flush=True)
    print(f"training Transformer-base on {card}: step {t['step_ms']:.1f} ms "
          f"wall, {t['step_device_ms']} ms device busy, "
          f"{t['target_tokens_per_s']:.0f} target tokens/s, peak "
          f"{t['peak_mem_gib']:.2f} GiB", flush=True)

    # 6. one training step on the card against the CPU
    c = train_vs_cpu(torch, np, fluid, T)
    print("train_vs_cpu " + json.dumps(c), flush=True)

    fwd_main = fwd_results["train bf16 pad drop"]
    bwd_main = bwd_results["train bf16 pad drop"]
    kernels_line = {"kernels": [
        _kernel_entry(
            "flash_attention_bthd_fwd",
            "paddle_tpu_torch/csrc/flash_attention_bthd_fwd.cu",
            "paddle_tpu/parallel/flash_attention.py:808",
            s["launches"]["flash_attention_bthd_fwd"]
            + t["launches"]["flash_attention_bthd_fwd"], fwd_main,
            max(fwd_main["err_out"], fwd_main["err_lse"])),
        _kernel_entry(
            "flash_attention_bthd_bwd",
            "paddle_tpu_torch/csrc/flash_attention_bthd_bwd.cu",
            "paddle_tpu/parallel/flash_attention.py:861",
            t["launches"]["flash_attention_bthd_bwd"], bwd_main,
            max(bwd_main["err_dq_dk_dv"])),
        _kernel_entry(
            "dropout_keep_mask",
            "paddle_tpu_torch/csrc/flash_attention_bthd_fwd.cu",
            "tests/test_flash_attention_tpu.py:26",
            mask_launches, mask, 0.0),
    ]}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
