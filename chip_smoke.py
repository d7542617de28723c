#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero; no phase is caught):

1. the card: name and power limit (nvidia-smi), torch's device name;
2. build every CUDA source in csrc/ (five sources, one nvcc each, all
   started together) and print ptxas' register / shared-memory report and
   each build's seconds (or that it was cached);
3. hold each kernel against its plain PyTorch version on the card, with
   stated tolerances, and time kernel, plain version and the one PyTorch
   library call that computes the same function (the yardstick, never
   used by the package), on every route of
   ``flash_attention.attention_route``: the small route (serving and
   t = 256 training shapes), the kblock route (t = 1024, b = 8), the
   bhtd route (t = 4096, b = 2; dropout at t = 2048; BHTD-layout inputs
   with an lse cotangent; the decode step tq = 1 over 1024 keys; each
   backward pass launched and checked on its own), a causal forward and
   backward at t = 8192 whose memory rise shows no [tq, tk] tensor, and
   the dropout-mask dump, bit for bit; then (3c) the three kernel
   studies of paddle_tpu_torch/benchmarks: the combined 1x1-conv backward
   at ResNet-50's three expand-conv shapes (batch 128), the grouped 3x3
   convolution at SE-ResNeXt-50's two c1 shapes, and the attention
   ablation in all four variants at h8/dh64 and two at h4/dh128, each
   against its plain version and timed beside its library call;
4. serve Transformer-base (base() widths, random weights from a seeded
   generator) through ServingEngine on CUDAPlace(0): 16 requests on 8
   slots at src_len = max_len = 128, then (4b) 8 requests on 4 slots at
   src_len = max_len = 1024; every route's launch count read from each
   run alone; two requests decoded alone through an engine of the same
   geometry give the same tokens, and one request's prefill state agrees
   with the same program run on the CPU;
5. train Transformer-base (full depth, dropout 0.1, label smoothing 0.1,
   Adam 1e-4, bf16 AMP) through Executor.run_steps at batch 64 x seq 256
   and (5b) at seq 1024 x batch 8 and seq 4096 x batch 2: finite loss
   every step, lower loss after a few steps on a repeated batch, 18
   forward and 18 backward launches a step of the shape's route and none
   of any other, the step wall / device-busy ms, target tokens/s and peak
   memory;
6. one f32 training step (dropout 0) on the card against the same step
   on the CPU: full widths and depth at batch 2 x seq 32, and (6b) 2+2
   layers at seq 768 (kblock route) and 1280 (bhtd route): loss and a
   named set of parameter gradients;
7. train ResNet-50 and (7b) SE-ResNeXt-50 at ImageNet shape (3 x 224 x
   224, 1000 classes, bf16 AMP, Momentum(0.1, 0.9), batch 128, synthetic
   batches from dataset/imagenet.py staged on the card) through
   Executor.run_steps: finite loss every step, lower loss after the
   repeated-batch steps, moving mean / variance moved off 0 / 1, step
   wall and device-busy ms, images/s, peak memory, device ms by kernel
   family, top device kernels;
   (7c) walk both Programs and count the conv2d ops whose backward and
   forward shapes are the ones phase 3c ran at;
8. one f32 training step (TF32 off) of ResNet-50 and of SE-ResNeXt-50 (a
   head without dropout) at batch 4, 3 x 64 x 64 on the card against the
   same step on the CPU: the loss and the classifier head's gradients
   held, a named set of gradients printed; and the same step in f64,
   which holds every named gradient tightly (the f32 step of a 50-layer
   net at initialization cannot: see TOL_VISION_F32);
9. print the kernels' JSON line, the card line, and the result line.

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
# in different orders; on an H100 out read <= 1.5e-6 in f32 (t up to
# 4096) and lse <= 9.6e-7 in both dtypes. In bf16 both round out to bf16
# once at the end, so they may differ by one bf16 ulp of the output:
# 3.9e-3 read (|out| in [0.5, 1)); the limit is one ulp below 2.
TOL_OUT = {"float32": 5e-6, "bfloat16": 8e-3}
TOL_LSE = 5e-6  # lse is f32 for every input dtype
# Backward kernel vs plain backward, relative to the largest |gradient|
# of the reference: both compute in f32 from the same inputs, in other
# orders (f32: a few ulps of the sums, read <= 3.6e-7 on an H100, t up
# to 4096); in bf16 both round dq/dk/dv to bf16 once at the end, so one
# bf16 ulp (2^-8 relative) of the largest element bounds it (read 1.7e-3).
TOL_GRAD_REL = {"float32": 1e-5, "bfloat16": 8e-3}
# GPU prefill state vs the same program on the CPU (f32 through six
# encoder layers; read 3.1e-6 at src_len 128 and 4.1e-6 at 1024 in most
# runs, and 1.5e-5 at src_len 128 in one run of the unchanged serving
# path, whose library GEMMs and CPU sums may take another order per
# process): 3x the largest reading
TOL_STATE = 5e-5
# One f32 training step on the card vs on the CPU (phase 6): the loss,
# and each named gradient relative to its largest |element| (the card
# runs the kernels and cuBLAS, the CPU the plain versions and MKL; f32
# sums in other orders through 12 layers). Read on an H100: loss equal
# (9.5e-7 at t = 1280, 2+2 layers), gradients within 2.1e-6 at t = 32 and
# 3.5e-6 at t = 768 / 1280; the limits are 6-10x the readings.
TOL_STEP_LOSS = 2e-5
TOL_STEP_GRAD_REL = 2e-5
# the t = 8192 causal call's memory rise over its inputs and outputs
# (a folded f32 [8192, 8192] bias alone would be 256 MiB)
MAX_RISE_MIB = 32
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores; HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
# the training shape of bench.py's Transformer-base run, and its
# long-context rows at constant tokens per step (bench.py:199)
TRAIN_B, TRAIN_T = 64, 256
LONG_TRAIN = ((1024, 8, "kblock"), (4096, 2, "bhtd"))

# Phase 3c, kernel vs plain version (max abs error). Both sum the same
# bf16 products in f32, in other orders, and round the result to bf16
# once, so they differ by at most one bf16 ulp (2^-7 relative) of the
# largest output. Read on an H100: conv1x1 dx 0.25-0.5 at |dx| <= 99-164
# (2.5e-3 to 3.9e-3 of the largest), grouped conv 7.8e-3 at |y| <= 3.3,
# attention ablation 6.1e-5 at |out| <= 0.027: half the limit each.
TOL_BF16_ULP_REL = 2.0 ** -7
# conv1x1 dW (f32, never rounded) relative to its largest element: read
# 1.9e-6 on an H100 (tensor-core f32 accumulation against cuBLAS f32);
# the JAX script asserts 1e-3.
TOL_DW_REL = 1e-5
# the vision training runs (phases 7, 7b): bench_resnet.py's batch,
# optimizer and learning rate
VISION_BATCH = 128
VISION_LR, VISION_MOMENTUM = 0.1, 0.9
# the rate the falling-loss check falls back to (read on an H100:
# ResNet-50 at 0.1 goes 7.46, 5.83, 5.51, 6.30, 7.27, 7.51 on a repeated
# batch; at 0.01 it falls every step, 7.46 to 5.56)
VISION_FALL_LR = 0.01
# One vision training step on the card vs on the CPU (phase 8), TF32 off:
# (loss abs, gradient relative to its largest element). A freshly
# initialized 50-layer batch-normalized ReLU net amplifies a perturbation
# layer by layer: on the CPU alone, a 1e-6 relative change of the images
# moves ResNet-50's early-layer gradients by 2-14% (f32 and f64 alike),
# and the f32 step differs from the f64 step by 2-6%. So the f32 step
# holds the loss (read 3.3e-5 / 6.5e-5 and 3.3e-6 on an H100) and the
# gradients of the classifier head, which depend on the forward pass alone
# (read 1.2e-4 and 2.4e-5), and prints the others (read up to 3.3e-1 for
# ResNet-50, 1.2e-1 for SE-ResNeXt-50). The same step in f64, where
# rounding starts 1e9 times smaller, holds every named gradient tightly
# (read: loss within 1.7e-14, gradients within 4.6e-13).
TOL_VISION_F32 = (5e-4, 2e-3)
TOL_VISION_F64 = (1e-11, 1e-10)

_SRC_FWD = "paddle_tpu_torch/csrc/flash_attention_bthd_fwd.cu"
_SRC_BWD = "paddle_tpu_torch/csrc/flash_attention_bthd_bwd.cu"
_TPU_FA = "paddle_tpu/parallel/flash_attention.py"


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


def _device_ms(fn, match="", iters=20, times=None):
    """Device time per call of ``fn`` spent in the kernels whose name
    contains ``match`` (every kernel and copy when empty); None when the
    trace holds no such kernel. ``times``: a trace already taken."""
    times = _device_times(fn, iters) if times is None else times
    total = sum(ms for name, ms in times.items() if match in name)
    return total or None


def _iters(b, h, tq, tk):
    """Timed calls per measurement: fewer at the long shapes."""
    work = b * h * tq * tk
    return 100 if work <= 1 << 23 else 20 if work <= 1 << 27 else 5


def _case(name, dtype, b, tq, tk, bias, fused=False, p_drop=0.0,
          layout="bthd", h=8, dh=64, split=False, g_lse=False):
    """One kernel comparison. ``bias``: none; pad ([1, 1, 1, tk], the
    last tk/8 keys padded); pad_b ([b, 1, 1, tk], per-row lengths in
    [tk/2, tk], as make_batch pads); causal; causal_pad (causal over
    pad_b). ``fused``: q, k, v are the strided [b, t, h, dh] views of one
    fused [b, t, 3*h*dh] projection, as the encoder's self-attention gives
    them. ``layout="bhtd"``: [b, h, t, dh] inputs through the BHTD
    functions. ``split``: also launch and check the backward's passes one
    at a time. ``g_lse``: a nonzero lse cotangent (BHTD)."""
    return dict(name=name, dtype=dtype, b=b, tq=tq, tk=tk, h=h, dh=dh,
                bias=bias, fused=fused, p_drop=p_drop, layout=layout,
                split=split, g_lse=g_lse)


def _attention_inputs(c, gen):
    """(q, k, v, bias, causal) for a case, on the card."""
    import torch

    dev = torch.device("cuda", 0)
    b, tq, tk, h, dh, dtype = (c[n] for n in ("b", "tq", "tk", "h", "dh",
                                              "dtype"))
    if c["fused"]:
        qkv = torch.randn(b, tq, 3 * h * dh, generator=gen, device=dev)
        q, k, v = (x.reshape(b, tq, h, dh)
                   for x in qkv.to(dtype).split(h * dh, dim=-1))
    else:
        q, k, v = (torch.randn(b, t, h, dh, generator=gen,
                               device=dev).to(dtype) for t in (tq, tk, tk))
    if c["layout"] == "bhtd":
        q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kind = c["bias"]
    bias = None
    if kind == "pad":
        n_real = tk - tk // 8
        mask = (torch.arange(tk, device=dev) < n_real).float()
        bias = ((1.0 - mask) * -1e9)[None, None, None, :]
    elif kind in ("pad_b", "causal_pad"):
        lens = torch.randint(tk // 2, tk + 1, (b, 1), generator=gen,
                             device=dev)
        mask = (torch.arange(tk, device=dev)[None, :] < lens).float()
        bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    return q, k, v, bias, kind.startswith("causal")


def _live(tq, tk, causal):
    """Live score elements per (batch, head): every (row, key) pair, or
    under the causal mask sum over rows of min(row + 1, tk)."""
    if not causal:
        return tq * tk
    n = min(tq, tk)
    return n * (n + 1) // 2 + (tq - n) * tk


def _bound(flops, nbytes, dname):
    op_ms = flops / PEAK_FLOPS[dname] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms
                                 else "bytes")


def _library_mask(fa, bias, causal, tq, tk, dtype, dev):
    """(attn_mask, is_causal) for F.scaled_dot_product_attention."""
    if causal and bias is None:
        return None, True
    if causal:
        return fa._combined_causal_bias(bias, tq, tk, dev).to(dtype), False
    return (None if bias is None else bias.to(dtype)), False


def _fns(fa, c, q, k, v, bias, causal, scale, seed):
    """(kernel forward, plain forward) for a case's layout."""
    p = c["p_drop"]
    if c["layout"] == "bhtd":
        return (lambda: fa.flash_attention_fwd(q, k, v, bias, seed, scale, p,
                                               causal=causal),
                lambda: fa.attention_plain(q, k, v, bias, scale, seed, p,
                                           causal))
    return (lambda: fa.flash_attention_bthd_fwd(q, k, v, bias, scale, causal,
                                                seed=seed, p_drop=p),
            lambda: fa.attention_bthd_plain(q, k, v, bias, scale, seed, p,
                                            causal))


def check_attention_kernel(fa, c, gen):
    """Forward kernel vs plain version on one case (with dropout when
    p_drop > 0: the plain version rebuilds the kernel's mask); returns the
    measurements."""
    import torch
    import torch.nn.functional as F

    b, tq, tk, h, dh = (c[n] for n in ("b", "tq", "tk", "h", "dh"))
    q, k, v, bias, causal = _attention_inputs(c, gen)
    route = fa.attention_route(tq, tk, h, dh, c["layout"])
    scale = 1.0 / dh ** 0.5
    seed = SEED + 17 if c["p_drop"] > 0 else None
    kernel, plain = _fns(fa, c, q, k, v, bias, causal, scale, seed)

    fa.reset_counts()
    out, lse = kernel()
    torch.cuda.synchronize()
    assert fa.launch_counts[(route, "fwd")] == 1, (c["name"], route)
    ref_out, ref_lse = plain()
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    del ref_out, ref_lse
    dname = str(c["dtype"]).split(".")[-1]
    tol = TOL_OUT[dname]
    assert out.shape == q.shape and lse.shape == q.shape[:3] + (1,)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert err_out <= tol and err_lse <= TOL_LSE, (
        f"{c['name']}: kernel vs plain max abs err out={err_out} (tol "
        f"{tol}) lse={err_lse} (tol {TOL_LSE})")

    iters = _iters(b, h, tq, tk)
    ms = _time_ms(kernel, iters, warmup=min(10, iters))
    plain_ms = _time_ms(plain, iters, warmup=2)
    qh, kh, vh = ((q, k, v) if c["layout"] == "bhtd"
                  else (x.transpose(1, 2) for x in (q, k, v)))
    mask, is_causal = _library_mask(fa, bias, causal, tq, tk, c["dtype"],
                                    q.device)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, dropout_p=c["p_drop"],
        is_causal=is_causal, scale=scale), iters, warmup=2)
    del mask
    device_ms = _device_ms(kernel, "fwd_kernel", iters=min(iters, 20))

    # bound: each input read once, each output written once (HBM), and
    # 4*b*h*dh operations per live score at the input dtype's peak. A
    # folded causal mask is the wrapper's own, not an input.
    bound_ms, bound_by = _bound(
        4.0 * b * h * dh * _live(tq, tk, causal),
        q.element_size() * (2 * b * tq * h * dh + 2 * b * tk * h * dh)
        + 4 * b * tq * h + (0 if bias is None else 4 * bias.numel()), dname)
    return {
        "case": c["name"], "route": route, "layout": c["layout"],
        "dtype": dname, "p_drop": c["p_drop"], "shape": [b, tq, tk, h, dh],
        "bias": c["bias"], "err_out": err_out, "err_lse": err_lse,
        "tol_out": tol, "tol_lse": TOL_LSE,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _grad_errs(name, grads, refs, xs):
    import torch

    errs, rels = [], []
    for nm, got, ref, x in zip("qkv", grads, refs, xs):
        assert got.shape == x.shape and got.dtype == x.dtype, (name, nm)
        assert torch.isfinite(got.float()).all(), (name, nm)
        err = (got.float() - ref.float()).abs().max().item()
        errs.append(err)
        rels.append(err / max(ref.float().abs().max().item(), 1e-30))
    return errs, rels


def check_attention_bwd(fa, c, gen):
    """Backward kernel vs plain backward on one case, both fed the
    kernel forward's (out, lse) and one output gradient (and an lse
    cotangent for ``g_lse`` cases); with ``split``, each pass launched
    alone as well (pass A: dk, dv; pass B: dq). Returns the
    measurements."""
    import torch
    import torch.nn.functional as F

    b, tq, tk, h, dh = (c[n] for n in ("b", "tq", "tk", "h", "dh"))
    q, k, v, bias, causal = _attention_inputs(c, gen)
    bhtd = c["layout"] == "bhtd"
    route = fa.attention_route(tq, tk, h, dh, c["layout"])
    scale = 1.0 / dh ** 0.5
    p = c["p_drop"]
    seed = SEED + 29 if p > 0 else None
    out, lse = _fns(fa, c, q, k, v, bias, causal, scale, seed)[0]()
    g = torch.randn(out.shape, generator=gen, device=out.device).to(
        c["dtype"])
    g_lse = (torch.randn(lse.shape, generator=gen, device=out.device)
             if c["g_lse"] else None)

    if bhtd:
        def kernel():
            return fa.flash_attention_bwd(q, k, v, bias, seed, out, lse, g,
                                          scale, p, causal=causal,
                                          g_lse=g_lse)

        def plain():
            return fa.attention_bwd_plain(q, k, v, bias, seed, out, lse, g,
                                          scale, p, causal, g_lse)
    else:
        def kernel():
            return fa.flash_attention_bthd_bwd(q, k, v, bias, seed, out,
                                               lse, g, scale, p, causal)

        def plain():
            return fa.attention_bthd_bwd_plain(q, k, v, bias, seed, out,
                                               lse, g, scale, p, causal)

    fa.reset_counts()
    grads = kernel()
    torch.cuda.synchronize()
    assert fa.launch_counts[(route, "bwd")] == 1, (c["name"], route)
    refs = plain()
    dname = str(c["dtype"]).split(".")[-1]
    errs, rels = _grad_errs(c["name"], grads, refs, (q, k, v))
    tol = TOL_GRAD_REL[dname]
    assert max(rels) <= tol, (
        f"{c['name']}: backward kernel vs plain, max abs err dq/dk/dv "
        f"{errs}, relative {rels} (tol {tol})")

    iters = _iters(b, h, tq, tk)
    ms = _time_ms(kernel, iters, warmup=min(10, iters))
    plain_ms = _time_ms(plain, iters, warmup=2)
    # library: the backward of F.scaled_dot_product_attention on the same
    # inputs, timed as (forward + backward) - forward
    qh, kh, vh = ((x.detach().requires_grad_() for x in (q, k, v)) if bhtd
                  else (x.transpose(1, 2).detach().requires_grad_()
                        for x in (q, k, v)))
    gh = g if bhtd else g.transpose(1, 2)
    mask, is_causal = _library_mask(fa, bias, causal, tq, tk, c["dtype"],
                                    q.device)

    def lib_fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              dropout_p=p,
                                              is_causal=is_causal,
                                              scale=scale)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (qh, kh, vh), gh)

    library_ms = (_time_ms(lib_fwd_bwd, iters, warmup=2)
                  - _time_ms(lib_fwd, iters, warmup=2))
    del mask
    times = _device_times(kernel, min(iters, 20))
    device_ms = _device_ms(None, "bwd_", times=times)

    # bound: 10*b*h*dh operations per live score (5 matrix products);
    # bytes read of q, out, dout, k, v, lse, delta and the caller's bias,
    # and written of dq, dk, dv
    live = _live(tq, tk, causal)
    elt = q.element_size()
    in_bytes = (elt * (3 * b * tq * h * dh + 2 * b * tk * h * dh)
                + 8 * b * tq * h + (0 if bias is None else 4 * bias.numel()))
    bound_ms, bound_by = _bound(
        10.0 * b * h * dh * live,
        in_bytes + elt * (b * tq * h * dh + 2 * b * tk * h * dh), dname)
    row = {
        "case": c["name"], "route": route, "layout": c["layout"],
        "dtype": dname, "p_drop": p, "shape": [b, tq, tk, h, dh],
        "bias": c["bias"], "g_lse": c["g_lse"],
        "err_dq_dk_dv": errs, "rel_err_dq_dk_dv": rels, "tol_rel": tol,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "device_ms_pass_a": _device_ms(None, "bwd_dkdv_kernel", times=times),
        "device_ms_pass_b": _device_ms(None, "bwd_dq_kernel", times=times),
        "device_ms_delta": _device_ms(None, "bwd_delta_kernel", times=times),
    }
    if c["split"]:
        row["passes"] = _check_passes(fa, c, route, q, k, v, bias, seed, out,
                                      lse, g, scale, causal, refs, iters,
                                      plain_ms, in_bytes, live)
    return row


def _check_passes(fa, c, route, q, k, v, bias, seed, out, lse, g, scale,
                  causal, refs, iters, plain_ms, in_bytes, live):
    """Pass A (dk, dv: the counterpart of ``_dkv_kernel``) and pass B (dq:
    ``_dq_kernel``), each launched alone (with the delta pre-pass both
    need), checked against the plain backward and timed. Bounds: 8 and 6
    b*h*dh operations per live score (4 and 3 matrix products); bytes of
    the inputs and of the pass's outputs. No single library call computes
    one pass."""
    import torch

    b, tq, tk, h, dh = (c[n] for n in ("b", "tq", "tk", "h", "dh"))
    dname = str(c["dtype"]).split(".")[-1]
    grads = [torch.zeros_like(x) for x in (q, k, v)]
    rows = {}
    for name, passes, idx, nops, kname in (
            ("pass_a", 1, (1, 2), 8.0, "bwd_dkdv_kernel"),
            ("pass_b", 2, (0,), 6.0, "bwd_dq_kernel")):
        def launch():
            fa._launch_bwd(route, q, k, v, bias, seed, out, lse, g, None,
                           scale, c["p_drop"], causal, *grads,
                           passes=passes)

        for i in idx:
            grads[i].zero_()
        launch()
        torch.cuda.synchronize()
        errs, rels = [], []
        for i in idx:
            ref = refs[i].float()
            err = (grads[i].float() - ref).abs().max().item()
            errs.append(err)
            rels.append(err / max(ref.abs().max().item(), 1e-30))
        assert max(rels) <= TOL_GRAD_REL[dname], (c["name"], name, rels)
        out_bytes = q.element_size() * len(idx) * b * (
            tq if idx == (0,) else tk) * h * dh
        bound_ms, bound_by = _bound(nops * b * h * dh * live,
                                    in_bytes + out_bytes, dname)
        rows[name] = {
            "max_abs_err": max(errs), "rel_err": rels,
            "ms": _time_ms(launch, iters, warmup=min(10, iters)),
            "device_ms": _device_ms(launch, kname, iters=min(iters, 20)),
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    return rows


def check_long_causal_memory(fa, gen):
    """A causal forward and backward at b = 1, t = 8192, bf16 (the bhtd
    route): the rise of max_memory_allocated over inputs and outputs stays
    under MAX_RISE_MIB, so no [tq, tk] tensor exists."""
    import torch

    c = _case("t8192 bf16 causal", torch.bfloat16, 1, 8192, 8192, "causal")
    q, k, v, _, causal = _attention_inputs(c, gen)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.reset_counts()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, None, None, causal)
    grads = fa.flash_attention_bthd_bwd(q, k, v, None, None, out, lse, g,
                                        None, 0.0, causal)
    torch.cuda.synchronize()
    made = sum(t.numel() * t.element_size() for t in (out, lse, *grads))
    rise = (torch.cuda.max_memory_allocated() - base - made) / 2**20
    assert fa.launch_counts[("bhtd", "fwd")] == 1
    assert fa.launch_counts[("bhtd", "bwd")] == 1
    assert all(torch.isfinite(x.float()).all() for x in (out, *grads))
    assert rise < MAX_RISE_MIB, f"t=8192 causal call rose {rise} MiB"
    return {"case": c["name"], "memory_rise_mib": rise,
            "limit_mib": MAX_RISE_MIB,
            "inputs_and_outputs_mib": (made + 4 * q.numel() * 2) / 2**20}


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


def _counts(fa):
    """The routes' launch counts and the dense calls, as JSON keys."""
    out = {f"{r}/{d}": n for (r, d), n in fa.launch_counts.items()}
    out["dense_calls"] = fa.dense_calls
    return out


def serve(torch, np, fluid, T, fa, serving, *, cfg, slots, src_len, max_len,
          n_req, new_tokens, min_len):
    """Phase 4/4b: Transformer-base through ServingEngine on the card."""
    dev_place = fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        T.build(cfg, is_test=True)
    startup.random_seed = SEED  # the executor's generator for this seed
    scope = fluid.Scope()
    exe = fluid.Executor(dev_place)
    with fluid.scope_guard(scope):
        exe.run(startup)

    rng = np.random.RandomState(SEED)
    lens = rng.randint(min_len, src_len + 1, n_req)
    srcs = [rng.randint(3, cfg.src_vocab_size, n).astype(np.int64)
            for n in lens]

    eng = serving.ServingEngine(cfg, scope, slots=slots, src_len=src_len,
                                max_len=max_len, place=dev_place)
    torch.cuda.synchronize()
    fa.reset_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(s, max_new_tokens=new_tokens) for s in srcs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(fa)
    outcomes = [h.outcome for h in handles]
    assert all(o in ("completed", "length") for o in outcomes), outcomes
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
        "max_len": max_len, "max_length": cfg.max_length,
        "source_lengths": [int(min_len), int(src_len)],
        "max_new_tokens": new_tokens, "tokens": n_tokens,
        "decode_steps": decode_steps,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_step_ms": decode_ms, "prefill_ms": prefill_ms,
        "decode_device_ms": decode_device_ms,
        "prefill_device_ms": prefill_device_ms,
        "prefill_state_err": state_err, "launches": launches,
    }


def train(torch, np, fluid, T, fa, *, seq, batch, route, max_length=256,
          repeated=8, window=8):
    """Phase 5/5b: train Transformer-base through Executor.run_steps at
    batch x seq."""
    cfg = T.TransformerConfig(max_length=max_length)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        model = T.build(cfg)  # dropout 0.1, label smoothing 0.1
        fluid.optimizer.Adam(1e-4).minimize(model["loss"])
    fluid.amp.enable_amp(main_prog)
    startup.random_seed = main_prog.random_seed = SEED
    loss = model["loss"]
    feeds = [T.make_batch(cfg, batch, seq, seq, seed=SEED + i)
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
        losses = []
        for _ in range(repeated):
            (value,) = exe.run_steps(main_prog, feeds[:1], 1, [loss])
            losses.append(float(value))
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses

        # the timed window, rotating over four batches; launch counts
        # from this window alone
        torch.cuda.synchronize()
        fa.reset_counts()
        t0 = time.perf_counter()
        (value,) = exe.run_steps(main_prog, feeds, window, [loss])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(fa)
        # a non-finite loss in any step of the window would have reached
        # the parameters through Adam
        assert np.isfinite(value), value
        assert all(torch.isfinite(scope.find_var(p.name)).all()
                   for p in main_prog.all_parameters()), "non-finite weights"
        per_step = {n: c / window for n, c in launches.items()}
        # 6 encoder self, 6 decoder self and 6 cross attentions a step,
        # each one forward and one backward launch on the shape's route
        want = {k: 0.0 for k in per_step}
        want[f"{route}/fwd"] = want[f"{route}/bwd"] = 3.0 * cfg.n_layer
        assert per_step == want, per_step
        times = _device_times(
            lambda: exe.run_steps(main_prog, feeds[:1], 1, [loss]), iters=2)
    device_ms = sum(times.values()) or None
    top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(float(feeds[i % len(feeds)]["trg_pad_mask"].sum())
                 for i in range(window))
    step_ms = wall / window * 1e3
    return {
        "batch": batch, "seq": seq, "route": route,
        "max_length": cfg.max_length, "amp": True, "dropout": cfg.dropout,
        "startup_s": startup_s, "repeated_batch_losses": losses,
        "window_steps": window, "last_loss": float(value),
        "step_ms": step_ms, "step_device_ms": device_ms,
        "idle_share": None if device_ms is None else 1 - device_ms / step_ms,
        "target_tokens_per_s": tokens / wall,
        "peak_mem_gib": peak / 2**30,
        "launches": launches, "launches_per_step": per_step,
        "top_kernels_ms": [[name[:80], ms] for name, ms in top],
    }


def train_vs_cpu(torch, np, fluid, T, fa, *, n_layer, seq, batch,
                 max_length=256):
    """Phase 6/6b: one f32 training step (dropout 0, Adam) on the card
    against the same step, from the same state, on the CPU."""
    cfg = T.TransformerConfig(dropout=0.0, n_layer=n_layer,
                              max_length=max_length)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        model = T.build(cfg)
        fluid.optimizer.Adam(1e-4).minimize(model["loss"])
    startup.random_seed = SEED
    feed = T.make_batch(cfg, batch, seq, seq, seed=SEED)
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
        fa.reset_counts()
        gpu = gpu_exe.run(main_prog, feed=feed, fetch_list=fetch)
        launches = _counts(fa)
    route = fa.attention_route(seq, seq, cfg.n_head, cfg.d_head)
    assert launches[f"{route}/fwd"] == launches[f"{route}/bwd"] \
        == 3 * n_layer and launches["dense_calls"] == 0, launches
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
    return {"n_layer": n_layer, "seq": seq, "batch": batch, "route": route,
            "loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
            "loss_err": loss_err, "grad_rel_err": rel}


def _study_row(name, shape, launch, plain, library, match, err, tol, flops,
               nbytes, iters):
    """Times of one kernel study case: events, profiler, plain version,
    library call (None when there is none), and the bound at the bf16
    tensor-core peak."""
    bound_ms, bound_by = _bound(flops, nbytes, "bfloat16")
    return {
        "case": name, "shape": list(shape), "max_abs_err": err, "tol": tol,
        "ms": _time_ms(launch, iters, warmup=3),
        "device_ms": _device_ms(launch, match, iters=min(iters, 10)),
        "plain_ms": _time_ms(plain, 3, warmup=1),
        "library_ms": (None if library is None
                       else _time_ms(library, iters, warmup=3)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_conv1x1_bwd(cb, n, ci, co):
    """Phase 3c: the combined 1x1-conv backward kernel against its plain
    version at one shape. Bound: x, dy, W read once, dx (bf16) and dW
    (f32) written once; 4*n*ci*co operations."""
    import torch

    x, dy, w = cb.make_inputs(n, ci, co, seed=SEED, device="cuda")
    before = cb.launches
    dx, dw = cb.combined_conv1x1_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert cb.launches == before + 1
    ref_dx, ref_dw = cb.combined_conv1x1_bwd_plain(x, dy, w)
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dw.shape == w.shape and dw.dtype == torch.float32
    assert torch.isfinite(dx.float()).all() and torch.isfinite(dw).all()
    err = (dx.float() - ref_dx.float()).abs().max().item()
    tol = TOL_BF16_ULP_REL * ref_dx.float().abs().max().item()
    dw_rel = ((dw - ref_dw).abs().max() / ref_dw.abs().max()).item()
    assert err <= tol and dw_rel <= TOL_DW_REL, (
        f"conv1x1_bwd {n}x{ci}x{co}: dx err {err} (tol {tol}), dW rel err "
        f"{dw_rel} (tol {TOL_DW_REL})")
    del ref_dx, ref_dw
    row = _study_row(
        f"conv1x1_bwd n{n} ci{ci} co{co}", (n, ci, co),
        lambda: cb.combined_conv1x1_bwd(x, dy, w),
        lambda: cb.combined_conv1x1_bwd_plain(x, dy, w),
        lambda: cb.matmul_pair(x, dy, w), "conv1x1_bwd", err, tol,
        4.0 * n * ci * co,
        2 * (n * ci + n * co + ci * co) + 2 * n * ci + 4 * ci * co, 20)
    row["dw_rel_err"], row["tol_dw_rel"] = dw_rel, TOL_DW_REL
    row["plan_cs_tn_parts_tiles"] = list(cb.plan(
        n, ci, co, torch.cuda.get_device_properties(0).multi_processor_count))
    return row


def check_grouped_conv(gc, tag, n, h, w, c):
    """Phase 3c: the grouped 3x3 convolution kernel against its plain
    version at one shape. Bound: x read once, y written once, the weights
    read once; 2*9*cg operations an output."""
    import torch

    x, wg = gc.make_inputs(n, h, w, c, seed=SEED, device="cuda")
    cg = c // gc.GROUPS
    before = gc.launches
    y = gc.grouped_conv(x, wg, gc.GROUPS)
    torch.cuda.synchronize()
    assert gc.launches == before + 1
    ref = gc.grouped_conv_plain(x, wg, gc.GROUPS)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL_BF16_ULP_REL * ref.float().abs().max().item()
    assert err <= tol, f"grouped_conv {tag}: err {err} (tol {tol})"
    del ref
    return _study_row(
        f"grouped_conv {tag}", (n, h, w, c),
        lambda: gc.grouped_conv(x, wg, gc.GROUPS),
        lambda: gc.grouped_conv_plain(x, wg, gc.GROUPS),
        lambda: gc.conv_ref(x, wg, gc.GROUPS), "grouped_conv", err, tol,
        18.0 * cg * n * h * w * c, 2 * (2 * n * h * w * c + 9 * cg * c), 20)


def check_attn_ablate(aa, name, b, h, t, dh, variant):
    """Phase 3c: one variant of the attention ablation kernel against its
    plain version (bq = t, bk = t as the study runs it). Bound:
    4*b*h*t^2*dh operations; q, k, v read once, out written once. The
    library call exists for the full variant only."""
    import torch
    import torch.nn.functional as F

    q, k, v = aa.make_inputs(b, h, t, dh, seed=SEED, device="cuda")
    fwd = aa.make_fwd(variant, b, h, t, dh, t, t)
    before = aa.launches
    out = fwd(q, k, v)
    torch.cuda.synchronize()
    assert aa.launches == before + 1
    ref = aa.attn_ablate_plain(q, k, v, variant, t)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL_BF16_ULP_REL * ref.float().abs().max().item()
    assert err <= tol, f"attn_ablate {name}/{variant}: err {err} (tol {tol})"
    del ref
    library = ((lambda: F.scaled_dot_product_attention(q, k, v))
               if variant == "full" else None)
    return _study_row(
        f"attn_ablate {name} {variant}", (b, h, t, dh),
        lambda: fwd(q, k, v),
        lambda: aa.attn_ablate_plain(q, k, v, variant, t), library,
        "attn_ablate", err, tol, 4.0 * b * h * t * t * dh,
        2 * 4 * b * h * t * dh, 50)


def _se_resnext_no_dropout(fluid, S, data_shape, class_dim):
    """SE-ResNeXt-50 from the model's public pieces with the head's
    dropout left out (its mask differs between devices), for phase 8."""
    layers = fluid.layers
    img = layers.data("data", shape=list(data_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = S.conv_bn_layer(img, 64, 7, stride=2, act="relu", prefix="stem")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for block, (n, filters) in enumerate(zip([3, 4, 6, 3],
                                             [128, 256, 512, 1024])):
        for i in range(n):
            x = S.bottleneck_block(
                x, filters, stride=2 if i == 0 and block != 0 else 1,
                cardinality=32, reduction_ratio=16, is_test=False,
                prefix=f"b{block}_{i}")
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    pool = layers.reshape(pool, [-1, pool.shape[1]])
    logits = layers.fc(pool, class_dim,
                       param_attr=fluid.ParamAttr(name="fc_out.w"),
                       bias_attr=fluid.ParamAttr(name="fc_out.b"))
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return {"feeds": [img, label], "loss": loss, "logits": logits}


def _build_vision(fluid, build, lr, amp):
    """(main, startup, model); ``model["lr"]`` names the learning-rate
    var the optimizer made."""
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        with fluid.unique_name.guard():
            model = build()
            opt = fluid.optimizer.Momentum(lr, VISION_MOMENTUM)
            opt.minimize(model["loss"])
    if amp:
        fluid.amp.enable_amp(main_prog)
    startup.random_seed = main_prog.random_seed = SEED
    model["lr"] = opt.learning_rate.name
    return main_prog, startup, model


# Device kernels of a vision step by family: the first family with a
# pattern that a kernel's name contains takes it (cuDNN's layout copies
# before the convolutions they serve).
_KERNEL_FAMILIES = (
    ("layout copies (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("pooling", ("pool",)),
    ("convolution and matmul (cuDNN, cuBLAS)",
     ("cudnn", "cutlass", "xmma", "gemm", "gemv", "nvjet", "conv", "wgrad",
      "dgrad", "sm90", "sm80")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset")),
)


def _kernel_families(times):
    """{family: device ms a step} of a {kernel name: ms} trace."""
    out = {family: 0.0 for family, _ in _KERNEL_FAMILIES}
    out["other"] = 0.0
    for kernel, ms in times.items():
        out[next((family for family, patterns in _KERNEL_FAMILIES
                  if any(p in kernel for p in patterns)), "other")] += ms
    return out


def train_vision(torch, np, fluid, imagenet, name, build, *, batch, lr,
                 fall_lr, repeated=6, window=6):
    """Phases 7/7b: train one vision model at ImageNet shape through
    Executor.run_steps (bf16 AMP, Momentum). The synthetic batches are
    made on the host from a seed and staged on the card once, so a step's
    wall time holds no host-to-device copy of the images. The loss must
    fall over ``repeated`` steps on one batch at ``lr``; where it does not
    (momentum 0.9 at rate 0.1 overshoots on a single repeated batch), what
    was read is kept in the row and the check is held from a fresh start
    at ``fall_lr``. The timed window runs at ``lr``."""
    main_prog, startup, model = _build_vision(fluid, build, lr, amp=True)
    loss = model["loss"]
    dev = torch.device("cuda", 0)
    feeds = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
             for f in imagenet.batched(batch, 3, seed=SEED)()]
    bn = next(op for op in main_prog.global_block().ops
              if op.type == "batch_norm")
    mean_name, var_name = bn.inputs["Mean"][0], bn.inputs["Variance"][0]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fluid.scope_guard(scope):
        def repeat(rate):
            """Losses of ``repeated`` steps on one batch from a fresh
            start at learning rate ``rate``."""
            exe.run(startup)
            assert float(scope.find_var(mean_name).abs().max()) == 0.0
            assert float((scope.find_var(var_name) - 1).abs().max()) == 0.0
            scope.set(model["lr"], torch.full((1,), rate, device=dev))
            out = []
            for _ in range(repeated):
                (value,) = exe.run_steps(main_prog, feeds[:1], 1, [loss])
                out.append(float(value))
            assert all(np.isfinite(out)), (name, rate, out)
            return out

        losses = {str(lr): repeat(lr)}
        if not losses[str(lr)][-1] < losses[str(lr)][0]:
            print(f"train_{name}: the loss did not fall at lr {lr}: "
                  f"{losses[str(lr)]}; holding the check at lr {fall_lr}",
                  flush=True)
            losses[str(fall_lr)] = repeat(fall_lr)
            assert losses[str(fall_lr)][-1] < losses[str(fall_lr)][0], (
                name, losses)
            scope.set(model["lr"], torch.full((1,), lr, device=dev))
        moved = {
            "moving_mean_max_abs": float(scope.find_var(mean_name).abs()
                                         .max()),
            "moving_var_max_dev": float((scope.find_var(var_name) - 1).abs()
                                        .max())}
        assert min(moved.values()) > 0.0, (name, moved)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (value, acc) = exe.run_steps(main_prog, feeds, window,
                                     [loss, model["acc"]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert np.isfinite(value), (name, value)
        assert all(torch.isfinite(scope.find_var(p.name)).all()
                   for p in main_prog.all_parameters()), "non-finite weights"
        times = _device_times(
            lambda: exe.run_steps(main_prog, feeds[:1], 1, [loss]), iters=2)
    device_ms = sum(times.values()) or None
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    step_ms = wall / window * 1e3
    ops = main_prog.global_block().ops
    return main_prog, {
        "model": name, "batch": batch, "image": [3, 224, 224],
        "classes": 1000, "amp": True, "lr": lr, "momentum": VISION_MOMENTUM,
        "ops_per_step": len(ops),
        "repeated_batch_losses": losses, "window_steps": window,
        "last_loss": float(value), "last_acc": float(acc), **moved,
        "step_ms": step_ms, "step_device_ms": device_ms,
        "idle_share": None if device_ms is None else 1 - device_ms / step_ms,
        "images_per_s": batch * window / wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "device_ms_by_family": _kernel_families(times),
        "top_kernels_ms": [[k[:80], ms] for k, ms in top],
    }


def _conv_ops(program, batch):
    """(filter shape, input shape, output shape, attrs) of every conv2d op
    of a Program, with the batch dim filled in."""
    block = program.global_block()
    for op in block.ops:
        if op.type != "conv2d":
            continue
        shapes = [tuple(batch if d == -1 else d for d in block.var(n).shape)
                  for n in (op.inputs["Filter"][0], op.inputs["Input"][0],
                            op.outputs["Output"][0])]
        yield (*shapes, op.attrs)


def live_shapes(resnet_prog, se_prog, batch, conv_shapes, gconv_shapes):
    """Phase 7c: how many conv2d ops a step of each trained Program have
    the shapes the kernel studies ran at. A 1x1, stride-1, ungrouped conv
    over [N, ci, H, W] has the backward (N*H*W, ci, co); a 3x3, stride-1
    conv with 32 groups and as many output as input channels has the
    forward (N, H, W, C). Fails when a studied shape is live in neither."""
    counts = {}
    for n, ci, co in conv_shapes:
        counts[f"conv1x1_bwd {n}x{ci}x{co}"] = sum(
            1 for f, i, o, a in _conv_ops(resnet_prog, batch)
            if f[2:] == (1, 1) and a["strides"] == [1, 1]
            and a["groups"] == 1
            and (i[0] * i[2] * i[3], i[1], o[1]) == (n, ci, co))
    for tag, n, h, w, c in gconv_shapes:
        counts[f"grouped_conv {tag} {n}x{h}x{w}x{c}"] = sum(
            1 for f, i, o, a in _conv_ops(se_prog, batch)
            if f[2:] == (3, 3) and a["strides"] == [1, 1]
            and a["groups"] == 32 and a["paddings"] == [1, 1]
            and (i[0], i[2], i[3], i[1]) == (n, h, w, c) and o[1] == c)
    assert all(v > 0 for v in counts.values()), counts
    return counts


def vision_vs_cpu(torch, np, fluid, name, build, names, head, *, double,
                  batch=4, image=64, classes=1000):
    """Phase 8: one training step (TF32 off, Momentum) of a vision model
    on the card against the same step, from the same state and batch, on
    the CPU: the loss and the named gradients, each relative to its
    largest element. ``double``: state and images cast to float64 (every
    op of the path follows its inputs' dtype), and every named gradient is
    held; in f32 only those of ``head`` (the classifier's) are."""
    main_prog, startup, model = _build_vision(fluid, build, VISION_LR,
                                              amp=False)
    rng = np.random.RandomState(SEED)
    wide = np.float64 if double else np.float32
    feed = {"data": rng.uniform(-1, 1, (batch, 3, image, image)).astype(wide),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}
    fetch = [model["loss"]] + [n + "@GRAD" for n in names]
    from paddle_tpu_torch import io as tio

    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    state = {n: scope.find_var(n).cpu().numpy() for n in scope.var_names()}
    state = {n: v.astype(wide) if v.dtype == np.float32 else v
             for n, v in state.items()}
    results = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        with fluid.scope_guard(tio.scope_from_numpy(state, place)):
            results.append(fluid.Executor(place).run(main_prog, feed=feed,
                                                     fetch_list=fetch))
    gpu, cpu = results
    assert gpu[1].dtype == wide, gpu[1].dtype
    loss_err = abs(float(gpu[0]) - float(cpu[0]))
    rel = {}
    for n, g, c in zip(names, gpu[1:], cpu[1:]):
        assert g.shape == c.shape and np.isfinite(g).all(), n
        rel[n] = float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
    tol_loss, tol_grad = TOL_VISION_F64 if double else TOL_VISION_F32
    row = {"model": name, "dtype": np.dtype(wide).name, "batch": batch,
           "image": image, "loss_gpu": float(gpu[0]),
           "loss_cpu": float(cpu[0]), "loss_err": loss_err,
           "grad_rel_err": rel, "tol_loss": tol_loss,
           "tol_grad_rel": tol_grad,
           "grads_held": list(names if double else head)}
    held = names if double else head
    assert loss_err <= tol_loss and max(rel[n] for n in held) <= tol_grad, row
    return row


def _study_entry(name, source, replaces, launches, first, rows):
    """A kernels-line entry for a kernel study: the times of the case
    ``first``, the largest error over all its cases ``rows``."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]}


def _kernel_entry(name, source, replaces, launches, row, err):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def _phase3_cases(torch):
    f32, bf16 = torch.float32, torch.bfloat16
    tb, tt = TRAIN_B, TRAIN_T
    fwd = [
        # the encoder self-attention of the serving prefill (src_len 128),
        # without and with dropout
        _case("prefill f32 pad", f32, 1, 128, 128, "pad", True),
        _case("prefill f32 pad drop", f32, 1, 128, 128, "pad", True, 0.1),
        _case("bf16 causal", bf16, 8, 256, 256, "causal"),
        _case("cross f32", f32, 2, 64, 128, "pad"),
        _case("ragged f32", f32, 2, 100, 77, "none"),
        # both head-width instantiations of the kernel (dh <= 64, <= 128)
        _case("dh128 f32", f32, 2, 128, 128, "pad", h=4, dh=128),
        _case("dh32 bf16", bf16, 2, 96, 200, "pad", h=4, dh=32),
        # the training step's three attentions (encoder self, decoder
        # self, cross), with its dropout
        _case("train bf16 pad drop", bf16, tb, tt, tt, "pad_b", True, 0.1),
        _case("train bf16 causal+pad drop", bf16, tb, tt, tt, "causal_pad",
              True, 0.1),
        _case("train bf16 cross drop", bf16, tb, tt, tt, "pad_b", False,
              0.1),
        _case("train f32 pad drop", f32, tb, tt, tt, "pad_b", True, 0.1),
        _case("train f32 causal+pad drop", f32, tb, tt, tt, "causal_pad",
              True, 0.1),
        _case("train f32 cross drop", f32, tb, tt, tt, "pad_b", False, 0.1),
    ]
    # the kblock route: the t = 1024 training row's three attentions and
    # the prefill at src_len 1024
    for dname, dt in (("bf16", bf16), ("f32", f32)):
        fwd += [
            _case(f"t1024 {dname} pad drop", dt, 8, 1024, 1024, "pad_b",
                  True, 0.1),
            _case(f"t1024 {dname} causal+pad drop", dt, 8, 1024, 1024,
                  "causal_pad", True, 0.1),
            _case(f"t1024 {dname} cross drop", dt, 8, 1024, 1024, "pad_b",
                  False, 0.1),
        ]
    # the bhtd route: the t = 4096 training row (decoder self with and
    # without its causal mask), dropout at t = 2048, BHTD-layout inputs,
    # and the serving decode step over 1024 keys
    fwd += [
        _case("t4096 bf16 causal+pad", bf16, 2, 4096, 4096, "causal_pad",
              True, split=True),
        _case("t4096 bf16 pad", bf16, 2, 4096, 4096, "pad_b", True,
              split=True),
        _case("t2048 bf16 causal+pad drop", bf16, 1, 2048, 2048,
              "causal_pad", True, 0.1),
        _case("bhtd layout f32 causal g_lse", f32, 2, 1024, 1024,
              "causal_pad", layout="bhtd", g_lse=True),
        _case("decode f32 tq1 tk1024", f32, 4, 1, 1024, "pad_b"),
    ]
    bwd = [c for c in fwd if c["name"].startswith(("train", "t1024",
                                                   "t4096", "t2048",
                                                   "bhtd"))] + [
        _case("ragged f32", f32, 2, 100, 77, "none"),
        _case("dh128 f32 drop", f32, 2, 128, 128, "pad", p_drop=0.2, h=4,
              dh=128),
        _case("dh32 bf16", bf16, 2, 96, 200, "pad", h=4, dh=32),
        _case("bf16 causal", bf16, 8, 256, 256, "causal"),
    ]
    return fwd, bwd


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import numpy as np
        import torch

        import paddle_tpu_torch as fluid
        from paddle_tpu_torch import kernels, serving
        from paddle_tpu_torch.benchmarks import attn_ablate as aa
        from paddle_tpu_torch.benchmarks import conv_bwd as cb
        from paddle_tpu_torch.benchmarks import grouped_conv as gc
        from paddle_tpu_torch.dataset import imagenet
        from paddle_tpu_torch.models import resnet as R
        from paddle_tpu_torch.models import se_resnext as S
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
    sources = [fa._FWD_SOURCE, fa._BWD_SOURCE, cb.SOURCE, gc.SOURCE,
               aa.SOURCE]
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
    fwd_cases, bwd_cases = _phase3_cases(torch)
    fwd_results = {}
    for case in fwd_cases:
        r = check_attention_kernel(fa, case, gen)
        fwd_results[r["case"]] = r
        print("attention " + json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    bwd_results = {}
    for case in bwd_cases:
        r = check_attention_bwd(fa, case, gen)
        bwd_results[r["case"]] = r
        print("attention_bwd " + json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    mem = check_long_causal_memory(fa, gen)
    print("memory " + json.dumps(mem), flush=True)
    fa.reset_counts()
    mask = check_mask_dump(fa, TRAIN_B, TRAIN_T, 8, TRAIN_T, 0.1)
    mask_launches = fa.mask_launches
    print("mask " + json.dumps(mask), flush=True)
    # the causal skip: causal / non-causal device time at t = 4096
    c_f, n_f = (fwd_results[f"t4096 bf16 {k}"] for k in ("causal+pad", "pad"))
    c_b, n_b = (bwd_results[f"t4096 bf16 {k}"] for k in ("causal+pad", "pad"))
    skip = {"fwd": c_f["device_ms"] / n_f["device_ms"],
            "pass_a": c_b["device_ms_pass_a"] / n_b["device_ms_pass_a"],
            "pass_b": c_b["device_ms_pass_b"] / n_b["device_ms_pass_b"]}
    print("causal_skip " + json.dumps(skip), flush=True)

    # 3c. the kernel studies against their plain versions, then each
    # study's own entry point with its launch count read from that run
    conv_rows = [check_conv1x1_bwd(cb, *shape) for shape in cb.SHAPES]
    gconv_rows = [check_grouped_conv(gc, *shape) for shape in gc.SHAPES]
    ablate_rows = [check_attn_ablate(aa, name, 64, h, 256, dh, variant)
                   for name, (h, dh), variants in aa.head_shapes()
                   for variant in variants]
    for r in conv_rows + gconv_rows + ablate_rows:
        print("study " + json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    cb.launches = gc.launches = aa.launches = 0
    for study in (cb, gc, aa):
        study.main()
    study_launches = {"conv_bwd": cb.launches, "grouped_conv": gc.launches,
                      "attn_ablate": aa.launches}
    assert min(study_launches.values()) > 0, study_launches
    print("study_launches " + json.dumps(study_launches), flush=True)
    torch.cuda.empty_cache()

    # 4. the serving path, at src_len 128 and (4b) 1024
    s = serve(torch, np, fluid, T, fa, serving, cfg=T.base(), slots=8,
              src_len=128, max_len=128, n_req=16, new_tokens=32, min_len=16)
    assert s["launches"]["small/fwd"] >= 16 * 6, s["launches"]
    print("serve " + json.dumps(s), flush=True)
    print(f"serving Transformer-base on {card}: {s['tokens_per_s']:.1f} "
          f"tokens/s, decode step {s['decode_step_ms']:.3f} ms "
          f"({s['slots']} slots), prefill {s['prefill_ms']:.3f} ms "
          f"(src_len {s['src_len']})", flush=True)
    long_cfg = T.TransformerConfig(max_length=1026)
    sl = serve(torch, np, fluid, T, fa, serving, cfg=long_cfg, slots=4,
               src_len=1024, max_len=1024, n_req=8, new_tokens=16,
               min_len=513)
    n_layer = long_cfg.n_layer
    # each prefill runs the encoder's self-attention on the kblock route;
    # every decode step runs its self and cross attentions on the bhtd
    # route (tq = 1 over 1024 keys); nothing else launches or runs dense
    want = {k: 0 for k in sl["launches"]}
    want["kblock/fwd"] = 8 * n_layer
    want["bhtd/fwd"] = 2 * n_layer * sl["decode_steps"]
    assert sl["launches"] == want, (sl["launches"], want)
    print("serve_long " + json.dumps(sl), flush=True)

    # 5. the training path, at t = 256 and (5b) the long-context rows
    t = train(torch, np, fluid, T, fa, seq=TRAIN_T, batch=TRAIN_B,
              route="small")
    print("train " + json.dumps(t), flush=True)
    print(f"training Transformer-base on {card}: step {t['step_ms']:.1f} ms "
          f"wall, {t['step_device_ms']} ms device busy, "
          f"{t['target_tokens_per_s']:.0f} target tokens/s, peak "
          f"{t['peak_mem_gib']:.2f} GiB", flush=True)
    long_train = {}
    for seq, batch, route in LONG_TRAIN:
        # max_length = seq + 2, as bench.py sets it
        r = train(torch, np, fluid, T, fa, seq=seq, batch=batch,
                  route=route, max_length=seq + 2, repeated=4, window=3)
        long_train[seq] = r
        print(f"train_t{seq} " + json.dumps(r), flush=True)
        torch.cuda.empty_cache()

    # 6. one training step on the card against the CPU
    c = train_vs_cpu(torch, np, fluid, T, fa, n_layer=6, seq=32, batch=2)
    print("train_vs_cpu " + json.dumps(c), flush=True)
    for seq in (768, 1280):
        c6 = train_vs_cpu(torch, np, fluid, T, fa, n_layer=2, seq=seq,
                          batch=1, max_length=seq + 2)
        print(f"train_vs_cpu_t{seq} " + json.dumps(c6), flush=True)

    # 7. the vision training path: ResNet-50, (7b) SE-ResNeXt-50, and
    # (7c) the studied shapes among their conv2d ops
    shape = dict(data_shape=(3, 224, 224), class_dim=1000, depth=50)
    vision_progs = {}
    for name, build in (("resnet50", lambda: R.get_model(**shape)),
                        ("se_resnext50", lambda: S.get_model(**shape))):
        vision_progs[name], v = train_vision(
            torch, np, fluid, imagenet, name, build, batch=VISION_BATCH,
            lr=VISION_LR, fall_lr=VISION_FALL_LR)
        print(f"train_{name} " + json.dumps(v), flush=True)
        print(f"training {name} on {card}: step {v['step_ms']:.1f} ms wall, "
              f"{v['step_device_ms']} ms device busy, "
              f"{v['images_per_s']:.0f} images/s, peak "
              f"{v['peak_mem_gib']:.2f} GiB", flush=True)
        torch.cuda.empty_cache()
    live = live_shapes(vision_progs["resnet50"], vision_progs["se_resnext50"],
                       VISION_BATCH, cb.SHAPES, gc.SHAPES)
    print("live_shapes " + json.dumps(live), flush=True)
    del vision_progs

    # 8. one f32 vision training step on the card against the CPU
    small = dict(data_shape=(3, 64, 64), class_dim=1000)
    for name, build, names, head in (
            ("resnet50", lambda: R.get_model(depth=50, **small),
             ["conv2d_0.w_0", "conv2d_1.w_0", "conv2d_3.w_0",
              "conv2d_26.w_0", "conv2d_52.w_0", "batch_norm_0.w_0",
              "batch_norm_52.b_0", "fc_0.w_0", "fc_0.b_0"],
             ["fc_0.w_0", "fc_0.b_0"]),
            ("se_resnext50 (no dropout)",
             lambda: _se_resnext_no_dropout(fluid, S, **small),
             ["stem_conv.w", "b0_0_c1_conv.w", "b0_0_se_sqz.w",
              "b0_0_se_exc.b", "b1_0_sc_conv.w", "b2_3_c1_conv.w",
              "b3_2_c2_conv.w", "stem_bn.scale", "b3_2_c2_bn.offset",
              "fc_out.w", "fc_out.b"], ["fc_out.w", "fc_out.b"])):
        for double in (False, True):
            c8 = vision_vs_cpu(torch, np, fluid, name, build, names, head,
                               double=double)
            print("vision_vs_cpu " + json.dumps(c8), flush=True)
        torch.cuda.empty_cache()

    t1k, t4k = long_train[1024], long_train[4096]
    fwd_main = fwd_results["train bf16 pad drop"]
    bwd_main = bwd_results["train bf16 pad drop"]
    kb_fwd, kb_bwd = (fwd_results["t1024 bf16 pad drop"],
                      bwd_results["t1024 bf16 pad drop"])
    bh_fwd = fwd_results["t4096 bf16 causal+pad"]
    passes = bwd_results["t4096 bf16 causal+pad"]["passes"]
    kernels_line = {"kernels": [
        _kernel_entry(
            "flash_attention_bthd_fwd", _SRC_FWD, f"{_TPU_FA}:808",
            s["launches"]["small/fwd"] + t["launches"]["small/fwd"],
            fwd_main, max(fwd_main["err_out"], fwd_main["err_lse"])),
        _kernel_entry(
            "flash_attention_bthd_bwd", _SRC_BWD, f"{_TPU_FA}:861",
            t["launches"]["small/bwd"], bwd_main,
            max(bwd_main["err_dq_dk_dv"])),
        _kernel_entry(
            "dropout_keep_mask", _SRC_FWD,
            "tests/test_flash_attention_tpu.py:26", mask_launches, mask,
            0.0),
        _kernel_entry(
            "flash_attention_fwd (bhtd route, causal)", _SRC_FWD,
            f"{_TPU_FA}:126",
            t4k["launches"]["bhtd/fwd"] + sl["launches"]["bhtd/fwd"],
            bh_fwd, max(bh_fwd["err_out"], bh_fwd["err_lse"])),
        _kernel_entry(
            "flash_attention_bwd pass B, dq (bhtd route, causal)", _SRC_BWD,
            f"{_TPU_FA}:181", t4k["launches"]["bhtd/bwd"],
            passes["pass_b"], passes["pass_b"]["max_abs_err"]),
        _kernel_entry(
            "flash_attention_bwd pass A, dk/dv (bhtd route, causal)",
            _SRC_BWD, f"{_TPU_FA}:233", t4k["launches"]["bhtd/bwd"],
            passes["pass_a"], passes["pass_a"]["max_abs_err"]),
        _kernel_entry(
            "flash_attention_bthd_fwd (kblock route)", _SRC_FWD,
            f"{_TPU_FA}:964",
            t1k["launches"]["kblock/fwd"] + sl["launches"]["kblock/fwd"],
            kb_fwd, max(kb_fwd["err_out"], kb_fwd["err_lse"])),
        _kernel_entry(
            "flash_attention_bthd_bwd (kblock route)", _SRC_BWD,
            f"{_TPU_FA}:1028", t1k["launches"]["kblock/bwd"], kb_bwd,
            max(kb_bwd["err_dq_dk_dv"])),
        _study_entry(
            "attn_ablate make_fwd (four variants)",
            "paddle_tpu_torch/csrc/attn_ablate.cu",
            "benchmarks/attn_ablate.py:41", study_launches["attn_ablate"],
            next(r for r in ablate_rows if r["library_ms"] is not None),
            ablate_rows),
        _study_entry(
            "combined_conv1x1_bwd", "paddle_tpu_torch/csrc/conv1x1_bwd.cu",
            "benchmarks/conv_bwd_pallas.py:80", study_launches["conv_bwd"],
            conv_rows[0], conv_rows),
        _study_entry(
            "grouped_conv", "paddle_tpu_torch/csrc/grouped_conv.cu",
            "benchmarks/grouped_conv_pallas.py:42",
            study_launches["grouped_conv"], gconv_rows[0], gconv_rows),
    ]}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
