#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero; no phase is caught):

1. the card: name and power limit (nvidia-smi), torch's device name;
2. build every CUDA source in csrc/ (six sources, one nvcc each, all
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
   backward pass launched and checked on its own; bf16 rows read the
   tensor-core kernels, f32 forward rows the CUDA-core ones and f32
   backward rows the 3xTF32 tensor-core ones, and no other kernel; two
   launches give equal bits in both dtypes; dh = 256, the widest head the
   kernels take, on the small and kblock routes, with no dense call; the
   library's backward timed alone, after one forward, by events and from
   the trace, with the names of its kernels; each bound on the dtype's
   fastest route, f32 on the CUDA cores or in 3xTF32), a
   causal forward and backward at t = 8192 whose memory rise shows no
   [tq, tk] tensor, and the dropout-mask dump, bit for bit, beside the
   device time of a fill of the same bytes; then (3c) the three kernel
   studies of paddle_tpu_torch/benchmarks: the combined 1x1-conv backward
   at ResNet-50's three expand-conv shapes (batch 128), the grouped 3x3
   convolution at SE-ResNeXt-50's four stride-1 c1 shapes (4, 8, 16 and
   32 channels a group), and the attention ablation in all four variants
   at h8/dh64 and two at h4/dh128, each against its plain version and
   timed beside its library call (by events, and from the trace with the
   library's kernel names); and the dropout op's kernel
   (dropout_apply_kernel) against its plain version bit for bit at the
   t = 256 step's activation shape in bf16 and f32, beside F.dropout;
4. serve Transformer-base (base() widths, random weights from a seeded
   generator) through ServingEngine on CUDAPlace(0): 16 requests on 8
   slots at src_len = max_len = 128, then (4b) 8 requests on 4 slots at
   src_len = max_len = 1024; every route's launch count read from each
   run alone; two requests decoded alone through an engine of the same
   geometry give the same tokens, and one request's prefill state agrees
   with the same program run on the CPU; in turns (eager, captured,
   captured, eager), each engine running its programs eagerly or as
   captured CUDA graphs, with the same greedy tokens and launch counts;
   every decode step's fetches come back as ``LazyFetches``, and an
   engine whose fetches are read at once gives the same tokens and
   launch counts;
5. train Transformer-base (full depth, dropout 0.1, label smoothing 0.1,
   Adam 1e-4, bf16 AMP) through Executor.run_steps at batch 64 x seq 256
   and (5b) at seq 1024 x batch 8 and seq 4096 x batch 2: finite loss
   every step, lower loss after a few steps on a repeated batch, 18
   forward and 18 backward launches a step of the shape's route and none
   of any other, the step wall / device-busy ms, target tokens/s and peak
   memory, the device ms a step of the forward kernel and of the two
   backward passes; (5c) the batch 64 x seq 256 step again in f32, without
   AMP (the framework's default): the attention backward on the 3xTF32
   kernels. First, nine t = 256 steps from one startup, two eager
   sequences and one through the captured step, at dropout 0 and 0.1:
   the captured losses, masks and final state may differ from the eager
   ones by no more than the two eager sequences differ (they read equal
   bits); every row timed in turns, eager (uncached runs) and captured
   (CUDA graph replays), launches a step from the replay counters and,
   by kernel name, from the trace of a replayed step (the dropout
   kernel's too), and the share of an eager step's device time spent
   re-running forwards inside derived grad ops; (5d) the training recipe
   at batch 64 x seq 256: AdamW under amp.decorate's dynamic loss
   scaling with a global-norm clip (``train_recipe``): nine steps
   captured equal to eager ones bit for bit, loss-scaling state
   included, the scale grown; the overflow drill inside the captured
   graph (scale 1e38: parameters bit-unchanged, scale halved, skip
   count + 1, finite loss; then an update); a save_persistables /
   load_persistables resume equal to an uninterrupted run bit for bit;
   the captured step's wall, device ms, idle share and tokens/s, and
   what the recipe adds to plain Adam's step by kernel family;
6. one f32 training step (dropout 0), captured, on the card against the
   same step on the CPU in f64: full widths and depth at batch 2 x seq
   32, and (6b) 2+2 layers at seq 768 (kblock route) and 1280 (bhtd
   route): loss and a named set of parameter gradients;
7. train ResNet-50 and (7b) SE-ResNeXt-50 at ImageNet shape (3 x 224 x
   224, 1000 classes, bf16 AMP, Momentum(0.1, 0.9), batch 128, synthetic
   batches from dataset/imagenet.py staged on the card) through
   Executor.run_steps: finite loss every step, lower loss after the
   repeated-batch steps, moving mean / variance moved off 0 / 1, step
   wall and device-busy ms, images/s, peak memory, device ms by kernel
   family, top device kernels, in turns, eager and captured; one
   captured ResNet-50 step against two eager ones from one startup;
   (7c) walk both Programs and count the conv2d ops whose backward and
   forward shapes are the ones phase 3c ran at; and the ``top_k`` op
   (which ``accuracy`` reads) at [128, 1000] bf16 logits full of ties
   against the stable order;
8. one f32 training step (TF32 off) of ResNet-50 and of SE-ResNeXt-50 (a
   head without dropout) at batch 4, 3 x 64 x 64, captured, on the card
   against the
   same step on the CPU: the loss and the classifier head's gradients
   held, a named set of gradients printed; and the same step in f64,
   which holds every named gradient tightly (the f32 step of a 50-layer
   net at initialization cannot: see TOL_VISION_F32);
9. export and deploy, weights from seed 1234: (9a) Transformer-base's
   is_test program through save_inference_model / load_inference_model
   into a fresh executor and Scope, a b16 x t128 batch's logits bit for
   bit equal to the source program's, the export's bytes and seconds; a
   Predictor with batch buckets [8, 16] at batch sizes 5, 16 and 21
   (rows within 1e-5, at most two captured graphs); a bf16 Predictor
   (enable_bf16) within 2e-2 of the largest logit, its argmax agreement
   and small/fwd launches; (9b) int8 post-training quantization:
   Calibrator abs_max, then KL, over four b16 x t128 batches on the card,
   save_int8_inference_model, the artifact's bytes beside 9a's, and
   ServingEngine(cfg, artifact dir) at phase 4's 128 geometry:
   engine.int8, its weights the host dequantization bit for bit, a
   second int8 engine and an engine over a Scope of the same dequantized
   weights giving the same greedy tokens, the agreement with the fp32
   engine printed, small/fwd and dense launches, decode step ms and
   tokens/s; (9c) ResNet-50's is_test program at b = 128 exported and
   run by a Predictor (top-1 equal), calibrated (abs_max, two batches of
   32) into the int8 artifact (batch-norm statistics in f32), whose
   frozen program runs within 0.2 of the f32 logits, top-1 agreement and
   bytes printed; (9d) QuantizationTransformPass on the t = 256
   Transformer-base training step at b = 16, dropout 0.1: four steps
   captured equal to eager, finite losses, and the device ms and
   launches a step the pass adds;
10. print the kernels' JSON line, the card line, and the result line.

Every executor is closed after its phase (its graphs and their pools
freed).

Exits non-zero without a result when CUDA is unavailable or when the
package is not next to this script.
"""

import collections
import hashlib
import json
import os
import subprocess
import tempfile
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
# One f32 training step on the card vs the same step on the CPU in f64
# (phase 6): the loss, and each named gradient relative to its largest
# |element| (the card runs the kernels and cuBLAS in f32, the reference
# the plain versions in f64). Read on an H100: loss within 5.9e-8,
# gradients within 3.5e-6 at t = 32 (with the earlier host-drawn seeds'
# startup weights, against the CPU's f32 step: loss equal (9.5e-7 at
# t = 1280), gradients within 2.1e-6 at t = 32 and 3.5e-6 at t = 768 /
# 1280). The limits are 6-10x the readings.
TOL_STEP_LOSS = 2e-5
TOL_STEP_GRAD_REL = 2e-5
# The CPU's own f32 step against its f64 step (phase 6), held the same
# way except where a ReLU gate flips: a pre-activation within the f32
# step's rounding of 0 (read on the CPU of an H100 host: two decoder FFN
# gates at t = 32, one -1.9e-7 in f64 and +4.7e-8 in f32) takes the other
# branch of the ReLU's derivative, and every gradient upstream of that
# gate moves (there up to 2.1e-3 of its largest element; not an error of
# any op: the step is discontinuous there). So the CPU's f32 step holds
# the loss, the gradients no flipped gate reaches (TOL_STEP_GRAD_REL; read
# <= 3.8e-6), and each gate's pre-activation relative to its largest
# |element| (read <= 7.1e-7), and prints the gradients a flip reaches.
TOL_GATE_REL = 1e-5
# the t = 8192 causal call's memory rise over its inputs and outputs
# (a folded f32 [8192, 8192] bias alone would be 256 MiB)
MAX_RISE_MIB = 32
# H100 SXM peaks (NVIDIA data sheet, dense) by the routes that compute a
# dtype's products to its accuracy: bf16 on the tensor cores; f32 on the
# CUDA cores, or on the tensor cores in 3xTF32 (three TF32 products of
# operands split into two TF32 terms, f32-accurate: a third of the 495
# TFLOP/s TF32 rate); HBM3. A bound takes the dtype's fastest route.
PEAK_FLOPS = {"float32": {"f32 CUDA cores": 67e12,
                          "3xTF32 tensor cores": 495e12 / 3},
              "bfloat16": {"bf16 tensor cores": 989e12}}
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

# The attention kernel families by input dtype: the forward's
# (csrc/flash_attention_bthd_fwd.cu; bf16 on the tensor cores, f32 on the
# CUDA cores: the tiled kernel for tq > 8, the split-KV decode kernel for
# tq <= 8, and the merge of the key splits) and the backward's (pass A,
# pass B) (csrc/flash_attention_bthd_bwd.cu; bf16 on wgmma, f32 on
# mma.sync in 3xTF32)
FWD_KERNELS = {"bfloat16": ("fwd_wgmma_kernel",),
               "float32": ("fwd_kernel", "fwd_decode_kernel",
                           "fwd_merge_kernel")}
BWD_KERNELS = {"bfloat16": ("bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel"),
               "float32": ("bwd_dkdv_tf32_kernel", "bwd_dq_tf32_kernel")}

_SRC_FWD = "paddle_tpu_torch/csrc/flash_attention_bthd_fwd.cu"
_SRC_BWD = "paddle_tpu_torch/csrc/flash_attention_bthd_bwd.cu"
_TPU_FA = "paddle_tpu/parallel/flash_attention.py"


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas_report(log):
    """ptxas' report with its repeated C7519 notes (a fence it injected
    before a wgmma) counted on one line."""
    lines = log.strip().splitlines()
    notes = [ln for ln in lines if "(C7519)" in ln]
    kept = [ln for ln in lines if "(C7519)" not in ln]
    if notes:
        kept.append(f"ptxas info: {len(notes)} x (C7519) warpgroup.arrive "
                    f"injected by the compiler before a wgmma")
    return "\n".join(kept)


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


def _device_times(fn, iters, expect=None, counts=None, replay=False,
                  trace=None):
    """{kernel name: device ms per call of ``fn``}: a torch.profiler trace
    held against the launches (``timing.device_times``: every kernel's
    count a multiple of ``iters``, ``expect`` {name part: launches a
    call}), taken again when it lost kernels, raising after five;
    ``counts`` receives each kernel's launches a call, ``trace`` what the
    trace was let off (one launch short of one kernel, ``replay`` calls
    only; one-element int64 kernels off the multiple)."""
    from paddle_tpu_torch.benchmarks import timing

    return timing.device_times(fn, iters, expect, counts=counts,
                               replay=replay, trace=trace)


def _matches(name, match):
    from paddle_tpu_torch.benchmarks import timing

    return timing.matches(name, match)


def _device_ms(fn, match="", iters=20, times=None, per_call=None):
    """Device time per call of ``fn`` spent in the kernels whose name
    contains ``match`` (a string or a tuple of them; every kernel and copy
    when empty); None when the trace holds no such kernel. ``per_call``:
    the launches of those kernels a call, held against the trace.
    ``times``: a trace already taken (and checked)."""
    if times is None:
        expect = None if per_call is None else {match: per_call}
        times = _device_times(fn, iters, expect)
    total = sum(ms for name, ms in times.items() if _matches(name, match))
    return total or None


def _iters(b, h, tq, tk):
    """Timed calls per measurement: fewer at the long shapes."""
    work = b * h * tq * tk
    return 100 if work <= 1 << 23 else 20 if work <= 1 << 27 else 5


def _case(name, dtype, b, tq, tk, bias, fused=False, p_drop=0.0,
          layout="bthd", h=8, dh=64, split=False, g_lse=False, repeat=False):
    """One kernel comparison. ``bias``: none; pad ([1, 1, 1, tk], the
    last tk/8 keys padded); pad_b ([b, 1, 1, tk], per-row lengths in
    [tk/2, tk], as make_batch pads); causal; causal_pad (causal over
    pad_b). ``fused``: q, k, v are the strided [b, t, h, dh] views of one
    fused [b, t, 3*h*dh] projection, as the encoder's self-attention gives
    them. ``layout="bhtd"``: [b, h, t, dh] inputs through the BHTD
    functions. ``split``: also launch and check the backward's passes one
    at a time. ``g_lse``: a nonzero lse cotangent (BHTD). ``repeat``: the
    backward launched twice gives equal bits."""
    return dict(name=name, dtype=dtype, b=b, tq=tq, tk=tk, h=h, dh=dh,
                bias=bias, fused=fused, p_drop=p_drop, layout=layout,
                split=split, g_lse=g_lse, repeat=repeat)


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
    """The least time the card could take for ``flops`` operations at the
    dtype's peak and ``nbytes`` of device memory traffic, on the dtype's
    fastest route: {bound_ms, bound_by ("operations" or "bytes"),
    bound_route, bound_ms_by_route (every route's bound)}."""
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    by_route = {route: max(flops / peak * 1e3, byte_ms)
                for route, peak in PEAK_FLOPS[dname].items()}
    route = min(by_route, key=by_route.get)
    op_ms = flops / PEAK_FLOPS[dname][route] * 1e3
    return {"bound_ms": by_route[route],
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "bound_route": route, "bound_ms_by_route": by_route}


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
    return (lambda: fa.flash_attention_bthd_fwd(q, k, v, bias, seed, scale,
                                                p, causal),
            lambda: fa.attention_bthd_plain(q, k, v, bias, scale, seed, p,
                                            causal))


def check_attention_kernel(fa, c, gen):
    """Forward kernel vs plain version on one case (with dropout when
    p_drop > 0: the plain version rebuilds the kernel's mask); returns the
    measurements."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch import kernels

    b, tq, tk, h, dh = (c[n] for n in ("b", "tq", "tk", "h", "dh"))
    q, k, v, bias, causal = _attention_inputs(c, gen)
    route = fa.attention_route(tq, tk, h, dh, c["layout"])
    scale = 1.0 / dh ** 0.5
    seed = SEED + 17 if c["p_drop"] > 0 else None
    kernel, plain = _fns(fa, c, q, k, v, bias, causal, scale, seed)

    kernels.reset_counts()
    out, lse = kernel()
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention", route, "fwd"] == 1, (c["name"],
                                                                  route)
    assert kernels.launch_counts["attention_dense"] == 0, c["name"]
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
    if dname == "float32":  # no atomics: a second launch, the same bits
        out2, lse2 = kernel()
        assert torch.equal(out, out2) and torch.equal(lse, lse2), c["name"]
        del out2, lse2

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
    # the kernels of the input dtype, read from the trace by their names:
    # bf16 one launch a call; f32 the tiled or the decode kernel of the
    # split plan, and the merge when the keys split
    plan = None
    if dname == "float32":
        plan = fa.f32_fwd_plan(b, h, tq, tk, dh, causal if route != "small"
                               else False, torch.cuda.get_device_properties(
                                   0).multi_processor_count)
    per_call = 1 if plan is None else 1 + (plan[1] > 1)
    device_ms = _device_ms(kernel, FWD_KERNELS[dname],
                           iters=min(iters, 20), per_call=per_call)
    assert device_ms, (c["name"], FWD_KERNELS[dname])

    # bound: each input read once, each output written once (HBM), and
    # 4*b*h*dh operations per live score at the input dtype's peak. A
    # folded causal mask is the wrapper's own, not an input.
    bound = _bound(
        4.0 * b * h * dh * _live(tq, tk, causal),
        q.element_size() * (2 * b * tq * h * dh + 2 * b * tk * h * dh)
        + 4 * b * tq * h + (0 if bias is None else 4 * bias.numel()), dname)
    return {
        "case": c["name"], "route": route, "layout": c["layout"],
        "dtype": dname, "p_drop": c["p_drop"], "shape": [b, tq, tk, h, dh],
        "bias": c["bias"], "err_out": err_out, "err_lse": err_lse,
        "tol_out": tol, "tol_lse": TOL_LSE,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, **bound,
        "kernels": (list(FWD_KERNELS[dname]) if plan is None else
                    [plan[0]] + (["fwd_merge_kernel"] if plan[1] > 1
                                 else [])),
        "f32_plan_kernel_splits_keys": plan,
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
    from paddle_tpu_torch import kernels

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

    kernels.reset_counts()
    grads = kernel()
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention", route, "bwd"] == 1, (c["name"],
                                                                  route)
    assert kernels.launch_counts["attention_dense"] == 0, c["name"]
    if c["repeat"]:
        # no atomics: a second launch on the same inputs gives equal bits
        assert all(torch.equal(a, b_) for a, b_ in zip(grads, kernel())), (
            c["name"], "backward launches differ")
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
    # inputs, timed directly: its forward runs once, outside the timed
    # window, and its backward alone is timed by events and read from the
    # trace (every kernel it launches)
    qh, kh, vh = ((x.detach().requires_grad_() for x in (q, k, v)) if bhtd
                  else (x.transpose(1, 2).detach().requires_grad_()
                        for x in (q, k, v)))
    gh = g if bhtd else g.transpose(1, 2)
    mask, is_causal = _library_mask(fa, bias, causal, tq, tk, c["dtype"],
                                    q.device)
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, dropout_p=p, is_causal=is_causal,
            scale=scale)

    def lib_bwd():
        torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True)

    library_ms = _time_ms(lib_bwd, iters, warmup=2)
    lib_times = _device_times(lib_bwd, min(iters, 20))
    del lib_out, mask
    times = _device_times(kernel, min(iters, 20), expect={
        BWD_KERNELS[dname][0]: 1, BWD_KERNELS[dname][1]: 1,
        "bwd_delta_kernel": 1})
    device_ms = _device_ms(None, "bwd_", times=times)
    # the call runs the delta pre-pass and the two passes of its dtype's
    # family, and no other attention backward kernel (the small route's
    # causal fold adds elementwise kernels)
    stray = [name for name in times if "bwd_" in name and not _matches(
        name, BWD_KERNELS[dname] + ("bwd_delta_kernel",))]
    assert not stray, (c["name"], stray)

    # bound: 10*b*h*dh operations per live score (5 matrix products);
    # bytes read of q, out, dout, k, v, lse, delta and the caller's bias,
    # and written of dq, dk, dv
    live = _live(tq, tk, causal)
    elt = q.element_size()
    in_bytes = (elt * (3 * b * tq * h * dh + 2 * b * tk * h * dh)
                + 8 * b * tq * h + (0 if bias is None else 4 * bias.numel()))
    bound = _bound(
        10.0 * b * h * dh * live,
        in_bytes + elt * (b * tq * h * dh + 2 * b * tk * h * dh), dname)
    row = {
        "case": c["name"], "route": route, "layout": c["layout"],
        "dtype": dname, "p_drop": p, "shape": [b, tq, tk, h, dh],
        "bias": c["bias"], "g_lse": c["g_lse"],
        "err_dq_dk_dv": errs, "rel_err_dq_dk_dv": rels, "tol_rel": tol,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_device_ms": sum(lib_times.values()),
        "library_kernels": [[name[:100], t] for name, t in sorted(
            lib_times.items(), key=lambda kv: -kv[1])],
        **bound,
        "kernels": list(BWD_KERNELS[dname]),
        "device_ms_pass_a": _device_ms(None, BWD_KERNELS[dname][0],
                                       times=times),
        "device_ms_pass_b": _device_ms(None, BWD_KERNELS[dname][1],
                                       times=times),
        "device_ms_delta": _device_ms(None, "bwd_delta_kernel", times=times),
        "bit_equal": True if c["repeat"] else None,
    }
    # both passes launched: the trace holds each one's kernel of the dtype
    assert row["device_ms_pass_a"] and row["device_ms_pass_b"], (
        c["name"], sorted(times))
    if c["split"]:
        row["passes"] = _check_passes(fa, c, route, q, k, v, bias, seed, out,
                                      lse, g, g_lse, scale, causal, refs,
                                      iters, plain_ms, in_bytes, live)
    return row


def _check_passes(fa, c, route, q, k, v, bias, seed, out, lse, g, g_lse,
                  scale, causal, refs, iters, plain_ms, in_bytes, live):
    """Pass A (dk, dv: the counterpart of ``_dkv_kernel``) and pass B (dq:
    ``_dq_kernel``), each launched alone (with the delta pre-pass both
    need) as the wrapper launches them (BTHD views of BHTD tensors, the
    lse cotangent, the small route's causal mask folded into the bias),
    checked against the plain backward and timed. Bounds: 8 and 6 b*h*dh
    operations per live score (4 and 3 matrix products); bytes of the
    inputs and of the pass's outputs. No single library call computes
    one pass."""
    import torch

    b, tq, tk, h, dh = (c[n] for n in ("b", "tq", "tk", "h", "dh"))
    dname = str(c["dtype"]).split(".")[-1]
    grads = [torch.zeros_like(x) for x in (q, k, v)]
    if c["layout"] == "bhtd":
        views = fa._bthd(q, k, v, out, lse, g, g_lse, *grads)
    else:
        views = [q, k, v, out, lse, g, g_lse, *grads]
        _, bias, causal = fa._bthd_route(q, k, causal, bias)
    rows = {}
    for name, passes, idx, nops, kname in (
            ("pass_a", 1, (1, 2), 8.0, BWD_KERNELS[dname][0]),
            ("pass_b", 2, (0,), 6.0, BWD_KERNELS[dname][1])):
        def launch():
            fa._launch_bwd(route, *views[:3], bias, seed, *views[3:7], scale,
                           c["p_drop"], causal, *views[7:], passes=passes)

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
        bound = _bound(nops * b * h * dh * live, in_bytes + out_bytes, dname)
        rows[name] = {
            "kernel": kname, "max_abs_err": max(errs), "rel_err": rels,
            "ms": _time_ms(launch, iters, warmup=min(10, iters)),
            "device_ms": _device_ms(launch, kname, iters=min(iters, 20),
                                    per_call=1),
            "plain_ms": plain_ms, "library_ms": None, **bound,
        }
        assert rows[name]["device_ms"], (c["name"], name, kname)
    return rows


def check_long_causal_memory(fa, gen):
    """A causal forward and backward at b = 1, t = 8192, bf16 (the bhtd
    route): the rise of max_memory_allocated over inputs and outputs stays
    under MAX_RISE_MIB, so no [tq, tk] tensor exists."""
    import torch
    from paddle_tpu_torch import kernels

    c = _case("t8192 bf16 causal", torch.bfloat16, 1, 8192, 8192, "causal")
    q, k, v, _, causal = _attention_inputs(c, gen)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_counts()
    out, lse = fa.flash_attention_bthd_fwd(q, k, v, causal=causal)
    grads = fa.flash_attention_bthd_bwd(q, k, v, None, None, out, lse, g,
                                        None, 0.0, causal)
    torch.cuda.synchronize()
    made = sum(t.numel() * t.element_size() for t in (out, lse, *grads))
    rise = (torch.cuda.max_memory_allocated() - base - made) / 2**20
    assert kernels.launch_counts["attention", "bhtd", "fwd"] == 1
    assert kernels.launch_counts["attention", "bhtd", "bwd"] == 1
    assert all(torch.isfinite(x.float()).all() for x in (out, *grads))
    assert rise < MAX_RISE_MIB, f"t=8192 causal call rose {rise} MiB"
    return {"case": c["name"], "memory_rise_mib": rise,
            "limit_mib": MAX_RISE_MIB,
            "inputs_and_outputs_mib": (made + 4 * q.numel() * 2) / 2**20}


def check_mask_dump(fa, b, tq, h, tk, p_drop):
    """The dump kernel's keep mask equals dropout_keep_mask_plain bit for
    bit; its keep rate is within 4 standard deviations of 1 - p."""
    import torch
    from paddle_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    seed = SEED + 41

    def kernel():
        return fa.dropout_keep_mask(seed, b, h, tq, tk, p_drop, dev)

    def plain():
        return fa.dropout_keep_mask_plain(seed, b, h, tq, tk, p_drop, dev)

    before = kernels.launch_counts["attention_mask"]
    got = kernel()
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention_mask"] == before + 1
    ref = plain().permute(0, 2, 1, 3)
    mismatched = int((got != ref).sum().item())
    assert mismatched == 0, f"mask dump: {mismatched} elements differ"
    n = got.numel()
    keep = (got > 0).float().mean().item()
    sd = (p_drop * (1 - p_drop) / n) ** 0.5
    assert abs(keep - (1 - p_drop)) <= 4 * sd, (keep, 1 - p_drop, sd)
    bound = _bound(0.0, 4.0 * n, "float32")

    def fill():  # a yardstick of the write, not the function
        return torch.empty((b, tq, h, tk), device=dev).fill_(1.0)

    return {
        "case": "mask dump", "shape": [b, tq, h, tk], "p_drop": p_drop,
        "mismatched": mismatched, "keep_rate": keep,
        "ms": _time_ms(kernel, 20),
        "device_ms": _device_ms(kernel, "dropout_mask_kernel", per_call=1),
        "plain_ms": _time_ms(plain, 20), "library_ms": None,
        "write_floor_ms": _device_ms(fill), **bound,
    }


def check_dropout_op(nn_ops, shape, dtype, p_drop):
    """The dropout op's kernel (dropout_apply_kernel) against its plain
    version at one shape, bit for bit (Out's bits and the Mask), for both
    implementations; times beside ``F.dropout`` (the yardstick) and the
    byte bound: x read, Out and the uint8 Mask written once."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    # four inputs, taken in turn by the timed calls: their 2 x 4 x 16.8 MB
    # (bf16) exceed the 50 MB L2, as a step's fresh activations do
    xs = [torch.randn(shape, generator=gen, device=dev).to(dtype)
          for _ in range(4)]
    x = xs[0]
    seed = SEED + 43
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    mismatched = 0
    for upscale in (True, False):
        before = kernels.launch_counts["dropout"]
        out, mask = nn_ops.dropout_fwd(x, seed, p_drop, upscale)
        torch.cuda.synchronize()
        assert kernels.launch_counts["dropout"] == before + 1
        ref_out, ref_mask = nn_ops.dropout_plain(x, seed, p_drop, upscale)
        mismatched += int((mask != ref_mask).sum().item())
        mismatched += int((out.view(bits) != ref_out.view(bits)).sum()
                          .item())
    assert mismatched == 0, f"dropout op: {mismatched} elements differ"
    n = x.numel()
    keep = mask.float().mean().item()
    sd = (p_drop * (1 - p_drop) / n) ** 0.5
    assert abs(keep - (1 - p_drop)) <= 4 * sd, (keep, 1 - p_drop, sd)

    turn = iter(range(1 << 30))

    def kernel():
        return nn_ops.dropout_fwd(xs[next(turn) % 4], seed, p_drop, True)

    def plain():
        return nn_ops.dropout_plain(x, seed, p_drop, True)

    def library():  # a yardstick, never used by the package
        return F.dropout(xs[next(turn) % 4], p_drop, training=True)

    bound = _bound(0.0, (2 * x.element_size() + 1) * n, "float32")
    return {
        "case": "dropout op", "shape": list(shape),
        "dtype": str(dtype).replace("torch.", ""), "p_drop": p_drop,
        "mismatched": mismatched, "keep_rate": keep, "max_abs_err": 0.0,
        "ms": _time_ms(kernel, 50),
        "device_ms": _device_ms(kernel, "dropout_apply_kernel", per_call=1),
        "plain_ms": _time_ms(plain, 5),
        "library_ms": _time_ms(library, 50),
        "library_device_ms": _device_ms(library), **bound,
    }


def _turns(run):
    """``run(eager)`` in turns, eager, captured, captured, eager (one card,
    one call: the host's share moves between calls), each turn's peak
    memory from its own window: {"eager": [...], "captured": [...]}."""
    import torch

    out = {"eager": [], "captured": []}
    for eager in (True, False, False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = run(eager)
        # allocated: live tensors; reserved: with the caching allocator's
        # blocks, the captured graphs' pools among them (a pool's freed
        # intermediates count as reserved, not allocated)
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        row["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
        out["eager" if eager else "captured"].append(row)
    return out


def _turn_summary(turns, keys):
    """Each key's readings, eager and captured, in the order taken."""
    return {k: {mode: [r[k] for r in rows] for mode, rows in turns.items()}
            for k in keys}


def _eager_executor(fluid):
    """An Executor whose every run is uncached, so eager: how the eager
    step stays measurable through an entry point that runs programs
    itself (ServingEngine)."""

    class EagerExecutor(fluid.Executor):
        def run(self, *args, **kwargs):
            kwargs["use_program_cache"] = False
            return super().run(*args, **kwargs)

    return EagerExecutor


def run_captured(fluid, program, state, feed, fetch, before=None):
    """One step of ``program`` on the card from ``state`` (name -> array)
    through the captured path: a first call (eager, the warm-up), the
    state set back, ``before()``, then the second call, which captures
    the step and replays it. Returns its fetches."""
    from paddle_tpu_torch import io as tio

    place = fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    scope = tio.scope_from_numpy(state, place)
    with fluid.scope_guard(scope):
        exe.run(program, feed=feed, fetch_list=fetch)
        for n, v in state.items():
            scope.set(n, v)
        if before is not None:
            before()
        got = exe.run(program, feed=feed, fetch_list=fetch)
    exe.close()
    return got


def _same_runs(torch, np, fluid, program, startup, feeds, fetch, steps,
               keep=()):
    """``steps`` steps of ``program`` four times, each on a fresh executor
    and scope from its startup (so the same startup state, executor steps
    and seeds): two eager sequences (uncached runs); one through the step
    runner by ``run`` (its first step eager, the rest replays of the
    captured step); and one through ``run_steps``: a first ``run`` (the
    warm-up), then one window of the other ``steps - 1`` steps, its feeds
    staged once and rotated, which returns the last step's fetches.
    Returns the largest differences from the first eager sequence: of
    every step's fetches and of the final state for the second eager
    sequence and the ``run`` one, of the last step's fetches and of the
    final state for the window; each sequence's first fetch a step; and
    the final values of the vars named in ``keep``, each sequence's."""
    runs = []
    for mode in ("eager", "eager", "run", "run_steps"):
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(scope):
            exe.run(startup)
            if mode == "run_steps":
                got = [exe.run(program, feed=feeds[0], fetch_list=fetch)]
                # window step i is executor step i + 1: feed (i + 1) % n
                rotated = feeds[1:] + feeds[:1]
                got.append(exe.run_steps(program, rotated, steps - 1,
                                         fetch))
            else:
                got = [exe.run(program, feed=feeds[i % len(feeds)],
                               fetch_list=fetch,
                               use_program_cache=mode == "run")
                       for i in range(steps)]
        final = {n: scope.find_var(n) for n in scope.var_names()}
        runs.append((got, final))
        exe.close()
        del scope
        torch.cuda.empty_cache()

    def diff(a, b):
        per_step = [max(float(np.abs(np.asarray(x, np.float64)
                                     - np.asarray(y, np.float64)).max())
                        for x, y in zip(sa, sb))
                    for sa, sb in zip(a[0], b[0])]
        state_d = max(float((a[1][n].double() - b[1][n].double()).abs()
                            .max()) for n in a[1]
                      if a[1][n].is_floating_point())
        return max(per_step), state_d, per_step

    ee, ec = diff(runs[0], runs[1]), diff(runs[0], runs[2])
    # the window's fetches are its last step's
    ew = diff(([runs[0][0][-1]], runs[0][1]), ([runs[3][0][-1]], runs[3][1]))
    got = runs[0][0]
    # fetches past the first (dropout masks): does each step draw anew?
    moved = all(not np.array_equal(got[i][j], got[i + 1][j])
                for i in range(steps - 1) for j in range(1, len(fetch)))
    return {"steps": steps, "later_fetches_move": moved,
            "eager_vs_eager": {"fetch": ee[0], "state": ee[1],
                               "per_step": ee[2]},
            "eager_vs_captured": {"fetch": ec[0], "state": ec[1],
                                  "per_step": ec[2]},
            "eager_vs_run_steps": {"last_fetch": ew[0], "state": ew[1],
                                   "window_steps": steps - 1},
            "first_fetch": [[float(np.asarray(g[0]).reshape(-1)[0])
                             for g in r[0]] for r in runs],
            "final": {n: [r[1][n].tolist() for r in runs] for n in keep}}


def _held_same(r):
    """The captured sequences may differ from the first eager one by no
    more than the second eager one does."""
    ee, ec, ew = (r["eager_vs_eager"], r["eager_vs_captured"],
                  r["eager_vs_run_steps"])
    assert ec["fetch"] <= ee["fetch"] and ec["state"] <= ee["state"], r
    assert ew["last_fetch"] <= ee["fetch"] and ew["state"] <= ee["state"], r


def _counts(fa):
    """The routes' launch counts and the dense calls, as JSON keys."""
    from paddle_tpu_torch import kernels

    out = {f"{r}/{d}": n for (r, d), n in fa.route_counts().items()}
    out["dense_calls"] = kernels.launch_counts["attention_dense"]
    return out


def serve(torch, np, fluid, T, fa, serving, *, cfg, slots, src_len, max_len,
          n_req, new_tokens, min_len):
    """Phase 4/4b: Transformer-base through ServingEngine on the card, in
    turns (eager, captured, captured, eager): each turn serves every
    request through a fresh engine, whose executor runs its programs
    eagerly (every run uncached) or through the captured steps, then
    times its prefill and decode step alone. Every turn gives the same
    greedy tokens and the same launch counts."""
    from paddle_tpu_torch import kernels

    dev_place = fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        T.build(cfg, is_test=True)
    startup.random_seed = SEED  # the executor's generator for this seed
    scope = fluid.Scope()
    exe = fluid.Executor(dev_place)
    with fluid.scope_guard(scope):
        exe.run(startup)
    exe.close()

    rng = np.random.RandomState(SEED)
    lens = rng.randint(min_len, src_len + 1, n_req)
    srcs = [rng.randint(3, cfg.src_vocab_size, n).astype(np.int64)
            for n in lens]
    eager_exe = _eager_executor(fluid)

    class SyncFetchExecutor(fluid.Executor):
        """Every fetch read at once: the engine's decode fetches come back
        as numpy lists, not LazyFetches."""

        def run(self, *args, **kwargs):
            kwargs["async_fetch"] = False
            return super().run(*args, **kwargs)

    def engine(eager, sync=False):
        eng = serving.ServingEngine(cfg, scope, slots=slots, src_len=src_len,
                                    max_len=max_len, place=dev_place)
        if eager:
            eng._exe = eager_exe(dev_place)
        elif sync:
            eng._exe = SyncFetchExecutor(dev_place)
        return eng

    def noting_fetches(eng, kinds):
        """Count the types of the engine's deferred fetches."""
        run = eng._exe.run

        def run_and_note(*args, **kwargs):
            out = run(*args, **kwargs)
            if kwargs.get("async_fetch"):
                kinds[type(out).__name__] += 1
            return out

        eng._exe.run = run_and_note

    state_err = None

    def turn(eager):
        nonlocal state_err
        eng = engine(eager)
        fetch_kinds = collections.Counter()
        noting_fetches(eng, fetch_kinds)
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        handles = [eng.submit(s, max_new_tokens=new_tokens) for s in srcs]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(fa)
        # every decode step's fetches came back as LazyFetches
        assert fetch_kinds == {"LazyFetches": eng.decode_steps}, fetch_kinds
        outcomes = [h.outcome for h in handles]
        assert all(o in ("completed", "length") for o in outcomes), outcomes
        tokens = [list(h.tokens) for h in handles]
        assert all(0 <= t < cfg.trg_vocab_size for ts in tokens for t in ts)
        n_tokens = sum(len(ts) for ts in tokens)

        # prefill and decode-step times, measured on the idle engine
        pre, dec = eng._progs["prefill"], eng._progs["decode"]

        def prefill_once(i):
            """One admission of request i into slot i % slots."""
            with fluid.scope_guard(eng.scope):
                eng._exe.run(eng._progs["prefill_program"], feed={
                    pre["feeds"][0].name:
                        np.pad(srcs[i], (0, src_len - lens[i]))[None],
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
            """One decode step over all slots, its tokens fetched
            (synced)."""
            with fluid.scope_guard(eng.scope):
                eng._exe.run(eng._progs["decode_program"],
                             feed={dec["feeds"][0].name: active},
                             fetch_list=[dec["emit"]])

        n_steps = 16
        for _ in range(2):  # a captured engine captures this fetch's step
            decode_once()
        t1 = time.perf_counter()
        for _ in range(n_steps):
            decode_once()
        decode_ms = (time.perf_counter() - t1) / n_steps * 1e3
        # device busy time per step/admission: the rest of the wall is host
        decode_device_ms = _device_ms(decode_once, iters=8)
        prefill_device_ms = _device_ms(lambda: prefill_once(0), iters=8)
        if not eager and state_err is None:
            state_err = _prefill_state_err(np, fluid, eng, srcs[0], lens[0],
                                           src_len, cfg, prefill_once)
        eng.close()
        return {"wall_s": wall, "tokens": n_tokens,
                "tokens_per_s": n_tokens / wall,
                "decode_steps": eng.decode_steps,
                "decode_step_ms": decode_ms, "prefill_ms": prefill_ms,
                "decode_device_ms": decode_device_ms,
                "prefill_device_ms": prefill_device_ms,
                "decode_idle_share": 1 - decode_device_ms / decode_ms,
                "launches": launches, "greedy_tokens": tokens,
                "deferred_fetches": dict(fetch_kinds)}

    turns = _turns(turn)
    rows = turns["eager"] + turns["captured"]
    tokens = rows[0]["greedy_tokens"]
    assert all(r["greedy_tokens"] == tokens for r in rows), \
        "captured and eager engines gave other greedy tokens"
    assert all(r["launches"] == rows[0]["launches"] for r in rows), [
        r["launches"] for r in rows]
    assert state_err <= TOL_STATE, (
        f"prefill state GPU vs CPU max abs err {state_err} > {TOL_STATE}")

    # two requests decoded alone through an engine of the same geometry
    for i in (0, n_req - 1):
        solo = engine(False)
        h = solo.submit(srcs[i], max_new_tokens=new_tokens)
        solo.run_until_idle()
        solo.close()
        assert list(h.tokens) == tokens[i], (i, list(h.tokens), tokens[i])
    # the same requests through an engine whose fetches are read at once
    # (no LazyFetches): the same tokens and launch counts
    synced = engine(False, sync=True)
    kernels.reset_counts()
    handles = [synced.submit(src, max_new_tokens=new_tokens) for src in srcs]
    synced.run_until_idle()
    synced.close()
    assert [list(h.tokens) for h in handles] == tokens, "synced fetches"
    assert _counts(fa) == rows[0]["launches"], (_counts(fa),
                                                rows[0]["launches"])

    cap = turns["captured"][1]
    for r in rows:
        del r["greedy_tokens"]
    return {
        "requests": n_req, "slots": slots, "src_len": src_len,
        "max_len": max_len, "max_length": cfg.max_length,
        "source_lengths": [int(min_len), int(src_len)],
        "max_new_tokens": new_tokens, "tokens": cap["tokens"],
        "decode_steps": cap["decode_steps"],
        "wall_s": cap["wall_s"], "tokens_per_s": cap["tokens_per_s"],
        "decode_step_ms": cap["decode_step_ms"],
        "prefill_ms": cap["prefill_ms"],
        "decode_device_ms": cap["decode_device_ms"],
        "prefill_device_ms": cap["prefill_device_ms"],
        "prefill_state_err": state_err, "launches": cap["launches"],
        "deferred_fetches": cap["deferred_fetches"],
        "synced_fetch_engine_same_tokens_and_launches": True,
        "greedy_tokens_sha1": hashlib.sha1(
            json.dumps(tokens).encode()).hexdigest(),
        "turns": _turn_summary(turns, (
            "tokens_per_s", "decode_step_ms", "decode_device_ms",
            "decode_idle_share", "prefill_ms", "prefill_device_ms",
            "peak_mem_gib", "peak_reserved_gib")),
    }


def _prefill_state_err(np, fluid, eng, src, n, src_len, cfg, prefill_once):
    """Request 0's prefill state in slot 0 on the card against the same
    prefill program run on the CPU (plain path)."""
    from paddle_tpu_torch import io as tio

    prefill_once(0)
    cpu_params = {name: eng.scope.find_var(name).cpu().numpy()
                  for name in eng.scope.var_names()}
    cpu_scope = tio.scope_from_numpy(cpu_params, fluid.CPUPlace())
    for name, (shape, dtype) in eng._progs["state_specs"].items():
        cpu_scope.set(name, np.zeros(shape, np.dtype(dtype)))
    pre = eng._progs["prefill"]
    with fluid.scope_guard(cpu_scope):
        fluid.Executor(fluid.CPUPlace()).run(
            eng._progs["prefill_program"], feed={
                pre["feeds"][0].name: np.pad(src, (0, src_len - n))[None],
                pre["feeds"][1].name: (np.arange(src_len) < n)
                .astype(np.float32)[None],
                pre["feeds"][2].name: np.asarray([0], np.int64)})
    last = cfg.n_layer - 1
    return max(
        float(np.abs(eng.scope.find_var(f"serve_{kind}{last}")[0].cpu()
                     .numpy() - cpu_scope.find_var(f"serve_{kind}{last}")[0]
                     .numpy()).max())
        for kind in ("ck", "cv"))


def rerun_share(torch, fn):
    """(device ms of the kernels that derived grad ops launch while they
    re-run their forward op under autograd, device ms of every kernel)
    of one call of ``fn``, from a profile with host ranges
    (core/autodiff.py opens ``RERUN_RANGE`` around each re-run while a
    profile is taken)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core import autodiff

    def device_ms(evt):
        return getattr(evt, "device_time_total",
                       getattr(evt, "cuda_time_total", 0.0)) / 1e3

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    rows = prof.key_averages()
    # the host range's device time is its kernels'; the trace also holds
    # the range as a device-side annotation, which is no kernel
    rerun = sum(device_ms(e) for e in rows if e.key == autodiff.RERUN_RANGE
                and getattr(e, "device_type", None) == cpu)
    total = sum(device_ms(e) for e in rows if e.key != autodiff.RERUN_RANGE
                and getattr(e, "device_type", None) == cuda)
    return rerun, total


def _transformer_training(fluid, T, *, seq, batch, max_length, amp,
                          dropout=0.1):
    """Transformer-base training (label smoothing 0.1, Adam 1e-4, bf16
    AMP or f32) and four batches of batch x seq."""
    cfg = T.TransformerConfig(max_length=max_length, dropout=dropout)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        model = T.build(cfg)
        fluid.optimizer.Adam(1e-4).minimize(model["loss"])
    if amp:
        fluid.amp.enable_amp(main_prog)
    startup.random_seed = main_prog.random_seed = SEED
    feeds = [T.make_batch(cfg, batch, seq, seq, seed=SEED + i)
             for i in range(4)]
    return cfg, main_prog, startup, model, feeds


def check_captured_equals_eager(torch, np, fluid, T, *, seq, batch,
                                max_length=256, steps=9):
    """Phase 5's check of the captured step: from one startup state, at
    the same executor steps, nine steps of the bf16 training step as two
    eager sequences and two through the step runner (its first step
    eager, then eight replays of the captured step: by ``run``, each
    step's fetches compared, and as one ``run_steps`` window, its last
    step's fetches and the final state compared), at dropout 0 (losses
    and final state) and 0.1 (losses and two dropout ops' masks: the
    attention kernels' masks reach the loss). The captured sequences may
    differ from the eager one by no more than two eager sequences differ
    from each other."""
    dev = torch.device("cuda", 0)
    out = {}
    for dropout in (0.0, 0.1):
        cfg, prog, startup, model, feeds = _transformer_training(
            fluid, T, seq=seq, batch=batch, max_length=max_length, amp=True,
            dropout=dropout)
        fetch = [model["loss"]]
        if dropout:
            fetch += [op.outputs["Mask"][0] for op in
                      prog.global_block().ops if op.type == "dropout"][:2]
        staged = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
                  for f in feeds]
        r = _same_runs(torch, np, fluid, prog, startup, staged, fetch, steps)
        _held_same(r)
        if dropout:
            assert r["later_fetches_move"], \
                "a dropout mask repeated from step to step"
        out[f"dropout {dropout}"] = r
        torch.cuda.empty_cache()
    return out


def _recipe_training(fluid, T, *, seq, batch, dropout):
    """Transformer-base trained through the recipe: AdamW(1e-4, weight
    decay 0.01) under ``amp.decorate`` (bf16, dynamic loss scaling from
    2^15, growth every 4 clean steps) with a global-norm clip of 1.0;
    label smoothing 0.1; four batches of batch x seq."""
    cfg = T.TransformerConfig(max_length=256, dropout=dropout)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        model = T.build(cfg)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(1.0))
        try:
            opt = fluid.amp.decorate(
                fluid.optimizer.AdamW(1e-4, weight_decay=0.01),
                init_loss_scaling=2.0 ** 15, use_dynamic_loss_scaling=True,
                incr_every_n_steps=4)
            opt.minimize(model["loss"])
        finally:
            fluid.clip.set_gradient_clip(None)
    startup.random_seed = main_prog.random_seed = SEED
    feeds = [T.make_batch(cfg, batch, seq, seq, seed=SEED + i)
             for i in range(4)]
    return main_prog, startup, model, opt, feeds


def _captured(exe, scope):
    """The step runners of ``scope`` that replay a captured graph, with
    their call counts."""
    return [r.calls for r in exe._runners.get(scope, {}).values()
            if r.graph is not None]


def _overflow_drill(torch, np, fluid, exe, scope, prog, startup, loss,
                    opt, staged):
    """Phase 5d (b), in ``scope`` on ``exe``: the startup and two steps
    (the warm-up and the capture), then three replays of the captured
    step. 1: the scale set to 1e38 through ``scope.set`` on a full batch:
    the loss is a mean over ~12k target tokens, so every gradient of the
    unscaled loss is far below 1 and none overflows; the parameters move
    (the direct divide by 1e38 keeps them, where a multiply by its
    subnormal reciprocal could flush them to 0). 2, the drill: the scale
    at the largest finite f32, on the same batch with one target token
    counted (``trg_pad_mask`` 0 but at [0, 0]: the mean's divisor is 1,
    and the output projection's gradient, |h| * 0.9 with |h| the final
    layer norm's output, overflows once |h| > 1.1; at 1e38 it would take
    |h| > 3.8, which a layer norm's output reaches only at some tokens):
    every parameter bit-unchanged, the scale halved, the skip count + 1,
    the fetched loss finite. 3: the next full batch at the halved scale
    updates the parameters."""
    scale = opt.loss_scaling_name
    skips = opt.skip_count_name
    params = [p.name for p in prog.all_parameters() if p.trainable]

    def snapshot():
        return {n: scope.find_var(n).clone() for n in params}

    def moved(snap):
        return [n for n in params if not torch.equal(scope.find_var(n),
                                                      snap[n])]

    exe.run(startup)
    for i in range(2):  # eager, then captured and replayed
        exe.run(prog, feed=staged[i], fetch_list=[loss])
    snap = snapshot()
    scope.set(scale, np.array([1e38], np.float32))
    (full_loss,) = exe.run(prog, feed=staged[2], fetch_list=[loss])
    drill = {"at_1e38_full_batch": {
        "loss": float(full_loss), "params_moved": len(moved(snap)),
        "skips": float(scope.find_var(skips)[0]),
        "scale_after": float(scope.find_var(scale)[0])}}
    assert drill["at_1e38_full_batch"]["skips"] == 0.0, drill
    assert drill["at_1e38_full_batch"]["params_moved"] >= \
        0.9 * len(params), drill

    one_target = dict(staged[2])
    mask = torch.zeros_like(one_target["trg_pad_mask"])
    mask[0, 0] = 1.0
    one_target["trg_pad_mask"] = mask
    snap = snapshot()
    top = np.finfo(np.float32).max
    scope.set(scale, np.array([top], np.float32))
    (drill_loss,) = exe.run(prog, feed=one_target, fetch_list=[loss])
    assert _captured(exe, scope) == [4], _captured(exe, scope)
    drill.update({
        "scale_set": float(top), "loss": float(drill_loss),
        "scale_after": float(scope.find_var(scale)[0]),
        "skips_after": float(scope.find_var(skips)[0]),
        "params_bit_unchanged": len(params) - len(moved(snap)),
        "params": len(params)})
    assert drill["params_bit_unchanged"] == len(params), drill
    assert drill["scale_after"] == float(top * np.float32(0.5)), drill
    assert drill["skips_after"] == 1.0, drill
    assert np.isfinite(drill["loss"]), drill

    (next_loss,) = exe.run(prog, feed=staged[3], fetch_list=[loss])
    updated = moved(snap)
    drill.update(next_loss=float(next_loss), params_updated=len(updated),
                 not_updated=sorted(set(params) - set(updated))[:8],
                 skips_next=float(scope.find_var(skips)[0]),
                 scale_next=float(scope.find_var(scale)[0]))
    assert np.isfinite(drill["next_loss"]), drill
    assert drill["skips_next"] == 1.0, drill
    assert drill["scale_next"] == drill["scale_after"], drill
    assert len(updated) >= 0.9 * len(params), drill
    return drill


def train_recipe(torch, np, fluid, T, fa, plain, *, seq, batch, window=8):
    """Phase 5d: Transformer-base at full width and depth trained through
    the recipe (``_recipe_training``) by Executor.run / run_steps on the
    card. (a) Nine steps at dropout 0.1, two eager sequences and two
    through the captured step (``_same_runs``): losses, two dropout
    masks and the final state (the loss-scaling vars among it) bit for
    bit, and the scale grown. (b) The overflow drill inside the captured
    graph (``_overflow_drill``): the scale set through ``scope.set`` (to
    1e38, where a full batch does not overflow, then to the largest f32
    on a batch of one target token), a replay that overflows leaves every parameter
    bit-unchanged, halves the scale, adds 1 to the skip count and
    fetches a finite loss, and the next replay updates the parameters.
    (c) At dropout 0, 3 steps, ``save_persistables``, and in a fresh
    Scope and Executor ``load_persistables`` and 3 more: the losses and
    the final state equal 6 uninterrupted steps bit for bit (the
    executor's step counter is no persistable, so masks would differ
    after a resume at dropout > 0, as in the JAX package). (d) Captured,
    timed: step wall and device ms, idle share and target tokens/s; the
    launches of the attention kernels and the dropout kernel a step from
    the counters, set to 0 just before the timed windows; and the device
    ms and launches a step by kernel family beside ``plain`` (phase 5's
    captured t = 256 row: plain Adam, no clip, no loss scaling) and the
    op types the recipe adds to the program."""
    from paddle_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    out = {"seq": seq, "batch": batch}

    # (a) captured equals eager
    prog, startup, model, opt, feeds = _recipe_training(
        fluid, T, seq=seq, batch=batch, dropout=0.1)
    loss = model["loss"]
    scale, good, bad, _ = prog._amp_scale_vars
    skips = opt.skip_count_name
    staged = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
              for f in feeds]
    masks = [op.outputs["Mask"][0] for op in prog.global_block().ops
             if op.type == "dropout"][:2]
    same = _same_runs(torch, np, fluid, prog, startup, staged,
                      [loss] + masks, 9, keep=(scale, good, bad, skips))
    _held_same(same)
    for key in ("eager_vs_eager", "eager_vs_captured"):
        assert same[key]["fetch"] == same[key]["state"] == 0.0, same
    assert same["eager_vs_run_steps"]["last_fetch"] == \
        same["eager_vs_run_steps"]["state"] == 0.0, same
    assert same["later_fetches_move"], "a dropout mask repeated"
    final = same["final"]
    assert all(v == final[n][0] for n in final for v in final[n]), final
    assert final[scale][0][0] > 2.0 ** 15, final  # the scale grew
    out["captured_vs_eager"] = same
    torch.cuda.empty_cache()

    # (b) the overflow drill inside the captured graph
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        out["overflow_drill"] = _overflow_drill(torch, np, fluid, exe, scope,
                                                prog, startup, loss, opt,
                                                staged)

        # (d) captured, timed: the same executor's replays
        torch.cuda.synchronize()
        kernels.reset_counts()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (value,) = exe.run_steps(prog, staged, window, [loss])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = _counts(fa)
        launches["dropout"] = kernels.launch_counts["dropout"]
        per_step = {k: n / (2 * window) for k, n in launches.items()}
        n_drop = sum(op.type == "dropout" for op in prog.global_block().ops)
        want = {k: 0.0 for k in per_step}
        want["small/fwd"] = want["small/bwd"] = 3.0 * 6
        want["dropout"] = float(n_drop)
        assert per_step == want, per_step
        assert np.isfinite(value), value
        counts, trace = {}, {}
        times = _device_times(lambda: exe.run_steps(
            prog, staged[:1], 1, [loss]), iters=2, counts=counts,
            replay=True, trace=trace)
    exe.close()
    del scope
    torch.cuda.empty_cache()
    tokens = sum(float(staged[i % 4]["trg_pad_mask"].sum())
                 for i in range(window))
    device_ms = sum(times.values())
    step_ms = [w / window * 1e3 for w in walls]
    fams = _families(times, counts)
    base = plain["by_family"]
    added_ops = collections.Counter(
        op.type for op in prog.global_block().ops)
    added_ops.subtract(plain["op_types"])
    out["timing"] = {
        "window_steps": window, "step_ms": step_ms,
        "step_device_ms": device_ms,
        "idle_share": [1 - device_ms / ms for ms in step_ms],
        "target_tokens_per_s": [tokens / w for w in walls],
        "last_loss": float(value), "launches_per_step": per_step,
        "trace_let_off": trace,
        "plain_adam_phase5": {k: plain[k] for k in (
            "step_ms", "step_device_ms", "idle_share",
            "target_tokens_per_s")},
        "by_family": fams,
        "added_by_family": {f: {k: fams[f][k] - base[f][k]
                                for k in ("device_ms", "launches")}
                            for f in fams},
        "added_device_ms": device_ms - plain["step_device_ms"],
        "added_launches": (sum(counts.values())
                           - sum(v["launches"] for v in base.values())),
        "ops_added_by_type": {k: v for k, v in sorted(added_ops.items())
                              if v},
        "top_kernels_ms": [[k[:80], ms] for k, ms in sorted(
            times.items(), key=lambda kv: -kv[1])[:12]],
    }

    # (c) resume at dropout 0
    prog0, startup0, model0, _, _ = _recipe_training(
        fluid, T, seq=seq, batch=batch, dropout=0.0)
    names = [v.name for v in prog0.list_vars() if v.persistable]

    def steps(exe, idx):
        return [float(exe.run(prog0, feed=staged[i % 4],
                              fetch_list=[model0["loss"]])[0]) for i in idx]

    def run(parts, tmp):
        """The losses and final state of 6 steps, cut after the steps of
        ``parts[0]`` by a save and a load into a fresh Scope and Executor
        when there are two parts."""
        losses = []
        for j, idx in enumerate(parts):
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            with fluid.scope_guard(scope):
                if j == 0:
                    exe.run(startup0)
                else:
                    fluid.io.load_persistables(exe, tmp, prog0)
                losses += steps(exe, idx)
                if j + 1 < len(parts):
                    fluid.io.save_persistables(exe, tmp, prog0)
                state = {n: scope.find_var(n).clone() for n in names}
            exe.close()
            del scope
        return losses, state

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        resumed = run([range(3), range(3, 6)], tmp)
        resume_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(tmp, "__params__.npz"))
    whole = run([range(6)], None)
    differ = [n for n in names if not torch.equal(resumed[1][n],
                                                  whole[1][n])]
    out["resume"] = {"losses_resumed": resumed[0],
                     "losses_uninterrupted": whole[0],
                     "state_vars": len(names), "state_vars_differ": differ,
                     "file_bytes": nbytes, "resumed_run_s": resume_s}
    assert resumed[0] == whole[0] and not differ, out["resume"]
    del resumed, whole
    torch.cuda.empty_cache()
    return out


def check_top_k_ties(torch, np):
    """Phase 7's check of the ``top_k`` op (which ``accuracy`` reads) at
    the vision step's logits shape, [128, 1000] bf16, with ties put in:
    every value on a grid of 1/4 and eight rows all equal. Indices and
    values equal the stable order (among equal values the lower index
    first, as jax.lax.top_k orders them), at k = 1 and 5."""
    from paddle_tpu_torch.core.registry import get_op_def

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn(128, 1000, generator=gen, device="cuda") * 4).round()
    x[:8] = 0.0
    x = (x / 4).to(torch.bfloat16)
    host = x.float().cpu().numpy()
    top_k = get_op_def("top_k").compute
    out = {}
    for k in (1, 5):
        got = top_k({"X": [x]}, {"k": k}, x.device)
        idx = np.argsort(-host, axis=-1, kind="stable")[:, :k]
        vals = np.take_along_axis(host, idx, -1)
        srt = -np.sort(-host, axis=-1)
        out[f"k{k}"] = {
            "rows_tied_at_the_cut": int((srt[:, k - 1] == srt[:, k]).sum()),
            "indices_equal": bool(np.array_equal(
                got["Indices"][0].cpu().numpy(), idx)),
            "values_equal": bool(np.array_equal(
                got["Out"][0].float().cpu().numpy(), vals))}
        assert out[f"k{k}"]["indices_equal"] and \
            out[f"k{k}"]["values_equal"], out
        assert out[f"k{k}"]["rows_tied_at_the_cut"] >= 8, out
    return out


def train(torch, np, fluid, T, fa, *, seq, batch, route, max_length=256,
          repeated=8, window=8, amp=True, rerun=False):
    """Phase 5/5b/5c: train Transformer-base through Executor.run_steps at
    batch x seq, with bf16 AMP (``amp``) or in f32, the framework's
    default; the step timed in turns, eager (uncached runs) and captured
    (run_steps replays). ``rerun``: the share of an eager step's device
    time spent re-running forwards inside derived grad ops."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import lowering

    cfg, main_prog, startup, model, feeds = _transformer_training(
        fluid, T, seq=seq, batch=batch, max_length=max_length, amp=amp)
    loss = model["loss"]
    dev = torch.device("cuda", 0)
    feeds = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
             for f in feeds]
    n_drop = sum(op.type == "dropout" for op in main_prog.global_block().ops)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dname = "bfloat16" if amp else "float32"
    # 6 encoder self, 6 decoder self and 6 cross attentions a step, each one
    # forward and one backward launch on the shape's route
    per_route = 3.0 * cfg.n_layer
    expect = {FWD_KERNELS[dname]: per_route,
              BWD_KERNELS[dname][0]: per_route,
              BWD_KERNELS[dname][1]: per_route,
              "dropout_apply_kernel": n_drop}
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

        def turn(eager):
            """One timed window, its launch counts and the device time of
            one step (a profiler trace, by kernel name)."""
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            if eager:
                for i in range(window):
                    (value,) = exe.run(main_prog, feed=feeds[i % 4],
                                       fetch_list=[loss],
                                       use_program_cache=False)
            else:
                (value,) = exe.run_steps(main_prog, feeds, window, [loss])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts(fa)
            launches["dropout"] = kernels.launch_counts["dropout"]
            # a non-finite loss in any step of the window would have
            # reached the parameters through Adam
            assert np.isfinite(value), value
            assert all(torch.isfinite(scope.find_var(p.name)).all()
                       for p in main_prog.all_parameters()), \
                "non-finite weights"
            per_step = {n: c / window for n, c in launches.items()}
            want = {k: 0.0 for k in per_step}
            want[f"{route}/fwd"] = want[f"{route}/bwd"] = per_route
            want["dropout"] = float(n_drop)
            assert per_step == want, per_step
            counts, trace = {}, {}
            if eager:
                times = _device_times(lambda: exe.run(
                    main_prog, feed=feeds[0], fetch_list=[loss],
                    use_program_cache=False), iters=2, expect=expect,
                    counts=counts, trace=trace)
            else:
                times = _device_times(lambda: exe.run_steps(
                    main_prog, feeds[:1], 1, [loss]), iters=2, expect=expect,
                    counts=counts, replay=True, trace=trace)
            traced = {str(m): sum(n for k, n in counts.items()
                                  if _matches(k, m)) for m in expect}
            # the replay counts and the trace's, kernel by kernel name
            assert list(traced.values()) == [
                per_step[f"{route}/fwd"], per_step[f"{route}/bwd"],
                per_step[f"{route}/bwd"], per_step["dropout"]], (traced,
                                                                 per_step)
            device_ms = sum(times.values())
            tokens = sum(float(feeds[i % 4]["trg_pad_mask"].sum())
                         for i in range(window))
            step_ms = wall / window * 1e3
            return {"step_ms": step_ms, "step_device_ms": device_ms,
                    "idle_share": 1 - device_ms / step_ms,
                    "target_tokens_per_s": tokens / wall,
                    "last_loss": float(value), "launches": launches,
                    "trace_let_off": trace,
                    "launches_per_step": per_step,
                    "traced_launches_per_step": traced, "times": times,
                    "counts": counts}

        turns = _turns(turn)
        t0 = time.perf_counter()
        lowering.lower_block(main_prog, 0, sorted(feeds[0]), [loss.name],
                             dev, amp)
        lower_ms = (time.perf_counter() - t0) * 1e3
        rerun_ms = None
        if rerun:
            rerun_ms = rerun_share(torch, lambda: exe.run(
                main_prog, feed=feeds[0], fetch_list=[loss],
                use_program_cache=False))
    exe.close()
    cap = turns["captured"][1]
    times, counts = cap.pop("times"), cap.pop("counts")
    for r in turns["eager"] + turns["captured"]:
        r.pop("times", None)
        r.pop("counts", None)
    # the attention runs in bf16 under AMP, else in f32: its backward
    # passes are read under that dtype's kernel names
    bwd_names = BWD_KERNELS[dname]
    bwd_passes_ms = sum(ms for name, ms in times.items()
                        if _matches(name, bwd_names))
    assert bwd_passes_ms > 0, (bwd_names, sorted(times))
    fwd_ms = sum(ms for name, ms in times.items()
                 if _matches(name, sum(FWD_KERNELS.values(), ())))
    dropout_ms = sum(ms for name, ms in times.items()
                     if _matches(name, "dropout_apply_kernel"))
    top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
    return {
        "batch": batch, "seq": seq, "route": route,
        "max_length": cfg.max_length, "amp": amp, "dropout": cfg.dropout,
        "startup_s": startup_s, "repeated_batch_losses": losses,
        "window_steps": window, "last_loss": cap["last_loss"],
        "step_ms": cap["step_ms"], "step_device_ms": cap["step_device_ms"],
        "fwd_kernel_device_ms": fwd_ms,
        "bwd_passes_device_ms": bwd_passes_ms,
        "dropout_kernel_device_ms": dropout_ms,
        "bwd_pass_kernels": list(bwd_names),
        "idle_share": cap["idle_share"],
        "target_tokens_per_s": cap["target_tokens_per_s"],
        "peak_mem_gib": cap["peak_mem_gib"],
        "peak_reserved_gib": cap["peak_reserved_gib"],
        "launches": cap["launches"],
        "launches_per_step": cap["launches_per_step"],
        "traced_launches_per_step": cap["traced_launches_per_step"],
        "by_family": _families(times, counts),
        "op_types": dict(collections.Counter(
            op.type for op in main_prog.global_block().ops)),
        "eager_lowering_ms": lower_ms,
        "derived_grad_rerun_device_ms": rerun_ms and rerun_ms[0],
        "eager_profile_device_ms": rerun_ms and rerun_ms[1],
        "turns": _turn_summary(turns, (
            "step_ms", "step_device_ms", "idle_share", "target_tokens_per_s",
            "peak_mem_gib", "peak_reserved_gib", "last_loss",
            "trace_let_off")),
        "top_kernels_ms": [[name[:80], ms] for name, ms in top],
    }


def _relu_gates(program):
    """(op index, input name) of every relu op of ``program``."""
    return [(i, op.inputs["X"][0])
            for i, op in enumerate(program.global_block().ops)
            if op.type == "relu"]


def _upstream(program, idx):
    """The names op ``idx``'s inputs depend on through the ops before it:
    the parameters among them take gradients through that op's
    derivative."""
    ops = program.global_block().ops
    need = set(ops[idx].input_arg_names)
    for op in reversed(ops[:idx]):
        if need.intersection(op.output_arg_names):
            need.update(n for n in op.input_arg_names if n)
    return need


def hold_cpu_f32(np, program, names, ref, got):
    """The CPU's f32 step against its f64 step (TOL_GATE_REL): ``ref`` /
    ``got`` hold the f64 / f32 fetches, the loss, the gradients of
    ``names`` and the pre-activation of every relu gate, in that order.
    Returns the loss error, each gradient's relative error, the flipped
    gates and the gradients they reach (printed, not held)."""
    gates = _relu_gates(program)
    k = 1 + len(names)
    assert len(ref) == len(got) == k + len(gates)
    loss_err = abs(float(got[0]) - float(ref[0]))
    assert loss_err <= TOL_STEP_LOSS, (float(got[0]), float(ref[0]))
    flips, reached, gate_err = {}, set(), 0.0
    for (idx, name), x32, x64 in zip(gates, got[k:], ref[k:]):
        err = float(np.abs(x32 - x64).max() / np.abs(x64).max())
        assert err <= TOL_GATE_REL, (name, err)
        gate_err = max(gate_err, err)
        flipped = (x32 > 0) != (x64 > 0)
        if flipped.any():
            flips[name] = {"n": int(flipped.sum()),
                           "x64": x64[flipped][:4].tolist(),
                           "x32": x32[flipped][:4].tolist()}
            reached |= _upstream(program, idx)
    rel = {n: float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
           for n, g, c in zip(names, got[1:k], ref[1:k])}
    held = {n: e for n, e in rel.items() if n not in reached}
    assert max(held.values(), default=0.0) <= TOL_STEP_GRAD_REL, held
    return {"loss_err": loss_err, "gate_rel_err": gate_err,
            "flipped_gates": flips, "grad_rel_err": held,
            "reached_by_a_flip": {n: e for n, e in rel.items()
                                  if n in reached}}


def cpu_steps(np, fluid, program, state, feed, fetch):
    """The step from ``state`` on the CPU in f64 and in f32, fetching
    ``fetch`` and every relu gate's pre-activation: {dtype: fetches}."""
    from paddle_tpu_torch import io as tio

    fetch = list(fetch) + [name for _, name in _relu_gates(program)]
    out = {}
    for wide in (np.float64, np.float32):
        # every op of the path follows its inputs' dtype
        st = {n: v.astype(wide) if v.dtype == np.float32 else v
              for n, v in state.items()}
        with fluid.scope_guard(tio.scope_from_numpy(st, fluid.CPUPlace())):
            out[np.dtype(wide).name] = fluid.Executor(fluid.CPUPlace()).run(
                program, feed=feed, fetch_list=fetch)
    return out


def train_vs_cpu(torch, np, fluid, T, fa, *, n_layer, seq, batch,
                 max_length=256):
    """Phase 6/6b: one f32 training step (dropout 0, Adam) on the card,
    through the captured path, against the same step, from the same
    state, on the CPU in f64; and the CPU's own f32 step against its f64
    step (``hold_cpu_f32``)."""
    from paddle_tpu_torch import kernels

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
        gpu_exe.close()
    state = {n: gpu_scope.find_var(n).cpu().numpy()
             for n in gpu_scope.var_names()}
    gpu = run_captured(fluid, main_prog, state, feed, fetch,
                       before=kernels.reset_counts)
    launches = _counts(fa)
    route = fa.attention_route(seq, seq, cfg.n_head, cfg.d_head)
    assert launches[f"{route}/fwd"] == launches[f"{route}/bwd"] \
        == 3 * n_layer and launches["dense_calls"] == 0, launches
    cpu = cpu_steps(np, fluid, main_prog, state, feed, fetch)
    ref = cpu["float64"]
    loss_err = abs(float(gpu[0]) - float(ref[0]))
    assert loss_err <= TOL_STEP_LOSS, (float(gpu[0]), float(ref[0]))
    rel = {}
    for n, g, c in zip(names, gpu[1:], ref[1:]):
        assert g.shape == c.shape and np.isfinite(g).all(), n
        rel[n] = float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
    assert max(rel.values()) <= TOL_STEP_GRAD_REL, rel
    return {"n_layer": n_layer, "seq": seq, "batch": batch, "route": route,
            "launches": launches[f"{route}/bwd"],
            "loss_gpu": float(gpu[0]), "loss_cpu_f64": float(ref[0]),
            "loss_err": loss_err, "grad_rel_err": rel,
            "cpu_f32_vs_f64": hold_cpu_f32(np, main_prog, names, ref,
                                           cpu["float32"])}


def _study_row(name, shape, launch, plain, library, match, err, tol, flops,
               nbytes, iters, per_call=1):
    """Times of one kernel study case: events, profiler, plain version,
    library call by events and from the trace (every kernel it launches,
    with their names; None when there is no library call), the kernel's
    device ms over the library's, and the bound at the bf16 tensor-core
    peak."""
    row = {
        "case": name, "shape": list(shape), "max_abs_err": err, "tol": tol,
        "ms": _time_ms(launch, iters, warmup=3),
        "device_ms": _device_ms(launch, match, iters=min(iters, 10),
                                per_call=per_call),
        "plain_ms": _time_ms(plain, 3, warmup=1),
        "library_ms": None, "library_device_ms": None,
        "library_kernels": None, "over_library": None,
        **_bound(flops, nbytes, "bfloat16"),
    }
    if library is not None:
        row["library_ms"] = _time_ms(library, iters, warmup=3)
        lib_times = _device_times(library, min(iters, 10))
        row["library_device_ms"] = sum(lib_times.values())
        row["library_kernels"] = [[k[:100], t] for k, t in sorted(
            lib_times.items(), key=lambda kv: -kv[1])]
        row["over_library"] = row["device_ms"] / row["library_device_ms"]
    return row


def check_conv1x1_bwd(cb, n, ci, co):
    """Phase 3c: the combined 1x1-conv backward kernel against its plain
    version at one shape. Bound: x, dy, W read once, dx (bf16) and dW
    (f32) written once; 4*n*ci*co operations."""
    import torch
    from paddle_tpu_torch import kernels

    x, dy, w = cb.make_inputs(n, ci, co, seed=SEED, device="cuda")
    before = kernels.launch_counts[cb.SOURCE]
    dx, dw = cb.combined_conv1x1_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts[cb.SOURCE] == before + 1
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
        2 * (n * ci + n * co + ci * co) + 2 * n * ci + 4 * ci * co, 20,
        per_call=2)  # the kernel and its fixed-order dW reduction
    row["dw_rel_err"], row["tol_dw_rel"] = dw_rel, TOL_DW_REL
    row["plan_cs_chunks_split_parts_tiles"] = list(cb.plan(
        n, ci, co, torch.cuda.get_device_properties(0).multi_processor_count))
    row["over_matmul_pair"] = row["ms"] / row["library_ms"]
    # the device ms of the main kernel and of the dW reduction apart
    times = _device_times(lambda: cb.combined_conv1x1_bwd(x, dy, w), 10,
                          expect={"conv1x1_bwd_kernel": 1,
                                  "conv1x1_bwd_reduce": 1})
    row["device_ms_kernel"] = _device_ms(None, "conv1x1_bwd_kernel",
                                         times=times)
    row["device_ms_reduce"] = _device_ms(None, "conv1x1_bwd_reduce",
                                         times=times)
    # no atomics: a second launch gives the same bits
    dx2, dw2 = cb.combined_conv1x1_bwd(x, dy, w)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2), row["case"]
    return row


def check_grouped_conv(gc, tag, n, h, w, c):
    """Phase 3c: the grouped 3x3 convolution kernel against its plain
    version at one shape, and a second launch's bits against the first's.
    Bound: x read once, y written once, the weights read once; 2*9*cg
    operations an output."""
    import torch
    from paddle_tpu_torch import kernels

    x, wg = gc.make_inputs(n, h, w, c, seed=SEED, device="cuda")
    cg = c // gc.GROUPS
    before = kernels.launch_counts[gc.SOURCE]
    y = gc.grouped_conv(x, wg, gc.GROUPS)
    torch.cuda.synchronize()
    assert kernels.launch_counts[gc.SOURCE] == before + 1
    ref = gc.grouped_conv_plain(x, wg, gc.GROUPS)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL_BF16_ULP_REL * ref.float().abs().max().item()
    assert err <= tol, f"grouped_conv {tag}: err {err} (tol {tol})"
    del ref
    assert torch.equal(y, gc.grouped_conv(x, wg, gc.GROUPS)), tag
    row = _study_row(
        f"grouped_conv {tag}", (n, h, w, c),
        lambda: gc.grouped_conv(x, wg, gc.GROUPS),
        lambda: gc.grouped_conv_plain(x, wg, gc.GROUPS),
        lambda: gc.conv_ref(x, wg, gc.GROUPS), "grouped_conv_mma_kernel",
        err, tol, 18.0 * cg * n * h * w * c,
        2 * (2 * n * h * w * c + 9 * cg * c), 20)
    row["cg"], row["bit_equal"] = cg, True
    row["plan"] = gc.plan(
        n, h, w, c, cg,
        torch.cuda.get_device_properties(0).multi_processor_count)._asdict()
    return row


def check_attn_ablate(aa, name, b, h, t, dh, variant):
    """Phase 3c: one variant of the attention ablation kernel against its
    plain version (bq = t, bk = t as the study runs it). Bound:
    4*b*h*t^2*dh operations; q, k, v read once, out written once. The
    library call exists for the full variant only."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch import kernels

    q, k, v = aa.make_inputs(b, h, t, dh, seed=SEED, device="cuda")
    fwd = aa.make_fwd(variant, b, h, t, dh, t, t)
    before = kernels.launch_counts[aa.SOURCE]
    out = fwd(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts[aa.SOURCE] == before + 1
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


def _families(times, counts):
    """{family: {"device_ms": ..., "launches": ...}} a step, of a replay's
    trace ({kernel name: ms} and {kernel name: launches})."""
    ms = _kernel_families(times)
    launches = _kernel_families(counts)
    return {f: {"device_ms": ms[f], "launches": launches[f]} for f in ms}


def train_vision(torch, np, fluid, imagenet, name, build, *, batch, lr,
                 fall_lr, repeated=6, window=6, check_equal=False):
    """Phases 7/7b: train one vision model at ImageNet shape through
    Executor.run_steps (bf16 AMP, Momentum). The synthetic batches are
    made on the host from a seed and staged on the card once, so a step's
    wall time holds no host-to-device copy of the images. The loss must
    fall over ``repeated`` steps on one batch at ``lr``; where it does not
    (momentum 0.9 at rate 0.1 overshoots on a single repeated batch), what
    was read is kept in the row and the check is held from a fresh start
    at ``fall_lr``. The timed window runs at ``lr``, in turns, eager
    (uncached runs) and captured (run_steps replays). ``check_equal``:
    one captured step against two eager ones from one startup state."""
    main_prog, startup, model = _build_vision(fluid, build, lr, amp=True)
    loss = model["loss"]
    # two fetch lists, as a trainer logs the accuracy every few steps: each
    # captures a graph of its own, and the two share the executor's pool
    fetch = [loss, model["acc"]]
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
        # the second fetch list's warm-up and capture, before the timing
        exe.run_steps(main_prog, feeds, 2, fetch)

        def turn(eager):
            """One timed window and the device time of one step."""
            trace = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if eager:
                for i in range(window):
                    (value, acc) = exe.run(
                        main_prog, feed=feeds[i % len(feeds)],
                        fetch_list=fetch, use_program_cache=False)
            else:
                (value, acc) = exe.run_steps(main_prog, feeds, window,
                                             fetch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert np.isfinite(value), (name, value)
            assert all(torch.isfinite(scope.find_var(p.name)).all()
                       for p in main_prog.all_parameters()), \
                "non-finite weights"
            if eager:
                # one step: an eager step's count of AMP casts and cuDNN
                # layout copies varies from call to call (an H100 traced
                # 755 bf16 copies over two ResNet-50 steps, five times)
                times = _device_times(lambda: exe.run(
                    main_prog, feed=feeds[0], fetch_list=fetch,
                    use_program_cache=False), iters=1, trace=trace)
            else:
                times = _device_times(lambda: exe.run_steps(
                    main_prog, feeds[:1], 1, [loss]), iters=2, replay=True,
                    trace=trace)
            device_ms = sum(times.values())
            step_ms = wall / window * 1e3
            return {"step_ms": step_ms, "step_device_ms": device_ms,
                    "idle_share": 1 - device_ms / step_ms,
                    "images_per_s": batch * window / wall,
                    "last_loss": float(value), "last_acc": float(acc),
                    "trace_let_off": trace, "times": times}

        turns = _turns(turn)
    exe.close()
    same = None
    if check_equal:
        same = _same_runs(torch, np, fluid, main_prog, startup, feeds,
                          [loss], 2)
        _held_same(same)
    cap = turns["captured"][1]
    times = cap.pop("times")
    for r in turns["eager"] + turns["captured"]:
        r.pop("times", None)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    ops = main_prog.global_block().ops
    return main_prog, {
        "model": name, "batch": batch, "image": [3, 224, 224],
        "classes": 1000, "amp": True, "lr": lr, "momentum": VISION_MOMENTUM,
        "ops_per_step": len(ops),
        "repeated_batch_losses": losses, "window_steps": window,
        "last_loss": cap["last_loss"], "last_acc": cap["last_acc"], **moved,
        "step_ms": cap["step_ms"], "step_device_ms": cap["step_device_ms"],
        "idle_share": cap["idle_share"],
        "images_per_s": cap["images_per_s"],
        "peak_mem_gib": cap["peak_mem_gib"],
        "peak_reserved_gib": cap["peak_reserved_gib"],
        "turns": _turn_summary(turns, (
            "step_ms", "step_device_ms", "idle_share", "images_per_s",
            "peak_mem_gib", "peak_reserved_gib", "last_loss",
            "trace_let_off")),
        "captured_vs_eager": same,
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
    on the card, through the captured path, against the same step, from
    the same state and batch, on the CPU: the loss and the named
    gradients, each relative to its largest element. ``double``: state
    and images cast to float64 (every op of the path follows its inputs'
    dtype), and every named gradient is held; in f32 only those of
    ``head`` (the classifier's) are."""
    main_prog, startup, model = _build_vision(fluid, build, VISION_LR,
                                              amp=False)
    rng = np.random.RandomState(SEED)
    wide = np.float64 if double else np.float32
    feed = {"data": rng.uniform(-1, 1, (batch, 3, image, image)).astype(wide),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}
    fetch = [model["loss"]] + [n + "@GRAD" for n in names]
    from paddle_tpu_torch import io as tio

    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    exe.close()
    state = {n: scope.find_var(n).cpu().numpy() for n in scope.var_names()}
    state = {n: v.astype(wide) if v.dtype == np.float32 else v
             for n, v in state.items()}
    gpu = run_captured(fluid, main_prog, state, feed, fetch)
    with fluid.scope_guard(tio.scope_from_numpy(state, fluid.CPUPlace())):
        cpu = fluid.Executor(fluid.CPUPlace()).run(main_prog, feed=feed,
                                                   fetch_list=fetch)
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


# Phase 9 (export and deploy): tolerances. The exported program runs the
# same ops at the same shapes on the same card as its source, so its
# logits are held bit for bit; a bucketed Predictor pads a batch up to a
# bucket, where cuBLAS may pick another kernel for the other row count:
# rows within 1e-5 of the largest |logit|; the bf16 Predictor rounds
# every matmul's inputs to bf16 (8 significant bits): within 2e-2 of the
# largest |logit|; the int8 ResNet-50 within 0.2 of it
# (tests/test_calibration.py:155).
TOL_BUCKET_REL = 1e-5
TOL_BF16_LOGIT_REL = 2e-2
TOL_INT8_LOGIT_REL = 0.2
# phase 9b's serving geometry: phase 4's 128 shape
SERVE_SLOTS, SERVE_LEN, SERVE_REQ, SERVE_NEW = 8, 128, 16, 32


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _graphs(exe):
    """The CUDA graphs an executor's compiled steps have captured."""
    return sum(r.graph is not None for runners in exe._runners.values()
               for r in runners.values())


def _rel_err(np, got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _transformer_is_test(fluid, T, cfg):
    """The is_test Transformer (logits and the masked loss) with its
    startup seeded: the same weights at every build."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        model = T.build(cfg, is_test=True)
    startup.random_seed = SEED
    return main, startup, model


def export_transformer(torch, np, fluid, T, fa, tmp):
    """Phase 9a: Transformer-base's ``is_test`` program exported by
    ``io.save_inference_model`` and loaded by ``load_inference_model``
    into a fresh executor and Scope: a b16 x t128 batch's logits bit for
    bit equal to the source program's (eager, then captured); a
    ``Predictor`` over the export with batch buckets [8, 16] at batch
    sizes 5, 16 and 21 (rows within TOL_BUCKET_REL of the exact runs, at
    most two captured graphs); and a bf16 ``Predictor`` (``enable_bf16``)
    on the same batch against f32 (TOL_BF16_LOGIT_REL), its ``small/fwd``
    launches read from its runs alone."""
    from paddle_tpu_torch import inference, io, kernels

    cfg = T.base()
    main, startup, model = _transformer_is_test(fluid, T, cfg)
    place = fluid.CUDAPlace(0)
    batch = T.make_batch(cfg, 32, 128, 128, seed=SEED)
    feed_names = ["src_ids", "src_pad_mask", "trg_ids", "trg_pad_mask"]
    full16 = {k: v[:16] for k, v in batch.items()}
    d = os.path.join(tmp, "transformer_fp32")
    scope, exe = fluid.Scope(), fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(startup)
        kernels.reset_counts()
        src = [exe.run(main, feed=full16, fetch_list=[model["logits"]])[0]
               for _ in range(2)]
        src_launches = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        io.save_inference_model(d, feed_names, [model["logits"]], exe, main)
        export_s = time.perf_counter() - t0
    exe.close()
    lscope, lexe = fluid.Scope(), fluid.Executor(place)
    with fluid.scope_guard(lscope):
        t0 = time.perf_counter()
        prog, feeds, fetches = io.load_inference_model(d, lexe)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert sorted(feeds) == sorted(feed_names), feeds
        kernels.reset_counts()
        loaded = [lexe.run(prog, feed={k: full16[k] for k in feeds},
                           fetch_list=fetches)[0] for _ in range(2)]
        loaded_launches = _counts(fa)
        assert loaded_launches["small/fwd"] == 2 * 3 * cfg.n_layer, \
            loaded_launches
        for a, b in zip(src, loaded):
            assert a.shape == (16, 128, cfg.trg_vocab_size), a.shape
            assert np.isfinite(a).all()
            assert np.array_equal(a, b), "loaded logits differ from the " \
                f"source's (max {float(np.abs(a - b).max())})"

        def rows(lo, n):
            return {k: batch[k][lo:lo + n] for k in feeds}

        cases = ((0, 5), (5, 16), (0, 21))
        exact = {c: lexe.run(prog, feed=rows(*c), fetch_list=fetches)[0]
                 for c in cases}
    lexe.close()
    pred = inference.create_predictor(
        inference.Config(d).set_batch_buckets([8, 16]))
    bucket_err = {}
    for c in cases:
        (got,) = pred.run(rows(*c))
        assert got.shape[0] == c[1], got.shape
        bucket_err[f"b{c[1]}"] = _rel_err(np, got, exact[c])
    graphs = _graphs(pred._exe)
    pred.close()
    assert max(bucket_err.values()) <= TOL_BUCKET_REL, bucket_err
    assert graphs <= 2, graphs
    bf16 = inference.create_predictor(inference.Config(d).enable_bf16())
    kernels.reset_counts()
    outs = [bf16.run({k: full16[k] for k in feeds})[0] for _ in range(2)]
    bf16_launches = _counts(fa)
    bf16.close()
    assert bf16_launches["small/fwd"] > 0, bf16_launches
    assert np.array_equal(outs[0], outs[1]), "bf16 eager and captured differ"
    bf16_err = _rel_err(np, outs[0], src[0])
    assert bf16_err <= TOL_BF16_LOGIT_REL, bf16_err
    mask = full16["trg_pad_mask"] > 0
    agree = float((outs[0].argmax(-1) == src[0].argmax(-1))[mask].mean())
    torch.cuda.empty_cache()
    return {"export_bytes": _dir_bytes(d), "export_s": export_s,
            "load_s": load_s,
            "files": {f: os.path.getsize(os.path.join(d, f))
                      for f in sorted(os.listdir(d))},
            "ops_exported": len(prog.global_block().ops),
            "ops_source": len(main.global_block().ops),
            "logits_bit_equal": True, "source_launches": src_launches,
            "loaded_launches": loaded_launches,
            "bucket_rel_err": bucket_err, "bucket_graphs": graphs,
            "bf16_rel_err": bf16_err, "bf16_argmax_agreement": agree,
            "bf16_launches": bf16_launches}, d


def _serve_requests(torch, np, fluid, fa, serving, cfg, weights):
    """Phase 4's 128 geometry through a fresh ``ServingEngine(cfg,
    weights)``: greedy tokens, wall, launches read from this run alone,
    then the decode step's wall with every slot live (phase 4 traces its
    device time). Returns (row, engine); the caller closes the engine."""
    from paddle_tpu_torch import kernels

    rng = np.random.RandomState(SEED)
    lens = rng.randint(16, SERVE_LEN + 1, SERVE_REQ)
    srcs = [rng.randint(3, cfg.src_vocab_size, n).astype(np.int64)
            for n in lens]
    eng = serving.ServingEngine(cfg, weights, slots=SERVE_SLOTS,
                                src_len=SERVE_LEN, max_len=SERVE_LEN,
                                place=fluid.CUDAPlace(0))
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    hs = [eng.submit(s, max_new_tokens=SERVE_NEW) for s in srcs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(fa)
    tokens = [list(h.tokens) for h in hs]
    assert all(h.outcome in ("completed", "length") for h in hs)
    n_tok = sum(map(len, tokens))
    dec = eng._progs["decode"]
    for i in range(SERVE_SLOTS):
        eng.submit(srcs[i % len(srcs)], max_new_tokens=1)
    eng.run_until_idle()
    active = np.ones(SERVE_SLOTS, bool)

    def decode_once():
        with fluid.scope_guard(eng.scope):
            eng._exe.run(eng._progs["decode_program"],
                         feed={dec["feeds"][0].name: active},
                         fetch_list=[dec["emit"]])

    for _ in range(2):
        decode_once()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(16):
        decode_once()
    decode_ms = (time.perf_counter() - t1) / 16 * 1e3
    return {"tokens": tokens, "n_tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall, "decode_steps": eng.decode_steps,
            "decode_step_ms": decode_ms, "launches": launches}, eng


def int8_transformer(torch, np, fluid, T, fa, serving, tmp, fp32_dir):
    """Phase 9b: Transformer-base calibrated on the card by
    ``Calibrator`` with abs_max and then KL over four b16 x t128
    batches, exported by ``save_int8_inference_model`` (the KL scales),
    and served from the artifact directory by ``ServingEngine(cfg,
    dir)`` at phase 4's 128 geometry: ``engine.int8``; its Scope holds
    the host dequantization of the int8 weights bit for bit and the
    float32 rest as saved; a second int8 engine and an engine over a
    Scope of the same dequantized weights give the same greedy tokens;
    the token agreement with the fp32 engine printed (random weights)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.slim import calibration

    cfg = T.base()
    main, startup, model = _transformer_is_test(fluid, T, cfg)
    place = fluid.CUDAPlace(0)
    scope, exe = fluid.Scope(), fluid.Executor(place)
    batches = [T.make_batch(cfg, 16, 128, 128, seed=SEED + 10 + i)
               for i in range(4)]
    calib = {}
    with fluid.scope_guard(scope):
        exe.run(startup)
        for algo in ("abs_max", "KL"):
            t0 = time.perf_counter()
            c = calibration.Calibrator(main, exe, scope=scope, algo=algo)
            for b in batches:
                c.sample(b)
            scales = c.compute_scales()
            calib[algo] = (c, scales, time.perf_counter() - t0)
        c, kl, _ = calib["KL"]
        ab = calib["abs_max"][1]
        assert set(kl) == set(ab) and all(
            0 < kl[n] <= ab[n] * (1 + 1e-6) for n in kl), (kl, ab)
        d = os.path.join(tmp, "transformer_int8")
        t0 = time.perf_counter()
        calibration.save_int8_inference_model(
            d, ["src_ids", "src_pad_mask", "trg_ids", "trg_pad_mask"],
            [model["logits"]], exe, main, c, scope=scope)
        save_s = time.perf_counter() - t0
        source = {n: io._to_numpy(scope.find_var(n))
                  for n in scope.var_names()}
    exe.close()
    del scope
    with open(os.path.join(d, "__int8_scales__.json")) as f:
        wscales = json.load(f)["weight_scales"]
    with np.load(os.path.join(d, "__params_int8__.npz")) as q8, \
            np.load(os.path.join(d, "__params__.npz")) as f32:
        dequant = {n: q8[n].astype(np.float32) * wscales[n] / 127.0
                   for n in q8.files}
        rest = {n: f32[n] for n in f32.files}
    n_int8 = sum(v.size for v in dequant.values())
    n_f32 = sum(v.size for v in rest.values())
    assert set(dequant) == set(c.weight_names), sorted(dequant)

    first, eng = _serve_requests(torch, np, fluid, fa, serving, cfg, d)
    assert eng.int8 and eng.stats()["int8"], eng.stats()
    for n, want in list(dequant.items()) + list(rest.items()):
        got = eng.scope.find_var(n).cpu().numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want), n
    eng.close()
    second, eng = _serve_requests(torch, np, fluid, fa, serving, cfg, d)
    eng.close()
    held = io.scope_from_numpy({**rest, **dequant}, place)
    from_scope, eng = _serve_requests(torch, np, fluid, fa, serving, cfg,
                                      held)
    assert not eng.int8
    eng.close()
    fp32, eng = _serve_requests(torch, np, fluid, fa, serving, cfg,
                                io.scope_from_numpy(source, place))
    eng.close()
    tokens = first["tokens"]
    assert second["tokens"] == tokens, "a second int8 engine differs"
    assert from_scope["tokens"] == tokens, \
        "an engine over the same dequantized weights differs"
    assert first["launches"]["small/fwd"] == SERVE_REQ * cfg.n_layer, \
        first["launches"]
    pairs = [(a, b) for x, y in zip(tokens, fp32["tokens"])
             for a, b in zip(x, y)]
    agree = sum(a == b for a, b in pairs) / max(len(pairs), 1)
    torch.cuda.empty_cache()
    for r in (first, second, from_scope, fp32):
        r.pop("tokens")
    fp32_bytes = _dir_bytes(fp32_dir)
    return {"calibration_s": {a: v[2] for a, v in calib.items()},
            "activations": len(kl),
            "kl_over_abs_max": [min(kl[n] / ab[n] for n in kl),
                                max(kl[n] / ab[n] for n in kl)],
            "save_s": save_s, "artifact_bytes": _dir_bytes(d),
            "fp32_bytes": fp32_bytes,
            "fp32_over_int8": fp32_bytes / _dir_bytes(d),
            "int8_weights": len(dequant), "int8_elements": n_int8,
            "f32_elements": n_f32,
            "files": {f: os.path.getsize(os.path.join(d, f))
                      for f in sorted(os.listdir(d))},
            "engine_weights_equal_host_dequant": True,
            "second_engine_same_tokens": True,
            "dequant_scope_engine_same_tokens": True,
            "tokens_agree_with_fp32": agree,
            "greedy_tokens_sha1": hashlib.sha1(
                json.dumps(tokens).encode()).hexdigest(),
            "int8_engine": first, "int8_engine_again": second,
            "dequant_scope_engine": from_scope, "fp32_engine": fp32}


def vision_export_int8(torch, np, fluid, R, imagenet, tmp):
    """Phase 9c: ResNet-50's ``is_test`` program at b = 128, 3 x 224 x
    224: exported and run through a ``Predictor`` (top-1 equal to the
    source program's); calibrated (abs_max) over two batches of 32 and
    exported as the int8 artifact (batch-norm statistics float32, none in
    the int8 file), whose frozen program a ``Predictor`` runs on the card
    within TOL_INT8_LOGIT_REL of f32."""
    from paddle_tpu_torch import inference, io
    from paddle_tpu_torch.slim import calibration

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("data", shape=[3, 224, 224], dtype="float32")
        logits = R.resnet_imagenet(img, class_dim=1000, depth=50,
                                   is_test=True)
    startup.random_seed = SEED
    x = next(imagenet.batched(128, 1, seed=SEED)())["data"]
    warm = [b["data"] for b in imagenet.batched(32, 2, seed=SEED + 1)()]
    d, d8 = os.path.join(tmp, "resnet50_fp32"), os.path.join(tmp,
                                                              "resnet50_int8")
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
        (ref,) = exe.run(main, feed={"data": x}, fetch_list=[logits])
        t0 = time.perf_counter()
        io.save_inference_model(d, ["data"], [logits], exe, main)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = calibration.Calibrator(main, exe, scope=scope, algo="abs_max")
        for b in warm:
            c.sample({"data": b})
        calibration.save_int8_inference_model(d8, ["data"], [logits], exe,
                                              main, c, scope=scope)
        int8_s = time.perf_counter() - t0
    exe.close()
    del scope
    pred = inference.create_predictor(inference.Config(d))
    (got,) = pred.run([x])
    pred.close()
    assert np.isfinite(ref).all() and ref.shape == (len(x), 1000)
    assert np.array_equal(got.argmax(1), ref.argmax(1)), "top-1 differs"
    stats = {n for op in main.global_block().ops if op.type == "batch_norm"
             for n in op.inputs["Mean"] + op.inputs["Variance"]}
    with np.load(os.path.join(d8, "__params_int8__.npz")) as q8, \
            np.load(os.path.join(d8, "__params__.npz")) as f32:
        assert not stats & set(q8.files), sorted(stats & set(q8.files))
        assert all(f32[n].dtype == np.float32 for n in stats)
        n_int8 = len(q8.files)
    p8 = inference.create_predictor(inference.Config(d8))
    (q,) = p8.run([x])
    n_qdq = sum(op.type == "quantize_dequantize_static"
                for op in p8.program.global_block().ops)
    p8.close()
    err = _rel_err(np, q, ref)
    assert err < TOL_INT8_LOGIT_REL, err
    torch.cuda.empty_cache()
    return {"batch": len(x), "fp32_bytes": _dir_bytes(d),
            "int8_bytes": _dir_bytes(d8),
            "fp32_over_int8": _dir_bytes(d) / _dir_bytes(d8),
            "export_s": export_s, "calibrate_and_int8_s": int8_s,
            "predictor_top1_equal": True, "int8_weights": n_int8,
            "bn_stats_f32": len(stats), "qdq_ops": n_qdq,
            "int8_rel_err": err,
            "int8_top1_agreement": float((q.argmax(1) == ref.argmax(1))
                                         .mean())}


def _qat_training(fluid, T, slim, *, seq, batch, qat):
    """Transformer-base training at dropout 0.1 (label smoothing 0.1,
    Adam 1e-4, bf16 AMP) with, when ``qat``, ``QuantizationTransformPass``
    applied before ``minimize``; four batches of batch x seq."""
    cfg = T.TransformerConfig(max_length=256, dropout=0.1)
    main_prog, startup = fluid.Program(), fluid.Program()
    n = 0
    with fluid.program_guard(main_prog, startup):
        model = T.build(cfg)
        if qat:
            n = slim.QuantizationTransformPass().apply(main_prog)
        fluid.optimizer.Adam(1e-4).minimize(model["loss"])
    fluid.amp.enable_amp(main_prog)
    startup.random_seed = main_prog.random_seed = SEED
    feeds = [T.make_batch(cfg, batch, seq, seq, seed=SEED + i)
             for i in range(4)]
    return main_prog, startup, model["loss"], feeds, n


def qat_training(torch, np, fluid, T, fa, *, seq, batch, steps=4):
    """Phase 9d: the t = 256 Transformer-base training step at b = 16,
    dropout 0.1, bf16 AMP, through ``QuantizationTransformPass`` (a
    ``fake_quantize_dequantize`` on every input of every ``mul``): four
    steps captured equal to eager ones (``_same_runs``, as phase 5),
    finite losses; then the captured step's device ms and launches
    beside the same step without the pass, each from a trace of replays
    on its own executor, and the attention kernels' launches a step."""
    from paddle_tpu_torch import kernels, slim

    dev = fluid.CUDAPlace(0).torch_device()
    out = {"seq": seq, "batch": batch}
    step = {}
    for qat in (True, False):
        prog, startup, loss, feeds, n = _qat_training(
            fluid, T, slim, seq=seq, batch=batch, qat=qat)
        staged = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
                  for f in feeds]
        if qat:
            same = _same_runs(torch, np, fluid, prog, startup, staged,
                              [loss], steps)
            _held_same(same)
            assert all(np.isfinite(v) for r in same["first_fetch"]
                       for v in r), same["first_fetch"]
            out["fake_quant_ops"] = n
            out["captured_vs_eager"] = same
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            for _ in range(2):  # the warm-up, then the capture
                exe.run_steps(prog, staged[:1], 1, [loss])
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (value,) = exe.run_steps(prog, staged, steps, [loss])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
            launches = {k: v / steps for k, v in _counts(fa).items()}
            counts, trace = {}, {}
            times = _device_times(lambda: exe.run_steps(
                prog, staged[:1], 1, [loss]), iters=2, counts=counts,
                replay=True, trace=trace)
        exe.close()
        del scope
        torch.cuda.empty_cache()
        assert np.isfinite(value), value
        assert launches["small/fwd"] == launches["small/bwd"] == 18, launches
        step["qat" if qat else "plain"] = {
            "step_ms": wall, "step_device_ms": sum(times.values()),
            "launches_per_step": sum(counts.values()),
            "attention_launches": launches, "trace_let_off": trace,
            "last_loss": float(value)}
    q, p = step["qat"], step["plain"]
    out.update(step)
    out["added_device_ms"] = q["step_device_ms"] - p["step_device_ms"]
    out["added_launches"] = q["launches_per_step"] - p["launches_per_step"]
    return out


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
        # the bf16 kernel's padded head widths and ragged edges
        _case("dh72 bf16 drop", bf16, 2, 128, 128, "pad", p_drop=0.1, h=4,
              dh=72),
        _case("dh128 bf16 drop", bf16, 2, 128, 128, "pad", p_drop=0.2, h=4,
              dh=128),
        _case("ragged bf16", bf16, 2, 100, 77, "none"),
        # the widest head the kernels take (the JAX small kernel takes any)
        _case("dh256 bf16 causal drop", bf16, 2, 256, 256, "causal",
              p_drop=0.1, h=2, dh=256, split=True),
        _case("dh256 f32 pad", f32, 2, 256, 256, "pad_b", h=2, dh=256,
              split=True),
        _case("dh256 bf16 t1024 causal+pad", bf16, 1, 1024, 1024,
              "causal_pad", h=2, dh=256),
        # the training step's three attentions (encoder self, decoder
        # self, cross), with its dropout
        _case("train bf16 pad drop", bf16, tb, tt, tt, "pad_b", True, 0.1,
              repeat=True),
        _case("train bf16 causal+pad drop", bf16, tb, tt, tt, "causal_pad",
              True, 0.1),
        _case("train bf16 cross drop", bf16, tb, tt, tt, "pad_b", False,
              0.1),
        _case("train f32 pad drop", f32, tb, tt, tt, "pad_b", True, 0.1,
              split=True, repeat=True),
        _case("train f32 causal+pad drop", f32, tb, tt, tt, "causal_pad",
              True, 0.1, split=True),
        _case("train f32 cross drop", f32, tb, tt, tt, "pad_b", False, 0.1),
    ]
    # the kblock route: the t = 1024 training row's three attentions and
    # the prefill at src_len 1024
    for dname, dt in (("bf16", bf16), ("f32", f32)):
        fwd += [
            _case(f"t1024 {dname} pad drop", dt, 8, 1024, 1024, "pad_b",
                  True, 0.1, split=dt == f32),
            _case(f"t1024 {dname} causal+pad drop", dt, 8, 1024, 1024,
                  "causal_pad", True, 0.1),
            _case(f"t1024 {dname} cross drop", dt, 8, 1024, 1024, "pad_b",
                  False, 0.1),
        ]
    # the encoder self-attention of the serving prefill at src_len 1024
    # (the f32 kernel splits its 128 query tiles' keys in two)
    fwd.append(_case("prefill f32 t1024 pad", f32, 1, 1024, 1024, "pad",
                     True))
    # the bhtd route: the t = 4096 training row (decoder self with and
    # without its causal mask), dropout at t = 2048, BHTD-layout inputs,
    # and the serving decode step over 1024 keys
    fwd += [
        _case("t4096 bf16 causal+pad", bf16, 2, 4096, 4096, "causal_pad",
              True, split=True, repeat=True),
        _case("t4096 bf16 pad", bf16, 2, 4096, 4096, "pad_b", True,
              split=True),
        _case("t2048 bf16 causal+pad drop", bf16, 1, 2048, 2048,
              "causal_pad", True, 0.1),
        _case("bhtd layout f32 causal g_lse", f32, 2, 1024, 1024,
              "causal_pad", layout="bhtd", g_lse=True, split=True,
              repeat=True),
        _case("decode f32 tq1 tk1024", f32, 4, 1, 1024, "pad_b"),
    ]
    bwd = [c for c in fwd if c["name"].startswith(("train", "t1024",
                                                   "t4096", "t2048",
                                                   "bhtd", "dh256"))] + [
        _case("ragged f32", f32, 2, 100, 77, "none", split=True),
        _case("dh128 f32 drop", f32, 2, 128, 128, "pad", p_drop=0.2, h=4,
              dh=128, split=True),
        # f32 rows that are not 16-byte aligned (dh 30: copied element by
        # element), ragged, with dropout
        _case("dh30 f32 drop", f32, 2, 100, 77, "none", p_drop=0.1, h=4,
              dh=30, split=True),
        _case("dh32 bf16", bf16, 2, 96, 200, "pad", h=4, dh=32, split=True),
        _case("bf16 causal", bf16, 8, 256, 256, "causal"),
        # the bf16 kernels' padded head widths and ragged edges
        _case("dh72 bf16 drop", bf16, 2, 128, 128, "pad", p_drop=0.1, h=4,
              dh=72, split=True),
        _case("dh128 bf16 drop", bf16, 2, 128, 128, "pad", p_drop=0.2, h=4,
              dh=128, split=True),
        _case("ragged bf16", bf16, 2, 100, 77, "none", split=True),
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
        from paddle_tpu_torch.ops import nn_ops
        from paddle_tpu_torch.parallel import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              f"repository root", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA device", file=sys.stderr)
        return 3

    # each phase's wall seconds, the builds' included
    phase_s, last = {}, [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

    # 1. the card
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | device {kind}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_done("card")

    # 2. build every kernel source, one nvcc each, all started together
    sources = [fa._FWD_SOURCE, fa._BWD_SOURCE, fa._MASK_SOURCE, cb.SOURCE,
               gc.SOURCE, aa.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(kernels.build, sources))
    for source, built in zip(sources, builds):
        if built is None:
            print(f"build {source}: cached", flush=True)
        else:
            log, seconds = built
            print(f"build {source}: {seconds:.2f} s\n{_ptxas_report(log)}",
                  flush=True)

    phase_done("build")

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
    kernels.reset_counts()
    mask = check_mask_dump(fa, TRAIN_B, TRAIN_T, 8, TRAIN_T, 0.1)
    mask_launches = kernels.launch_counts["attention_mask"]
    print("mask " + json.dumps(mask), flush=True)
    # the dropout op's kernel at the t = 256 step's activation shape, in
    # both dtypes the AMP step feeds it
    drop_rows = [check_dropout_op(nn_ops, (TRAIN_B, TRAIN_T, 512), dt, 0.1)
                 for dt in (torch.bfloat16, torch.float32)]
    for r in drop_rows:
        print("dropout_op " + json.dumps(r), flush=True)
    # the causal skip: causal / non-causal device time at t = 4096
    c_f, n_f = (fwd_results[f"t4096 bf16 {k}"] for k in ("causal+pad", "pad"))
    c_b, n_b = (bwd_results[f"t4096 bf16 {k}"] for k in ("causal+pad", "pad"))
    skip = {"fwd": c_f["device_ms"] / n_f["device_ms"],
            "pass_a": c_b["device_ms_pass_a"] / n_b["device_ms_pass_a"],
            "pass_b": c_b["device_ms_pass_b"] / n_b["device_ms_pass_b"]}
    print("causal_skip " + json.dumps(skip), flush=True)
    for dname, tag in (("bfloat16", "fwd_bf16"), ("float32", "fwd_f32")):
        print(f"{tag} " + json.dumps({
            name: {"device_ms": r["device_ms"], "ms": r["ms"],
                   "library_ms": r["library_ms"],
                   "ms_over_library": r["ms"] / r["library_ms"],
                   "err_out": r["err_out"], "err_lse": r["err_lse"],
                   "kernels": r["kernels"]}
            for name, r in fwd_results.items() if r["dtype"] == dname}),
            flush=True)
    # the backward rows against the library's backward timed directly:
    # events ms over events ms, device ms over device ms
    for dname, tag in (("bfloat16", "bwd_bf16"), ("float32", "bwd_f32")):
        print(f"{tag} " + json.dumps({
            name: {"ms": r["ms"], "device_ms": r["device_ms"],
                   "device_ms_pass_a": r["device_ms_pass_a"],
                   "device_ms_pass_b": r["device_ms_pass_b"],
                   "library_ms": r["library_ms"],
                   "library_device_ms": r["library_device_ms"],
                   "ms_over_library": r["ms"] / r["library_ms"],
                   "device_over_library": (r["device_ms"]
                                           / r["library_device_ms"]),
                   "bound_ms": r["bound_ms"],
                   "bound_route": r["bound_route"],
                   "max_rel_err": max(r["rel_err_dq_dk_dv"])}
            for name, r in bwd_results.items() if r["dtype"] == dname}),
            flush=True)

    phase_done("3")

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
    kernels.reset_counts()
    for study in (cb, gc, aa):
        study.main()
    study_launches = {name: kernels.launch_counts[study.SOURCE]
                      for name, study in (("conv_bwd", cb),
                                          ("grouped_conv", gc),
                                          ("attn_ablate", aa))}
    assert min(study_launches.values()) > 0, study_launches
    print("study_launches " + json.dumps(study_launches), flush=True)
    torch.cuda.empty_cache()

    phase_done("3c")

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

    phase_done("4")

    # 5. the training path, at t = 256 and (5b) the long-context rows;
    # first the captured step against the eager one
    same = check_captured_equals_eager(torch, np, fluid, T, seq=TRAIN_T,
                                       batch=TRAIN_B)
    print("captured_vs_eager " + json.dumps(same), flush=True)
    t = train(torch, np, fluid, T, fa, seq=TRAIN_T, batch=TRAIN_B,
              route="small", rerun=True)
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
    phase_done("5")

    # 5c. the same t = 256 step in f32 (no AMP): the attention backward on
    # the 3xTF32 kernels, 18 launches a step on the small route
    t32 = train(torch, np, fluid, T, fa, seq=TRAIN_T, batch=TRAIN_B,
                route="small", amp=False)
    print("train_f32 " + json.dumps(t32), flush=True)
    print(f"training Transformer-base in f32 on {card}: step "
          f"{t32['step_ms']:.1f} ms wall, {t32['step_device_ms']} ms device "
          f"busy, attention backward {t32['bwd_passes_device_ms']:.3f} ms a "
          f"step, {t32['target_tokens_per_s']:.0f} target tokens/s, peak "
          f"{t32['peak_mem_gib']:.2f} GiB", flush=True)
    torch.cuda.empty_cache()

    phase_done("5c")

    # 5d. the training recipe at t = 256: loss scaling, clip, AdamW
    rec = train_recipe(torch, np, fluid, T, fa, t, seq=TRAIN_T,
                       batch=TRAIN_B)
    print("train_recipe " + json.dumps(rec), flush=True)
    tr = rec["timing"]
    print(f"training Transformer-base through the recipe on {card}: step "
          f"{tr['step_ms']} ms wall, {tr['step_device_ms']:.2f} ms device "
          f"busy ({tr['added_device_ms']:+.2f} ms and "
          f"{tr['added_launches']:+.0f} launches over plain Adam), "
          f"{tr['target_tokens_per_s']} target tokens/s", flush=True)

    phase_done("5d")

    # 6. one training step on the card against the CPU
    c = train_vs_cpu(torch, np, fluid, T, fa, n_layer=6, seq=32, batch=2)
    print("train_vs_cpu " + json.dumps(c), flush=True)
    # the f32 steps at t = 768 (kblock) and 1280 (bhtd): the 3xTF32
    # backward on the long routes, its launches read from each step
    vs_cpu = {}
    for seq in (768, 1280):
        vs_cpu[seq] = train_vs_cpu(torch, np, fluid, T, fa, n_layer=2,
                                   seq=seq, batch=1, max_length=seq + 2)
        print(f"train_vs_cpu_t{seq} " + json.dumps(vs_cpu[seq]), flush=True)

    phase_done("6")

    # 7. the vision training path: ResNet-50, (7b) SE-ResNeXt-50, and
    # (7c) the studied shapes among their conv2d ops
    shape = dict(data_shape=(3, 224, 224), class_dim=1000, depth=50)
    vision_progs = {}
    for name, build in (("resnet50", lambda: R.get_model(**shape)),
                        ("se_resnext50", lambda: S.get_model(**shape))):
        vision_progs[name], v = train_vision(
            torch, np, fluid, imagenet, name, build, batch=VISION_BATCH,
            lr=VISION_LR, fall_lr=VISION_FALL_LR,
            check_equal=name == "resnet50")
        print(f"train_{name} " + json.dumps(v), flush=True)
        print(f"training {name} on {card}: step {v['step_ms']:.1f} ms wall, "
              f"{v['step_device_ms']} ms device busy, "
              f"{v['images_per_s']:.0f} images/s, peak "
              f"{v['peak_mem_gib']:.2f} GiB", flush=True)
        torch.cuda.empty_cache()
    live = live_shapes(vision_progs["resnet50"], vision_progs["se_resnext50"],
                       VISION_BATCH, cb.SHAPES, gc.SHAPES)
    print("live_shapes " + json.dumps(live), flush=True)
    print("top_k_ties " + json.dumps(check_top_k_ties(torch, np)),
          flush=True)
    del vision_progs

    phase_done("7")

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

    phase_done("8")

    # 9. export and deploy: the __model__ format and the Predictor, int8
    # post-training quantization served on the card, and QAT
    with tempfile.TemporaryDirectory() as tmp:
        ex, fp32_dir = export_transformer(torch, np, fluid, T, fa, tmp)
        print("export " + json.dumps(ex), flush=True)
        q8 = int8_transformer(torch, np, fluid, T, fa, serving, tmp,
                              fp32_dir)
        print("int8_serve " + json.dumps(q8), flush=True)
        eng8 = q8["int8_engine"]
        print(f"serving Transformer-base from its int8 artifact on {card}: "
              f"{q8['artifact_bytes']} bytes ({q8['fp32_over_int8']:.2f}x "
              f"smaller than fp32), {eng8['tokens_per_s']:.1f} tokens/s, "
              f"decode step {eng8['decode_step_ms']:.3f} ms, "
              f"{eng8['launches']['small/fwd']} small/fwd and "
              f"{eng8['launches']['dense_calls']} dense attention calls",
              flush=True)
        v8 = vision_export_int8(torch, np, fluid, R, imagenet, tmp)
        print("resnet50_export " + json.dumps(v8), flush=True)
    qat = qat_training(torch, np, fluid, T, fa, seq=TRAIN_T, batch=16)
    print("qat " + json.dumps(qat), flush=True)

    phase_done("9")
    print("phase_seconds " + json.dumps(phase_s), flush=True)

    t1k, t4k = long_train[1024], long_train[4096]
    fwd_main = fwd_results["train bf16 pad drop"]
    fwd_prefill = fwd_results["prefill f32 pad"]
    bwd_main = bwd_results["train bf16 pad drop"]
    bwd_f32 = bwd_results["train f32 pad drop"]
    kb_bwd_f32 = bwd_results["t1024 f32 pad drop"]
    bh_passes_f32 = bwd_results["bhtd layout f32 causal g_lse"]["passes"]
    kb_fwd, kb_bwd = (fwd_results["t1024 bf16 pad drop"],
                      bwd_results["t1024 bf16 pad drop"])
    kb_fwd_f32 = fwd_results["t1024 f32 pad drop"]
    bh_fwd = fwd_results["t4096 bf16 causal+pad"]
    bh_decode = fwd_results["decode f32 tq1 tk1024"]
    passes = bwd_results["t4096 bf16 causal+pad"]["passes"]

    def err(row):
        return max(row["err_out"], row["err_lse"])

    kernels_line = {"kernels": [
        _kernel_entry(
            "flash_attention_bthd_fwd, bf16 fwd_wgmma_kernel (small route)",
            _SRC_FWD, f"{_TPU_FA}:808", t["launches"]["small/fwd"],
            fwd_main, err(fwd_main)),
        _kernel_entry(
            "flash_attention_bthd_fwd, f32 fwd_kernel (CUDA cores, 64-row "
            "tiles; small route, serving prefill)", _SRC_FWD,
            f"{_TPU_FA}:808",
            s["launches"]["small/fwd"], fwd_prefill, err(fwd_prefill)),
        _kernel_entry(
            "flash_attention_bthd_bwd (bf16: bwd_dkdv_wgmma_kernel + "
            "bwd_dq_wgmma_kernel)", _SRC_BWD, f"{_TPU_FA}:861",
            t["launches"]["small/bwd"], bwd_main,
            max(bwd_main["err_dq_dk_dv"])),
        _kernel_entry(
            "flash_attention_bthd_bwd (f32: bwd_dkdv_tf32_kernel + "
            "bwd_dq_tf32_kernel, 3xTF32 on mma.sync; small route, f32 "
            "training)", _SRC_BWD, f"{_TPU_FA}:861",
            t32["launches"]["small/bwd"], bwd_f32,
            max(bwd_f32["err_dq_dk_dv"])),
        _kernel_entry(
            "flash_attention_bthd_bwd (f32, 3xTF32; kblock route, the f32 "
            "step at t = 768)", _SRC_BWD, f"{_TPU_FA}:1028",
            vs_cpu[768]["launches"], kb_bwd_f32,
            max(kb_bwd_f32["err_dq_dk_dv"])),
        _kernel_entry(
            "flash_attention_bwd pass B, dq, bwd_dq_tf32_kernel (f32, bhtd "
            "route, causal, lse cotangent; the f32 step at t = 1280)",
            _SRC_BWD, f"{_TPU_FA}:181", vs_cpu[1280]["launches"],
            bh_passes_f32["pass_b"], bh_passes_f32["pass_b"]["max_abs_err"]),
        _kernel_entry(
            "flash_attention_bwd pass A, dk/dv, bwd_dkdv_tf32_kernel (f32, "
            "bhtd route, causal, lse cotangent; the f32 step at t = 1280)",
            _SRC_BWD, f"{_TPU_FA}:233", vs_cpu[1280]["launches"],
            bh_passes_f32["pass_a"], bh_passes_f32["pass_a"]["max_abs_err"]),
        _kernel_entry(
            "dropout op forward (dropout_apply_kernel; bf16 row)",
            "paddle_tpu_torch/csrc/dropout_mask.cu",
            "no Pallas source: the JAX dropout op draws its mask with "
            "jax.random, paddle_tpu/ops/nn_ops.py:244",
            t["launches"]["dropout"], drop_rows[0], 0.0),
        _kernel_entry(
            "dropout_keep_mask (dropout_mask_kernel)",
            "paddle_tpu_torch/csrc/dropout_mask.cu",
            "tests/test_flash_attention_tpu.py:26", mask_launches, mask,
            0.0),
        _kernel_entry(
            "flash_attention_fwd, bf16 fwd_wgmma_kernel (bhtd route, "
            "causal)", _SRC_FWD, f"{_TPU_FA}:126",
            t4k["launches"]["bhtd/fwd"], bh_fwd, err(bh_fwd)),
        _kernel_entry(
            "flash_attention_fwd, f32 fwd_decode_kernel + fwd_merge_kernel "
            "(CUDA cores, split-KV; bhtd route, decode step)", _SRC_FWD,
            f"{_TPU_FA}:126",
            sl["launches"]["bhtd/fwd"], bh_decode, err(bh_decode)),
        _kernel_entry(
            "flash_attention_bwd pass B, dq, bwd_dq_wgmma_kernel (bhtd route, "
            "causal)", _SRC_BWD,
            f"{_TPU_FA}:181", t4k["launches"]["bhtd/bwd"],
            passes["pass_b"], passes["pass_b"]["max_abs_err"]),
        _kernel_entry(
            "flash_attention_bwd pass A, dk/dv, bwd_dkdv_wgmma_kernel (bhtd "
            "route, causal)",
            _SRC_BWD, f"{_TPU_FA}:233", t4k["launches"]["bhtd/bwd"],
            passes["pass_a"], passes["pass_a"]["max_abs_err"]),
        _kernel_entry(
            "flash_attention_bthd_fwd, bf16 fwd_wgmma_kernel (kblock route)",
            _SRC_FWD, f"{_TPU_FA}:964", t1k["launches"]["kblock/fwd"],
            kb_fwd, err(kb_fwd)),
        _kernel_entry(
            "flash_attention_bthd_fwd, f32 fwd_kernel (CUDA cores, 64-row "
            "tiles, with fwd_merge_kernel where the keys split; kblock "
            "route, serving prefill at 1024)", _SRC_FWD, f"{_TPU_FA}:964",
            sl["launches"]["kblock/fwd"], kb_fwd_f32, err(kb_fwd_f32)),
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
            "grouped_conv (grouped_conv_mma_kernel, mma.sync; s0-s3)",
            "paddle_tpu_torch/csrc/grouped_conv.cu",
            "benchmarks/grouped_conv_pallas.py:42",
            study_launches["grouped_conv"], gconv_rows[0], gconv_rows),
    ]}
    # every kernel of the paths ran in them
    assert all(e["launches"] > 0 for e in kernels_line["kernels"]), [
        (e["name"], e["launches"]) for e in kernels_line["kernels"]]
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
