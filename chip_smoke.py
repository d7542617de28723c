#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero; no phase is caught):

1. the card: name and power limit (nvidia-smi), torch's device name;
2. build every CUDA source in csrc/ (seven sources, one nvcc each, all
   started together) and print ptxas' register / shared-memory report and
   each build's seconds (or that it was cached); while the two attention
   sources compile (minutes), the phases that launch none of their
   kernels run on the card, in this order: 17, 18 (once the NMS sweep's
   source has built), 3c (once the study sources have built), 7, 8 and
   15 (once the dropout source has built); phase 3 waits for every
   build;
3. hold each kernel against its plain PyTorch version on the card, with
   stated tolerances, and time kernel, plain version and the one PyTorch
   library call that computes the same function (the yardstick, never
   used by the package), on every route of
   ``flash_attention.attention_route``: the small route (serving and
   t = 256 training shapes, and the beam decode loop's two of phase
   12), the kblock route (t = 1024, b = 8), the bhtd route (t = 4096,
   b = 2; dropout at t = 2048; BHTD-layout inputs with an lse cotangent;
   the decode step tq = 1 over 1024 keys; each backward pass launched
   and checked on its own; bf16 rows read the
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
10. the serving planes (``serving_planes``), Transformer-base at full
    width, weights from seed 1234, at phase 4's two geometries, with the
    telemetry flag on for (a)-(d): (10a) an EngineSupervisor whose decode
    step 5 raises without a slot hint restarts once, replays all 16
    requests and returns the greedy tokens of an undisturbed engine byte
    for byte (the seconds from the failure to the first replayed token,
    and the lowerings and graph captures the restart cost); a fresh
    supervisor through three such faults holds its reserved memory
    (after restart 3 within 0.25 GiB of after restart 1); meanwhile a
    thread reads /metrics, /serve and /requests of ``monitor.serve(port=0)``
    and ``monitor.device_memory()`` while the engines capture; (10b) a
    warm supervisor's decode loop parked 1 s against a 250 ms watchdog:
    a serve.decode stall record, one restart, the same tokens, and the
    parked thread ends after the restart without a decode step; (10c)
    ``raise(slot=3)`` evicts only slot 3, and NaN written into slot 2's
    cross-attention K rows through the Scope ends that request 'error'
    with every serving state tensor finite after the scrub, the other
    requests' tokens unchanged; (10d) a fault-plan RESOURCE_EXHAUSTED and
    a real torch.OutOfMemoryError in a decode step each fail the engine
    and leave an OOM record with phase 'serve', the card's watermarks
    and the allocator's largest live blocks; (10e) at both geometries,
    decode windows in turns with telemetry, request tracing and the
    trace ring off, on, on, off: decode step ms and tokens/s, and the
    sampled decode steps' feed / dispatch / device / fetch ms and host
    share; (10f) phase 5d's recipe step with the numerics plane on (its
    gradients instrumented): four steps eager and
    captured give bit-equal bundles, the loss-scale and grad-norm gauges
    equal the in-graph values, and the device ms and launches the stats
    op adds to a captured step;
11. the fleet front door (``fleet_front_door``), Transformer-base at
    full width, weights from seed 1234, ServingFleet over supervised
    replicas on the one card, every stream held byte for byte to an
    engine run alone: (11a) 3 replicas serve 48 requests at src_len 128
    (every replica serves, no restart), tokens/s beside one warm engine
    at the same offered load; (11b) ``router.replica_crash:
    raise(replica=1)`` kills a replica mid-decode, at 128 with 3 replicas
    and at src_len = max_len = 1024 with 2 replicas of 4 slots: monotone
    streams, one trace tid a request; (11c) a rolling rollout to weights
    from seed 1235 under traffic: nothing rejected, each stream equal to
    an engine alone on the weights of the generation that served it;
    (11d) the autoscaler up under saturation (seconds from the decision
    to the new replica's first token, its lowerings and captures) and
    down when idle; (11e) the capture gate's record over the phase: no
    capture failed, no pump error, no restart, reserved memory after the
    fleets close within 0.25 GiB of before the phase; captures that
    waited and the longest wait;
12. beam-search translation (``beam_translate``), Transformer-base at
    full width, weights from seed 1234, 8 sources of phase 4's 128
    geometry (src_len = max_len = 128); a line names each sub-phase
    before it runs: (12a) ``transformer.translate(beam_size=1)`` on the
    card equals the serving engine's greedy tokens row for row (a row
    may diverge only at a step whose two best logits lie within 1e-4,
    read by teacher forcing; the count is printed); (12b) beam 4 in
    turns, eager (uncached: the while op's eager loop), captured,
    captured (the loop body a captured CUDA graph replayed from the host
    loop), eager: equal ids, bit-equal scores; each turn's wall, steps,
    ms a step, hypothesis tokens a second, body captures and fwd_kernel
    launches, and a profiled run a mode for its launches and device ms a
    step; (12c) the same with end_id set to the token 12b's best beam of
    source 0 wrote at step 5, held to the loop's exit rule (it stops at
    the step where its last hypothesis ended, or at max_len - 1 when one
    never does; the hypotheses that ended are counted), end_id at every
    position a hypothesis wrote after its end; and the early exit itself:
    source 0 alone, greedy, with end_id the token it wrote at step 5,
    whose loop must stop after at most 5 steps, eager and captured alike;
    (12d) translate on the card against the CPU at full
    width, 2 sources, beam 4, src_len = max_len = 16: equal ids under
    12a's near-tie rule, scores within 1e-4 relative; (12e) the f32
    fwd_kernel at the loop's two attention shapes (self-attention over
    b*K = 32 rows of 128 with the causal mask folded into a row bias,
    cross-attention over 128 source keys), held against its plain version
    among phase 3's cases, reported beside phase 12's launches;
13. the benchmark's other model families (``families``), each at the
    JAX package's benchmark configuration (bench_family.py), weights from
    seed 1234, a line naming each sub-phase before it runs: (13a)
    BERT-base pretraining (12 layers, d 768, 12 heads, vocab 30522) at
    b 64 x s 128, bf16 AMP, Adam 1e-4; (13b) DeepFM (26 fields, 1M-row
    tables, 16-dim factors, a 400 x 400 x 400 tower) at b 4096, Adam
    1e-3, dense and with row-sparse embedding gradients
    (``is_sparse=True``, ``is_distributed=True``); (13c) SSD-300 (VGG16,
    8732 priors, 21 classes, 50 padded gt rows) at b 32, bf16 AMP,
    Momentum(0.001, 0.9), on bench_family.py's synthetic feed: each
    three steps eager, captured (run) and in a run_steps window from one
    startup, captured equal to eager bit for bit; then timed in turns,
    eager and captured: step wall and device ms, idle share, tokens /
    examples / images a second, launches a step from the trace, peak
    memory; BERT's step launches fwd_wgmma_kernel and passes A and B 12
    times each on the small route, no dense attention, and its share of
    the bf16 dense peak (bench_family.py's FLOP formula); DeepFM's sparse
    run leaves every row no batch touched bit-unchanged in both tables
    and both Adam moments; (13d) two f32 steps of each model at 2 layers
    or blocks of its full width (BERT 2 layers, DeepFM a 400 x 400 tower
    on both paths, ``ssd.get_model`` with its detection_output head)
    on the card against the port on the CPU (TOL_FAMILY_*); phase 3
    holds the attention kernels at BERT's shape;
14. the training runtime (``training_runtime``), a line naming each
    sub-phase before it runs: (14a) Transformer-base (full width and
    depth, dropout 0.1, label smoothing 0.1, bf16 AMP through
    amp.decorate, Adam under noam_decay(512, 4000)) trained through
    contrib.Trainer from dataset.wmt16 (batch 64, source and target
    padded to 256, reader.firstn) with prefetch_depth 2 and an async
    checkpoint every epoch, three epochs of 16 steps: a finite loss every
    step, the LR equal to noam_decay's closed form, 18 + 18 small-route
    launches a step and none of any other route, the dropout kernel's
    launches, the last epoch's ms a step, a replayed step's device ms,
    idle share, target tokens/s and peak reserved memory, and each save's
    snapshot ms, background write s, bytes and the next save's wait;
    (14b) prefetch_depth 0 against 2 in turns on the same path (two
    epochs of 8 steps) and on bench_pipeline.py's MLP, under its flags:
    equal losses bit for bit, ms a step, sync / pipelined, the verdict
    mix; (14c) reader.next fails in epoch 2 with one resume allowed and
    async saves: the trainer resumes from checkpoint_2 and its final
    parameters, Adam moments and LR step equal 14a's bit for bit; a
    ckpt.commit fault leaves checkpoint_3 as latest and valid; (14d) 14a's
    capture taken with the loader streaming (batches staged ahead, no
    capture failure), and six small steps captured on the main thread
    while a DeviceLoader streams to another thread: no capture fails, the
    loader's copies waited for the captures, captured equal eager; (14e)
    Executor.train_from_dataset over an InMemoryDataset of text files
    equals the same batches through Executor.run bit for bit, and
    release_scope frees the scope's captured steps; bounded to 150 s;
15. the recurrent family and the rest of the benchmark's zoo (``zoo``):
    stacked_dynamic_lstm (15a), machine_translation (15b), VGG-16 f32 and
    bf16 (15c), MNIST conv and MLP (15d) trained at fluid_benchmark.py's
    defaults, captured equal to eager bit for bit; VGG-16 served through
    the Predictor at mb 64 (15e); the rnn ops in f64 and each model small
    against the CPU (15f); bounded to 150 s;
16. structured control flow, CRF / CTC and the label-semantic-roles
    chapter (``control_flow``), a line naming each sub-phase before it
    runs: (16a) the book's db_lstm at its widths (8 layers of LSTM 128
    from fc 512, 59 labels, the frozen 44,068 x 32 conll05 table, the
    CRF's transition at lr 1e-3, SGD on an exponential decay) at batch
    10 x T 30 from conll05.train() through DataFeeder: captured equal to
    eager bit for bit, timed in turns (step and device ms, launches,
    idle share, examples/s, the derived grads' re-runs), the loss falling
    on a repeated batch, the decode path and chunk F1, and the path
    through save / load_inference_model bit for bit; (16b)
    transformer.build_scan at phase 5's configuration: in f32 at dropout
    0, from one state, every gradient of its first SGD step within 1e-5
    (loss) / 1e-4 (gradients) of build()'s on its stacked weights, every
    parameter after that step within 0.5 of build()'s update, and its
    free-running second step within the same limits of build()'s from
    its state; in bf16 AMP at dropout 0.1 captured equal to
    eager bit for bit, each scan's forward recomputed in its scan_grad
    equal to the forward's, unroll 6 equal to unroll 1, the captured
    step's ms beside phase 5's with its fwd_wgmma_kernel, pass A + B and
    dropout launches; (16c) cond with a non-finite untaken branch,
    bounded_while under and at its bound, Switch, DynamicRNN, StaticRNN,
    IfElse, warpctc, the greedy decoder, edit_distance, chunk_eval,
    hash, print / py_func in a training step (uncaptured, printing every
    step), the card against the CPU, and the CRF / CTC ops in f64;
    bounded to 120 s;
17. the op-library slice (``op_library``), a line naming each sub-phase
    before it runs: (17a) each of the slice's 88 op types (math, tensor,
    nn, proximal optimizer) at small shapes in f64 on the card against
    the CPU, outputs and derived gradients (one normal cotangent an
    output; ``op_and_grads``), the draws of the random ops bit for bit and
    each random op held to its properties (range, uniformity, moments);
    (17b) the word2vec chapter's N-gram model at a 10,000-word
    vocabulary (4 context words, embedding 256, fc 1024 relu, batch 1024,
    Adam 1e-3) with four heads: fc + softmax + the older cross_entropy,
    hsigmoid, nce (10 negatives), sampled softmax (1,024 samples), each
    50 steps eager and captured, equal bit for bit, the loss falling, the
    captured step's wall and device ms, launches, examples/s, and two f32
    steps against the CPU (TF32 off); (17c) the DCGAN generator (z 100 ->
    4 x 4 x 1024 -> conv2d_transpose 512, 256, 128, 3 -> 64 x 64 x 3) at
    batch 128, f32 and bf16 AMP, Adam(2e-4, beta1 0.5), 20 steps eager
    and captured equal bit for bit (cuDNN deterministic for that check),
    timed, and two f32 steps at batch 8 against the CPU; bounded to 120 s;
18. the vision and detection slice (``vision_detection``), a line naming
    each sub-phase before it runs: (18a) each of the slice's 31 op types
    (vision_ops' 22, detection_ops' 9) at small shapes in f64 on the card
    against the CPU, outputs and derived gradients (``op_and_grads``), the
    three sampling ops' selections bit for bit from one op seed and held
    to their properties; the NMS sweep (nms_sweep_mask_kernel and
    nms_sweep_scan_kernel) against its plain version bit for bit at m =
    64, 400, 1000, 2000 and 12,000 (ties, zero-width, inverted,
    duplicate, NaN and infinite boxes; the case's threshold and -0.1; in
    vision_ops' IoU and, through detection_ops' RPN sweep, in
    box_util's), the mask kernel's words equal to the plain words, timed
    by events and from the trace (both kernels, each) beside the plain
    loop's time and launches and the bound of the IoU tests the data
    needs; SSD-300's multiclass_nms through the kernels equal to the
    plain sweep's bit for bit; (18b) FPN Faster
    R-CNN's heads at Detectron's R-50-FPN_1x widths (2 images of 800 x
    1344, P2-P6 at 256 channels from fed lateral sums, 268,569 anchors an
    image, rpn_target_assign, generate_proposals a level, collect /
    generate_proposal_labels / distribute, roi_align 7 x 7 on each level,
    the box head, mask targets at 28), Momentum(0.02, 0.9), 10 steps eager
    and captured equal bit for bit, the loss falling, the captured step
    timed with the sweep's launches and device ms, and two steps at a toy
    size against the CPU; (18c) YOLOv3's three heads at 608 x 608, batch
    8, 50 gt rows, yolov3_loss at strides 32 / 16 / 8, 10 steps eager and
    captured equal bit for bit, timed; the eval path (yolo_box,
    multiclass_nms over 640 candidate sets of 1000) timed in turns; two
    toy steps against the CPU; (18d) SSD-300's VOC evaluation
    (detection_output, DetectionMAP 11-point with difficult gts) over 4
    batches of 32 and a reset, every mAP and binned state equal to the
    metric's on the CPU over the same detections, the batch's device ms
    and the sweep's in it; bounded to 120 s;
19. print the kernels' JSON line, the card line, and the result line.

Every executor is closed after its phase (its graphs and their pools
freed).

Exits non-zero without a result when CUDA is unavailable or when the
package is not next to this script.
"""

import collections
import gc
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

        traced_turns = {True: 0, False: 0}

        def turn(eager):
            """One timed window, its launch counts and, in the first eager
            turn and the second captured one, the device time of one step
            (a profiler trace, by kernel name)."""
            traced_turns[eager] += 1
            trace_this = traced_turns[eager] == (1 if eager else 2)
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
            counts, trace, times, traced = {}, {}, {}, None
            if trace_this and eager:
                times = _device_times(lambda: exe.run(
                    main_prog, feed=feeds[0], fetch_list=[loss],
                    use_program_cache=False), iters=2, expect=expect,
                    counts=counts, trace=trace)
            elif trace_this:
                times = _device_times(lambda: exe.run_steps(
                    main_prog, feeds[:1], 1, [loss]), iters=2, expect=expect,
                    counts=counts, replay=True, trace=trace)
            if trace_this:
                traced = {str(m): sum(n for k, n in counts.items()
                                      if _matches(k, m)) for m in expect}
                # the replay counts and the trace's, kernel by kernel name
                assert list(traced.values()) == [
                    per_step[f"{route}/fwd"], per_step[f"{route}/bwd"],
                    per_step[f"{route}/bwd"], per_step["dropout"]], (
                        traced, per_step)
            device_ms = sum(times.values()) if trace_this else None
            tokens = sum(float(feeds[i % 4]["trg_pad_mask"].sum())
                         for i in range(window))
            step_ms = wall / window * 1e3
            return {"step_ms": step_ms, "step_device_ms": device_ms,
                    "idle_share": device_ms and 1 - device_ms / step_ms,
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


def hold_vs_f64(np, program, names, ref, got,
                tol=(TOL_STEP_LOSS, TOL_GATE_REL, TOL_STEP_GRAD_REL)):
    """A step in f32 (or bf16) against the same step in f64, held as
    TOL_GATE_REL sets out: ``ref`` / ``got`` hold the f64 / other fetches,
    the loss, the gradients of ``names`` and the pre-activation of every
    relu gate of ``program``, in that order; ``tol``: (loss absolute,
    gate, gradient relative to its largest element). Returns the loss
    error, each gradient's relative error, the flipped gates and the
    gradients they reach (printed, not held)."""
    tol_loss, tol_gate, tol_grad = tol
    gates = _relu_gates(program)
    k = 1 + len(names)
    assert len(ref) == len(got) == k + len(gates)
    loss_err = abs(float(got[0]) - float(ref[0]))
    assert loss_err <= tol_loss, (float(got[0]), float(ref[0]))
    flips, reached, gate_err = {}, set(), 0.0
    for (idx, name), x32, x64 in zip(gates, got[k:], ref[k:]):
        err = float(np.abs(x32 - x64).max() / np.abs(x64).max())
        assert err <= tol_gate, (name, err)
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
    assert max(held.values(), default=0.0) <= tol_grad, held
    return {"loss_err": loss_err, "gate_rel_err": gate_err,
            "flipped_gates": flips, "grad_rel_err": held,
            "reached_by_a_flip": {n: e for n, e in rel.items()
                                  if n in reached}, "tol": list(tol)}


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
    step (``hold_vs_f64``)."""
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
            "cpu_f32_vs_f64": hold_vs_f64(np, main_prog, names, ref,
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


def card_startup_state(fluid, startup):
    """The state ``startup`` makes on the card: {name: numpy array}."""
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    exe.close()
    return {n: scope.find_var(n).cpu().numpy() for n in scope.var_names()}


def step_vs_cpu(np, fluid, name, main_prog, state, loss, feed, names, held,
                tol, *, double, extra=()):
    """One training step (TF32 off) of ``main_prog`` on the card, through
    the captured path, against the same step, from the same ``state``
    and ``feed``, on the CPU: the loss (absolute) and the gradients of
    ``names``, each relative to its largest element; those of ``held``
    within ``tol`` = (loss, gradient), the others printed. ``double``:
    state and float feeds cast to float64 (every op of the path follows
    its inputs' dtype). ``extra``: vars fetched after the gradients.
    Returns (row, the card's fetches, the CPU's)."""
    from paddle_tpu_torch import io as tio

    wide = np.float64 if double else np.float32

    def cast(d):
        return {n: v.astype(wide) if v.dtype == np.float32 else v
                for n, v in d.items()}
    state, feed = cast(state), cast(feed)
    fetch = [loss] + [n + "@GRAD" for n in names] + list(extra)
    gpu = run_captured(fluid, main_prog, state, feed, fetch)
    with fluid.scope_guard(tio.scope_from_numpy(state, fluid.CPUPlace())):
        cpu = fluid.Executor(fluid.CPUPlace()).run(main_prog, feed=feed,
                                                   fetch_list=fetch)
    assert gpu[1].dtype == wide, gpu[1].dtype
    loss_err = abs(float(gpu[0]) - float(cpu[0]))
    rel = {}
    for n, g, c in zip(names, gpu[1:], cpu[1:]):
        assert g.shape == c.shape and np.isfinite(g).all(), n
        rel[n] = _rel_err(np, g, c)
    row = {"model": name, "dtype": np.dtype(wide).name,
           "feed_shapes": {k: list(v.shape) for k, v in feed.items()},
           "loss_gpu": float(gpu[0]), "loss_cpu": float(cpu[0]),
           "loss_err": loss_err, "grad_rel_err": rel, "tol_loss": tol[0],
           "tol_grad_rel": tol[1], "grads_held": list(held)}
    assert loss_err <= tol[0] and max(rel[n] for n in held) <= tol[1], row
    return row, gpu, cpu


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


# Phase 10 (the serving planes): Transformer-base at full width, weights
# from SEED, phase 4's geometries. Greedy tokens are compared for
# equality (byte-identical replays); restarts' reserved memory within
# 0.25 GiB of the first restart's.
SERVE_GEOM = dict(slots=8, src_len=128, max_len=128, n_req=16,
                  new_tokens=32, min_len=16)
SERVE_LONG_GEOM = dict(slots=4, src_len=1024, max_len=1024)
TOL_RESTART_RESERVED_GIB = 0.25
# the wedge drill: a decode step parked 1.0 s against a 250 ms watchdog
# (tests/test_serving_resilience.py:297's timeout)
WEDGE_TIMEOUT_MS, WEDGE_DELAY_S = 250, 1.0


def _serving_weights(fluid, T, cfg, seed=SEED):
    """Transformer-base's is_test weights on the card from ``seed``: the
    Scope every phase 10 and 11 engine serves."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        T.build(cfg, is_test=True)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    exe.close()
    return scope


def _sources(np, cfg, n_req, src_len, min_len):
    rng = np.random.RandomState(SEED)
    lens = rng.randint(min_len, src_len + 1, n_req)
    return [rng.randint(3, cfg.src_vocab_size, n).astype(np.int64)
            for n in lens]


def _undisturbed(serving, cfg, weights, srcs, geom, new_tokens):
    """Greedy tokens of an engine stepped on this thread, no fault."""
    eng = serving.ServingEngine(cfg, weights, **geom)
    hs = [eng.submit(s, max_new_tokens=new_tokens) for s in srcs]
    eng.run_until_idle()
    eng.close()
    assert all(h.outcome in ("completed", "length") for h in hs)
    return [list(h.tokens) for h in hs]


def _graph_costs(exe):
    """(lowered programs, captured graphs) of an executor."""
    graphs = sum(r.graph is not None for rs in exe._runners.values()
                 for r in rs.values())
    return len(exe._cache), graphs


class _RouteReader:
    """Reads /metrics, /serve and /requests of the monitor server and
    ``monitor.device_memory()`` in a loop on a thread of its own while
    the engines capture their graphs: host state only, so no capture is
    disturbed. Counts the reads; a failed read is kept and raised by
    ``stop``."""

    def __init__(self, monitor, port):
        import threading
        import urllib.request

        self._urlopen = urllib.request.urlopen
        self._monitor = monitor
        self._base = f"http://127.0.0.1:{port}"
        self.reads = collections.Counter()
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                for route in ("/metrics", "/serve", "/requests"):
                    with self._urlopen(self._base + route,
                                       timeout=10) as r:
                        assert r.status == 200, (route, r.status)
                        r.read()
                    self.reads[route] += 1
                self._monitor.device_memory()
                self.reads["device_memory"] += 1
            except Exception as e:  # re-raised by stop()
                self.error = e
                return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)
        assert not self._thread.is_alive(), "route reader did not stop"
        if self.error is not None:
            raise self.error
        return dict(self.reads)


def supervised_restart(torch, np, serving, faults, monitor, cfg, weights,
                       srcs, clean, geom, new_tokens):
    """Phase 10a. (1) A supervisor whose decode step 5 raises without a
    slot hint: one restart, every pending request replayed, the tokens
    byte-identical to ``clean``; the seconds from the failure to the
    first replayed token and the lowerings and captures the restart
    cost. (2) A fresh supervisor through three such faults: the reserved
    memory while each rebuilt engine serves, after restart 3 within
    TOL_RESTART_RESERVED_GIB of after restart 1. The monitor server's
    routes and device_memory() are read on another thread throughout."""
    port = monitor.serve(port=0, host="127.0.0.1")
    reader = _RouteReader(monitor, port)

    class Timed(serving.EngineSupervisor):
        """Notes each restart: when the failure was declared, how many
        requests it replayed, and the reserved memory while the engine
        it replaces served (read on the loop thread that runs it)."""

        def __init__(self, *a, **k):
            self.notes = []
            super().__init__(*a, **k)

        def _restart_locked(self, old, reason):
            note = {"t": time.perf_counter(), "old": old,
                    "reserved_gib": torch.cuda.memory_reserved() / 2**30,
                    "pending": sum(1 for s in old._slots
                                   if s.request is not None)
                    + len(old._queue)}
            self.notes.append(note)
            super()._restart_locked(old, reason)
            note["rebuild_s"] = time.perf_counter() - note["t"]

    spans = monitor.histogram("pt_span_seconds")
    lowering = {"span": "executor.compile"}

    def drive(plan):
        sup = Timed(cfg, weights, **geom)
        faults.arm(plan)
        try:
            hs = [sup.submit(s, max_new_tokens=new_tokens) for s in srcs]
            first_token_s = None
            while not all(h.done for h in hs):
                if first_token_s is None and sup.notes:
                    eng = sup.engine
                    if eng is not sup.notes[0]["old"] and \
                            eng.tokens_emitted > 0:
                        first_token_s = (time.perf_counter()
                                         - sup.notes[0]["t"])
                time.sleep(0.0005)
            tokens = [h.result(timeout=60) for h in hs]
        finally:
            faults.disarm()
        eng = sup.engine
        end_reserved = torch.cuda.memory_reserved() / 2**30
        costs = _graph_costs(eng._exe)
        restarts, replayed = sup.restarts, sup.replayed
        sup.close()
        assert all(h.outcome in ("completed", "length") for h in hs)
        assert tokens == clean, "supervised replay changed the tokens"
        return sup, restarts, replayed, first_token_s, costs, end_reserved

    msg = "injected engine fault"
    lowered0 = (spans.count(lowering), spans.sum(lowering))
    sup, restarts, replayed, first_s, costs, _ = drive(
        f"serve.decode:raise({msg})@5")
    # the lowerings of run (1): the first engine's two and the restart's
    lowerings = (spans.count(lowering) - lowered0[0],
                 spans.sum(lowering) - lowered0[1])
    assert restarts == 1, restarts
    # every request still pending at the failure replayed (those that
    # ended on EOS before it are done)
    assert replayed == sup.notes[0]["pending"] >= geom["slots"], (
        replayed, sup.notes[0]["pending"])
    assert first_s is not None
    sup3, restarts3, _, _, _, end_reserved = drive(
        f"serve.decode:raise({msg})@5,25,45")
    assert restarts3 == 3, restarts3
    # reserved while the engine of restart k served: read at restart
    # k + 1, and at the end for restart 3
    reserved = [n["reserved_gib"] for n in sup3.notes[1:]] + [end_reserved]
    assert abs(reserved[2] - reserved[0]) <= TOL_RESTART_RESERVED_GIB, \
        reserved
    reads = reader.stop()
    assert all(reads.get(r, 0) > 0 for r in
               ("/metrics", "/serve", "/requests", "device_memory")), reads
    monitor.stop_server()
    return {"restarts": restarts, "replayed": replayed,
            "failure_to_first_replayed_token_s": first_s,
            "restart_rebuild_s": sup.notes[0]["rebuild_s"],
            "lowerings_in_run": lowerings[0],
            "lowering_s_mean": lowerings[1] / max(1, lowerings[0]),
            "restart_lowerings": costs[0], "restart_graph_captures":
            costs[1], "three_fault_restarts": restarts3,
            "reserved_gib_after_restarts_1_2_3": reserved,
            "route_reads_during_captures": reads, "byte_identical": True}


def wedge_restart(torch, np, serving, faults, monitor, cfg, weights, srcs,
                  clean, geom, new_tokens):
    """Phase 10b: a warm supervisor (its decode and prefill graphs
    captured) whose decode loop a fault plan parks for WEDGE_DELAY_S
    against a WEDGE_TIMEOUT_MS watchdog: the stall record (site
    serve.decode), one restart, tokens byte-identical to ``clean``; the
    parked thread wakes after the restart, finds its engine closed and
    ends without a decode step or an executor call."""
    sup = serving.EngineSupervisor(cfg, weights,
                                   wedge_timeout_ms=WEDGE_TIMEOUT_MS,
                                   **geom)
    warm = [sup.submit(s, max_new_tokens=4) for s in srcs[:2]]
    for h in warm:
        h.result(timeout=120)
    old = sup.engine
    assert old._wedge_armed()
    old_thread = sup._loop_thread
    stalls0 = len(monitor.stalls())
    faults.arm(f"serve.decode:delay({WEDGE_DELAY_S})@3")
    try:
        hs = [sup.submit(s, max_new_tokens=new_tokens) for s in srcs]
        tokens = [h.result(timeout=120) for h in hs]
    finally:
        faults.disarm()
    old_steps, old_runs = old.decode_steps, dict(old._runs)
    old_thread.join(timeout=2 * WEDGE_DELAY_S + 5)
    assert not old_thread.is_alive(), "the parked loop thread never ended"
    assert (old.decode_steps, dict(old._runs)) == (old_steps, old_runs)
    assert old._exe._retired is not None
    stalls = [s for s in monitor.stalls()[stalls0:]
              if s["site"] == "serve.decode"]
    restarts = sup.restarts
    sup.close()
    assert restarts == 1, restarts
    assert stalls, "no serve.decode stall record"
    assert tokens == clean, "the wedge restart changed the tokens"
    return {"restarts": restarts, "stall_records": len(stalls),
            "wedge_timeout_ms": WEDGE_TIMEOUT_MS,
            "parked_s": WEDGE_DELAY_S, "woken_thread_harmless": True,
            "byte_identical": True}


def containment(torch, np, serving, faults, cfg, weights, srcs, clean,
                geom, new_tokens):
    """Phase 10c on fresh engines stepped on this thread: (1) decode step
    6 raises naming slot 3: only that slot's request is evicted (its
    tokens a prefix of its clean stream), every other request's tokens
    byte-identical; (2) NaN written into slot 2's cross-attention K rows
    through the Scope: that request ends 'error', no non-finite value is
    left in any serving state tensor, the others byte-identical."""
    eng = serving.ServingEngine(cfg, weights, **geom)
    hs = [eng.submit(s, max_new_tokens=new_tokens) for s in srcs]
    faults.arm("serve.decode:raise(poisoned slot=3)@6")
    try:
        eng.run_until_idle()
    finally:
        faults.disarm()
    assert eng.state == "serving"
    evicted = [i for i, h in enumerate(hs) if h.outcome == "evicted"]
    assert len(evicted) == 1, [h.outcome for h in hs]
    (v,) = evicted
    assert hs[v].tokens == clean[v][:len(hs[v].tokens)]
    for i, h in enumerate(hs):
        if i != v:
            assert h.tokens == clean[i], f"request {i}"
    eng.close()

    eng = serving.ServingEngine(cfg, weights, **geom)
    hs = [eng.submit(s, max_new_tokens=new_tokens) for s in srcs]
    for _ in range(4):
        eng.step()
    victim = eng._slots[2].request
    eng.scope.find_var("serve_ck0")[2] = float("nan")
    state = list(eng._progs["state_specs"])
    eng.run_until_idle()
    finite = all(bool(torch.isfinite(eng.scope.find_var(n).float()).all())
                 for n in state)
    errored = [i for i, h in enumerate(hs) if h.outcome == "error"]
    eng.close()
    assert errored == [hs.index(victim)], errored
    assert finite, "a poisoned row survived the scrub"
    for i, h in enumerate(hs):
        if h is not victim:
            assert h.tokens == clean[i], f"request {i}"
    return {"evicted_request": v, "nonfinite_request": errored[0],
            "rows_scrubbed": True, "neighbours_byte_identical": True}


def oom_drill(torch, np, serving, faults, monitor, cfg, weights, srcs,
              geom):
    """Phase 10d on fresh engines: a fault-plan RESOURCE_EXHAUSTED at
    decode step 3, then a real torch.OutOfMemoryError (an allocation of
    1 TiB inside the third decode call): each fails the engine and
    leaves an OOM record with phase 'serve', the card's watermarks and
    the allocator's largest live blocks."""
    results = {}
    for kind in ("fault_plan", "real"):
        n0 = len(monitor.oom_records())
        eng = serving.ServingEngine(cfg, weights, **geom)
        for s in srcs[:geom["slots"]]:
            eng.submit(s)
        if kind == "fault_plan":
            faults.arm("serve.decode:raise(RESOURCE_EXHAUSTED: injected "
                       "device OOM)@3")
        else:
            run, calls = eng._exe.run, [0]

            def run_then_oom(program, *a, **k):
                if program is eng._progs["decode_program"]:
                    calls[0] += 1
                    if calls[0] == 3:
                        torch.empty(1 << 40, dtype=torch.uint8,
                                    device="cuda")
                return run(program, *a, **k)

            eng._exe.run = run_then_oom
        raised = None
        try:
            for _ in range(10):
                eng.step()
        except serving.EngineFailed as e:
            raise AssertionError(f"failed before the OOM: {e}")
        except Exception as e:
            raised = e
        finally:
            faults.disarm()
        assert raised is not None and monitor.is_oom_error(raised), raised
        if kind == "real":
            assert isinstance(raised, torch.OutOfMemoryError), raised
        assert eng.state == "failed", eng.state
        recs = monitor.oom_records()[n0:]
        eng.close()
        torch.cuda.empty_cache()
        assert len(recs) == 1 and recs[0]["phase"] == "serve", recs
        rec = recs[0]
        monitor.validate_oom_report(rec)
        assert rec["device_memory"], rec
        assert rec["largest_buffers"], rec
        results[kind] = {
            "error": rec["error"][:120],
            "device_memory": rec["device_memory"],
            "largest_buffer_bytes": rec["largest_buffers"][0]["nbytes"],
            "engine_state": "failed"}
    return results


def _telemetry_flags(flags, on, trace_dir):
    flags.set_flags({"telemetry": on, "trace_dir": trace_dir if on else ""})


def telemetry_cost(torch, np, serving, flags, monitor, cfg, weights, srcs,
                   geom, tag, trace_dir, window=32):
    """Phase 10e at one geometry: one warm engine, windows in turns with
    telemetry, request tracing and the trace ring off, on, on, off; each
    window serves ``slots`` fresh requests, every slot live, and times
    ``window`` decode steps (wall to the last step's tokens on the
    host). The on windows' sampled step records give the decode step's
    feed / dispatch / device / fetch ms and the host share."""
    slots = geom["slots"]
    eng = serving.ServingEngine(cfg, weights, **geom)
    for s in srcs[:slots]:  # warm-up: every program lowered and captured
        eng.submit(s, max_new_tokens=4)
    eng.run_until_idle()
    rows = {"off": [], "on": []}
    phases = []
    for on in (False, True, True, False):
        _telemetry_flags(flags, on, trace_dir)
        hs = [eng.submit(srcs[i % len(srcs)], max_new_tokens=window + 8)
              for i in range(slots)]
        for _ in range(3):  # admit every request, first step dispatched
            eng.step()
        assert all(s.request is not None for s in eng._slots)
        monitor.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emitted = sum(eng.step() for _ in range(window))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if on:
            phases += [r["phases"] for r in monitor.recent_steps()
                       if "phases" in r]
        eng.run_until_idle()
        assert all(h.outcome in ("completed", "length", "expired")
                   for h in hs)
        rows["on" if on else "off"].append(
            {"decode_step_ms": wall / window * 1e3,
             "tokens_per_s": emitted / wall})
    _telemetry_flags(flags, False, trace_dir)
    eng.close()
    assert phases, "no sampled decode step"
    mean = {k: sum(p[k] for p in phases) / len(phases)
            for k in ("feed", "dispatch", "device", "fetch")}
    total = sum(mean.values())
    off_ms = [r["decode_step_ms"] for r in rows["off"]]
    on_ms = [r["decode_step_ms"] for r in rows["on"]]
    return {"geometry": tag, "slots": slots, "window": window,
            "turns": rows,
            "telemetry_added_ms": (sum(on_ms) / len(on_ms)
                                   - sum(off_ms) / len(off_ms)),
            "sampled_steps": len(phases), "phases_ms": mean,
            "host_share": 1.0 - mean["device"] / total}


def numerics_recipe(torch, np, fluid, T, flags, monitor, numerics, *,
                    seq, batch, steps=4):
    """Phase 10f: phase 5d's recipe step with the numerics flag on (the
    gradients instrumented, with instrument()'s default of no histogram:
    the card tests hold the histogram in a captured graph): four
    steps eager and four through the captured step from one startup
    give bit-equal decoded bundles; pt_amp_loss_scale equals the scale
    variable and pt_grad_global_norm the clip's norm; the captured
    step's device ms and launches beside the same step built without
    the plane."""
    bundles = []
    real_to_host = numerics._to_host

    def keep(b):
        arr = real_to_host(b)
        bundles.append(np.array(arr))
        return arr

    def build(instrumented):
        flags.set_flags({"numerics": instrumented})
        try:
            prog, startup, model, opt, feeds = _recipe_training(
                fluid, T, seq=seq, batch=batch, dropout=0.1)
        finally:
            flags.set_flags({"numerics": False})
        plan = (numerics.instrument(prog, include=("gradient",),
                                    histogram_bins=0)
                if instrumented else None)
        return prog, startup, model, opt, feeds, plan

    def timed(exe, scope, prog, loss, feed):
        """Device ms and launches of one replayed step (two warm-up
        calls: the eager one and the capture)."""
        counts = {}
        with fluid.scope_guard(scope):
            for _ in range(2):
                exe.run(prog, feed=feed, fetch_list=[loss])
            times = _device_times(lambda: exe.run(
                prog, feed=feed, fetch_list=[loss]), iters=3,
                counts=counts, replay=True)
        return sum(times.values()), sum(counts.values())

    prog, startup, model, opt, feeds, plan = build(True)
    norm_name = next(v for k, v in plan.aux if k == "grad_global_norm")
    flags.set_flags({"telemetry": True, "numerics": True})
    numerics._to_host = keep
    try:
        runs = {}
        for cached in (False, True):
            bundles.clear()
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            with fluid.scope_guard(scope):
                exe.run(startup)
                staged = [{k: torch.as_tensor(v, device="cuda")
                           for k, v in f.items()} for f in feeds]
                norms = []
                for i in range(steps):
                    loss, norm = exe.run(
                        prog, feed=staged[i % len(staged)],
                        fetch_list=[model["loss"], norm_name],
                        use_program_cache=cached)
                    norms.append(float(norm.reshape(-1)[0]))
                scale = float(scope.find_var(opt.loss_scaling_name)
                              .reshape(-1)[0])
            gauge_scale = monitor.gauge("pt_amp_loss_scale").value()
            gauge_norm = monitor.gauge("pt_grad_global_norm").value()
            assert gauge_scale == scale, (gauge_scale, scale)
            assert gauge_norm == norms[-1], (gauge_norm, norms[-1])
            assert len(bundles) == steps, len(bundles)
            runs[cached] = list(bundles)
            if cached:
                on_ms, on_launches = timed(exe, scope, prog, model["loss"],
                                           staged[0])
            exe.close()
            del scope
        assert all(np.array_equal(a, b) for a, b in
                   zip(runs[False], runs[True])), "bundles differ"
        assert all(np.isfinite(b).all() for b in runs[True])
    finally:
        numerics._to_host = real_to_host
        flags.set_flags({"telemetry": False, "numerics": False})
    prog0, startup0, model0, _, feeds0, _ = build(False)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup0)
    off_ms, off_launches = timed(exe, scope, prog0, model0["loss"], {
        k: torch.as_tensor(v, device="cuda") for k, v in feeds0[0].items()})
    exe.close()
    del scope
    torch.cuda.empty_cache()
    return {"instrumented_vars": len(plan.entries),
            "aux": [k for k, _ in plan.aux], "hist_bins": plan.hist_bins,
            "bundle_size": plan.bundle_size, "steps": steps,
            "captured_equals_eager_bundles": True,
            "loss_scale_gauge_equals_var": True,
            "grad_norm_gauge_equals_clip_norm": True,
            "step_device_ms": on_ms, "plain_step_device_ms": off_ms,
            "added_device_ms": on_ms - off_ms,
            "added_launches": on_launches - off_launches}


def serving_planes(torch, np, fluid, T, fa, tmp):
    """Phase 10: the serving planes on the card (see the module
    docstring). Returns one JSON-able row per sub-phase and the
    attention launches the phase made, by route."""
    from paddle_tpu_torch import (faults, flags, kernels, monitor,
                                  numerics, serving)

    place = fluid.CUDAPlace(0)
    cfg = T.base()
    weights = _serving_weights(fluid, T, cfg)
    g = SERVE_GEOM
    geom = dict(slots=g["slots"], src_len=g["src_len"],
                max_len=g["max_len"], place=place)
    srcs = _sources(np, cfg, g["n_req"], g["src_len"], g["min_len"])
    kernels.reset_counts()
    clean = _undisturbed(serving, cfg, weights, srcs, geom, g["new_tokens"])
    out = {}
    flags.set_flags({"telemetry": True})
    try:
        t0 = time.perf_counter()
        out["10a"] = supervised_restart(
            torch, np, serving, faults, monitor, cfg, weights, srcs, clean,
            geom, g["new_tokens"])
        out["10b"] = wedge_restart(
            torch, np, serving, faults, monitor, cfg, weights, srcs, clean,
            geom, g["new_tokens"])
        out["10c"] = containment(torch, np, serving, faults, cfg, weights,
                                 srcs, clean, geom, g["new_tokens"])
        out["10d"] = oom_drill(torch, np, serving, faults, monitor, cfg,
                               weights, srcs, geom)
        drills_s = time.perf_counter() - t0
    finally:
        flags.set_flags({"telemetry": False})
    short_launches = _counts(fa)
    long_cfg = T.TransformerConfig(max_length=1026)
    long_weights = _serving_weights(fluid, T, long_cfg)
    lg = dict(SERVE_LONG_GEOM, place=place)
    long_srcs = _sources(np, long_cfg, lg["slots"], lg["src_len"], 513)
    kernels.reset_counts()
    out["10e"] = [
        telemetry_cost(torch, np, serving, flags, monitor, cfg, weights,
                       srcs, geom, "128", tmp),
        telemetry_cost(torch, np, serving, flags, monitor, long_cfg,
                       long_weights, long_srcs, lg, "1024", tmp)]
    long_launches = _counts(fa)
    del weights, long_weights
    torch.cuda.empty_cache()
    kernels.reset_counts()
    out["10f"] = numerics_recipe(torch, np, fluid, T, flags, monitor,
                                 numerics, seq=TRAIN_T, batch=TRAIN_B)
    recipe_launches = _counts(fa)
    out["drills_s"] = drills_s
    return out, short_launches, long_launches, recipe_launches


# Phase 11 (the fleet front door): ServingFleet over supervised replicas
# on one card, Transformer-base at full width, weights from SEED, at
# SERVE_GEOM (and SERVE_LONG_GEOM for one drill). Every stream is held
# byte for byte to an engine run alone (``_undisturbed``). A fault plan
# is armed only once every replica's decode graph is captured and every
# request of the drill has streamed a token, and fires at the router's
# next pump tick, never after a sleep; every wait is bounded.
FLEET_REPLICAS, FLEET_REQUESTS = 3, 48
FLEET_POLL_S = 0.002
FLEET_WAIT_S = 120.0
# the replicas' watchdog: far above a replayed step, below a capture that
# holds a replica back for seconds (which must not restart it)
FLEET_WEDGE_TIMEOUT_MS = 1000
ROLLOUT_SEED = SEED + 1
# the kill drills' new tokens: enough decode steps after the first token
# for the kill to land on work in flight
DRILL_TOKENS = 64


def _released_gib(torch):
    """Reserved GiB once everything unreferenced is released: garbage
    collected, the cuBLAS workspaces of every thread dropped, the
    allocator's cache emptied (read the same way before and after the
    phase)."""
    gc.collect()
    torch.cuda.synchronize()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def _wait_until(pred, what, timeout=FLEET_WAIT_S):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout} s waiting for "
                                 f"{what}")
        time.sleep(0.0005)


class _FleetRecord:
    """Builds the phase's fleets on the card and keeps every supervisor
    they made (the phase's restart record) and every fleet (its pump
    errors)."""

    def __init__(self, serving, fleet_serving):
        self._serving, self._fleet_serving = serving, fleet_serving
        self.sups, self.fleets = [], []

    def _factory(self, cfg, weights, **kw):
        sup = self._serving.EngineSupervisor(
            cfg, weights, wedge_timeout_ms=FLEET_WEDGE_TIMEOUT_MS, **kw)
        self.sups.append(sup)
        return sup

    def fleet(self, cfg, weights, replicas, geom, **kw):
        f = self._fleet_serving.ServingFleet(
            cfg, weights, replicas=replicas, poll_s=FLEET_POLL_S,
            replica_factory=self._factory, **geom, **kw)
        self.fleets.append(f)
        return f

    def restarts(self):
        return sum(s.restarts for s in self.sups)

    def pump_errors(self):
        errs = [(f.pump_errors, f.last_pump_error) for f in self.fleets]
        return sum(n for n, _ in errs), [e for n, e in errs if n]


def _warm_replicas(fleet, srcs):
    """Two requests through each replica's supervisor, one after the
    other: every replica lowers and captures its prefill and decode."""
    for rep in list(fleet._replicas.values()):
        for s in srcs[:2]:
            h = rep.sup.submit(s, max_new_tokens=4)
            h.result(timeout=FLEET_WAIT_S)
        eng = rep.sup.engine
        runs = [eng._runs[eng._progs[k]._uid]
                for k in ("prefill_program", "decode_program")]
        assert min(runs) >= 2 and len(eng._exe._cache) == 2, runs
        assert eng._wedge_armed()


def _drill_kill(faults, monitor, fleet, srcs, clean, new_tokens, replica):
    """Kill the ``replica``-th live replica mid-decode: streams equal
    ``clean``, every view the client read is a prefix of the next (no
    duplicate, no gap), and each re-homed request's trace events lie on
    its one tid with one submit."""
    import threading

    monitor.reset()  # an empty trace ring for this drill's requests
    frs = [fleet.submit(s, max_new_tokens=new_tokens) for s in srcs]
    live = sorted(fleet._replicas.values(), key=lambda r: r.id)
    victim = live[replica].id
    mine = [fr for fr in frs if fr.replica_id == victim]
    assert mine, "the router gave the victim no request"
    # mid-decode: every request the victim was given has streamed a
    # token (or ended); armed then, the kill lands at the next pump tick
    _wait_until(lambda: all(len(fr.tokens) >= 1 or fr.done for fr in mine),
                "the victim's first tokens")
    assert any(not fr.done for fr in mine), \
        "the victim holds no request in flight"
    views = {id(fr): [] for fr in frs}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            for fr in frs:
                views[id(fr)].append(list(fr.tokens))
            time.sleep(0.0005)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    failovers0 = fleet.failovers
    faults.arm(f"router.replica_crash:raise(replica={replica})@1")
    try:
        streams = [fr.result(timeout=FLEET_WAIT_S) for fr in frs]
    finally:
        faults.disarm()
        stop.set()
        watcher.join(timeout=30)
    assert not watcher.is_alive()
    assert fleet.failovers == failovers0 + 1, fleet.failovers
    assert all(fr.outcome in ("completed", "length") for fr in frs)
    assert streams == clean, "a fleet stream differs from the oracle"
    for fr, final in zip(frs, streams):
        seen = views[id(fr)] + [final]
        for a, b in zip(seen, seen[1:]):
            assert b[:len(a)] == a, (fr.trace_id, a, b)
    rehomed = [fr for fr in frs if fr.failovers >= 1]
    assert rehomed, "no request was re-homed"
    for fr in rehomed:
        evs = [e for e in monitor.trace_events()
               if e.get("args", {}).get("req") == fr.trace_id]
        assert {e["tid"] for e in evs} == {fr.trace_tid}, fr.trace_id
        assert [e["name"] for e in evs].count("submit") == 1, fr.trace_id
    return {"requests": len(frs), "new_tokens": new_tokens,
            "killed_replica": victim, "rehomed": len(rehomed),
            "replicas_after": fleet.stats()["replica_count"],
            "monotone": True, "one_trace_tid": True,
            "byte_identical": True}


def fleet_front_door(torch, np, fluid, T, fa, tmp):
    """Phase 11: the fleet on the card (see the module docstring).
    Returns one JSON-able row per sub-phase and the attention launches
    the phase made, by route. Every fleet is closed on the way out, also
    when a check fails."""
    from paddle_tpu_torch import fleet_serving, serving

    rec = _FleetRecord(serving, fleet_serving)
    try:
        return _fleet_phase(torch, np, fluid, T, fa, tmp, rec)
    finally:
        for f in rec.fleets:  # closed already unless a check failed
            f.close(drain_timeout_s=0.0)


def _fleet_phase(torch, np, fluid, T, fa, tmp, rec):
    """The body of ``fleet_front_door``, sub-phase by sub-phase; ``rec``
    builds and records its fleets."""
    from paddle_tpu_torch import faults, flags, kernels, monitor, serving
    from paddle_tpu_torch.core.lowering import GATE

    place = fluid.CUDAPlace(0)
    cfg = T.base()
    g = SERVE_GEOM
    geom = dict(slots=g["slots"], src_len=g["src_len"],
                max_len=g["max_len"], place=place)
    new_tokens = g["new_tokens"]
    reserved0 = _released_gib(torch)
    weights = _serving_weights(fluid, T, cfg)
    srcs = _sources(np, cfg, FLEET_REQUESTS, g["src_len"], g["min_len"])
    kernels.reset_counts()
    GATE.reset_stats()
    out = {}

    # 11a: 3 replicas against one engine at the same offered load
    clean = _undisturbed(serving, cfg, weights, srcs, geom, new_tokens)
    eng = serving.ServingEngine(cfg, weights, **geom)
    for s in srcs[:2]:  # warm: prefill and decode captured
        eng.submit(s, max_new_tokens=4)
        eng.run_until_idle()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(s, max_new_tokens=new_tokens) for s in srcs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    eng.close()
    assert [list(h.tokens) for h in hs] == clean
    one_tokens = sum(len(h.tokens) for h in hs)
    fleet = rec.fleet(cfg, weights, FLEET_REPLICAS, geom)
    _warm_replicas(fleet, srcs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frs = [fleet.submit(s, max_new_tokens=new_tokens) for s in srcs]
    streams = [fr.result(timeout=FLEET_WAIT_S) for fr in frs]
    fleet_wall = time.perf_counter() - t0
    assert streams == clean, "a fleet stream differs from the oracle"
    rows = fleet.stats()["replicas"]
    assert all(r["routed"] >= 1 for r in rows), rows
    assert fleet.failovers == 0 and rec.restarts() == 0
    fleet_tokens = sum(len(s) for s in streams)
    out["11a"] = {
        "replicas": FLEET_REPLICAS, "requests": len(srcs),
        "new_tokens": new_tokens, "tokens": fleet_tokens,
        "routed": [r["routed"] for r in rows],
        "fleet_wall_s": fleet_wall,
        "fleet_tokens_per_s": fleet_tokens / fleet_wall,
        "one_engine_wall_s": one_wall,
        "one_engine_tokens_per_s": one_tokens / one_wall,
        "fleet_over_one_engine": (fleet_tokens / fleet_wall)
        / (one_tokens / one_wall),
        "restarts": 0, "byte_identical": True}

    # 11b: kill one replica mid-decode at 128, on the warm fleet
    flags.set_flags({"telemetry": True, "trace_dir": tmp,
                     "trace_every_n_steps": 16})
    try:
        kill = srcs[:24]
        clean_kill = _undisturbed(serving, cfg, weights, kill, geom,
                                  DRILL_TOKENS)
        out["11b"] = {"128": _drill_kill(faults, monitor, fleet, kill,
                                         clean_kill, DRILL_TOKENS,
                                         replica=1)}
    finally:
        flags.set_flags({"telemetry": False, "trace_dir": "",
                         "trace_every_n_steps": 1})
    assert fleet.pump_errors == 0, fleet.last_pump_error

    # 11c: a rolling rollout to a second weight set under traffic
    weights2 = _serving_weights(fluid, T, cfg, seed=ROLLOUT_SEED)
    roll = srcs[:32]
    oracle = {0: _undisturbed(serving, cfg, weights, roll, geom,
                              new_tokens),
              1: _undisturbed(serving, cfg, weights2, roll, geom,
                              new_tokens)}
    assert oracle[0] != oracle[1]
    captures0 = GATE.stats()["captures"]
    pre = [fleet.submit(s, max_new_tokens=new_tokens) for s in roll[:16]]
    _wait_until(lambda: all(len(fr.tokens) >= 1 or fr.done for fr in pre),
                "the rollout's first tokens")
    t0 = time.perf_counter()
    res = fleet.rollout(weights2)
    rollout_s = time.perf_counter() - t0
    post = [fleet.submit(s, max_new_tokens=new_tokens) for s in roll[16:]]
    got = [fr.result(timeout=FLEET_WAIT_S) for fr in pre + post]
    outcomes = collections.Counter(fr.outcome for fr in pre + post)
    assert set(outcomes) <= {"completed", "length"}, outcomes
    gens = [fr.generation for fr in pre + post]
    for i, (fr, toks) in enumerate(zip(pre + post, got)):
        assert toks == oracle[fr.generation][i], (i, fr.generation)
    assert all(gn == 1 for gn in gens[16:])
    assert res == {"generation": 1, "replicas_rotated": FLEET_REPLICAS - 1,
                   "replicas": FLEET_REPLICAS - 1}, res
    out["11c"] = {
        "requests": len(roll), "rollout_s": rollout_s,
        "replicas_rotated": res["replicas_rotated"],
        "generations": dict(collections.Counter(gens)),
        "rejected": 0, "captures_during_rollout":
        GATE.stats()["captures"] - captures0,
        "each_stream_equals_its_generations_oracle": True}
    fleet.close()

    # 11b at src_len = max_len = 1024: 2 replicas of 4 slots
    long_cfg = T.TransformerConfig(max_length=1026)
    long_weights = _serving_weights(fluid, T, long_cfg)
    lg = dict(SERVE_LONG_GEOM, place=place)
    long_srcs = _sources(np, long_cfg, 8, lg["src_len"], 513)
    clean_long = _undisturbed(serving, long_cfg, long_weights, long_srcs,
                              lg, DRILL_TOKENS)
    lfleet = rec.fleet(long_cfg, long_weights, 2, lg)
    _warm_replicas(lfleet, long_srcs)
    flags.set_flags({"telemetry": True, "trace_dir": tmp,
                     "trace_every_n_steps": 16})
    try:
        out["11b"]["1024"] = _drill_kill(faults, monitor, lfleet, long_srcs,
                                         clean_long, DRILL_TOKENS,
                                         replica=1)
    finally:
        flags.set_flags({"telemetry": False, "trace_dir": "",
                         "trace_every_n_steps": 1})
    lfleet.close()

    # 11d: autoscale up under saturation, then down when idle
    flags.set_flags({"serve_fleet_autoscale_window": 2,
                     "serve_fleet_scale_down_idle_ticks": 3,
                     "serve_fleet_scale_up_queue_factor": 0.5})
    try:
        afleet = rec.fleet(cfg, weights, 1, geom, queue_depth=16,
                           min_replicas=1, max_replicas=2)
        _warm_replicas(afleet, srcs)
        (old,) = afleet._replicas.values()
        frs = [afleet.submit(s, max_new_tokens=new_tokens)
               for s in srcs[:8]]
        _wait_until(lambda: afleet.stats()["queue_depth"] == 0,
                    "the first eight admitted")
        frs += [afleet.submit(s, max_new_tokens=new_tokens)
                for s in srcs[8:24]]
        assert afleet.autoscale_tick() is None
        t0 = time.perf_counter()
        assert afleet.autoscale_tick() == "up"
        (new,) = [r for r in afleet._replicas.values() if r is not old]
        frs += [afleet.submit(s, max_new_tokens=new_tokens)
                for s in srcs[24:32]]
        _wait_until(lambda: new.sup.engine.tokens_emitted > 0,
                    "the new replica's first token")
        first_token_s = time.perf_counter() - t0
        got = [fr.result(timeout=FLEET_WAIT_S) for fr in frs]
        assert got == clean[:32], "an autoscaled stream differs"
        lowered, captured = _graph_costs(new.sup.engine._exe)
        assert afleet.drain(timeout_s=FLEET_WAIT_S)
        acts = [afleet.autoscale_tick() for _ in range(3)]
        assert acts[-1] == "down", acts
        assert afleet.stats()["replica_count"] == 1
        out["11d"] = {
            "scale_up_to_first_token_s": first_token_s,
            "spin_up_lowerings": lowered, "spin_up_graph_captures":
            captured, "new_replica_routed": new.routed,
            "scale_ups": afleet.scale_ups,
            "scale_downs": afleet.scale_downs}
        afleet.close()
    finally:
        flags.set_flags({
            name: flags._DEFS[name][1]
            for name in ("serve_fleet_autoscale_window",
                         "serve_fleet_scale_down_idle_ticks",
                         "serve_fleet_scale_up_queue_factor")})
    launches = _counts(fa)

    # 11e: the gate's record over the whole phase
    gate = GATE.stats()
    pump_errors, pump_texts = rec.pump_errors()
    restarts, n_sups = rec.restarts(), len(rec.sups)
    # every fleet is closed: drop what still holds the weights (the
    # supervisors and fleets keep theirs) and the loop threads' cuBLAS
    # workspaces
    rec.sups.clear()
    rec.fleets.clear()
    del fleet, lfleet, afleet, old, new, weights, weights2, long_weights
    reserved1 = _released_gib(torch)
    assert gate["capture_failures"] == 0, gate
    assert pump_errors == 0, pump_texts
    assert restarts == 0, restarts
    assert abs(reserved1 - reserved0) <= TOL_RESTART_RESERVED_GIB, (
        reserved0, reserved1)
    out["11e"] = {**gate, "pump_errors": 0, "wedge_restarts": 0,
                  "supervisors": n_sups,
                  "reserved_gib_before_after": [reserved0, reserved1]}
    return out, launches


# --- phase 12: beam-search translation ------------------------------------

# Transformer-base at full width, phase 4's 128 geometry: 8 sources of
# 16-128 tokens (the serving sources' lengths), padded to src_len 128,
# decoded to max_len 128; weights from seed 1234
BEAM_SOURCES, BEAM_LEN, BEAM_K = 8, 128, 4
# a near tie: two f32 paths (the serving engine's KV-cache step and the
# beam decode's full-prefix re-run; the card and the CPU) sum in other
# orders, a few f32 ulps of a logit apart, so where the two best
# candidates lie closer than this they may pick differently; a row may
# diverge only at such a step
NEAR_TIE = 1e-4
# card vs CPU beam scores (12d), relative: f32 sums of 15 log-probs
# through 6+6 layers in two orders
TOL_BEAM_CPU_REL = 1e-4
# the card vs CPU run (12d): 2 sources, src_len = max_len = 16
BEAM_CPU_SOURCES, BEAM_CPU_LEN = 2, 16
# the fwd_kernel at the decode loop's attention shapes, held against its
# plain version among phase 3's cases (12e reports them: late in a full
# run the profiler lost the first of these 20-call traces five times in
# a row, where phase 3's traces keep theirs)
BEAM_ATTENTION_CASES = ("beam self f32 b32 t128 causal+pad",
                        "beam cross f32 b32 tq128 tk128 pad")


def _pad_sources(np, srcs, src_len):
    """[n, src_len] ids (zero-padded) and their pad mask."""
    ids = np.zeros((len(srcs), src_len), np.int64)
    pad = np.zeros((len(srcs), src_len), np.float32)
    for i, s in enumerate(srcs):
        ids[i, :len(s)] = s
        pad[i, :len(s)] = 1.0
    return ids, pad


def _teacher_logp(np, fluid, T, cfg, place, scope, src, pad, seqs):
    """Log-probabilities [n, t, V] (f64) of the is_test training program
    over the n rows ``seqs`` ([n, t] ids from BOS) of one source."""
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        model = T.build(cfg, is_test=True)
    n, t = seqs.shape
    feed = {"src_ids": np.repeat(src[None], n, 0),
            "trg_ids": seqs.astype(np.int64),
            "lbl_ids": np.zeros((n, t), np.int64),
            "src_pad_mask": np.repeat(pad[None], n, 0),
            "trg_pad_mask": np.ones((n, t), np.float32)}
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        (logits,) = exe.run(main, feed=feed, fetch_list=[model["logits"]],
                            use_program_cache=False)
    exe.close()
    z = logits.astype(np.float64)
    m = z.max(-1, keepdims=True)
    return z - m - np.log(np.exp(z - m).sum(-1, keepdims=True))


def _candidate_gap(np, logp, prefix, end_id):
    """The smallest gap between adjacent totals among the k + 1 best
    candidates of the beam step that writes position s (``prefix``: the
    k hypotheses' ids [k, s] before it): each hypothesis's teacher-forced
    score (its tokens 1..s-1 up to its first end_id) plus the log-probs at
    position s - 1; a finished hypothesis extends by end_id alone at no
    cost; at s = 1 only the first beam is live. With k = 1 it is the gap
    of the two best logits."""
    k, s = prefix.shape
    totals = []
    for h in range(k):
        if s == 1 and h > 0:
            break
        score, done = 0.0, False
        for pos in range(1, s):
            score += logp[h, pos - 1, prefix[h, pos]]
            if prefix[h, pos] == end_id:
                done = True
                break
        totals.extend([score] if done else list(score + logp[h, s - 1]))
    top = np.sort(np.asarray(totals))[::-1][:k + 1]
    return float(np.min(top[:-1] - top[1:]))


def _loop_exit(np, ids, end_id, steps):
    """Hold a decode's ids [b, k, max_len] to its loop's exit after
    ``steps`` steps: the loop stops at the step where its last hypothesis
    ended (every hypothesis holds end_id in positions 1..steps) or, when
    one never ends, at max_len - 1; after a hypothesis's end every
    position it wrote holds end_id, and the positions past the last step
    keep BOS. Returns how many hypotheses ended."""
    max_len = ids.shape[-1]
    ends = []
    for seq in ids.reshape(-1, max_len):
        hit = np.nonzero(seq[1:steps + 1] == end_id)[0]
        if hit.size:
            first = int(hit[0]) + 1
            ends.append(first)
            assert (seq[first:steps + 1] == end_id).all(), seq
        assert (seq[steps + 1:] == 0).all(), seq
    if len(ends) == ids.shape[0] * ids.shape[1]:
        assert steps == max(ends), (steps, ends)
    else:
        assert steps == max_len - 1, (steps, len(ends))
    return len(ends)


def _first_divergence(a, b):
    """The first position at which two id arrays ([k, t]) differ, or
    None."""
    for s in range(a.shape[-1]):
        if not (a[..., :s + 1] == b[..., :s + 1]).all():
            return s
    return None


def _translate_run(torch, fa, T, exe, scope, src, pad, cfg, k, end_id):
    """One translate on the card at max_len = src_len: (ids, scores,
    record). The record: wall seconds, the loop's steps (read from the
    fwd_kernel's launches: one an encoder layer, then two a decoder layer
    a step), ms a step, hypothesis tokens a second, body captures (the
    capture gate's count) and fwd_kernel launches."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.lowering import GATE

    kernels.reset_counts()
    captures = GATE.stats()["captures"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = T.translate(exe, scope, src, pad, cfg, beam_size=k,
                              max_len=src.shape[1], end_id=end_id)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(fa)
    launches = counts["small/fwd"]
    steps = (launches - cfg.n_layer) // (2 * cfg.n_layer)
    assert launches == (1 + 2 * steps) * cfg.n_layer and steps > 0, counts
    assert sum(counts.values()) == launches, counts  # no other route
    return ids, scores, {
        "wall_s": wall, "steps": steps, "ms_a_step": wall * 1e3 / steps,
        "hypothesis_tokens_per_s": ids.shape[0] * k * steps / wall,
        "body_captures": GATE.stats()["captures"] - captures,
        "fwd_kernel_launches": launches}


def _translate_turns(torch, np, fluid, fa, T, scope, src, pad, cfg, k,
                     end_id, profile=False):
    """Beam ``k`` in turns, eager (uncached: the eager loop), captured,
    captured (one cached executor: its first turn runs the warm-up and
    captures the loop body, its second replays it), eager; with
    ``profile``, then one profiled translate a mode for its launches and
    device ms a step. The ids of every turn must be equal, the scores of
    the captured and eager turns bit-equal."""
    place = fluid.CUDAPlace(0)
    eager_exe = _eager_executor(fluid)(place)
    captured_exe = fluid.Executor(place)
    turns, outs = {"eager": [], "captured": []}, []
    for mode in ("eager", "captured", "captured", "eager"):
        exe = eager_exe if mode == "eager" else captured_exe
        ids, scores, row = _translate_run(torch, fa, T, exe, scope, src,
                                          pad, cfg, k, end_id)
        turns[mode].append(row)
        outs.append((mode, ids, scores))
    ids0, sc0 = outs[0][1], outs[0][2]
    for mode, ids, scores in outs:
        assert np.array_equal(ids, ids0), mode
        assert np.array_equal(scores, sc0), mode
    steps = turns["eager"][0]["steps"]
    assert all(r["steps"] == steps for rs in turns.values() for r in rs)
    assert [r["body_captures"] for r in turns["captured"]] == [1, 0], turns
    assert all(r["body_captures"] == 0 for r in turns["eager"]), turns
    profiled = {}
    for mode, exe in ((("eager", eager_exe), ("captured", captured_exe))
                      if profile else ()):
        counts = {}
        times = _device_times(
            lambda: T.translate(exe, scope, src, pad, cfg, beam_size=k,
                                max_len=src.shape[1], end_id=end_id), 1,
            counts=counts, replay=mode == "captured")
        profiled[mode] = {
            "launches_a_step": sum(counts.values()) / steps,
            "device_ms_a_step": sum(times.values()) / steps,
            "fwd_kernel_device_ms_a_step": sum(
                ms for n, ms in times.items() if "fwd_kernel" in n) / steps}
    (_, runner), = captured_exe._loop_runners.items()
    eager_exe.close()
    captured_exe.close()
    launches = sum(r["fwd_kernel_launches"] for rs in turns.values()
                   for r in rs)
    return ids0, sc0, {"steps": steps, "turns": _turn_summary(
        turns, ("wall_s", "ms_a_step", "hypothesis_tokens_per_s",
                "body_captures", "fwd_kernel_launches")),
        "profile": profiled, "runner_loops": runner.loops}, launches


def beam_translate(torch, np, fluid, T, fa, serving):
    """Phase 12 (see the module docstring): one line names each sub-phase
    before it runs. Returns a JSON-able row a sub-phase and the
    fwd_kernel launches of its translate runs."""
    from paddle_tpu_torch.core.lowering import GATE

    cfg = T.base()
    weights = _serving_weights(fluid, T, cfg)
    srcs = _sources(np, cfg, BEAM_SOURCES, BEAM_LEN, 16)
    src, pad = _pad_sources(np, srcs, BEAM_LEN)
    out, launches = {}, 0
    GATE.reset_stats()

    print("phase 12a: translate beam 1 against the serving engine",
          flush=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    ids1, sc1, row = _translate_run(torch, fa, T, exe, weights, src, pad,
                                    cfg, 1, 1)
    exe.close()
    launches += row["fwd_kernel_launches"]
    eng = serving.ServingEngine(cfg, weights, slots=BEAM_SOURCES,
                                src_len=BEAM_LEN, max_len=BEAM_LEN)
    hs = [eng.submit(s) for s in srcs]
    eng.run_until_idle()
    eng.close()
    diverged, near_ties, gaps = 0, 0, []
    for r, h in enumerate(hs):
        seq = list(ids1[r, 0, 1:])
        if 1 in seq:
            seq = seq[:seq.index(1)]
        got = list(h.tokens)
        if seq == got:
            continue
        diverged += 1
        p = next(i for i in range(min(len(seq), len(got)) + 1)
                 if i == len(seq) or i == len(got) or seq[i] != got[i])
        prefix = np.asarray([[0] + got[:p]], np.int64)
        logp = _teacher_logp(np, fluid, T, cfg, fluid.CUDAPlace(0), weights,
                             src[r], pad[r], prefix)
        gap = _candidate_gap(np, logp, prefix, 1)
        gaps.append(gap)
        near_ties += gap < NEAR_TIE
        assert gap < NEAR_TIE, (
            f"row {r} diverges from the serving engine at token {p} where "
            f"the two best logits lie {gap} apart")
    out["12a"] = {**row, "rows": BEAM_SOURCES, "diverged_rows": diverged,
                  "near_tie_rows": near_ties, "gaps": gaps,
                  "tokens": [len(h.tokens) for h in hs]}

    print("phase 12b: translate beam 4, eager and captured in turns",
          flush=True)
    ids4, sc4, rec, n = _translate_turns(torch, np, fluid, fa, T, weights,
                                         src, pad, cfg, BEAM_K, 1,
                                         profile=True)
    launches += n
    assert ids4.shape == (BEAM_SOURCES, BEAM_K, BEAM_LEN)
    assert np.isfinite(sc4).all() and (np.diff(sc4, axis=1) <= 0).all()
    assert (ids4[:, :, 0] == 0).all()
    out["12b"] = rec

    print("phase 12c: early exit, beam 4 with end_id from 12b's best beam "
          "of source 0 at step 5", flush=True)
    end_id = int(ids4[0, 0, 5])
    assert end_id != 0, end_id
    idsc, _, rec, n = _translate_turns(torch, np, fluid, fa, T, weights, src,
                                       pad, cfg, BEAM_K, end_id)
    launches += n
    out["12c"] = {"end_id": end_id, "ended_hypotheses": _loop_exit(
        np, idsc, end_id, rec["steps"]), **rec}
    # the early exit itself: one source greedy, whose one hypothesis ends
    # at the token it wrote at step 5 (a beam-4 run ends early only where
    # all 32 hypotheses emit its end_id)
    print("phase 12c: early exit, beam 1 over source 0 with end_id from "
          "its own step 5", flush=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    first, _, row = _translate_run(torch, fa, T, exe, weights, src[:1],
                                   pad[:1], cfg, 1, 1)
    exe.close()
    launches += row["fwd_kernel_launches"]
    end1 = int(first[0, 0, 5])
    ids_e, _, rec, n = _translate_turns(torch, np, fluid, fa, T, weights,
                                        src[:1], pad[:1], cfg, 1, end1)
    launches += n
    assert rec["steps"] <= 5 < BEAM_LEN - 1, rec["steps"]
    assert _loop_exit(np, ids_e, end1, rec["steps"]) == 1
    out["12c_greedy"] = {"end_id": end1, **rec}

    print("phase 12d: translate on the card against the CPU", flush=True)
    csrcs = _sources(np, cfg, BEAM_CPU_SOURCES, BEAM_CPU_LEN, 8)
    csrc, cpad = _pad_sources(np, csrcs, BEAM_CPU_LEN)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    gids, gsc, row = _translate_run(torch, fa, T, exe, weights, csrc, cpad,
                                    cfg, BEAM_K, 1)
    exe.close()
    launches += row["fwd_kernel_launches"]
    cpu = fluid.CPUPlace()
    cpu_weights = fluid.Scope()
    for name in weights.var_names():
        cpu_weights.set(name, weights.find_var(name).cpu())
    t0 = time.perf_counter()
    uids, usc = T.translate(fluid.Executor(cpu), cpu_weights, csrc, cpad,
                            cfg, beam_size=BEAM_K, max_len=BEAM_CPU_LEN)
    cpu_s = time.perf_counter() - t0
    diverged, gaps, worst = 0, [], 0.0
    for r in range(BEAM_CPU_SOURCES):
        s = _first_divergence(gids[r], uids[r])
        if s is None:
            worst = max(worst, float(np.abs(gsc[r] - usc[r]).max()
                                     / np.abs(usc[r]).max()))
            continue
        diverged += 1
        logp = _teacher_logp(np, fluid, T, cfg, cpu, cpu_weights, csrc[r],
                             cpad[r], uids[r, :, :s])
        gap = _candidate_gap(np, logp, uids[r, :, :s], 1)
        gaps.append(gap)
        assert gap < NEAR_TIE, (
            f"source {r}: the card's beams leave the CPU's at position {s} "
            f"where the best candidates lie {gap} apart")
    assert worst <= TOL_BEAM_CPU_REL, worst
    out["12d"] = {"card": row, "cpu_s": cpu_s, "diverged_rows": diverged,
                  "gaps": gaps, "max_rel_err_scores": worst,
                  "tol": TOL_BEAM_CPU_REL}
    del cpu_weights
    torch.cuda.empty_cache()
    return out, launches


# Phase 13: the other model families of the JAX package's benchmark
# (bench_family.py), each at its configuration there: BERT-base
# pretraining (b 64 x s 128, bf16 AMP, Adam 1e-4; bench_family.py:163-172),
# DeepFM (26 fields, 1M-row tables, 16-dim factors, a 400 x 400 x 400
# tower, b 4096, Adam 1e-3; :211-219), dense and row-sparse, and SSD-300
# (VGG16, 8732 priors, 21 classes, 50 padded gt rows, b 32, bf16 AMP,
# Momentum(0.001, 0.9); :253-277)
BERT_B, BERT_T, BERT_LR = 64, 128, 1e-4
BERT_ATTENTION_CASE = "bert bf16 b64 t128 h12 pad drop"
DEEPFM = dict(num_fields=26, vocab_size=1_000_000, embed_dim=16,
              hidden=(400, 400, 400))
DEEPFM_B, DEEPFM_LR = 4096, 1e-3
SSD_B, SSD_CLASSES, SSD_GT = 32, 21, 50
SSD_LR, SSD_MOMENTUM = 0.001, 0.9
SSD300_PRIORS = 8732
# the bf16 dense peak of one H100 SXM (NVIDIA data sheet)
BF16_PEAK = PEAK_FLOPS["bfloat16"]["bf16 tensor cores"]
# Phase 13d: two steps of each model at 2 layers or blocks of its full
# width, f32 with TF32 off, on the card (the captured step from its
# second call) against the same steps of the port on the CPU, from one
# startup state and one batch. Both sum in f32 in other orders: each
# step's loss within 1e-5 relative, the first step's named gradients
# within 1e-4 of their largest element, and the state after two steps
# within 1e-4 of each tensor's largest element (or 1e-9 absolute). Under
# Adam the state held is the moments: Adam's first steps are sign-like,
# so a parameter element whose gradient lies within rounding of zero
# moves by +-lr on either device (an H100 read 1.2e-3 of the largest
# element of a zero-initialized 2-layer BERT attention bias after two
# steps, with both losses equal to 8e-8); the parameters' differences are
# printed, and the second step's loss holds the first update. Index
# outputs (the sparse rows, the detections' labels) are compared exactly.
TOL_FAMILY_LOSS_REL = 1e-5
TOL_FAMILY_GRAD_REL = 1e-4
TOL_FAMILY_STATE_REL = 1e-4
FAMILY_CPU = {"bert": dict(n_layer=2, batch=2, seq=64),
              "deepfm": dict(hidden=(400, 400), batch=512),
              "ssd": dict(batch=4, image=(3, 64, 64), classes=7, gt=8)}


def bert_train_flops_per_step(cfg, batch, t):
    """The matmul FLOPs of a BERT pretraining step, forward and backward
    (encoder, MLM transform and projection; the NSP head is negligible):
    the JAX package's benchmark formula (bench_family.py:88-96)."""
    d, di, n_layer = cfg.d_model, cfg.d_inner, cfg.n_layer
    tok = batch * t
    per_layer = 4 * 2 * tok * d * d + 2 * 2 * tok * d * di \
        + 2 * 2 * tok * t * d
    head = 2 * tok * d * d + 2 * tok * d * cfg.vocab_size
    return 3.0 * (n_layer * per_layer + head)


def ssd300_feed(np, b, s):
    """bench_family.py:263-277's SSD-300 batch: normal images, 1-11 boxes
    an image in the 50 padded rows, labels in 1..20."""
    r = np.random.RandomState(s)
    imgs = r.normal(0, 1, (b, 3, 300, 300)).astype(np.float32)
    boxes = np.zeros((b, 50, 4), np.float32)
    labels = np.zeros((b, 50), np.int64)
    for i in range(b):
        n_obj = r.randint(1, 12)
        cx, cy = r.uniform(0.2, 0.8, (2, n_obj))
        w, h = r.uniform(0.1, 0.5, (2, n_obj))
        boxes[i, :n_obj, 0] = np.clip(cx - w / 2, 0, 1)
        boxes[i, :n_obj, 1] = np.clip(cy - h / 2, 0, 1)
        boxes[i, :n_obj, 2] = np.clip(cx + w / 2, 0, 1)
        boxes[i, :n_obj, 3] = np.clip(cy + h / 2, 0, 1)
        labels[i, :n_obj] = r.randint(1, 21, n_obj)
    return {"image": imgs, "gt_box": boxes, "gt_label": labels}


def _family_program(fluid, build, make_opt, amp):
    """(main, startup, model, optimizer) of ``build()`` minimized by
    ``make_opt()``, bf16 AMP where ``amp``, seeded."""
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        model = build()
        opt = make_opt()
        opt.minimize(model["loss"])
    if amp:
        fluid.amp.enable_amp(main_prog)
    startup.random_seed = main_prog.random_seed = SEED
    return main_prog, startup, model, opt


def train_family(torch, np, fluid, fa, name, build, make_opt, feeds, *,
                 amp, items, unit, window=4, equal_steps=3, expect=None,
                 tables=(), rerun=False, watch=None):
    """Phase 13a-c: train one model through Executor.run / run_steps on
    the card. First ``equal_steps`` steps from one startup, two eager
    sequences, one through the step runner (captured from its second
    call) and one through a run_steps window (``_same_runs``): the
    captured sequences' losses and final state equal to the eager one
    bit for bit. Then the step timed in turns, eager (uncached runs) and
    captured (run_steps replays): wall and device ms, idle share,
    ``unit`` a second (``items`` a step), launches a step from the trace
    (``expect``: {kernel name part: launches a step} held against it) and
    the attention routes' counters, peak memory. ``tables``: the
    row-sparse tables, whose rows no batch touched (and those rows of
    their Adam moments) must keep their startup bits. ``rerun``: the
    device ms an eager step spends in the forwards that derived grad ops
    re-run (``rerun_share``). ``watch``: {launch-count key: kernel name
    part, or a tuple of them}: each key's counted launches a step in every
    turn (the counts set to 0 at the turn's start), and the traced launches
    and device ms a captured step of the kernels whose names hold a part.
    The first turn of each mode also traces a
    step's device time (one a mode: a trace of a recurrent model's ~10^4
    launches a step takes seconds to read). Returns (row, the captured step's traced launches by kernel name)."""
    from paddle_tpu_torch import kernels

    main_prog, startup, model, opt = _family_program(fluid, build,
                                                     make_opt, amp)
    loss = model["loss"]
    dev = torch.device("cuda", 0)
    feeds = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
             for f in feeds]
    # cuDNN's default f32 backward algorithms for VGG-16's convolutions add
    # with atomics on the H100 (two eager steps differed by 4.0e-4 in a
    # loss): the bit check asks for its deterministic ones, the timed turns
    # below run on the defaults
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        same = _same_runs(torch, np, fluid, main_prog, startup, feeds,
                          [loss], equal_steps)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _held_same(same)
    ec, ew = same["eager_vs_captured"], same["eager_vs_run_steps"]
    assert ec["fetch"] == ec["state"] == ew["last_fetch"] == ew["state"] \
        == 0.0, (name, same)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        slots = [n for n, d in opt.slot_descriptor().items()
                 if d["param"] in tables
                 and d["slot"] in ("moment1", "moment2")]
        watched = {n: scope.find_var(n).clone() for n in list(tables) + slots}
        # the eager step's warm-up and the captured step's capture
        exe.run(main_prog, feed=feeds[0], fetch_list=[loss],
                use_program_cache=False)
        exe.run_steps(main_prog, feeds, 2, [loss])
        traced = {True: 0, False: 0}

        def turn(eager):
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            if eager:
                for i in range(window):
                    (value,) = exe.run(main_prog, feed=feeds[i % len(feeds)],
                                       fetch_list=[loss],
                                       use_program_cache=False)
            else:
                (value,) = exe.run_steps(main_prog, feeds, window, [loss])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v / window for k, v in _counts(fa).items()}
            drops = kernels.launch_counts["dropout"] / window
            watched = {k: kernels.launch_counts[k] / window
                       for k in (watch or {})}
            assert np.isfinite(value), (name, value)
            assert all(torch.isfinite(scope.find_var(p.name)).all()
                       for p in main_prog.all_parameters()), \
                (name, "non-finite weights")
            counts, trace, times = {}, {}, None
            if not traced[eager]:
                traced[eager] += 1
                if eager:
                    times = _device_times(lambda: exe.run(
                        main_prog, feed=feeds[0], fetch_list=[loss],
                        use_program_cache=False), iters=1, expect=expect,
                        counts=counts, trace=trace)
                else:
                    times = _device_times(lambda: exe.run_steps(
                        main_prog, feeds[:1], 1, [loss]), iters=2,
                        expect=expect, counts=counts, replay=True,
                        trace=trace)
            device_ms = sum(times.values()) if times else None
            step_ms = wall / window * 1e3
            return {"step_ms": step_ms, "step_device_ms": device_ms,
                    "idle_share": device_ms and 1 - device_ms / step_ms,
                    f"{unit}_per_s": items * window / wall,
                    "last_loss": float(value),
                    "launches_per_step": times and sum(counts.values()),
                    "attention_launches_per_step": launches,
                    "dropout_launches_per_step": drops,
                    "watched_launches_per_step": watched,
                    "trace_let_off": trace, "times": times,
                    "counts": counts}

        turns = _turns(turn)
        untouched = None
        if tables:
            vocab = scope.find_var(tables[0]).shape[0]
            hit = torch.zeros(vocab, dtype=torch.bool, device=dev)
            for f in feeds:
                hit[f["feat_ids"].reshape(-1)] = True
            untouched = int((~hit).sum())
            assert 0 < untouched < vocab, untouched
            for n, before in watched.items():
                after = scope.find_var(n)
                assert torch.equal(after[~hit], before[~hit]), (name, n)
                assert not torch.equal(after[hit], before[hit]), (name, n)
        rerun_ms = rerun_share(torch, lambda: exe.run(
            main_prog, feed=feeds[0], fetch_list=[loss],
            use_program_cache=False)) if rerun else None
    exe.close()
    cap = turns["captured"][1]
    # the last captured turn that traced the device
    dev_cap = next(r for r in reversed(turns["captured"]) if r["times"])
    times, counts = dev_cap["times"], dev_cap["counts"]
    for r in turns["eager"] + turns["captured"]:
        r.pop("times", None)
        r.pop("counts", None)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    row = {
        "model": name, "amp": amp, f"{unit}_a_step": items,
        "ops_per_step": len(main_prog.global_block().ops),
        "captured_vs_eager": {k: same[k] for k in (
            "steps", "eager_vs_eager", "eager_vs_captured",
            "eager_vs_run_steps", "first_fetch")},
        "window_steps": window, "last_loss": cap["last_loss"],
        "step_ms": cap["step_ms"],
        "step_device_ms": dev_cap["step_device_ms"],
        "idle_share": 1 - dev_cap["step_device_ms"] / cap["step_ms"],
        f"{unit}_per_s": cap[f"{unit}_per_s"],
        "launches_per_step": dev_cap["launches_per_step"],
        "attention_launches_per_step": cap["attention_launches_per_step"],
        "dropout_launches_per_step": cap["dropout_launches_per_step"],
        "peak_mem_gib": cap["peak_mem_gib"],
        "peak_reserved_gib": cap["peak_reserved_gib"],
        "untouched_rows_bit_equal": untouched,
        "turns": _turn_summary(turns, (
            "step_ms", "step_device_ms", "idle_share", f"{unit}_per_s",
            "launches_per_step", "peak_mem_gib", "peak_reserved_gib",
            "last_loss", "trace_let_off")),
        "device_ms_by_family": _kernel_families(times),
        "launches_by_family": _kernel_families(counts),
        "top_kernels_ms": [[k[:80], ms] for k, ms in top],
    }
    if watch:
        row["watch"] = {key: {
            "launches_per_step": {mode: [r["watched_launches_per_step"][key]
                                         for r in rows]
                                  for mode, rows in turns.items()},
            "traced_launches_per_step": sum(
                n for k, n in counts.items() if _matches(k, part)),
            "device_ms": sum(ms for k, ms in times.items()
                             if _matches(k, part))}
            for key, part in watch.items()}
    if rerun_ms is not None:
        row["derived_grad_rerun_device_ms"], row["eager_profile_device_ms"] \
            = rerun_ms
        row["derived_grad_rerun_share"] = rerun_ms[0] / rerun_ms[1]
    return row, counts


def _family_steps(fluid, place, main_prog, state, feeds, fetch):
    """Each feed's step of ``main_prog`` on ``place`` from ``state``
    (cached runs: on the card the second is captured); returns each
    step's fetches and the final state."""
    from paddle_tpu_torch import io as tio

    scope = tio.scope_from_numpy(state, place)
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        got = [exe.run(main_prog, feed=f, fetch_list=fetch) for f in feeds]
    final = {n: scope.find_var(n).cpu().numpy() for n in scope.var_names()}
    exe.close()
    return got, final


def family_vs_cpu(torch, np, fluid, name, build, make_opt, feeds, names, *,
                  exact=()):
    """Phase 13d: two f32 steps of a model on the card against the port
    on the CPU, from the card's startup state: each step's loss, the
    first step's gradients ``names``, the first step's ``exact`` fetches
    ((label, model key or var name) pairs held by ``_held_exactly``), and
    the float state after the steps: every tensor, or under Adam its
    moments (the parameters' differences printed; see
    TOL_FAMILY_STATE_REL)."""
    main_prog, startup, model, opt = _family_program(fluid, build, make_opt,
                                                     amp=False)
    slots = opt.slot_descriptor()
    adam = isinstance(opt, fluid.optimizer.Adam)
    state = card_startup_state(fluid, startup)
    fetch = [model["loss"]] + [model.get(k, k) for _, k in exact] \
        + list(names)
    gpu, gpu_final = _family_steps(fluid, fluid.CUDAPlace(0), main_prog,
                                   state, feeds, fetch)
    cpu, cpu_final = _family_steps(fluid, fluid.CPUPlace(), main_prog,
                                   state, feeds, fetch)
    losses = [[float(g[0]), float(c[0])] for g, c in zip(gpu, cpu)]
    loss_rel = max(abs(g - c) / max(abs(c), 1e-30) for g, c in losses)
    grad_rel = {}
    for i, n in enumerate(names):
        g, c = gpu[0][1 + len(exact) + i], cpu[0][1 + len(exact) + i]
        assert g.shape == c.shape and np.isfinite(g).all(), (name, n)
        grad_rel[n] = _rel_err(np, g, c)
    exact_equal = {label: _held_exactly(np, label, gpu[0][1 + i],
                                        cpu[0][1 + i])
                   for i, (label, _) in enumerate(exact)}
    state_rel, unheld = {}, {}
    for n, c in cpu_final.items():
        g = gpu_final[n]
        if not np.issubdtype(c.dtype, np.floating):
            assert np.array_equal(g, c), (name, n)
            continue
        err = (0.0 if np.abs(g - c).max() <= 1e-9 else _rel_err(np, g, c))
        if adam and slots.get(n, {}).get("slot") not in (
                "moment1", "moment2", "beta1_pow", "beta2_pow"):
            unheld[n] = err
        else:
            state_rel[n] = err
    worst = max(state_rel, key=state_rel.get)
    loose = max(unheld, key=unheld.get) if unheld else None
    row = {"model": name, "steps": len(feeds), "losses_gpu_cpu": losses,
           "loss_rel_err": loss_rel, "grad_rel_err": grad_rel,
           "state_rel_err_max": [worst, state_rel[worst]],
           "state_held": len(state_rel),
           "unheld_rel_err_max": loose and [loose, unheld[loose]],
           "exact": exact_equal,
           "tol": {"loss_rel": TOL_FAMILY_LOSS_REL,
                   "grad_rel": TOL_FAMILY_GRAD_REL,
                   "state_rel": TOL_FAMILY_STATE_REL}}
    assert loss_rel <= TOL_FAMILY_LOSS_REL, row
    assert max(grad_rel.values()) <= TOL_FAMILY_GRAD_REL, row
    assert state_rel[worst] <= TOL_FAMILY_STATE_REL, row
    return row


def _held_exactly(np, label, got, want):
    """Index fetches held exactly: a sparse gradient's rows; the
    detections' labels (row for row), their scores and boxes within
    TOL_FAMILY_GRAD_REL of the largest."""
    if label == "detection":
        assert got.shape == want.shape, (got.shape, want.shape)
        assert np.array_equal(got[..., 0], want[..., 0]), "detection labels"
        err = _rel_err(np, got[..., 1:], want[..., 1:])
        assert err <= TOL_FAMILY_GRAD_REL, err
        return {"labels_equal": True, "rows": int(got.shape[1]),
                "kept": int((got[..., 0] >= 0).sum()), "score_box_rel": err}
    assert np.array_equal(got, want), label
    return True


def _family_done(out, key, row):
    """Keep a sub-phase's row, with the seconds since phase 13 began, and
    print it as its ``family_`` line."""
    row["at_s"] = time.perf_counter() - out["t0"]
    out[key] = row
    print(f"family_{key} " + json.dumps(row), flush=True)


def families(torch, np, fluid, fa):
    """Phase 13: BERT-base, DeepFM (dense and sparse) and SSD-300 trained
    on the card at bench_family.py's configurations (13a-c), then each at
    2 layers or blocks against the CPU (13d). Returns {sub-phase: row};
    a line names each sub-phase before it runs, and its ``family_`` line
    follows as each row is done."""
    from paddle_tpu_torch.models import bert as B
    from paddle_tpu_torch.models import deepfm as D
    from paddle_tpu_torch.models import ssd as SSD

    out = {"t0": time.perf_counter()}
    print("phase 13a: BERT-base pretraining", flush=True)
    bcfg = B.base()
    n_layer = bcfg.n_layer
    drops = 2 * n_layer + 1  # attention out and FFN a layer, embeddings
    # every layer's self-attention: one forward and one backward launch
    # (passes A and B) on the small route, and no dense call
    expect = {FWD_KERNELS["bfloat16"]: n_layer,
              BWD_KERNELS["bfloat16"][0]: n_layer,
              BWD_KERNELS["bfloat16"][1]: n_layer}
    bert, bert_counts = train_family(
        torch, np, fluid, fa, "bert_base", lambda: B.build(bcfg),
        lambda: fluid.optimizer.Adam(BERT_LR),
        [B.make_batch(bcfg, BERT_B, BERT_T, seed=SEED + s) for s in range(4)],
        amp=True, items=BERT_B * BERT_T, unit="tokens", expect=expect)
    route = fa.attention_route(BERT_T, BERT_T, bcfg.n_head,
                               bcfg.d_model // bcfg.n_head)
    assert route == "small", route
    per_step = bert["attention_launches_per_step"]
    want = {k: 0.0 for k in per_step}
    want["small/fwd"] = want["small/bwd"] = float(n_layer)
    assert per_step == want, per_step
    flops = bert_train_flops_per_step(bcfg, BERT_B, BERT_T)
    bert.update({
        "batch": BERT_B, "seq": BERT_T, "lr": BERT_LR, "route": route,
        "dropout_layers": drops,
        "train_tflop_per_step": flops / 1e12,
        "bound_ms_at_bf16_peak": flops / BF16_PEAK * 1e3,
        "bf16_peak_share": flops / (bert["step_ms"] * 1e-3) / BF16_PEAK,
        "attention_kernel_launches_traced": {
            k: sum(n for name, n in bert_counts.items() if _matches(name, k))
            for k in (FWD_KERNELS["bfloat16"][0],) + BWD_KERNELS["bfloat16"]},
    })
    _family_done(out, "13a", bert)
    torch.cuda.empty_cache()

    print("phase 13b: DeepFM, dense and row-sparse", flush=True)
    dcfg = D.DeepFMConfig(**DEEPFM)
    dfeeds = [D.make_batch(dcfg, DEEPFM_B, seed=SEED + s) for s in range(4)]
    for sparse in (False, True):
        row, _ = train_family(
            torch, np, fluid, fa, f"deepfm_{'sparse' if sparse else 'dense'}",
            lambda: D.build(dcfg, is_distributed=True, is_sparse=sparse),
            lambda: fluid.optimizer.Adam(DEEPFM_LR), dfeeds, amp=False,
            items=DEEPFM_B, unit="examples",
            tables=("deepfm_first.w", "deepfm_factor.w") if sparse else ())
        row.update({"batch": DEEPFM_B, "lr": DEEPFM_LR, "is_sparse": sparse,
                    "is_distributed": True, **DEEPFM,
                    "hidden": list(DEEPFM["hidden"])})
        _family_done(out, "13b_sparse" if sparse else "13b_dense", row)
        torch.cuda.empty_cache()

    print("phase 13c: SSD-300", flush=True)
    def ssd300():
        model = SSD.get_ssd300_model(SSD_CLASSES, SSD_GT)
        assert tuple(model["priors"].shape) == (SSD300_PRIORS, 4), \
            model["priors"].shape
        return model

    ssd, _ = train_family(
        torch, np, fluid, fa, "ssd300", ssd300,
        lambda: fluid.optimizer.Momentum(SSD_LR, momentum=SSD_MOMENTUM),
        [ssd300_feed(np, SSD_B, SEED + s) for s in range(4)], amp=True,
        items=SSD_B, unit="images")
    ssd.update({"batch": SSD_B, "classes": SSD_CLASSES, "gt_rows": SSD_GT,
                "priors": SSD300_PRIORS, "lr": SSD_LR,
                "momentum": SSD_MOMENTUM})
    _family_done(out, "13c", ssd)
    torch.cuda.empty_cache()

    print("phase 13d: each model on the card against the CPU", flush=True)
    c = FAMILY_CPU["bert"]
    small_bert = B.BertConfig(n_layer=c["n_layer"], dropout=0.0)
    _family_done(out, "13d_bert", family_vs_cpu(
        torch, np, fluid, "bert_2_layers", lambda: B.build(small_bert),
        lambda: fluid.optimizer.Adam(BERT_LR),
        [B.make_batch(small_bert, c["batch"], c["seq"], seed=SEED + s)
         for s in range(2)],
        ["bert_tok_emb.w@GRAD", "enc0_attn_qkv_colp.w@GRAD",
         "enc1_ffn2_rowp.w@GRAD", "mlm_proj_colp.w@GRAD", "nsp.w@GRAD"]))
    c = FAMILY_CPU["deepfm"]
    small_fm = D.DeepFMConfig(**{**DEEPFM, "hidden": c["hidden"]})
    fm_feeds = [D.make_batch(small_fm, c["batch"], seed=SEED + s)
                for s in range(2)]
    for sparse in (False, True):
        grads = ["deepfm_mlp0.w@GRAD", "deepfm_out.w@GRAD"]
        grads += (["deepfm_factor.w@GRAD@VALUES", "deepfm_first.w@GRAD@VALUES"]
                  if sparse else ["deepfm_factor.w@GRAD"])
        row = family_vs_cpu(
            torch, np, fluid, f"deepfm_2_layers_{'sparse' if sparse else 'dense'}",
            lambda: D.build(small_fm, is_distributed=True, is_sparse=sparse),
            lambda: fluid.optimizer.Adam(DEEPFM_LR), fm_feeds, grads,
            exact=[("rows", "deepfm_factor.w@GRAD@ROWS")] if sparse else ())
        _family_done(out, f"13d_deepfm_{'sparse' if sparse else 'dense'}",
                     row)
    c = FAMILY_CPU["ssd"]
    ssd_kw = dict(image_shape=c["image"], num_classes=c["classes"],
                  gt_capacity=c["gt"])
    _family_done(out, "13d_ssd", family_vs_cpu(
        torch, np, fluid, "ssd_get_model",
        lambda: SSD.get_model(batch_size=c["batch"], **ssd_kw),
        lambda: fluid.optimizer.Momentum(0.01, momentum=SSD_MOMENTUM),
        [SSD.synthetic_batch(c["batch"], seed=SEED + s, **ssd_kw)
         for s in range(2)],
        ["conv2d_0.w_0@GRAD", "batch_norm_3.w_0@GRAD"],
        exact=[("detection", "detection")]))
    out["seconds"] = time.perf_counter() - out.pop("t0")
    return out


# --- phase 14: the training runtime (contrib.Trainer over readers) ---

# 14a: three epochs of 16 steps of the main path, a checkpoint an epoch
RT_EPOCHS, RT_STEPS = 3, 16
RT_FEEDS = ["src_ids", "trg_ids", "lbl_ids", "src_pad_mask", "trg_pad_mask"]
# 14b: turns of two epochs of 8 steps on the Transformer, and
# bench_pipeline.py's MLP (width 1024, batch 256, 4 fc layers, SGD 0.05,
# 30 steps x 3 epochs), each under bench_pipeline.py's flags
RT_TURN_EPOCHS, RT_TURN_STEPS = 2, 8
MLP_WIDTH, MLP_BATCH, MLP_STEPS, MLP_EPOCHS = 1024, 256, 30, 3
# noam_decay's warmup steps (the reference transformer's)
NOAM_WARMUP = 4000
# 14c: the fault's hit of reader.next, step 5 of epoch 2
RT_FAIL_HIT = 2 * RT_STEPS + 6


def wmt16_reader(np, reader, wmt16, batch, t, steps):
    """The main path's reader: dataset.wmt16 pairs, each padded to ``t``
    with its pad masks, ``steps`` batches of ``batch`` (reader.firstn)."""
    def pad(sample):
        out = []
        for a in sample:
            ids = np.zeros(t, np.int64)
            ids[:len(a)] = a
            out.append(ids)
        out.append((np.arange(t) < len(sample[0])).astype(np.float32))
        out.append((np.arange(t) < len(sample[1])).astype(np.float32))
        return tuple(out)

    samples = reader.map_readers(pad, wmt16.train(10000, 10000, max_len=t))
    return reader.batch(reader.firstn(samples, batch * steps), batch)


def _runtime_trainer(fluid, T, contrib, cfg, ckpt=None):
    """Transformer-base through contrib.Trainer on the card: bf16 AMP
    (amp.decorate), Adam under noam_decay(d_model, 4000), the LR the
    trainer's second output. Seeded and built under unique_name.guard(),
    so two trainers start from the same weights under the same names."""
    from paddle_tpu_torch import layers

    lr = {}

    def train_func():
        fluid.default_main_program().random_seed = SEED
        fluid.default_startup_program().random_seed = SEED
        model = T.build(cfg)
        lr["var"] = layers.noam_decay(cfg.d_model, NOAM_WARMUP)
        return [model["loss"], lr["var"]]

    def optimizer_func():
        return fluid.amp.decorate(fluid.optimizer.Adam(lr["var"]))

    with fluid.unique_name.guard():
        return contrib.Trainer(train_func, optimizer_func,
                               fluid.CUDAPlace(0), checkpoint_config=ckpt)


def _mlp_trainer(fluid, contrib):
    """bench_pipeline.py's MLP through contrib.Trainer on the card."""
    from paddle_tpu_torch import layers

    def train_func():
        fluid.default_main_program().random_seed = SEED
        fluid.default_startup_program().random_seed = SEED
        x = layers.data("x", shape=[MLP_WIDTH], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = x
        for _ in range(4):
            h = layers.fc(h, MLP_WIDTH, act="relu")
        logits = layers.fc(h, 16)
        return [layers.mean(
            layers.softmax_with_cross_entropy(logits, label))]

    with fluid.unique_name.guard():
        return contrib.Trainer(train_func,
                               lambda: fluid.optimizer.SGD(0.05),
                               fluid.CUDAPlace(0))


def _mlp_reader(np):
    """bench_pipeline.py's reader: generate and normalize on the host."""
    def gen():
        rng = np.random.RandomState(0)
        for _ in range(MLP_STEPS):
            x = rng.randn(MLP_BATCH, MLP_WIDTH)
            x = (x - x.mean(axis=1, keepdims=True)) / (
                x.std(axis=1, keepdims=True) + 1e-6)
            yield list(zip(x.astype(np.float32),
                           rng.randint(0, 16, MLP_BATCH).astype(np.int64)))

    return gen


def _noam(np, d_model, step):
    """noam_decay's closed form in f32, as the graph computes it."""
    s = np.float32(step)
    return (np.float32(d_model) ** np.float32(-0.5) * np.minimum(
        s ** np.float32(-0.5), s * np.float32(NOAM_WARMUP) ** np.float32(-1.5))
    ).astype(np.float32)


def _host_state(torch, np, scope):
    """A Scope's values on the host: {name: numpy copy}, bf16 as bits."""
    out = {}
    for n in scope.var_names():
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                v = v.view(torch.int16)
            out[n] = v.cpu().numpy().copy()
        else:
            out[n] = np.array(v, copy=True)
    return out


def _train_recorded(torch, np, contrib, trainer, epochs, reader, feeds,
                    handler=None):
    """``trainer.train`` recording every step's fetches (kept as the
    trainer returns them, read after the run: a LazyFetches read in the
    handler would wait for its step) and each epoch's wall; returns
    ([fetches of each step as floats], {epoch: seconds})."""
    fetched, walls, t0 = [], {}, [0.0]

    def record(e):
        if isinstance(e, contrib.BeginEpochEvent):
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()
        elif isinstance(e, contrib.EndStepEvent):
            fetched.append(e.metrics)
        elif isinstance(e, contrib.EndEpochEvent):
            torch.cuda.synchronize()
            walls[e.epoch] = time.perf_counter() - t0[0]
        if handler is not None:
            handler(e)

    trainer.train(epochs, record, reader, feeds,
                  log_time_attribution=False)
    rows = [[float(np.asarray(v).reshape(-1)[0]) for v in m]
            for m in fetched]
    return rows, walls


def _mode_flags(flags, depth):
    """bench_pipeline.py's two modes: sync phases every step and
    synchronous staging, or sampled phases and prefetch."""
    flags.set_flags({"telemetry": True, "step_phases": True,
                     "step_phases_every_n": 8 if depth else 1,
                     "prefetch_depth": depth})


def _verdict_mix(monitor):
    c = monitor.counter("pt_step_bound_total")
    return {v: int(c.value(labels={"verdict": v}))
            for v in monitor.BOUND_VERDICTS}


def runtime_14a(torch, np, fluid, T, fa, ctx, tmp):
    """14a: the main path, three epochs of 16 steps with an async
    checkpoint an epoch; returns (row, final host state, launches)."""
    from paddle_tpu_torch import contrib, flags, kernels
    from paddle_tpu_torch.benchmarks import timing
    from paddle_tpu_torch.core.lowering import GATE
    from paddle_tpu_torch.parallel import checkpoint as ck

    rd, wmt16, cfg = ctx["reader"], ctx["wmt16"], ctx["cfg"]
    flags.set_flags({"prefetch_depth": 2})
    d = os.path.join(tmp, "ckpt_14a")
    ckpt = contrib.CheckpointConfig(d, max_num_checkpoints=2,
                                    async_save=True)
    t0 = time.perf_counter()
    trainer = _runtime_trainer(fluid, T, contrib, cfg, ckpt)
    build_s = time.perf_counter() - t0
    n_drop = sum(op.type == "dropout"
                 for op in trainer.main_program.global_block().ops)
    batches = wmt16_reader(np, rd, wmt16, TRAIN_B, TRAIN_T, RT_STEPS)
    capture = {}

    def at_capture(e):
        # the second run of the step is the one that captures it
        if isinstance(e, contrib.BeginStepEvent) and (e.epoch, e.step) == (
                0, 1):
            loader = trainer.loader
            capture["staged_before"] = loader.stats["batches"]
            capture["worker_alive"] = loader._active[2].is_alive()
            capture["captures_before"] = GATE.stats()["captures"]
        elif isinstance(e, contrib.EndStepEvent) and (e.epoch, e.step) == (
                0, 1):
            capture["captures_after"] = GATE.stats()["captures"]
            capture["staged_after"] = trainer.loader.stats["batches"]
        elif isinstance(e, contrib.EndEpochEvent) and e.epoch == 0:
            capture["epoch0_loader"] = dict(trainer.loader.stats)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    GATE.reset_stats()
    rows, walls = _train_recorded(torch, np, contrib, trainer, RT_EPOCHS,
                                  batches, RT_FEEDS, at_capture)
    launches = _counts(fa)
    launches["dropout"] = kernels.launch_counts["dropout"]
    gate = GATE.stats()
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    n = RT_EPOCHS * RT_STEPS
    losses = [r[0] for r in rows]
    lrs = [r[1] for r in rows]
    assert len(rows) == n and all(np.isfinite(losses)), losses
    want_lr = [float(_noam(np, cfg.d_model, s + 1)) for s in range(n)]
    assert np.allclose(lrs, want_lr, rtol=1e-6, atol=0), (lrs, want_lr)
    step_var = [v for v in trainer.scope.var_names()
                if v.startswith("learning_rate_sched_step")]
    assert len(step_var) == 1, step_var
    assert float(np.asarray(trainer.scope.find_var(step_var[0]).cpu())
                 .reshape(-1)[0]) == n
    want = {k: 0 for k in launches}
    want["small/fwd"] = want["small/bwd"] = 3 * cfg.n_layer * n
    want["dropout"] = n_drop * n
    assert launches == want, (launches, want)
    # 14d's half from this run: the capture, with the loader streaming
    assert gate["capture_failures"] == 0, gate
    assert capture["captures_after"] > capture["captures_before"], capture
    assert capture["worker_alive"], capture
    # batches 0 and 1 handed out, at least one more staged ahead
    assert capture["staged_before"] > 2, capture
    # the capture and a copy of the loader's overlapped: the copy waited
    # for the capture, or the capture for the copy
    assert (capture["epoch0_loader"]["gate_waits"]
            + gate["captures_waited"]) >= 1, (capture, gate)
    state = _host_state(torch, np, trainer.scope)

    # the trainer's step alone: device ms of one replay, by kernel
    from paddle_tpu_torch.data_feeder import DataFeeder

    feeder = DataFeeder(
        [trainer.main_program.global_block().var(k) for k in RT_FEEDS])
    feed = feeder.feed(next(iter(batches())))
    expect = {FWD_KERNELS["bfloat16"]: 3.0 * cfg.n_layer,
              BWD_KERNELS["bfloat16"][0]: 3.0 * cfg.n_layer,
              BWD_KERNELS["bfloat16"][1]: 3.0 * cfg.n_layer,
              "dropout_apply_kernel": n_drop}
    with fluid.scope_guard(trainer.scope):
        times = timing.device_times(lambda: trainer.exe.run(
            trainer.main_program, feed=feed,
            fetch_list=trainer.train_outputs), 2, expect, replay=True)
    device_ms = sum(times.values())
    last = RT_EPOCHS - 1
    step_ms = walls[last] / RT_STEPS * 1e3
    tokens = sum(float(np.sum([s[4] for s in b])) for b in batches())
    saves = []
    for rec in trainer.save_log:
        path = os.path.join(d, f"checkpoint_{rec['serial']}")
        saves.append({**rec, "bytes": (_dir_bytes(path)
                                       if os.path.isdir(path) else None)})
    assert ck.latest_step(d) == RT_EPOCHS, ck.available_steps(d)
    assert ck.available_steps(d) == [RT_EPOCHS - 1, RT_EPOCHS]
    trainer.exe.close()
    row = {
        "batch": TRAIN_B, "seq": TRAIN_T, "epochs": RT_EPOCHS,
        "steps_an_epoch": RT_STEPS, "dropout": cfg.dropout,
        "build_s": build_s, "losses": losses,
        "lr_first_last": [lrs[0], lrs[-1]],
        "epoch_wall_s": [walls[e] for e in range(RT_EPOCHS)],
        "step_ms": step_ms, "step_device_ms": device_ms,
        "idle_share": 1 - device_ms / step_ms,
        "target_tokens_per_s": tokens / walls[last],
        "peak_reserved_gib": peak_reserved,
        "launches": launches,
        "launches_per_step": {k: v / n for k, v in launches.items()},
        "saves": saves, "gate": gate, "capture": capture,
        "top_kernels_ms": [[k[:80], v] for k, v in sorted(
            times.items(), key=lambda kv: -kv[1])[:8]],
    }
    return row, state, launches


def runtime_14b(torch, np, fluid, T, ctx):
    """14b: prefetch_depth 0 against 2 in turns (0, 2, 2, 0) on the main
    path and on bench_pipeline.py's MLP, under bench_pipeline.py's flags:
    equal losses bit for bit, ms a step over the last epoch, the verdict
    mix at the end of each turn. One trainer a model: each turn starts
    from its startup state and executor step 0 (its first turn captures
    the step; every turn times its last epoch)."""
    from paddle_tpu_torch import contrib, flags, monitor

    rd, wmt16, cfg = ctx["reader"], ctx["wmt16"], ctx["cfg"]
    out = {}
    for name in ("transformer", "mlp"):
        if name == "transformer":
            trainer = _runtime_trainer(fluid, T, contrib, cfg)
            reader = wmt16_reader(np, rd, wmt16, TRAIN_B, TRAIN_T,
                                  RT_TURN_STEPS)
            epochs, steps, feeds = RT_TURN_EPOCHS, RT_TURN_STEPS, RT_FEEDS
        else:
            trainer = _mlp_trainer(fluid, contrib)
            reader = _mlp_reader(np)
            epochs, steps, feeds = MLP_EPOCHS, MLP_STEPS, ["x", "label"]
        start = {n: trainer.scope.find_var(n).clone()
                 for n in trainer.scope.var_names()}
        turns = {0: [], 2: []}
        ref = None
        for depth in (0, 2, 2, 0):
            for n, v in start.items():
                trainer.scope.set(n, v.clone())
            trainer.exe._step = 0
            monitor.reset()
            _mode_flags(flags, depth)
            rows, walls = _train_recorded(torch, np, contrib, trainer,
                                          epochs, reader, feeds)
            losses = [r[0] for r in rows]
            if ref is None:
                ref = losses
            assert losses == ref, (name, depth, losses, ref)
            turns[depth].append({
                "ms_a_step": walls[epochs - 1] / steps * 1e3,
                "verdicts": _verdict_mix(monitor)})
        trainer.exe.close()
        del trainer, start
        torch.cuda.empty_cache()
        sync = [t["ms_a_step"] for t in turns[0]]
        pipe = [t["ms_a_step"] for t in turns[2]]
        out[name] = {"sync": turns[0], "pipelined": turns[2],
                     "sync_over_pipelined": (sum(sync) / sum(pipe)),
                     "losses_equal": True, "steps": len(ref)}
    flags.set_flags({"telemetry": False, "step_phases_every_n": 16,
                     "prefetch_depth": 2})
    monitor.reset()
    return out


def runtime_14c(torch, np, fluid, T, ctx, tmp, want_state, want_losses):
    """14c: reader.next fails at step 5 of epoch 2 with one resume
    allowed and async saves on: the Trainer resumes from checkpoint_2 and
    ends bit-equal to 14a's uninterrupted run; then a ckpt.commit fault
    leaves checkpoint_3 as the newest valid serial."""
    from paddle_tpu_torch import contrib, faults, flags
    from paddle_tpu_torch.parallel import checkpoint as ck

    rd, wmt16, cfg = ctx["reader"], ctx["wmt16"], ctx["cfg"]
    flags.set_flags({"prefetch_depth": 2})
    d = os.path.join(tmp, "ckpt_14c")
    ckpt = contrib.CheckpointConfig(d, max_num_checkpoints=2,
                                    max_resume_retries=1, async_save=True)
    trainer = _runtime_trainer(fluid, T, contrib, cfg, ckpt)
    batches = wmt16_reader(np, rd, wmt16, TRAIN_B, TRAIN_T, RT_STEPS)
    faults.arm(f"reader.next:raise@{RT_FAIL_HIT}")
    try:
        rows, _ = _train_recorded(torch, np, contrib, trainer, RT_EPOCHS,
                                  batches, RT_FEEDS)
    finally:
        faults.disarm()
    losses = [r[0] for r in rows]
    before = (RT_FAIL_HIT - 1)
    # the run before the fault, then epoch 2 again from checkpoint_2
    assert losses[:before] == want_losses[:before], "pre-fault losses"
    assert losses[before:] == want_losses[2 * RT_STEPS:], "resumed losses"
    state = _host_state(torch, np, trainer.scope)
    assert sorted(state) == sorted(want_state), (
        sorted(set(state) ^ set(want_state)))
    differ = [n for n in state if not np.array_equal(state[n],
                                                     want_state[n])]
    assert not differ, differ
    # a commit fault: the previous serial stays the newest valid one
    faults.arm("ckpt.commit:raise@1")
    failed = None
    try:
        trainer._save_checkpoint(RT_EPOCHS + 1)
        trainer._wait_pending_save()
    except faults.InjectedFault as e:
        failed = str(e)
    finally:
        faults.disarm()
    assert failed is not None, "the ckpt.commit fault did not fire"
    latest = ck.latest_step(d)
    with open(os.path.join(d, "latest")) as f:
        pointer = int(f.read())
    assert latest == pointer == RT_EPOCHS, (latest, pointer)
    assert ck.validate_checkpoint(d, RT_EPOCHS)
    assert os.path.isdir(os.path.join(d, f"checkpoint_{RT_EPOCHS + 1}.tmp"))
    trainer.exe.close()
    return {"fault_hit": RT_FAIL_HIT, "steps_run": len(losses),
            "resumed_from": 2, "state_vars": len(state),
            "state_bit_equal": True, "commit_fault": failed,
            "latest_after_commit_fault": latest, "valid": True}


def runtime_14d(torch, np, fluid):
    """14d's drill: a DeviceLoader streams [64, 256] batches to a
    consumer thread while the main thread captures small fc steps on
    fresh executors: no capture fails, the loader's copies wait for the
    captures, and each captured step equals its eager run."""
    from paddle_tpu_torch import layers, reader
    from paddle_tpu_torch.core.lowering import GATE

    def endless():
        r = np.random.RandomState(SEED)
        while True:
            yield {k: r.randint(0, 10000, (TRAIN_B, TRAIN_T)).astype(
                np.int64) for k in RT_FEEDS}

    loader = reader.DeviceLoader(endless, RT_FEEDS, depth=2,
                                 place=fluid.CUDAPlace(0))
    stop, seen = [False], [0]

    def consume():
        for feed in loader:
            seen[0] += 1
            if stop[0]:
                break

    def three_steps(i, cached):
        """Three steps of a small fc model from a seeded startup: the
        first eager, then (``cached``) captured and replayed."""
        main_prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main_prog, startup):
            x = layers.data("x", shape=[256], dtype="float32")
            loss = layers.mean(layers.fc(layers.fc(x, 256, act="relu"), 8))
            fluid.optimizer.SGD(0.1).minimize(loss)
        startup.random_seed = main_prog.random_seed = SEED + i
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        feed = {"x": np.random.RandomState(i).randn(64, 256).astype(
            np.float32)}
        with fluid.scope_guard(scope):
            exe.run(startup)
            got = [exe.run(main_prog, feed=feed, fetch_list=[loss],
                           use_program_cache=cached)[0] for _ in range(3)]
        exe.close()
        return got

    GATE.reset_stats()
    thread = __import__("threading").Thread(target=consume, daemon=True)
    thread.start()
    try:
        equal = []
        for i in range(6):
            captured = three_steps(i, True)
            eager = three_steps(i, False)
            equal.append(all(np.array_equal(a, b)
                             for a, b in zip(captured, eager)))
    finally:
        stop[0] = True
        thread.join(30)
    assert not thread.is_alive(), "the consumer thread did not end"
    loader.close()
    gate = GATE.stats()
    assert gate["capture_failures"] == 0, gate
    assert gate["captures"] >= 6, gate
    assert all(equal), equal
    assert loader.stats["gate_waits"] > 0, loader.stats
    return {"captures": gate["captures"], "capture_failures": 0,
            "loader": dict(loader.stats), "batches_consumed": seen[0],
            "longest_capture_wait_s": gate["longest_capture_wait_s"],
            "captured_equals_eager": equal}


def runtime_14e(torch, np, fluid, tmp):
    """14e: Executor.train_from_dataset over an InMemoryDataset of text
    files, a small fc model on the card: its losses and final weights
    equal the same batches through Executor.run, bit for bit."""
    from paddle_tpu_torch import layers

    r = np.random.RandomState(SEED)
    files = []
    for i in range(4):
        path = os.path.join(tmp, f"part-{i}.txt")
        with open(path, "w") as f:
            for _ in range(64):
                x = r.randn(16)
                f.write(" ".join(f"{v:.6f}" for v in x)
                        + f" {int(r.randint(4))}\n")
        files.append(path)

    def parse(line):
        vals = line.split()
        return (np.array(vals[:16], np.float32),
                np.array(vals[16:], np.int64))

    def build():
        main_prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main_prog, startup), \
                fluid.unique_name.guard():
            x = layers.data("x", shape=[16], dtype="float32")
            y = layers.data("label", shape=[1], dtype="int64")
            loss = layers.mean(layers.softmax_with_cross_entropy(
                layers.fc(layers.fc(x, 32, act="relu"), 4), y))
            fluid.optimizer.SGD(0.1).minimize(loss)
        startup.random_seed = main_prog.random_seed = SEED
        return main_prog, startup, x, y, loss

    class Recording(fluid.Executor):
        """An executor that keeps every run's first fetch."""

        seen = None

        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            if out and self.seen is not None:
                self.seen.append(np.asarray(out[0]).copy())
            return out

    results = []
    for via_dataset in (True, False):
        main_prog, startup, x, y, loss = build()
        dataset = fluid.DatasetFactory().create_dataset("InMemoryDataset")
        dataset.set_filelist(files)
        dataset.set_batch_size(32)
        dataset.set_use_var([x, y])
        dataset.set_parse_fn(parse)
        dataset.load_into_memory()
        dataset.set_shuffle_seed(SEED)
        dataset.local_shuffle()
        exe, scope = Recording(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            exe.seen = []
            if via_dataset:
                steps = exe.train_from_dataset(main_prog, dataset,
                                               fetch_list=[loss])
            else:
                steps = 0
                for feed in dataset.batch_reader()():
                    exe.run(main_prog, feed=feed, fetch_list=[loss])
                    steps += 1
            weights = {p.name: scope.find_var(p.name).cpu().numpy().copy()
                       for p in main_prog.all_parameters()}
        released = exe.release_scope(scope)
        exe.close()
        results.append((steps, [float(v) for v in exe.seen], weights,
                        released))
    (s1, l1, w1, rel), (s2, l2, w2, _) = results
    assert s1 == s2 == 8, (s1, s2)
    assert l1 == l2, (l1, l2)
    assert all(np.array_equal(w1[n], w2[n]) for n in w1)
    assert rel >= 1, rel
    return {"steps": s1, "losses": l1, "bit_equal": True,
            "runners_released": rel}


def training_runtime(torch, np, fluid, T, fa, tmp):
    """Phase 14: the training runtime on the card, 14a-14e (each sub-phase
    named on a line before it runs); returns ({key: row}, the main
    path's launches)."""
    from paddle_tpu_torch import reader
    from paddle_tpu_torch.dataset import wmt16

    ctx = {"reader": reader, "wmt16": wmt16,
           "cfg": T.TransformerConfig(max_length=TRAIN_T)}
    out = {}
    print("phase 14a: Transformer-base through contrib.Trainer from "
          "dataset.wmt16, prefetch 2, async checkpoints", flush=True)
    out["14a"], state, launches = runtime_14a(torch, np, fluid, T, fa, ctx,
                                              tmp)
    torch.cuda.empty_cache()
    print("phase 14b: prefetch_depth 0 against 2, in turns", flush=True)
    out["14b"] = runtime_14b(torch, np, fluid, T, ctx)
    print("phase 14c: crash in epoch 2, auto-resume, commit fault",
          flush=True)
    out["14c"] = runtime_14c(torch, np, fluid, T, ctx, tmp, state,
                             out["14a"]["losses"])
    del state
    torch.cuda.empty_cache()
    print("phase 14d: captures beside a streaming DeviceLoader", flush=True)
    out["14d"] = {"main_path": out["14a"]["capture"],
                  "drill": runtime_14d(torch, np, fluid)}
    print("phase 14e: Executor.train_from_dataset", flush=True)
    out["14e"] = runtime_14e(torch, np, fluid, tmp)
    return out, launches


# --- phase 15: the recurrent family and the rest of the benchmark's zoo ---

# benchmarks/fluid_benchmark.py's defaults (:112-118) for the five models it
# times: batch 32, seq_len 64, Adam 1e-3, f32 (--amp: bf16 AMP); each model
# at its JAX configuration (:41-75), uncut
ZOO_B, ZOO_T, ZOO_LR = 32, 64, 1e-3
# the repeated-batch check: ZOO_REPEATED steps on one batch at ZOO_LR must
# end below where they began
ZOO_REPEATED = 6
# 15c: VGG-16's head feeds the dropout op's kernel [batch, 4096] at p 0.5
VGG_FC, VGG_DROP = 4096, 0.5
# 15e: BASELINE.md's published configuration, VGG-16 inference at mb 64
VGG_INFER_B = 64
VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# 15f: each rnn op in f64 on the card against f64 on the CPU (cuBLAS
# against the CPU's BLAS, other summation orders): outputs and gradients
# within 1e-10 of their largest |element|
TOL_RNN_F64_REL = 1e-10
# 15f: each model at one or two layers or blocks of its full width
# against the CPU (family_vs_cpu: phase 13d's tolerances)
ZOO_CPU_B = 4


def vgg16_train_flops_per_step(batch, side=224, classes=1000, fc=4096):
    """The FLOPs of a VGG-16 training step, a multiply-add two: 3x the
    forward's convolutions and fc layers."""
    flops, c = 0, 3
    for filters, n in VGG16_BLOCKS:
        for _ in range(n):
            flops += 2 * side * side * c * filters * 9
            c = filters
        side //= 2
    flops += 2 * (c * side * side * fc + fc * fc + fc * classes)
    return 3.0 * batch * flops


def _zoo_feeds(np, name, batch, n, seed):
    """``n`` batches of fluid_benchmark.py's synthetic feeds (normal images
    or pixels, uniform labels) for the vision models."""
    out = []
    for s in range(n):
        r = np.random.RandomState(seed + s)
        if name == "mnist":
            out.append({"pixel": r.normal(0, 1, (batch, 784))
                        .astype(np.float32),
                        "label": r.randint(0, 10, (batch, 1))
                        .astype(np.int64)})
        else:
            out.append({"data": r.normal(0, 1, (batch, 3, 224, 224))
                        .astype(np.float32),
                        "label": r.randint(0, 1000, (batch, 1))
                        .astype(np.int64)})
    return out


def _falling_loss(torch, np, fluid, build, feed, amp, make_opt=None):
    """Losses of ZOO_REPEATED steps on one batch from a fresh start at
    ``make_opt()`` (Adam(ZOO_LR) by default), the step captured from its
    second call: finite, the last below the first."""
    main_prog, startup, model, _ = _family_program(
        fluid, build, make_opt or (lambda: fluid.optimizer.Adam(ZOO_LR)),
        amp)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        got = [float(exe.run(main_prog, feed=feed,
                             fetch_list=[model["loss"]])[0])
               for _ in range(ZOO_REPEATED)]
    exe.close()
    assert all(np.isfinite(got)) and got[-1] < got[0], got
    return got


def _zoo_train(torch, np, fluid, fa, name, build, feeds, *, amp):
    """15a-d: one model trained through Executor.run / run_steps at
    fluid_benchmark.py's defaults (``train_family``: captured = eager bit
    for bit over three steps, turns, device ms by family, launches), and
    its loss falling on a repeated batch."""
    row, _ = train_family(torch, np, fluid, fa, name, build,
                          lambda: fluid.optimizer.Adam(ZOO_LR), feeds,
                          amp=amp, items=ZOO_B, unit="examples")
    assert not any(row["attention_launches_per_step"].values()), row
    row["repeated_batch_losses"] = _falling_loss(torch, np, fluid, build,
                                                 feeds[0], amp)
    row.update(batch=ZOO_B, lr=ZOO_LR)
    torch.cuda.empty_cache()
    return row


def _recurrence(row, layers, t):
    """A recurrent model's row with its launches a layer and time step (a
    step walks each of its ``layers`` lstm ops' T steps three times:
    forward, the grad op's re-run, backward)."""
    row.update(lstm_layers=layers, time_steps=t,
               launches_per_time_step=row["launches_per_step"] / (layers * t))
    return row


def vgg_inference(torch, np, fluid, V, tmp):
    """15e: VGG-16's is_test network at 3 x 224 x 224 exported by
    ``io.save_inference_model`` and served through ``inference.Predictor``
    at mb 64 (BASELINE.md's configuration), f32 and bf16: logits against
    the source program's (f32 within TOL_BUCKET_REL, bf16 within
    TOL_BF16_LOGIT_REL of the largest |logit|), ms a batch over
    ``Predictor.run`` (numpy in and out; the step captured from its second
    call), and the device ms of one run."""
    from paddle_tpu_torch import inference, io

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("data", shape=[3, 224, 224], dtype="float32")
        logits = V.vgg16(img, class_dim=1000, is_test=True)
    startup.random_seed = SEED
    x = _zoo_feeds(np, "vgg", VGG_INFER_B, 1, SEED)[0]["data"]
    d = os.path.join(tmp, "vgg16")
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
        (ref,) = exe.run(main, feed={"data": x}, fetch_list=[logits])
        t0 = time.perf_counter()
        io.save_inference_model(d, ["data"], [logits], exe, main)
        export_s = time.perf_counter() - t0
    exe.close()
    del scope
    assert np.isfinite(ref).all() and ref.shape == (VGG_INFER_B, 1000)
    rows = {}
    for dtype in ("float32", "bfloat16"):
        config = inference.Config(d)
        if dtype == "bfloat16":
            config.enable_bf16()
        t0 = time.perf_counter()
        pred = inference.create_predictor(config)
        load_s = time.perf_counter() - t0
        pred.run([x])  # the eager call
        (got,) = pred.run([x])  # the capture
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            (got,) = pred.run([x])
            walls.append((time.perf_counter() - t0) * 1e3)
        times = _device_times(lambda: pred.run([x]), iters=2, replay=True)
        graphs = _graphs(pred._exe)
        pred.close()
        err = _rel_err(np, got, ref)
        tol = TOL_BUCKET_REL if dtype == "float32" else TOL_BF16_LOGIT_REL
        assert err <= tol, (dtype, err)
        rows[dtype] = {
            "ms_a_batch": sorted(walls)[len(walls) // 2],
            "ms_a_batch_min": min(walls), "walls_ms": walls,
            "device_ms": sum(times.values()),
            "images_per_s": VGG_INFER_B / (sorted(walls)[len(walls) // 2]
                                           / 1e3),
            "logit_rel_err": err, "tol": tol, "load_s": load_s,
            "graphs": graphs,
            "top1_agreement": float((got.argmax(1) == ref.argmax(1)).mean()),
            "device_ms_by_family": _kernel_families(times)}
    torch.cuda.empty_cache()
    return {"batch": VGG_INFER_B, "image": [3, 224, 224], "classes": 1000,
            "export_s": export_s, "export_bytes": _dir_bytes(d), **rows}


def _rnn_op_cases(np):
    """(name, op type, f64 inputs, attrs): each recurrent op at B 4, T 16,
    H 32 with lengths (rows of length 0 and T), is_reverse, H0 / C0 and
    forget_bias among them."""
    r = np.random.RandomState(SEED)
    b, t, h = 4, 16, 32

    def f(*shape):
        return r.normal(0, 0.5, shape)

    lens = np.array([16, 9, 0, 3], np.int64)
    return [
        ("lstm", "lstm", {"Input": [f(b, t, 4 * h)],
                          "Weight": [f(h, 4 * h)], "Bias": [f(4 * h)]},
         {}),
        ("lstm lengths H0 C0 forget_bias", "lstm",
         {"Input": [f(b, t, 4 * h)], "Weight": [f(h, 4 * h)],
          "Bias": [f(4 * h)], "H0": [f(b, h)], "C0": [f(b, h)],
          "Length": [lens]}, {"forget_bias": 1.0}),
        ("lstm lengths reverse", "lstm",
         {"Input": [f(b, t, 4 * h)], "Weight": [f(h, 4 * h)],
          "H0": [f(b, h)], "C0": [f(b, h)], "Length": [lens[:, None]]},
         {"is_reverse": True}),
        ("gru lengths reverse H0", "gru",
         {"Input": [f(b, t, 3 * h)], "Weight": [f(h, 3 * h)],
          "Bias": [f(3 * h)], "H0": [f(b, h)], "Length": [lens]},
         {"is_reverse": True}),
        ("gru", "gru", {"Input": [f(b, t, 3 * h)], "Weight": [f(h, 3 * h)]},
         {}),
        ("gru_unit", "gru_unit", {"Input": [f(b, 3 * h)],
                                  "HiddenPrev": [f(b, h)],
                                  "Weight": [f(h, 3 * h)],
                                  "Bias": [f(3 * h)]}, {}),
        ("lstm_unit forget_bias", "lstm_unit",
         {"X": [f(b, 4 * h)], "C_prev": [f(b, h)]}, {"forget_bias": 1.0}),
        ("lstmp reverse", "lstmp",
         {"Input": [f(b, t, 4 * h)], "Weight": [f(16, 4 * h)],
          "ProjWeight": [f(h, 16)], "Bias": [f(1, 7 * h)]},
         {"is_reverse": True}),
    ]


def op_and_grads(torch, np, op_type, ins, attrs, dev, seed, op_seed=None):
    """One op's outputs and its derived gradients (``make_grad_compute``)
    on ``dev`` from numpy inputs ``ins``, for one normal cotangent an
    output drawn from ``seed`` (in a float output's dtype, else f64):
    {slot: numpy array}, outputs and grads. ``op_seed``: a random op's
    seed handle, for the op and its grad."""
    from paddle_tpu_torch.core import autodiff
    from paddle_tpu_torch.core.registry import get_op_def

    opdef = get_op_def(op_type)
    rng_kw = {} if op_seed is None else {"seed": op_seed}
    t_ins = {k: [torch.from_numpy(np.asarray(v)).to(dev) for v in vs]
             for k, vs in ins.items()}
    outs = opdef.compute(t_ins, dict(attrs), dev, **rng_kw)
    r = np.random.RandomState(seed)
    g_ins = dict(t_ins, **outs)
    g_ins.update({"GRAD::" + k: [torch.from_numpy(
        r.normal(0, 1, tuple(v[0].shape))).to(
            dev, v[0].dtype if v[0].is_floating_point() else torch.float64)]
        for k, v in outs.items()})
    grads = autodiff.make_grad_compute(opdef)(
        g_ins, dict(attrs, fwd_input_slots=list(ins),
                    fwd_output_slots=list(outs)), dev, **rng_kw)
    return {k: v[0].cpu().numpy()
            for k, v in list(outs.items()) + list(grads.items())
            if v and v[0] is not None}


def rnn_ops_vs_cpu(torch, np):
    """15f: each recurrent op's outputs and derived gradients (one f64
    cotangent an output) on the card against the CPU, in f64."""
    rows = {}
    for name, op, ins, attrs in _rnn_op_cases(np):
        gpu, cpu = (op_and_grads(torch, np, op, ins, attrs, dev, SEED + 1)
                    for dev in (torch.device("cuda", 0), torch.device("cpu")))
        assert sorted(gpu) == sorted(cpu), (name, sorted(gpu), sorted(cpu))
        errs = {k: _rel_err(np, gpu[k], cpu[k]) for k in cpu}
        assert max(errs.values()) <= TOL_RNN_F64_REL, (name, errs)
        rows[name] = {"max_rel_err": max(errs.values()),
                      "values": len(errs)}
    return {"dtype": "float64", "tol_rel": TOL_RNN_F64_REL, "ops": rows}


def _vgg_blocks(fluid, V, blocks, side, fc_dim):
    """VGG's first ``blocks`` conv blocks at their full widths over
    3 x side x side images and its fc head (``fc_dim``, no dropout)."""
    layers = fluid.layers
    img = layers.data("data", shape=[3, side, side], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = img
    for filters, n in VGG16_BLOCKS[:blocks]:
        x = V.conv_block(x, filters, n)
    for _ in range(2):
        x = layers.fc(x, fc_dim, act="relu")
    logits = layers.fc(x, 1000)
    return {"loss": layers.mean(layers.softmax_with_cross_entropy(logits,
                                                                  label))}


def zoo(torch, np, fluid, fa, tmp):
    """Phase 15: stacked_dynamic_lstm (15a), machine_translation (15b),
    VGG-16 f32 and bf16 (15c, with the dropout op's kernel held against
    its plain version at its head's shape), MNIST conv and MLP (15d)
    trained on the card at fluid_benchmark.py's defaults; VGG-16 served
    through the Predictor at mb 64 (15e); the rnn ops and each model at
    one or two layers against the CPU (15f). Returns {sub-phase: row}; a
    line names each sub-phase before it runs, and its ``zoo_`` line
    follows."""
    from paddle_tpu_torch.models import mnist as MN
    from paddle_tpu_torch.models import seq2seq as S2S
    from paddle_tpu_torch.models import stacked_lstm as SL
    from paddle_tpu_torch.models import vgg as V
    from paddle_tpu_torch.ops import nn_ops

    out = {"t0": time.perf_counter()}

    def done(key, row):
        row["at_s"] = time.perf_counter() - out["t0"]
        out[key] = row
        print(f"zoo_{key} " + json.dumps(row), flush=True)

    print("phase 15a: stacked_dynamic_lstm (vocab 5148, 3 x (fc + lstm "
          "128), seq_len 64, batch 32)", flush=True)
    scfg = SL.StackedLSTMConfig(max_len=ZOO_T)
    row = _zoo_train(torch, np, fluid, fa, "stacked_dynamic_lstm",
                     lambda: SL.build(scfg),
                     [SL.make_batch(scfg, ZOO_B, seed=SEED + s)
                      for s in range(4)], amp=False)
    done("15a", _recurrence(row, scfg.stacked_num, ZOO_T))

    print("phase 15b: machine_translation (vocab 2000, 2 + 2 lstm 256, "
          "dot attention, src and trg 64, batch 32)", flush=True)
    mcfg = S2S.Seq2SeqConfig()
    row = _zoo_train(torch, np, fluid, fa, "machine_translation",
                     lambda: S2S.build(mcfg),
                     [S2S.make_batch(mcfg, ZOO_B, ZOO_T, ZOO_T,
                                     seed=SEED + s) for s in range(4)],
                     amp=False)
    done("15b", _recurrence(row, 2 * mcfg.num_layers, ZOO_T))

    vfeeds = _zoo_feeds(np, "vgg", ZOO_B, 4, SEED)
    flops = vgg16_train_flops_per_step(ZOO_B)
    for amp in (False, True):
        tag = "bf16" if amp else "f32"
        print(f"phase 15c: VGG-16 {tag} (3 x 224 x 224, 1000 classes, "
              f"batch 32)", flush=True)
        row = _zoo_train(torch, np, fluid, fa, f"vgg16_{tag}",
                         lambda: V.get_model(batch_size=ZOO_B), vfeeds,
                         amp=amp)
        peak = PEAK_FLOPS["bfloat16"]["bf16 tensor cores"] if amp else \
            PEAK_FLOPS["float32"]["f32 CUDA cores"]
        row.update(train_tflop_per_step=flops / 1e12,
                   peak_share=flops / (row["step_ms"] * 1e-3) / peak,
                   peak_tflop_s=peak / 1e12)
        # the head's two dropout ops, each a launch of the dropout op's
        # kernel on [batch, 4096] in the step's activation dtype; the
        # kernel held bit for bit against its plain version there
        assert row["dropout_launches_per_step"] == 2, row
        row["dropout_op"] = check_dropout_op(
            nn_ops, (ZOO_B, VGG_FC), torch.bfloat16 if amp else torch.float32,
            VGG_DROP)
        done(f"15c_{tag}", row)
    del vfeeds

    mfeeds = _zoo_feeds(np, "mnist", ZOO_B, 4, SEED)
    for use_conv in (True, False):
        tag = "conv" if use_conv else "mlp"
        print(f"phase 15d: MNIST {tag} (batch 32)", flush=True)
        done(f"15d_{tag}", _zoo_train(
            torch, np, fluid, fa, f"mnist_{tag}",
            lambda: MN.get_model(batch_size=ZOO_B, use_conv=use_conv),
            mfeeds, amp=False))

    print("phase 15e: VGG-16 inference through the Predictor at mb 64, "
          "f32 and bf16", flush=True)
    done("15e", vgg_inference(torch, np, fluid, V, tmp))

    print("phase 15f: the rnn ops in f64 and each model at one or two "
          "layers, the card against the CPU", flush=True)
    done("15f_ops", rnn_ops_vs_cpu(torch, np))
    c = SL.StackedLSTMConfig(stacked_num=2, max_len=ZOO_T)
    done("15f_stacked_lstm", family_vs_cpu(
        torch, np, fluid, "stacked_lstm_2_blocks", lambda: SL.build(c),
        lambda: fluid.optimizer.Adam(ZOO_LR),
        [SL.make_batch(c, ZOO_CPU_B, seed=SEED + s) for s in range(2)],
        ["slstm_emb.w@GRAD", "slstm_fc0.w@GRAD", "slstm_lstm0.w@GRAD",
         "slstm_lstm1.w@GRAD", "slstm_out.w@GRAD"]))
    c = S2S.Seq2SeqConfig(num_layers=1)
    done("15f_seq2seq", family_vs_cpu(
        torch, np, fluid, "seq2seq_1_layer", lambda: S2S.build(c),
        lambda: fluid.optimizer.Adam(ZOO_LR),
        [S2S.make_batch(c, ZOO_CPU_B, ZOO_T, ZOO_T, seed=SEED + s)
         for s in range(2)],
        ["src_emb.w@GRAD", "enc_l0_hh.w@GRAD", "dec_l0_hh.w@GRAD",
         "attn_merge.w@GRAD", "proj.w@GRAD"]))
    done("15f_vgg", family_vs_cpu(
        torch, np, fluid, "vgg16_2_blocks",
        lambda: _vgg_blocks(fluid, V, 2, 64, 512),
        lambda: fluid.optimizer.Adam(ZOO_LR),
        [{"data": f["data"][:, :, :64, :64].copy(), "label": f["label"]}
         for f in _zoo_feeds(np, "vgg", ZOO_CPU_B, 2, SEED)],
        ["conv2d_0.w_0@GRAD", "conv2d_3.w_0@GRAD", "fc_0.w_0@GRAD",
         "fc_2.w_0@GRAD"]))
    done("15f_mnist", family_vs_cpu(
        torch, np, fluid, "mnist_conv",
        lambda: MN.get_model(batch_size=ZOO_CPU_B, use_conv=True),
        lambda: fluid.optimizer.Adam(ZOO_LR),
        _zoo_feeds(np, "mnist", ZOO_CPU_B, 2, SEED),
        ["conv2d_0.w_0@GRAD", "conv2d_1.w_0@GRAD", "fc_0.w_0@GRAD"]))
    out["seconds"] = time.perf_counter() - out.pop("t0")
    return out


# --- phase 16: structured control flow, CRF / CTC, the SRL chapter ------

# the reference's book/test_label_semantic_roles.py: word_dim 32, mark_dim
# 5, hidden_dim 512 (dynamic_lstm(size=512) is an LSTM of 128), depth 8,
# mix_hidden_lr 1e-3 on the CRF's transition, SGD on exponential_decay(
# 0.01, 100000, 0.5, staircase=True), BATCH_SIZE 10; conll05's
# dictionaries (44,068 words, 3,162 predicates, 59 labels: 29 chunk types
# in IOB). Sequences are padded to 30 (conll05's sentences are 5-29
# words). The one departure from the book: no peepholes (the JAX
# package's dynamic_lstm raises on them).
SRL_WORD, SRL_PRED, SRL_MARK, SRL_LABELS = 44068, 3162, 2, 59
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HIDDEN, SRL_DEPTH = 32, 5, 512, 8
SRL_MIX_LR = 1e-3
SRL_B, SRL_T = 10, 30
SRL_CHUNK_TYPES = (SRL_LABELS - 1 + 1) // 2
SRL_FIELDS = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
              "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data",
              "target"]
# 16b: build_scan against build() at Transformer-base, f32, dropout 0, SGD
# steps from one state: the same ops in the same order, but the scan's
# gradients come from autograd through the re-run layer (other summation
# orders than the registered and derived grads of build()): loss
# relative, and each gradient relative to its largest element; each
# parameter after the first update relative to its largest update
# element: a missing or doubled update reads 1, rounding one ulp of a
# weight over its update (1/6 on the H100: the decoder's first
# cross-attention q and k weights move by at most 6 ulps in that step)
TOL_SCAN_LOSS_REL, TOL_SCAN_GRAD_REL, TOL_SCAN_STATE_REL = 1e-5, 1e-4, 0.5
# 16c: the drills' small programs, card against CPU (family_vs_cpu)
DRILL_B = 4


def srl_db_lstm(fluid, table):
    """The book's ``db_lstm`` and its objective, from the port's public
    layers: six word-context embeddings sharing the frozen ``emb`` table
    (``table``: conll05.get_embedding()), the predicate and mark
    embeddings (row-sparse), fc + sums into SRL_DEPTH dynamic_lstm of
    alternating direction (candidate relu, cell sigmoid), each layer's
    fc over the previous lstm's (hidden, cell) pair as the book wrote it;
    linear_chain_crf on ``crfw`` (its learning rate SRL_MIX_LR),
    crf_decoding and chunk_eval; the test program cloned before the
    optimizer."""
    L = fluid.layers
    feeds = {n: L.data(n, shape=[SRL_T], dtype="int64") for n in SRL_FIELDS}
    length = L.data("word_data_len", shape=[], dtype="int64")
    pred_emb = L.embedding(feeds["verb_data"],
                           size=[SRL_PRED, SRL_WORD_DIM], is_sparse=True,
                           param_attr="vemb")
    mark_emb = L.embedding(feeds["mark_data"],
                           size=[SRL_MARK, SRL_MARK_DIM], is_sparse=True)
    emb_attr = fluid.ParamAttr(
        name="emb", trainable=False,
        initializer=fluid.initializer.NumpyArrayInitializer(table))
    embs = [L.embedding(feeds[n], size=[SRL_WORD, SRL_WORD_DIM],
                        is_sparse=True, param_attr=emb_attr)
            for n in SRL_FIELDS[:6]] + [pred_emb, mark_emb]

    def lstm(x, reverse):
        return L.dynamic_lstm(x, SRL_HIDDEN, length=length,
                              candidate_activation="relu",
                              gate_activation="sigmoid",
                              cell_activation="sigmoid", is_reverse=reverse)

    hidden_0 = L.sums([L.fc(e, SRL_HIDDEN, num_flatten_dims=2, act="tanh")
                       for e in embs])
    tmp = [hidden_0, lstm(hidden_0, False)]
    for i in range(1, SRL_DEPTH):
        mix = L.sums([
            L.fc(tmp[0], SRL_HIDDEN, num_flatten_dims=2, act="tanh"),
            L.fc(list(tmp[1]), SRL_HIDDEN, num_flatten_dims=2, act="tanh")])
        tmp = [mix, lstm(mix, i % 2 == 1)]
    feature = L.sums([
        L.fc(tmp[0], SRL_LABELS, num_flatten_dims=2, act="tanh"),
        L.fc(list(tmp[1]), SRL_LABELS, num_flatten_dims=2, act="tanh")])
    cost = L.linear_chain_crf(feature, feeds["target"], length=length,
                              param_attr=fluid.ParamAttr(
                                  name="crfw", learning_rate=SRL_MIX_LR))
    decode = L.crf_decoding(feature, param_attr=fluid.ParamAttr(name="crfw"),
                            length=length)
    _, _, f1, n_infer, n_label, n_correct = L.chunk_eval(
        decode, feeds["target"], "IOB", SRL_CHUNK_TYPES, seq_length=length)
    test_program = fluid.default_main_program().clone(for_test=True)
    return {"loss": L.mean(cost), "decode": decode, "f1": f1,
            "n_infer": n_infer, "n_label": n_label, "n_correct": n_correct,
            "feed_vars": [feeds[n] for n in SRL_FIELDS],
            "test_program": test_program}


def _srl_sgd(fluid):
    return fluid.optimizer.SGD(learning_rate=fluid.layers.exponential_decay(
        learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
        staircase=True))


def _srl_feeds(conll05, DataFeeder, model, n):
    """``n`` batches of SRL_B records of conll05.train() through the
    DataFeeder, each field padded to SRL_T (with its length)."""
    reader = conll05.train()()
    feeder = DataFeeder(model["feed_vars"],
                        pad_to={f: SRL_T for f in SRL_FIELDS})
    out = []
    for _ in range(n):
        fd = feeder.feed([next(reader) for _ in range(SRL_B)])
        out.append({k: fd[k] for k in SRL_FIELDS + ["word_data_len"]})
    return out


def srl_16a(torch, np, fluid, fa, tmp):
    """16a: the label-semantic-roles chapter at the book's widths trained
    on the card (``train_family``: captured = eager bit for bit over three
    steps, the step timed in turns, launches, device ms, the derived
    grads' re-runs), its loss falling on a repeated batch under the
    book's SGD; then the decode path of the test program after four
    steps, its chunk F1, and the same path through save_inference_model
    / load_inference_model (captured from its second call) bit for
    bit."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.data_feeder import DataFeeder
    from paddle_tpu_torch.dataset import conll05

    table = conll05.get_embedding()

    def build():
        return srl_db_lstm(fluid, table)

    def make_opt():
        return _srl_sgd(fluid)

    main_prog, startup, model, _ = _family_program(fluid, build, make_opt,
                                                   amp=False)
    feeds = _srl_feeds(conll05, DataFeeder, model, 4)
    row, _ = train_family(torch, np, fluid, fa, "srl_db_lstm", build,
                          make_opt, feeds, amp=False, items=SRL_B,
                          unit="examples", rerun=True)
    assert not any(row["attention_launches_per_step"].values()), row
    assert row["dropout_launches_per_step"] == 0, row
    row["repeated_batch_losses"] = _falling_loss(torch, np, fluid, build,
                                                 feeds[0], False, make_opt)
    fetch = [model[k] for k in ("decode", "n_infer", "n_label",
                                "n_correct")]
    feed_names = [n for n in SRL_FIELDS if n != "target"] + ["word_data_len"]
    d = os.path.join(tmp, "srl")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        assert np.array_equal(scope.find_var("emb").cpu().numpy(), table)
        losses = [float(exe.run(main_prog, feed=f,
                                fetch_list=[model["loss"]])[0])
                  for f in feeds]
        ref = [exe.run(model["test_program"], feed=f, fetch_list=fetch)
               for f in feeds]
        io.save_inference_model(d, feed_names, [model["decode"]], exe,
                                main_prog)
        assert np.array_equal(scope.find_var("emb").cpu().numpy(), table), \
            "the frozen table moved"
    exe.close()
    del scope
    exe2 = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        loaded, names, targets = io.load_inference_model(d, exe2)
        got = [exe2.run(loaded, feed={k: f[k] for k in names},
                        fetch_list=targets)[0] for f in feeds + feeds]
    graphs = _graphs(exe2)
    exe2.close()
    for g, r in zip(got, ref + ref):
        assert np.array_equal(g, r[0]), "the loaded decode path differs"
    n_i, n_l, n_c = (sum(int(r[k][0]) for r in ref) for k in (1, 2, 3))
    p = n_c / n_i if n_i else 0.0
    rc = n_c / n_l if n_l else 0.0
    row.update(
        batch=SRL_B, seq=SRL_T, depth=SRL_DEPTH, hidden=SRL_HIDDEN,
        labels=SRL_LABELS, decode_after_steps=losses,
        chunks={"infer": n_i, "label": n_l, "correct": n_c,
                "f1": 2 * p * rc / (p + rc) if p + rc else 0.0},
        loaded_decode_bit_equal=True, loaded_graphs=graphs,
        export_bytes=_dir_bytes(d))
    torch.cuda.empty_cache()
    return row


def _scan_program(fluid, T, cfg, scan, unroll=1, amp=False, sgd=False):
    """build() or build_scan() minimized by Adam(1e-4), phase 5's
    optimizer, or by SGD(1e-3) (``sgd``: a parity check, where Adam's
    first, sign-like steps would turn 1e-7 differences of a gradient
    into visible ones)."""
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        model = (T.build_scan(cfg, unroll=unroll) if scan
                 else T.build(cfg))
        opt = (fluid.optimizer.SGD(1e-3) if sgd
               else fluid.optimizer.Adam(1e-4))
        opt.minimize(model["loss"])
    if amp:
        fluid.amp.enable_amp(main_prog)
    startup.random_seed = main_prog.random_seed = SEED
    return main_prog, startup, model


def _steps_from(torch, np, fluid, place, main_prog, state, feeds, fetch):
    """Each feed's step (cached runs) from ``state`` on ``place``: the
    fetches, and the state after the first step (numpy). ``state`` is
    copied: on the CPU a scope's tensors would share its arrays, which
    the steps update in place."""
    from paddle_tpu_torch import io as tio

    exe = fluid.Executor(place)
    scope = tio.scope_from_numpy({n: np.array(v) for n, v in state.items()},
                                 place)
    got, after_first = [], None
    with fluid.scope_guard(scope):
        for f in feeds:
            got.append(exe.run(main_prog, feed=f, fetch_list=fetch))
            if after_first is None:  # copies: later replays write in place
                after_first = {n: scope.find_var(n).cpu().numpy().copy()
                               for n in scope.var_names()}
    exe.close()
    del scope
    torch.cuda.empty_cache()
    return got, after_first


def _numpy_state(fluid, place, startup, dtype):
    """A startup program's state, run on ``place``, as numpy, its f32
    arrays cast to ``dtype``."""
    exe, scope = fluid.Executor(place), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    exe.close()
    out = {n: scope.find_var(n).cpu().numpy() for n in scope.var_names()}
    return {n: v.astype(dtype) if v.dtype.name == "float32" else v
            for n, v in out.items()}


def _scan_slices(T, cfg):
    """build()'s per-layer parameter name -> (build_scan's stacked
    parameter, layer); the other parameters keep their names."""
    return {src_fn(i): (f"{prefix}_{key}_stacked", i)
            for prefix, specs in (("enc_stack", T._enc_weight_specs(cfg)),
                                  ("dec_stack", T._dec_weight_specs(cfg)))
            for key, _shape, src_fn in specs for i in range(cfg.n_layer)}


def scan_vs_build(torch, np, fluid, T, place, cfg, batch, dtype="float32"):
    """build() and build_scan() at dropout 0, two SGD steps each from
    build()'s startup state (cast to ``dtype``; build_scan's stacks from
    ``stack_weights_from_layers``), and build()'s second step from
    build_scan's state after its first. Every parameter is compared on
    build()'s names, each stacked one by its layer slices:

    - ``step_1``: the loss (relative) and every gradient (relative to its
      largest element; the attention K biases, whose gradient is zero but
      for rounding because softmax ignores a shift of a query's logits,
      to their weight's) from one state;
    - ``state_after_step_1``: each parameter after the first update,
      relative to the largest element of build()'s update;
    - ``step_2_same_state``: build_scan's free-running second step
      against build()'s from the same state (build_scan's);
    - ``step_2_free_running`` (build_scan's second step against
      build()'s own) and ``build_at_the_two_states`` (build()'s second
      step from its state against from build_scan's): what rounding in
      the first step moves in the second.

    Returns the readings; ``hold_scan_vs_build`` holds them."""
    from paddle_tpu_torch.core import lowering

    dtype = np.dtype(dtype)
    b, t = batch
    feeds = [T.make_batch(cfg, b, t, t, seed=SEED + i) for i in range(2)]
    a_prog, a_start, a_model = _scan_program(fluid, T, cfg, scan=False,
                                             sgd=True)
    b_prog, b_start, b_model = _scan_program(fluid, T, cfg, scan=True,
                                             sgd=True)
    state_a = _numpy_state(fluid, place, a_start, dtype)
    state_b0 = _numpy_state(fluid, place, b_start, dtype)
    slices = _scan_slices(T, cfg)
    params = [p.name for p in a_prog.global_block().all_parameters()
              if p.trainable]
    b_params = list(dict.fromkeys(slices.get(n, (n, None))[0]
                                  for n in params))

    def stacked(state):
        per_layer, scan = fluid.Scope(), fluid.Scope()
        for n, v in state.items():
            per_layer.set(n, v)
        for n, v in state_b0.items():
            scan.set(n, state.get(n, v))
        T.stack_weights_from_layers(cfg, per_layer, scan)
        return {n: scan.find_var(n) for n in scan.var_names()}

    def unstacked(values):
        """build_scan's {name: array} on build()'s parameter names."""
        out = {}
        for n in params:
            sn, i = slices.get(n, (n, None))
            out[n] = values[sn] if i is None else values[sn][i]
        return out

    def scale_of(n):
        return n[:-2] + ".w" if n.endswith("_k_colp.b") else n

    def reading(want, got, scan=True):
        """The loss (relative) and every gradient (relative) of build()'s
        step ``want`` and build_scan's (``scan``) or build()'s ``got``."""
        gw = dict(zip(params, want[1:]))
        gg = (unstacked(dict(zip(b_params, got[1:]))) if scan
              else dict(zip(params, got[1:])))
        grads = {n: float(np.abs(np.asarray(gg[n], np.float64) - gw[n]).max()
                          / max(np.abs(gw[scale_of(n)]).max(), 1e-30))
                 for n in params}
        return {"loss_want": float(want[0]), "loss_got": float(got[0]),
                "loss_rel_err": abs(float(got[0]) - float(want[0]))
                / abs(float(want[0])),
                "grad_rel_err_max": max(grads.values()),
                "worst_grads": dict(sorted(grads.items(),
                                           key=lambda kv: -kv[1])[:4])}

    a_fetch = [a_model["loss"]] + [n + "@GRAD" for n in params]
    b_fetch = [b_model["loss"]] + [n + "@GRAD" for n in b_params]
    got_a, state_a1 = _steps_from(torch, np, fluid, place, a_prog, state_a,
                                  feeds, a_fetch)
    got_b, state_b1 = _steps_from(torch, np, fluid, place, b_prog,
                                  stacked(state_a), feeds, b_fetch)
    b1 = unstacked(state_b1)
    (at_b1,), _ = _steps_from(torch, np, fluid, place, a_prog,
                              {**state_a1, **b1}, feeds[1:], a_fetch)
    upd = {n: np.abs(state_a1[n].astype(np.float64) - state_a[n]).max()
           for n in params}
    state = {n: float(np.abs(b1[n].astype(np.float64) - state_a1[n]).max()
                      / max(upd[scale_of(n)], 1e-30)) for n in params}
    lw = lowering.lower_block(b_prog, 0, sorted(feeds[0]),
                              [b_model["loss"].name],
                              fluid.framework.resolve_device(place))
    return {
        "dtype": dtype.name, "batch": b, "seq": t, "layers": cfg.n_layer,
        "params": len(params), "scan_params": len(b_params),
        "step_1": reading(got_a[0], got_b[0]),
        "state_after_step_1": {
            "rel_err_max": max(state.values()),
            "worst": dict(sorted(state.items(), key=lambda kv: -kv[1])[:4])},
        "step_2_same_state": reading(at_b1, got_b[1]),
        "step_2_free_running": reading(got_a[1], got_b[1]),
        "build_at_the_two_states": reading(got_a[1], at_b1, scan=False),
        "ops_build": len(a_prog.global_block().ops),
        "ops_build_scan": len(b_prog.global_block().ops),
        "uncaptured": lw.uncaptured}


def hold_scan_vs_build(row, loss_rel, grad_rel, state_rel):
    """Hold ``scan_vs_build``'s readings from one state (step 1, the
    state after it, step 2 from one state) at the limits; the two
    free-running second steps are read, not held."""
    for k in ("step_1", "step_2_same_state"):
        assert row[k]["loss_rel_err"] <= loss_rel, (k, row)
        assert row[k]["grad_rel_err_max"] <= grad_rel, (k, row)
    assert row["state_after_step_1"]["rel_err_max"] <= state_rel, row
    assert row["uncaptured"] is None, row
    row["tol"] = {"loss_rel": loss_rel, "grad_rel": grad_rel,
                  "state_rel": state_rel}


def _scan_reruns_replay(torch, np, fluid, prog, startup, feed, loss):
    """One eager step of a build_scan program with the scan op's compute
    wrapped: each scan's FinalState from its forward (grad off) and from
    its grad op's re-run (grad on, the derived scan_grad) compared bit
    for bit: the re-run replays the forward's dropout seeds."""
    from paddle_tpu_torch.core.registry import get_op_def

    opdef = get_op_def("scan")
    plain = opdef.compute
    seen = {False: [], True: []}

    def recording(ins, attrs, device, **kw):
        out = plain(ins, attrs, device, **kw)
        seen[torch.is_grad_enabled()].append(
            out["FinalState"][0].detach().clone())
        return out

    opdef.compute = recording
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            exe.run(prog, feed=feed, fetch_list=[loss],
                    use_program_cache=False)
        exe.close()
    finally:
        opdef.compute = plain
    fwd, rerun = seen[False], seen[True]
    # the backward runs the decoder's scan_grad first
    assert len(fwd) == len(rerun) == 2, (len(fwd), len(rerun))
    for a, b in zip(fwd, reversed(rerun)):
        assert torch.equal(a, b), "a scan_grad re-run drew other masks"
    return {"scans": 2, "rerun_final_state_bit_equal": True,
            "dtype": str(fwd[0].dtype)}


def build_scan_16b(torch, np, fluid, T, fa):
    """16b: transformer.build_scan at phase 5's configuration (bf16 AMP,
    dropout 0.1, label smoothing 0.1, Adam 1e-4, b 64 x t 256): (1) f32
    at dropout 0 against build(); (2) three steps eager, captured by
    ``run`` and in a run_steps window from one startup, bit for bit, and
    each scan's forward recomputed inside its grad op equal to the
    forward's; unroll 6 equal to unroll 1 bit for bit; (3) the captured
    step timed (unroll 1 and 6) with its fwd_wgmma_kernel (#6), pass A +
    B (#7) and dropout_apply_kernel launches a step, counted over one
    window each. Returns (row, the unroll-1 window's launches)."""
    from paddle_tpu_torch import kernels

    f32 = scan_vs_build(torch, np, fluid, T, fluid.CUDAPlace(0),
                        T.TransformerConfig(max_length=TRAIN_T, dropout=0.0),
                        (TRAIN_B, TRAIN_T))
    hold_scan_vs_build(f32, TOL_SCAN_LOSS_REL, TOL_SCAN_GRAD_REL,
                       TOL_SCAN_STATE_REL)
    out = {"f32_vs_build": f32}
    cfg = T.TransformerConfig(max_length=TRAIN_T, dropout=0.1)
    feeds = [T.make_batch(cfg, TRAIN_B, TRAIN_T, TRAIN_T, seed=SEED + i)
             for i in range(4)]
    dev = torch.device("cuda", 0)
    staged = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
              for f in feeds]
    progs = {u: _scan_program(fluid, T, cfg, True, unroll=u, amp=True)
             for u in (1, cfg.n_layer)}
    prog, startup, model = progs[1]
    loss = model["loss"]
    same = _same_runs(torch, np, fluid, prog, startup, staged, [loss], 3)
    _held_same(same)
    ec, ew = same["eager_vs_captured"], same["eager_vs_run_steps"]
    assert ec["fetch"] == ec["state"] == ew["last_fetch"] == ew["state"] \
        == 0.0, same
    out["captured_vs_eager"] = {k: same[k] for k in (
        "steps", "eager_vs_eager", "eager_vs_captured", "eager_vs_run_steps",
        "first_fetch")}
    out["rerun_replays_seeds"] = _scan_reruns_replay(
        torch, np, fluid, prog, startup, staged[0], loss)
    timed, launches = {}, None
    for u, (p, st, m) in progs.items():
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(st)
            first = [float(exe.run(p, feed=staged[i],
                                   fetch_list=[m["loss"]],
                                   use_program_cache=False)[0])
                     for i in range(2)]
            exe.run_steps(p, staged, 2, [m["loss"]])  # the capture
            windows = []
            for _ in range(2):
                torch.cuda.synchronize()
                kernels.reset_counts()
                t0 = time.perf_counter()
                (value,) = exe.run_steps(p, staged, 4, [m["loss"]])
                torch.cuda.synchronize()
                windows.append((time.perf_counter() - t0) / 4 * 1e3)
                counts = _counts(fa)
                counts["dropout"] = kernels.launch_counts["dropout"]
            assert np.isfinite(float(value)), value
            traced = {}
            times = _device_times(lambda: exe.run_steps(
                p, staged[:1], 1, [m["loss"]]), iters=2, counts=traced,
                replay=True)
        exe.close()
        del scope
        torch.cuda.empty_cache()
        per_step = {k: v / 4 for k, v in counts.items() if v}
        device_ms = sum(times.values())
        timed[u] = {"eager_first_losses": first, "step_ms": windows,
                    "step_device_ms": device_ms,
                    "idle_share": 1 - device_ms / min(windows),
                    "launches_per_step": per_step,
                    "by_family": _families(times, traced),
                    "op_types": dict(collections.Counter(
                        op.type for op in p.global_block().ops)),
                    "top_kernels_ms": [[k[:80], ms] for k, ms in sorted(
                        times.items(), key=lambda kv: -kv[1])[:12]]}
        if u == 1:
            launches = counts
    assert timed[1]["eager_first_losses"] == \
        timed[cfg.n_layer]["eager_first_losses"], timed
    # 6 encoder and 6 decoder layers: 18 attentions a step, each forward
    # launched once more in its scan_grad's re-run; 18 backward launches;
    # each dropout op of a layer body twice a layer (its forward, its
    # re-run), the others once
    blk = prog.global_block()
    body = sum(op.type == "dropout" for o in blk.ops if o.type == "scan"
               for op in o.attrs["sub_block"].ops)
    drops = sum(o.type == "dropout" for o in blk.ops) + 2 * cfg.n_layer * body
    per = timed[1]["launches_per_step"]
    assert per.get("small/fwd") == 36 and per.get("small/bwd") == 18, per
    assert per.get("dropout") == drops, (per, drops)
    assert not any(k for k in per if not k.startswith(("small/",
                                                       "dropout"))), per
    out.update(unroll=timed, batch=TRAIN_B, seq=TRAIN_T, amp=True,
               dropout=cfg.dropout)
    return out, launches


def _drill_models(fluid):
    """16c's programs: (name, build, make_opt, feeds, gradient names,
    exact fetches), each small, held card against CPU."""
    import numpy as np

    L = fluid.layers
    r = np.random.RandomState(SEED)
    b = DRILL_B

    def cond_log():
        p = L.create_parameter([3], "float32", name="cond_p",
                               default_initializer=fluid.initializer
                               .ConstantInitializer(0.0))
        flag = L.data("flag", shape=[1], dtype="bool",
                      append_batch_size=False)
        out = L.cond(flag, lambda: L.log(p), lambda: L.scale(p, 2.0))
        return {"loss": L.reduce_sum(out)}

    def bounded(lim):
        def build():
            x = L.data("x", shape=[4], dtype="float32")
            acc = L.fc(x, 4, bias_attr=False,
                       param_attr=fluid.ParamAttr(name="bw_w"))
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", lim)
            cond = L.less_than(i, n)
            w = L.While(cond, max_trip_count=5)
            with w.block():
                L.assign(L.tanh(L.fc(acc, 4, bias_attr=False,
                                     param_attr=fluid.ParamAttr(
                                         name="bw_w2"))), output=acc)
                L.increment(i)
                L.less_than(i, n, cond=cond)
            return {"loss": L.mean(acc), "steps": w._steps_var,
                    "cond": cond}
        return build

    lr_holder = {}

    def switch_warmup():
        step = L.data("step", shape=[1], dtype="float32",
                      append_batch_size=False)
        x = L.data("x", shape=[4], dtype="float32")
        lr = L.fill_constant([1], "float32", 0.0)
        with L.Switch() as sw:
            with sw.case(L.less_than(step, L.fill_constant(
                    [1], "float32", 10.0))):
                L.assign(L.scale(step, 0.01), output=lr)
            with sw.default():
                L.assign(L.fill_constant([1], "float32", 0.1), output=lr)
        lr_holder["lr"] = lr
        return {"loss": L.mean(L.fc(x, 3, param_attr=fluid.ParamAttr(
            name="sw_w"))), "lr": lr}

    def rnns():
        x = L.data("seq", shape=[5, 3], dtype="float32")
        length = L.data("length", shape=[1], dtype="int64")
        drnn = L.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x, length=length)
            acc = drnn.memory(shape=[3])
            h = L.fc([xt, acc], 3, act="tanh",
                     param_attr=[fluid.ParamAttr(name="dr_x"),
                                 fluid.ParamAttr(name="dr_h")])
            drnn.update_memory(acc, h)
            drnn.output(h)
        dyn = drnn()
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(dyn)
            prev = rnn.memory(shape=[3], batch_ref=dyn, ref_batch_dim_idx=0)
            h = L.tanh(L.fc([xt, prev], 3, param_attr=[
                fluid.ParamAttr(name="sr_x"), fluid.ParamAttr(name="sr_h")]))
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        st = L.reduce_mean(rnn(), dim=1)
        ie = L.IfElse(L.less_than(L.reduce_sum(st, dim=1, keep_dim=True),
                                  L.fill_constant([1], "float32", 0.0)))
        with ie.true_block():
            ie.output(L.fc(ie.input(st), 2, param_attr=fluid.ParamAttr(
                name="ie_t")))
        with ie.false_block():
            ie.output(L.scale(L.fc(ie.input(st), 2, param_attr=fluid
                                   .ParamAttr(name="ie_f")), -1.0))
        return {"loss": L.mean(L.square(ie())), "dyn": dyn}

    def ctc():
        x = L.data("ctc_x", shape=[8, 6], dtype="float32")
        tags = L.data("ctc_tags", shape=[8], dtype="int64")
        lab = L.data("ctc_lab", shape=[3], dtype="int64")
        xl = L.data("ctc_xl", shape=[1], dtype="int64")
        ll = L.data("ctc_ll", shape=[1], dtype="int64")
        logits = L.fc(x, 5, num_flatten_dims=2, param_attr=fluid.ParamAttr(
            name="ctc_w"))
        loss = L.mean(L.warpctc(logits, lab, blank=0, input_length=xl,
                                label_length=ll))
        dec, dlen = L.ctc_greedy_decoder(L.softmax(logits), blank=0,
                                         input_length=xl)
        dist, _ = L.edit_distance(dec, lab, normalized=False,
                                  input_length=dlen, label_length=ll)
        _, _, f1, _, _, nc = L.chunk_eval(L.argmax(logits, axis=-1), tags,
                                          "IOB", 2, seq_length=xl)
        return {"loss": loss, "decoded": dec, "dist": dist, "nc": nc,
                "hash": L.hash(lab, hash_size=1000, num_hash=3)}

    seq = r.normal(0, 1, (b, 5, 3)).astype(np.float32)
    lens = np.array([[5], [2], [0], [4]], np.int64)
    ctc_feed = {"ctc_x": r.normal(0, 1, (b, 8, 6)).astype(np.float32),
                "ctc_lab": r.randint(1, 5, (b, 3)).astype(np.int64),
                "ctc_tags": r.randint(0, 5, (b, 8)).astype(np.int64),
                "ctc_xl": np.array([[8], [5], [6], [3]], np.int64),
                "ctc_ll": np.array([[3], [2], [0], [1]], np.int64)}
    xs = [{"x": r.normal(0, 1, (b, 4)).astype(np.float32)}
          for _ in range(2)]
    sgd = lambda: fluid.optimizer.SGD(0.1)  # noqa: E731
    return [
        ("cond non-finite untaken branch", cond_log, sgd,
         [{"flag": np.array([False])}] * 2, ["cond_p@GRAD"], ()),
        ("bounded_while 3 of 5", bounded(3), sgd, xs,
         ["bw_w@GRAD", "bw_w2@GRAD"], (("steps", "steps"),
                                       ("cond", "cond"))),
        ("bounded_while truncated at 5", bounded(7), sgd, xs,
         ["bw_w@GRAD", "bw_w2@GRAD"], (("steps", "steps"),
                                       ("cond", "cond"))),
        ("Switch LR warmup", switch_warmup,
         lambda: fluid.optimizer.SGD(lr_holder["lr"]),
         [dict(xs[0], step=np.array([3.0], np.float32)),
          dict(xs[1], step=np.array([30.0], np.float32))], ["sw_w@GRAD"],
         ()),
        ("DynamicRNN, StaticRNN, IfElse", rnns, sgd,
         [{"seq": seq, "length": lens}] * 2,
         ["dr_x@GRAD", "dr_h@GRAD", "sr_x@GRAD", "ie_t@GRAD", "ie_f@GRAD"],
         ()),
        ("warpctc, greedy decode, edit_distance, chunk_eval, hash", ctc,
         sgd, [ctc_feed] * 2, ["ctc_w@GRAD"],
         (("decoded", "decoded"), ("edit distance", "dist"),
          ("chunk_eval", "nc"), ("hash", "hash"))),
    ]


def _host_callback_drill(torch, np, fluid):
    """16c: print and py_func in a training step on the card: the step
    reports itself uncaptured (its reason counted at every call), print
    writes every step and the py_func's forward and backward run every
    step; its losses equal the CPU's."""
    import contextlib
    import io as _io

    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.core import lowering

    calls = collections.Counter()

    def tanh(a):
        calls["fwd"] += 1
        return np.tanh(a)

    def tanh_grad(y, dy):
        calls["bwd"] += 1
        return dy * (1.0 - y * y)

    L = fluid.layers

    def build():
        x = L.data("x", shape=[4], dtype="float32", append_batch_size=False)
        h = L.fc(L.reshape(x, [1, 4]), 4, param_attr=fluid.ParamAttr(
            name="hc_w"))
        y = fluid.default_main_program().global_block().create_var(
            name="hc_y", shape=(1, 4), dtype="float32")
        L.py_func(tanh, h, y, backward_func=tanh_grad,
                  skip_vars_in_backward_input=h)
        y = L.Print(y, message="hc-drill", summarize=4, print_phase="both")
        return {"loss": L.mean(y)}

    feed = {"x": np.linspace(-1, 1, 4).astype(np.float32)}
    main_prog, startup, model, _ = _family_program(
        fluid, build, lambda: fluid.optimizer.SGD(0.5), amp=False)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    exe.close()
    state = {n: scope.find_var(n).cpu().numpy() for n in scope.var_names()}
    runs = {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        lowering.uncaptured_steps.clear()
        calls.clear()
        err = _io.StringIO()
        exe = fluid.Executor(place)
        with fluid.scope_guard(tio.scope_from_numpy(state, place)), \
                contextlib.redirect_stderr(err):
            losses = [float(exe.run(main_prog, feed=feed,
                                    fetch_list=[model["loss"]])[0])
                      for _ in range(3)]
        exe.close()
        runs[place.__class__.__name__] = {
            "losses": losses, "uncaptured": dict(lowering.uncaptured_steps),
            "printed": err.getvalue().count("hc-drill"),
            "py_func_calls": dict(calls)}
    card = runs["CUDAPlace"]
    assert card["uncaptured"] == {"host_callback op 'py_func'": 3}, card
    assert card["printed"] == 6 and card["py_func_calls"] == {
        "fwd": 3, "bwd": 3}, card
    cpu = runs["CPUPlace"]["losses"]
    assert max(abs(a - c) / abs(c) for a, c in zip(card["losses"], cpu)) \
        <= TOL_FAMILY_LOSS_REL, runs
    return runs


def drills_16c(torch, np, fluid):
    """16c: the drills at small sizes, the card against the CPU: cond with
    a non-finite untaken branch (a finite gradient), bounded_while under
    and at its bound, Switch as an LR warmup, DynamicRNN frozen past each
    length with StaticRNN and IfElse, warpctc with the greedy decoder,
    edit_distance, chunk_eval and hash (exactly), print / py_func in a
    training step; and linear_chain_crf / crf_decoding / warpctc in f64
    with their gradients (``op_and_grads``)."""
    out = {}
    for name, build, make_opt, feeds, names, exact in _drill_models(fluid):
        out[name] = family_vs_cpu(torch, np, fluid, name, build, make_opt,
                                  feeds, names, exact=exact)
    out["print and py_func"] = _host_callback_drill(torch, np, fluid)
    r = np.random.RandomState(SEED + 16)
    em, trans = r.normal(0, 1, (4, 12, 6)), r.normal(0, 0.5, (8, 6))
    lens = np.array([12, 7, 1, 9], np.int64)
    cases = [
        ("linear_chain_crf", {"Emission": [em], "Transition": [trans],
                              "Label": [r.randint(0, 6, (4, 12))],
                              "Length": [lens]}, {}),
        ("crf_decoding", {"Emission": [em], "Transition": [trans],
                          "Length": [lens]}, {}),
        ("warpctc", {"Logits": [r.normal(0, 1, (4, 12, 6))],
                     "Label": [r.randint(1, 6, (4, 4))],
                     "LogitsLength": [lens],
                     "LabelLength": [np.array([4, 3, 0, 2], np.int64)]},
         {"norm_by_times": True}),
    ]
    ops = {}
    for op, ins, attrs in cases:
        gpu, cpu = (op_and_grads(torch, np, op, ins, attrs, dev, SEED + 2)
                    for dev in (torch.device("cuda", 0),
                                torch.device("cpu")))
        assert sorted(gpu) == sorted(cpu), (op, sorted(gpu), sorted(cpu))
        errs = {}
        for k in cpu:
            if np.issubdtype(cpu[k].dtype, np.floating):
                errs[k] = _rel_err(np, gpu[k], cpu[k])
            else:
                assert np.array_equal(gpu[k], cpu[k]), (op, k)
                errs[k] = 0.0
        assert max(errs.values()) <= TOL_RNN_F64_REL, (op, errs)
        ops[op] = {"max_rel_err": max(errs.values()), "values": len(errs)}
    out["f64 ops"] = {"dtype": "float64", "tol_rel": TOL_RNN_F64_REL,
                      "ops": ops}
    return out


def control_flow(torch, np, fluid, T, fa, tmp):
    """Phase 16: the label-semantic-roles chapter (16a), transformer.
    build_scan (16b) and the control-flow / CRF drills (16c). Returns
    ({sub-phase: row}, the launches of 16b's timed unroll-1 window); a
    line names each sub-phase before it runs, and its ``control_`` line
    follows."""
    out = {"t0": time.perf_counter()}

    def done(key, row):
        row["at_s"] = time.perf_counter() - out["t0"]
        out[key] = row
        print(f"control_{key} " + json.dumps(row), flush=True)

    print(f"phase 16a: label semantic roles (db_lstm: hidden "
          f"{SRL_HIDDEN}, depth {SRL_DEPTH}, {SRL_LABELS} labels, batch "
          f"{SRL_B}, T {SRL_T}, SGD)", flush=True)
    done("16a", srl_16a(torch, np, fluid, fa, tmp))
    print("phase 16b: transformer.build_scan at Transformer-base, b 64 x "
          "t 256", flush=True)
    row, launches = build_scan_16b(torch, np, fluid, T, fa)
    done("16b", row)
    print("phase 16c: control-flow and CRF drills, the card against the "
          "CPU", flush=True)
    done("16c", drills_16c(torch, np, fluid))
    out["seconds"] = time.perf_counter() - out.pop("t0")
    return out, launches


# --- phase 17: the op-library slice ----------------------------------------

# 17a: the slice's op types, card against CPU in f64 (one normal cotangent
# an output): outputs and derived gradients relative to their largest
# element; f32 outputs (the metrics' histograms, the random ops' values)
# at f32's rounding; integers, bools and the random ops' draws exactly
TOL_SLICE_F64_REL = 1e-10
TOL_SLICE_F32_REL = 1e-5
# 17b: the word2vec chapter's N-gram model (tests/test_book.py:117) at the
# Penn Treebank vocabulary of Mikolov et al.'s language models: 4 context
# words, a shared 256-wide embedding, fc 1024 relu, batch 1024; four heads
NGRAM_VOCAB, NGRAM_CTX, NGRAM_EMB, NGRAM_HIDDEN = 10000, 4, 256, 1024
NGRAM_B, NGRAM_STEPS, NGRAM_LR = 1024, 50, 1e-3
NGRAM_NEG, NGRAM_SAMPLES = 10, 1024
NGRAM_HEADS = ("cross_entropy", "hsigmoid", "nce", "sampled_softmax")
# the bigram corpus: each word's successor is its fixed permutation image
# with probability NGRAM_FOLLOW, else uniform (tests/test_book.py:121-128)
NGRAM_FOLLOW = 0.8
# 17c: the DCGAN generator of Radford et al. 2016, Fig. 1: z 100 -> 4 x 4 x
# 1024 -> conv2d_transpose 512, 256, 128, 3 (4 x 4, stride 2, padding 1),
# batch_norm + relu between, tanh out: 64 x 64 x 3; batch 128, Adam(2e-4,
# beta1 0.5), mean square error against seeded targets
DCGAN_Z, DCGAN_BASE, DCGAN_WIDTHS = 100, 1024, (512, 256, 128, 3)
DCGAN_B, DCGAN_STEPS, DCGAN_LR, DCGAN_BETA1 = 128, 20, 2e-4, 0.5
# the CPU's part of 17c: the same widths at batch 8, one step from the
# card's startup state against the CPU's f64 step. The card's f64 step:
# the loss (absolute) and every gradient relative to its largest element
# (read on an H100: 5.6e-15). The card's f32 step as phase 6 holds the
# CPU's (``hold_vs_f64``, TOL_GATE_REL): the loss (read 1.2e-8), every
# relu gate's pre-activation (read 6.9e-7) and the gradients no flipped
# gate reaches (read 3.0e-7, the output layer's). One gate flips there:
# a pre-activation of the last relu is +8.6e-7 in f64 and -3.0e-7 in
# f32, so every gradient upstream of it moves (up to 1.1e-2 of its
# largest element; with cuDNN off no gate flips and every gradient reads
# <= 9.0e-7: paddle_tpu_torch/benchmarks/conv_transpose_precision.py).
# No op is at fault: each algorithm cuDNN picks is IEEE f32, which
# ``conv_transpose_ops_f32`` holds at TOL_SLICE_F32_REL (read <= 3.0e-6;
# TF32's 10-bit inputs would round at 4.9e-4). The bf16 AMP step the
# same way at bf16's rounding (8 significant bits): TOL_DCGAN_BF16 =
# (loss absolute: read 4.3e-5 of a loss of 0.55; gate: read 1.1e-2;
# gradient: read 7.0e-3, the output layer's)
DCGAN_CPU_B = 8
TOL_DCGAN_F64 = (1e-11, 1e-10)
TOL_DCGAN_BF16 = (1e-3, 3e-2, 3e-2)


def ngram_head_model(fluid, head, vocab=NGRAM_VOCAB, ctx=NGRAM_CTX,
                     emb=NGRAM_EMB, hidden=NGRAM_HIDDEN, neg=NGRAM_NEG,
                     samples=NGRAM_SAMPLES):
    """17b's next-word model with one of NGRAM_HEADS: the context words'
    shared embeddings concatenated, fc ``hidden`` relu, then (i) fc to
    the vocabulary, softmax and the older ``cross_entropy``; (ii)
    ``hsigmoid``; (iii) ``nce`` with ``neg`` negatives; (iv)
    ``sampled_softmax_with_cross_entropy`` of ``samples`` over the fc
    logits. Returns {"loss": mean cost}."""
    layers = fluid.layers
    words = layers.data("ctx", shape=[ctx], dtype="int64")
    nxt = layers.data("next", shape=[1], dtype="int64")
    embs = layers.embedding(words, size=[vocab, emb],
                            param_attr=fluid.ParamAttr(name="shared_emb.w"))
    h = layers.fc(layers.reshape(embs, [0, ctx * emb]), hidden, act="relu")
    if head == "cross_entropy":
        cost = layers.cross_entropy(layers.fc(h, vocab, act="softmax"), nxt)
    elif head == "hsigmoid":
        cost = layers.hsigmoid(h, nxt, vocab)
    elif head == "nce":
        cost = layers.nce(h, nxt, vocab, num_neg_samples=neg)
    else:
        cost = layers.sampled_softmax_with_cross_entropy(
            layers.fc(h, vocab), nxt, samples)
    return {"loss": layers.mean(cost)}


def ngram_feeds(np, vocab, ctx, batch, steps, seed):
    """``steps`` batches of (``ctx`` words, the next word) windows from a
    seeded bigram corpus, consecutive windows, one batch after another."""
    r = np.random.RandomState(seed)
    succ = r.permutation(vocab)
    n = batch * steps + ctx
    follow = r.rand(n) < NGRAM_FOLLOW
    other = r.randint(vocab, size=n)
    corpus = np.empty(n, np.int64)
    corpus[0] = 0
    for i in range(1, n):
        corpus[i] = succ[corpus[i - 1]] if follow[i] else other[i]
    idx = np.arange(batch * steps)[:, None] + np.arange(ctx + 1)[None, :]
    win = corpus[idx]
    return [{"ctx": win[s * batch:(s + 1) * batch, :ctx],
             "next": win[s * batch:(s + 1) * batch, ctx:]}
            for s in range(steps)]


def dcgan_generator(fluid, base=DCGAN_BASE, widths=DCGAN_WIDTHS, z=DCGAN_Z):
    """17c's generator: z -> fc to 4 x 4 x ``base`` -> batch_norm + relu ->
    a conv2d_transpose (4 x 4, stride 2, padding 1) a width, batch_norm +
    relu between them, tanh after the last; the loss is the mean square
    error against the ``target`` images. Returns {"loss", "image"}."""
    layers = fluid.layers
    noise = layers.data("z", shape=[z], dtype="float32")
    side = 4 * 2 ** len(widths)
    target = layers.data("target", shape=[widths[-1], side, side],
                         dtype="float32")
    x = layers.reshape(layers.fc(noise, 4 * 4 * base), [0, base, 4, 4])
    x = layers.batch_norm(x, act="relu")
    for i, width in enumerate(widths):
        last = i == len(widths) - 1
        x = layers.conv2d_transpose(x, width, filter_size=4, stride=2,
                                    padding=1, bias_attr=False if not last
                                    else None, act="tanh" if last else None)
        if not last:
            x = layers.batch_norm(x, act="relu")
    return {"loss": layers.mean(layers.square_error_cost(x, target)),
            "image": x}


def dcgan_feeds(np, batch, steps, seed, z=DCGAN_Z, side=64, channels=3):
    r = np.random.RandomState(seed)
    return [{"z": r.uniform(-1, 1, (batch, z)).astype(np.float32),
             "target": np.tanh(r.normal(0, 1, (batch, channels, side, side)))
             .astype(np.float32)} for _ in range(steps)]


def slice_op_cases(np):
    """(name, op type, inputs, attrs) of every op type of the slice at
    small shapes, float inputs f64; the random ops' value dtype f32. Kinks
    of max / abs are kept off the inputs."""
    r = np.random.RandomState(SEED + 17)

    def f(*shape, scale=1.0):
        return r.normal(0, scale, shape)

    def off0(*shape):
        x = f(*shape)
        return np.where(np.abs(x) < 0.1, 0.3, x)

    def probs(*shape):
        p = r.uniform(0.05, 1.0, shape)
        return p / p.sum(-1, keepdims=True)

    def ints(hi, *shape):
        return r.randint(0, hi, shape).astype(np.int64)

    def bits(*shape):
        return r.rand(*shape) < 0.5

    y01 = ints(2, 6, 1).astype(np.float64)
    ypm = np.where(y01 > 0, 1.0, -1.0)
    x1 = f(6, 1)
    labels = np.stack([r.choice(40, 2, replace=False) for _ in range(6)])
    grid = r.uniform(-1.2, 1.2, (2, 3, 2, 2))
    return [
        # math_ops
        ("p_norm", {"X": [off0(3, 5)]}, {"porder": 3.0, "axis": 1}),
        ("log_loss", {"Predicted": [r.uniform(0.05, 0.95, (6, 1))],
                      "Labels": [y01]}, {}),
        ("rank_loss", {"Label": [y01], "Left": [f(6, 1)],
                       "Right": [f(6, 1)]}, {}),
        ("margin_rank_loss", {"Label": [ypm], "X1": [x1], "X2": [
            x1 - ypm * np.array([[.5], [-.7], [1.2], [-.3], [.9], [-1.5]])]},
         {"margin": 0.1}),
        ("hinge_loss", {"Logits": [np.array([[.2], [-1.7], [2.5], [.6],
                                             [-.4], [1.3]])],
                        "Labels": [y01]}, {}),
        ("kldiv_loss", {"X": [np.log(probs(3, 5))],
                        "Target": [probs(3, 5)]}, {"reduction": "batchmean"}),
        ("bpr_loss", {"X": [f(4, 6)], "Label": [ints(6, 4, 1)]}, {}),
        ("cos_sim", {"X": [f(4, 5)], "Y": [f(4, 5)]}, {}),
        ("sign", {"X": [f(3, 4)]}, {}),
        ("minus", {"X": [f(3, 4)], "Y": [f(3, 4)]}, {}),
        ("l1_norm", {"X": [off0(3, 4)]}, {}),
        ("squared_l2_distance", {"X": [f(4, 3, 2)], "Y": [f(4, 3, 2)]}, {}),
        ("modified_huber_loss", {"X": [np.array([[-2.], [-.5], [.3], [1.6],
                                                 [.8], [-1.3]])],
                                 "Y": [y01]}, {}),
        ("teacher_student_sigmoid_loss", {
            "X": [np.array([[-20.], [-.5], [.3], [1.6], [18.], [-1.3]])],
            "Label": [np.array([[0.], [-1.], [.4], [1.], [.7], [0.]])]}, {}),
        ("cvm", {"X": [np.abs(f(4, 6)) * 3], "CVM": [f(4, 2)]}, {}),
        ("data_norm", {"X": [f(5, 3)], "BatchSize": [np.full(3, 1e4)],
                       "BatchSum": [f(3, scale=100.0)],
                       "BatchSquareSum": [np.abs(f(3, scale=1e4)) + 1e3]},
         {}),
        ("spectral_norm", {"Weight": [f(4, 3, 2)], "U": [f(4)],
                           "V": [f(6)]}, {"dim": 0, "power_iters": 2}),
        ("fsp", {"X": [f(2, 3, 4, 5)], "Y": [f(2, 4, 4, 5)]}, {}),
        ("is_empty", {"X": [f(2, 3)]}, {}),
        ("fill", {}, {"value": [1.5, -2.0, 3.25, 0.0, 7.0, 8.5],
                      "shape": [2, 3], "dtype": "float64"}),
        ("uniform_random_batch_size_like", {"Input": [f(7, 5)]},
         {"shape": [-1, 300], "min": -2.0, "max": 3.0}),
        ("gaussian_random_batch_size_like", {"Input": [f(7, 5)]},
         {"shape": [-1, 300], "mean": 1.5, "std": 0.5}),
        ("cross_entropy2", {"X": [probs(5, 4)], "Label": [ints(4, 5, 1)]},
         {"ignore_index": 0}),
        ("fill_zeros_like2", {"X": [f(3, 2)]}, {}),
        ("reduce_all", {"X": [bits(3, 4)]}, {"dim": [1]}),
        ("reduce_any", {"X": [bits(3, 4)]}, {}),
        ("has_inf", {"X": [np.array([1.0, np.inf])]}, {}),
        ("has_nan", {"X": [np.array([1.0, np.nan])]}, {}),
        ("elementwise_mod", {"X": [f(3, 4, scale=5.0)],
                             "Y": [np.array([2.5, -3.0, 1.5, -0.75])]}, {}),
        ("not_equal", {"X": [ints(3, 3, 4)], "Y": [ints(3, 3, 4)]}, {}),
        ("less_equal", {"X": [f(3, 4)], "Y": [f(4)]}, {}),
        ("logical_or", {"X": [bits(3, 4)], "Y": [bits(3, 4)]}, {}),
        ("logical_xor", {"X": [bits(3, 4)], "Y": [bits(3, 4)]}, {}),
        # tensor_ops
        ("truncated_gaussian_random", {}, {"shape": [300, 200], "mean": 0.5,
                                           "std": 2.0}),
        ("shape", {"X": [f(2, 3, 4)]}, {}),
        ("stack", {"X": [f(2, 3), f(2, 3), f(2, 3)]}, {"axis": 1}),
        ("unstack", {"X": [f(3, 4, 2)]}, {"axis": 1}),
        ("expand_as", {"X": [f(3, 1)], "Y": [f(3, 4)]}, {}),
        ("gather", {"X": [f(5, 3)], "Index": [np.array([[0, 4], [4, 1]])]},
         {}),
        ("arg_min", {"X": [f(3, 5)]}, {"axis": 1}),
        ("cumsum", {"X": [f(2, 3, 4)]}, {"axis": -1, "reverse": True,
                                          "exclusive": True}),
        ("pad", {"X": [f(2, 3)]}, {"paddings": [1, 0, 2, 3],
                                   "pad_value": 0.5}),
        ("tile", {"X": [f(2, 3)]}, {"repeat_times": [2, 1]}),
        ("reverse", {"X": [f(3, 4, 2)]}, {"axis": [0, 2]}),
        ("argsort", {"X": [np.array([[1.0, -0.0, 2.0, 0.0, 1.0, -1.0]])]},
         {"descending": True}),
        ("diag", {"Diagonal": [f(4)]}, {}),
        ("linspace", {"Start": [np.array([0.5])], "Stop": [np.array([3.0])]},
         {"num": 7, "dtype": "float64"}),
        ("gather_nd", {"X": [f(3, 4, 2)],
                       "Index": [np.array([[0, 1], [2, 3], [0, 1]])]}, {}),
        ("scatter_nd_add", {"X": [f(3, 4)],
                            "Index": [np.array([[2], [0], [2]])],
                            "Updates": [f(3, 4)]}, {}),
        ("pad2d", {"X": [f(2, 3, 4, 5)]}, {"paddings": [1, 2, 2, 1],
                                           "mode": "reflect"}),
        ("pad_constant_like", {"X": [f(4, 5)], "Y": [f(2, 3)]},
         {"pad_value": 1.5}),
        ("crop", {"X": [f(3, 5, 4)]}, {"offsets": [1, 2, 0],
                                       "shape": [2, 2, 3]}),
        ("shuffle_channel", {"X": [f(2, 6, 2, 3)]}, {"group": 3}),
        ("pixel_shuffle", {"X": [f(2, 8, 3, 2)]}, {"upscale_factor": 2}),
        ("space_to_depth", {"X": [f(2, 3, 4, 6)]}, {"blocksize": 2}),
        ("multiplex", {"X": [f(4, 3), f(4, 3), f(4, 3)],
                       "Ids": [np.array([[2], [0], [1], [2]])]}, {}),
        ("sampling_id", {"X": [probs(64, 9)]}, {}),
        ("shard_index", {"X": [np.array([[1], [7], [15], [8]])]},
         {"index_num": 16, "nshards": 2, "shard_id": 1,
          "ignore_value": -1}),
        ("flatten", {"X": [f(2, 3, 4)]}, {"axis": 2}),
        ("anchor_generator", {"Input": [f(1, 8, 3, 5)]},
         {"anchor_sizes": [32.0, 64.0], "stride": [16.0, 8.0]}),
        ("reshape", {"X": [f(2, 3, 4)]}, {"shape": [0, -1, 2]}),
        ("transpose", {"X": [f(2, 3, 4)]}, {"axis": [2, 0, 1]}),
        ("squeeze", {"X": [f(2, 1, 3, 1)]}, {"axes": [1]}),
        ("unsqueeze", {"X": [f(2, 3)]}, {"axes": [0, 2]}),
        # nn_ops
        ("conv2d_transpose", {"Input": [f(2, 4, 4, 3)],
                              "Filter": [f(4, 3, 3, 2)]},
         {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1],
          "groups": 2}),
        ("cross_entropy", {"X": [probs(5, 4)], "Label": [ints(4, 5, 1)]},
         {}),
        ("huber_loss", {"X": [f(6, 1)], "Y": [f(6, 1)]}, {"delta": 0.8}),
        ("smooth_l1_loss", {"X": [f(4, 3)], "Y": [f(4, 3)],
                            "InsideWeight": [np.abs(f(4, 3)) + 0.5],
                            "OutsideWeight": [np.abs(f(4, 3))]}, {}),
        ("mean_iou", {"Predictions": [ints(5, 4, 6)],
                      "Labels": [ints(5, 4, 6)]}, {"num_classes": 6}),
        ("maxout", {"X": [f(2, 6, 3, 2)]}, {"groups": 3}),
        ("prelu", {"X": [off0(2, 3, 2, 2)], "Alpha": [f(3)]},
         {"mode": "channel"}),
        ("group_norm", {"X": [f(2, 6, 3, 4)], "Scale": [f(6)],
                        "Bias": [f(6)]}, {"groups": 3}),
        ("sync_batch_norm", {"X": [f(4, 3, 2, 2)], "Scale": [f(3)],
                             "Bias": [f(3)], "Mean": [f(3)],
                             "Variance": [np.abs(f(3)) + 0.5]}, {}),
        ("norm", {"X": [f(2, 3, 4)]}, {"axis": 1}),
        ("affine_channel", {"X": [f(2, 3, 2, 2)], "Scale": [f(3)],
                            "Bias": [f(3)]}, {}),
        ("bilinear_interp", {"X": [f(2, 3, 4, 5)]},
         {"out_h": 3, "out_w": 9, "align_corners": False, "align_mode": 0}),
        ("nearest_interp", {"X": [f(2, 3, 4, 5)]}, {"out_h": 7,
                                                     "out_w": 9}),
        ("row_conv", {"X": [f(2, 5, 3)], "Filter": [f(3, 3)]}, {}),
        ("temporal_shift", {"X": [f(6, 8, 2, 2)]}, {"seg_num": 3}),
        ("grid_sampler", {"X": [f(2, 3, 4, 5)], "Grid": [grid]}, {}),
        ("auc", {"Predict": [probs(64, 2)], "Label": [ints(2, 64, 1)]}, {}),
        ("bilinear_tensor_product", {"X": [f(3, 4)], "Y": [f(3, 5)],
                                     "Weight": [f(2, 4, 5)],
                                     "Bias": [f(1, 2)]}, {}),
        ("nce", {"Input": [f(6, 5)], "Label": [ints(40, 6, 1)],
                 "Weight": [f(40, 5, scale=0.5)], "Bias": [f(40)]},
         {"num_neg_samples": 7}),
        ("hierarchical_sigmoid", {"X": [f(6, 5)], "W": [f(36, 5)],
                                  "Bias": [f(36)],
                                  "Label": [np.array([0, 36, 17, 31, 32, 3])]},
         {"num_classes": 37}),
        ("sample_logits", {"Logits": [f(6, 40)], "Labels": [labels]},
         {"num_samples": 24}),
        ("fc", {"Input": [f(2, 3, 4, 2)], "W": [f(8, 5)], "Bias": [f(5)]},
         {"in_num_col_dims": 2}),
        # optimizer_ops
        ("proximal_gd", {"Param": [f(3, 4)], "Grad": [f(3, 4)],
                         "LearningRate": [np.array([0.1])]},
         {"l1": 0.2, "l2": 0.05}),
        ("proximal_adagrad", {"Param": [f(3, 4)], "Grad": [f(3, 4)],
                              "Moment": [np.abs(f(3, 4))],
                              "LearningRate": [np.array([0.1])]},
         {"l1": 0.1, "l2": 0.2}),
    ]


def slice_op_run(torch, np, op_type, ins, attrs, dev, seed):
    """One op of 17a on ``dev``: ``op_and_grads`` (outputs and derived
    gradients, one normal cotangent an output from ``seed``), or its
    outputs alone for an op without a gradient; a random op receives the
    op seed ``seed`` (``needs_rng``) or a generator seeded with it
    (``host_rng``)."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.core.registry import get_op_def

    opdef = get_op_def(op_type)
    kw = {}
    if opdef.needs_rng:
        kw["seed"] = rng.SeedHandle(torch.full((), seed, dtype=torch.int64,
                                               device=dev), 0)
    if opdef.host_rng:
        kw["generator"] = torch.Generator(device=dev).manual_seed(seed)
    if not opdef.no_grad:
        return op_and_grads(torch, np, op_type, ins, attrs, dev, seed,
                            op_seed=kw.get("seed"))
    t_ins = {k: [torch.from_numpy(np.asarray(v)).to(dev) for v in vs]
             for k, vs in ins.items()}
    outs = opdef.compute(t_ins, dict(attrs), dev, **kw)
    return {k: v[0].cpu().numpy() for k, v in outs.items() if v}


def _random_properties(torch, np, op_type, got, ins, dev):
    """The random ops' properties on the card: the batch-size-like
    uniform in range and uniform (chi-square, 20 bins, p 1e-3: 43.82);
    the normal's and the truncated normal's moments within 5 standard
    errors (the truncated normal within 2 sigma); sampling_id's ids in
    range; sample_logits' own draws (Samples past the true labels) in
    range and uniform over 4096 rows of 64 (chi-square, 40 classes, p
    1e-3: 72.05). nce outputs no draw: its classes come from the same
    ``rng.op_randint``, held by 17a's words check."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.core.registry import get_op_def

    def chi2(counts):
        want = counts.sum() / len(counts)
        return float(((counts - want) ** 2 / want).sum())

    if op_type == "uniform_random_batch_size_like":
        v = got["Out"].ravel()
        c = chi2(np.histogram(v, 20, (-2.0, 3.0))[0])
        assert v.min() >= -2.0 and v.max() <= 3.0 and c < 43.82, c
        return {"chi2_20_bins": c}
    if op_type == "gaussian_random_batch_size_like":
        v = got["Out"].ravel().astype(np.float64)
        se = 0.5 / np.sqrt(v.size)
        assert abs(v.mean() - 1.5) < 5 * se and abs(v.std() - 0.5) < 5 * se
        return {"mean": float(v.mean()), "std": float(v.std())}
    if op_type == "truncated_gaussian_random":
        v = got["Out"].ravel().astype(np.float64)
        phi, z = np.exp(-2.0) / np.sqrt(2 * np.pi), 0.9544997361036416
        sd = 2.0 * np.sqrt(1 - 4 * phi / z)
        assert v.min() >= 0.5 - 4.0 and v.max() <= 0.5 + 4.0
        assert abs(v.mean() - 0.5) < 5 * sd / np.sqrt(v.size)
        assert abs(v.std() - sd) < 5 * sd / np.sqrt(2 * v.size), v.std()
        return {"mean": float(v.mean()), "std": float(v.std()),
                "truncated_std": sd}
    if op_type == "sampling_id":
        ids = got["Out"]
        assert ids.min() >= 0 and ids.max() < ins["X"][0].shape[1]
        return {"ids": len(ids)}
    if op_type == "nce":
        return {"draws": "held by the words check"}
    assert op_type == "sample_logits", op_type
    r = np.random.RandomState(SEED)
    big = {"Logits": [torch.from_numpy(r.normal(0, 1, (4096, 40))).to(dev)],
           "Labels": [torch.from_numpy(r.randint(0, 40, (4096, 1))).to(dev)]}
    seed = rng.SeedHandle(torch.full((), SEED, dtype=torch.int64,
                                     device=dev), 0)
    samples = get_op_def(op_type).compute(big, {"num_samples": 64}, dev,
                                          seed=seed)["Samples"][0]
    draws = samples[:, 1:].cpu().numpy()
    c = chi2(np.bincount(draws.ravel(), minlength=40))
    assert draws.min() >= 0 and draws.max() < 40 and c < 72.05, c
    return {"chi2_40_classes": c, "draws": int(draws.size)}


_DRAW_OPS = ("uniform_random_batch_size_like",
             "gaussian_random_batch_size_like", "sampling_id")


def ops_vs_cpu_17a(torch, np):
    """17a: every op type of the slice on the card against the CPU (the
    port's own plain ops on both; f64 inputs, one normal f64 cotangent an
    output): f64 values and gradients within TOL_SLICE_F64_REL of their
    largest element, f32 values within TOL_SLICE_F32_REL; integers and
    bools exactly; the random ops that draw from the op seed bit for bit
    (their words too), the host-seeded initializer by its properties
    (the card's generator is not the CPU's), and each random op held to
    its properties on the card."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.core.registry import get_op_def

    gpu_dev, cpu_dev = torch.device("cuda", 0), torch.device("cpu")
    rows, types = {}, set()
    for op, ins, attrs in slice_op_cases(np):
        opdef = get_op_def(op)
        gpu, cpu = (slice_op_run(torch, np, op, ins, attrs, d, SEED)
                    for d in (gpu_dev, cpu_dev))
        assert sorted(gpu) == sorted(cpu), (op, sorted(gpu), sorted(cpu))
        # the draws themselves bit for bit; nce's and sample_logits'
        # arithmetic over them as any op's (their words held below)
        errs, exact = {}, op in _DRAW_OPS
        for k, c in cpu.items():
            g = gpu[k]
            assert g.shape == c.shape and g.dtype == c.dtype, (op, k)
            if opdef.host_rng:
                continue
            if exact or not np.issubdtype(c.dtype, np.floating):
                assert np.array_equal(g, c, equal_nan=True), (op, k)
                errs[k] = 0.0
                continue
            tol = (TOL_SLICE_F64_REL if c.dtype == np.float64
                   else TOL_SLICE_F32_REL)
            finite = np.isfinite(c)
            assert np.array_equal(finite, np.isfinite(g)), (op, k)
            errs[k] = (_rel_err(np, g[finite], c[finite]) if finite.any()
                       else 0.0)
            assert errs[k] <= tol, (op, k, errs[k], tol)
        row = {"max_rel_err": max(errs.values(), default=None),
               "values": len(cpu), "bit_equal": exact}
        if opdef.needs_rng or opdef.host_rng:
            if opdef.needs_rng:
                words = [rng.op_words(rng.SeedHandle(torch.full(
                    (), SEED, dtype=torch.int64, device=d), 0), (64, 64), d)
                    .cpu() for d in (gpu_dev, cpu_dev)]
                assert torch.equal(*words), op
            row["properties"] = _random_properties(torch, np, op, gpu, ins,
                                                   gpu_dev)
        rows[op] = row
        types.add(op)
    assert len(types) == 88, len(types)
    return {"op_types": len(types), "tol_f64_rel": TOL_SLICE_F64_REL,
            "tol_f32_rel": TOL_SLICE_F32_REL, "ops": rows}


def _falls(np, name, row):
    """The loss of ``train_family``'s captured sequence (its bit check's
    step-runner run) falls: every step's finite, the mean of the last
    five below the first. Adds ``losses``: the first, middle and last."""
    losses = row["captured_vs_eager"]["first_fetch"][2]
    assert np.isfinite(losses).all(), (name, losses)
    assert np.mean(losses[-5:]) < losses[0], (name, losses)
    row["losses"] = [losses[0], losses[len(losses) // 2], losses[-1]]


def op_launches(torch, np, op_type, ins, attrs):
    """Kernels one op launches on the card, alone and in its derived grad
    op (which re-runs the forward under autograd), from the traces of two
    calls each (``_device_times``); float outputs take ones as their
    cotangents."""
    from paddle_tpu_torch.core import autodiff, rng
    from paddle_tpu_torch.core.registry import get_op_def

    dev = torch.device("cuda", 0)
    opdef = get_op_def(op_type)
    t_ins = {k: [torch.from_numpy(np.asarray(v)).to(dev) for v in vs]
             for k, vs in ins.items()}
    kw = {}
    if opdef.needs_rng:
        kw["seed"] = rng.SeedHandle(torch.full((), SEED, dtype=torch.int64,
                                               device=dev), 0)
    outs = opdef.compute(t_ins, dict(attrs), dev, **kw)
    g_ins = dict(t_ins, **outs)
    g_ins.update({"GRAD::" + k: [torch.ones_like(v[0])]
                  for k, v in outs.items() if v and v[0].is_floating_point()})
    g_attrs = dict(attrs, fwd_input_slots=list(ins),
                   fwd_output_slots=list(outs))
    grad = autodiff.make_grad_compute(opdef)
    fwd_counts, grad_counts = {}, {}
    _device_times(lambda: opdef.compute(t_ins, dict(attrs), dev, **kw),
                  iters=2, counts=fwd_counts)
    _device_times(lambda: grad(g_ins, g_attrs, dev, **kw), iters=2,
                  counts=grad_counts)
    return {"forward": sum(fwd_counts.values()),
            "derived_grad": sum(grad_counts.values())}


def _head_op_case(np, head):
    """(op type, inputs, attrs) of a 17b head's op at the phase's shapes."""
    r = np.random.RandomState(SEED)
    v, b, h = NGRAM_VOCAB, NGRAM_B, NGRAM_HIDDEN
    x = r.normal(0, 1, (b, h)).astype(np.float32)
    label = r.randint(0, v, (b, 1)).astype(np.int64)
    if head == "hsigmoid":
        return ("hierarchical_sigmoid",
                {"X": [x], "W": [r.normal(0, 0.02, (v - 1, h))
                                 .astype(np.float32)],
                 "Bias": [np.zeros(v - 1, np.float32)], "Label": [label]},
                {"num_classes": v})
    if head == "nce":
        return ("nce", {"Input": [x], "Label": [label],
                        "Weight": [r.normal(0, 0.02, (v, h))
                                   .astype(np.float32)],
                        "Bias": [np.zeros(v, np.float32)]},
                {"num_neg_samples": NGRAM_NEG})
    return ("sample_logits",
            {"Logits": [r.normal(0, 1, (b, v)).astype(np.float32)],
             "Labels": [label]}, {"num_samples": NGRAM_SAMPLES})


def heads_17b(torch, np, fluid, fa):
    """17b: the N-gram model at a 10,000-word vocabulary with each of the
    four heads, Adam(1e-3), trained by ``train_family``: NGRAM_STEPS
    steps eager, through the step runner and through a run_steps window,
    equal bit for bit, the loss falling (``_falls``), then the captured
    step timed; two f32 steps on the card against the CPU
    (``family_vs_cpu``, TF32 off: every gradient and the Adam moments);
    and the launches of the head's own op (``op_launches``: the path
    walk of hierarchical_sigmoid, nce's and sample_logits' draws)."""
    feeds = ngram_feeds(np, NGRAM_VOCAB, NGRAM_CTX, NGRAM_B, NGRAM_STEPS,
                        SEED)
    out = {}
    for head in NGRAM_HEADS:
        def build(head=head):
            return ngram_head_model(fluid, head)

        def make_opt():
            return fluid.optimizer.Adam(NGRAM_LR)

        row, _ = train_family(torch, np, fluid, fa, head, build, make_opt,
                              feeds, amp=False, items=NGRAM_B,
                              unit="examples", window=20,
                              equal_steps=NGRAM_STEPS)
        _falls(np, head, row)
        torch.cuda.empty_cache()
        main_prog = _family_program(fluid, build, make_opt, False)[0]
        names = [p.name + "@GRAD" for p in main_prog.all_parameters()
                 if p.trainable]
        row["vs_cpu"] = family_vs_cpu(torch, np, fluid, head, build,
                                      make_opt, feeds[:2], names)
        if head != "cross_entropy":
            op, ins, attrs = _head_op_case(np, head)
            row["head_op"] = op
            row["head_op_launches"] = op_launches(torch, np, op, ins, attrs)
        out[head] = row
    return out


def conv_transpose_ops_f32(torch, np):
    """17c's conv2d_transpose op at each of the generator's four layers'
    shapes (batch DCGAN_CPU_B, the smoke's cuDNN settings): f32 on the
    card against f64 on the CPU, the output and the derived gradients
    (``op_and_grads``) within TOL_SLICE_F32_REL of their largest element.
    Returns each layer's errors."""
    r = np.random.RandomState(SEED + 3)
    attrs = {"strides": [2, 2], "paddings": [1, 1]}
    rows, cin, side = {}, DCGAN_BASE, 4
    for i, cout in enumerate(DCGAN_WIDTHS):
        ins = {"Input": [r.normal(0, 1, (DCGAN_CPU_B, cin, side, side))],
               "Filter": [r.normal(0, 0.02, (cin, cout, 4, 4))]}
        want = op_and_grads(torch, np, "conv2d_transpose", ins, attrs,
                            torch.device("cpu"), SEED)
        got = op_and_grads(torch, np, "conv2d_transpose",
                           {k: [v.astype(np.float32) for v in vs]
                            for k, vs in ins.items()}, attrs,
                           torch.device("cuda", 0), SEED)
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        assert all(v.dtype == np.float32 for v in got.values()), i
        errs = {k: _rel_err(np, got[k], want[k]) for k in want}
        assert max(errs.values()) <= TOL_SLICE_F32_REL, (i, errs)
        rows[f"conv2d_transpose_{i}"] = errs
        cin, side = cout, 2 * side
    return rows


def dcgan_17c(torch, np, fluid, fa):
    """17c: the DCGAN generator at its published widths, batch 128, f32
    and bf16 AMP, Adam(2e-4, beta1 0.5), trained by ``train_family``
    (DCGAN_STEPS steps, captured = eager bit for bit under cuDNN's
    deterministic algorithms, the loss falling, the timed turns on its
    defaults). Then at the same widths and batch DCGAN_CPU_B against the
    CPU's f64 step from the card's startup state: the card's f64 step
    (every gradient), its f32 and its bf16 AMP steps (``hold_vs_f64``:
    the loss, every relu gate's pre-activation, the gradients no flipped
    gate reaches), and each conv2d_transpose op in f32 (see
    TOL_DCGAN_F64)."""
    feeds = dcgan_feeds(np, DCGAN_B, DCGAN_STEPS, SEED)

    def build():
        return dcgan_generator(fluid)

    def make_opt():
        return fluid.optimizer.Adam(DCGAN_LR, beta1=DCGAN_BETA1)

    out = {}
    for amp in (False, True):
        row, _ = train_family(torch, np, fluid, fa, "dcgan", build, make_opt,
                              feeds, amp=amp, items=DCGAN_B, unit="images",
                              window=10, equal_steps=DCGAN_STEPS)
        _falls(np, "dcgan", row)
        out["bf16" if amp else "f32"] = row
        torch.cuda.empty_cache()
    main_prog, startup, model, _ = _family_program(fluid, build, make_opt,
                                                   amp=False)
    amp_prog = _family_program(fluid, build, make_opt, amp=True)[0]
    names = [p.name for p in main_prog.all_parameters() if p.trainable]
    grads = [n + "@GRAD" for n in names]
    loss = model["loss"].name
    gates = [n for _, n in _relu_gates(main_prog)]
    state = card_startup_state(fluid, startup)
    feed = dcgan_feeds(np, DCGAN_CPU_B, 1, SEED + 1)[0]
    cut = (f"batch {DCGAN_CPU_B}, not {DCGAN_B}: the CPU's part of the "
           f"phase bound")
    out["vs_cpu_f64"], _, ref = step_vs_cpu(
        np, fluid, "dcgan", main_prog, state, loss, feed, names, names,
        TOL_DCGAN_F64, double=True, extra=gates)
    out["vs_cpu_f64"]["cut"] = cut
    f32 = run_captured(fluid, main_prog, state, feed, [loss] + grads + gates)
    out["f32_vs_cpu_f64"] = hold_vs_f64(np, main_prog, names, ref, f32)
    amp_gates = [n for _, n in _relu_gates(amp_prog)]
    bf16 = run_captured(fluid, amp_prog, state, feed,
                        [loss] + grads + amp_gates)
    out["bf16_vs_cpu_f64"] = hold_vs_f64(np, main_prog, names, ref, bf16,
                                         tol=TOL_DCGAN_BF16)
    out["f32_vs_cpu_f64"]["cut"] = out["bf16_vs_cpu_f64"]["cut"] = cut
    out["conv_transpose_f32_ops"] = conv_transpose_ops_f32(torch, np)
    return out


def op_library(torch, np, fluid, fa):
    """Phase 17: the slice's op types card against CPU (17a), the
    N-gram model's four large-vocabulary heads (17b), the DCGAN generator
    (17c). Returns {sub-phase: row}; a line names each sub-phase before
    it runs, and its ``oplib_`` line follows."""
    out = {"t0": time.perf_counter()}

    def done(key, row):
        row["at_s"] = time.perf_counter() - out["t0"]
        out[key] = row
        print(f"oplib_{key} " + json.dumps(row), flush=True)

    print("phase 17a: the slice's 88 op types, card against CPU in f64",
          flush=True)
    done("17a", ops_vs_cpu_17a(torch, np))
    print(f"phase 17b: N-gram model, vocabulary {NGRAM_VOCAB}, heads "
          f"{', '.join(NGRAM_HEADS)}, batch {NGRAM_B}, {NGRAM_STEPS} steps",
          flush=True)
    done("17b", heads_17b(torch, np, fluid, fa))
    print(f"phase 17c: DCGAN generator, batch {DCGAN_B}, f32 and bf16, "
          f"{DCGAN_STEPS} steps; against the CPU at batch {DCGAN_CPU_B}",
          flush=True)
    done("17c", dcgan_17c(torch, np, fluid, fa))
    out["seconds"] = time.perf_counter() - out.pop("t0")
    return out


# --- phase 18: the vision and detection ops, FPN Faster R-CNN's heads,
# YOLOv3's loss and SSD-300's VOC evaluation ---

# 18a: card against CPU in f64, as 17a (TOL_SLICE_*); the NMS sweep's
# kernels against its plain version bit for bit, at these candidate counts
# and set counts (m = 400: SSD-300's eval, 32 images x 20 classes; m =
# 1000: YOLOv3's, 8 images x 80 classes; m = 2000: an FPN level's
# proposals, 2 images; m = 12,000: the RPN's pre-NMS top-n of Detectron's
# C4 training configs, lib/core/config.py TRAIN.RPN_PRE_NMS_TOP_N)
NMS_CASES = ((64, 64), (400, 640), (1000, 640), (2000, 2), (12000, 2))
# the sweep's two kernels, as the trace names them (a call launches each
# once)
NMS_KERNELS = ("nms_sweep_mask_kernel", "nms_sweep_scan_kernel")
# the largest m whose plain loop (~5 launches a candidate) is traced for
# its launches; above it the loop is timed once and not traced
NMS_TRACE_PLAIN_M = 2000
# floating-point operations of one IoU test of the sweep (4 max / min, 2
# clamps, 3 subtractions, 2 products, 1 add, 1 max, 1 divide, 1 compare)
NMS_IOU_FLOPS = 15
# 18b: Detectron's configs/12_2017_baselines/e2e_faster_rcnn_R-50-FPN_1x.yaml
# (RPN, FPN routing and box head; mask targets at the resolution of
# e2e_mask_rcnn_R-50-FPN_1x.yaml) at its published widths on 2 images of
# 800 x 1333 padded to 800 x 1344. The ResNet-50-FPN backbone is not a
# model of the JAX package: its lateral sums (P2-P5, 256 channels) are fed
# from a seed, and the FPN's 3 x 3 output convolutions and P6 (a stride-2
# subsample of P5) are trained
FPN = dict(images=2, height=800, width=1344, im_h=800.0, im_w=1333.0,
           channels=256, strides=(4, 8, 16, 32, 64),
           anchor_sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
           ratios=(0.5, 1.0, 2.0), rpn_batch=256, rpn_fg=0.5, rpn_pos=0.7,
           rpn_neg=0.3, pre_nms=2000, post_nms=2000, rpn_nms=0.7,
           min_size=0.0, collect_post=2000, min_level=2, max_level=5,
           refer_level=4, refer_scale=224, rcnn_batch=512, rcnn_fg=0.25,
           fg_thresh=0.5, bg_hi=0.5, bg_lo=0.0, classes=81,
           reg_weights=(0.1, 0.1, 0.2, 0.2), roi=7, sampling_ratio=2,
           fc=1024, mask_res=28, gt=20, parts=2, verts=16, use_random=True)
# the same heads at a toy size (tests/test_torch_rcnn_yolo.py runs them
# against the JAX package): no candidate is cut by a top-k or a batch, so
# two frameworks' rounding cannot change which RoIs are sampled; the
# second stage samples every candidate, its batch the 1,536 proposal rows
# (3 x (16 x 24 + 8 x 12 + 4 x 6 + 2 x 3 + 1 x 2)) and the 4 gt rows
FPN_TOY = dict(FPN, images=2, height=64, width=96, im_h=64.0, im_w=90.0,
               channels=8, anchor_sizes=(8.0, 16.0, 32.0, 64.0, 128.0),
               rpn_batch=64, rpn_nms=0.8, collect_post=3000,
               rcnn_batch=1540, classes=5, fc=32, mask_res=7, gt=4,
               parts=2, verts=6, use_random=False)
# steps in each of the bit check's four sequences (10, not 20: the
# smoke's time limit on a slow host)
FPN_LR, FPN_MOMENTUM, FPN_STEPS = 0.02, 0.9, 10
# 18c: Darknet's cfg/yolov3.cfg at 608 x 608: the three output 1 x 1
# convolutions (255 channels) over fed Darknet-53 maps, yolov3_loss at
# strides 32 / 16 / 8 with the paper's anchors and masks, label smoothing;
# the eval path yolo_box -> multiclass_nms at the reference's eval settings
YOLO = dict(batch=8, size=608, classes=80, gt=50,
            anchors=(10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116,
                     90, 156, 198, 373, 326),
            masks=((6, 7, 8), (3, 4, 5), (0, 1, 2)),
            channels=(1024, 512, 256), strides=(32, 16, 8),
            ignore_thresh=0.7, conf_thresh=0.005, nms_top_k=1000,
            keep_top_k=100, nms_thresh=0.45)
YOLO_TOY = dict(YOLO, batch=2, size=64, classes=4, gt=6,
                anchors=(2, 3, 4, 6, 6, 4, 6, 12, 12, 9, 12, 24, 23, 18, 31,
                         40, 40, 36),
                channels=(16, 8, 4), nms_top_k=40, keep_top_k=20)
YOLO_LR, YOLO_MOMENTUM, YOLO_STEPS = 0.001, 0.9, 10
# 18d: PaddleCV object_detection/eval.py (Fluid 1.4): SSD-300 on VOC,
# detection_output then DetectionMAP, 4 batches of 32 and a reset
SSD_EVAL = dict(batch=32, batches=4, nms_thresh=0.45, nms_top_k=400,
                keep_top_k=200, score_thresh=0.01, overlap=0.5,
                ap_version="11point", difficult_share=0.2)


def vision_op_cases(np):
    """(op type, inputs, attrs) of each of the slice's 31 op types at small
    shapes, float inputs f64 (the ops that compute in f32 whatever their
    inputs: their outputs f32); the sampling ops with ``use_random``."""
    r = np.random.RandomState(SEED + 18)

    def f(*shape, scale=1.0):
        return r.normal(0, scale, shape)

    def boxes(shape, lo, hi, wmin, wmax):
        x1, y1 = r.uniform(lo, hi, shape), r.uniform(lo, hi, shape)
        w, h = r.uniform(wmin, wmax, shape), r.uniform(wmin, wmax, shape)
        return np.stack([x1, y1, x1 + w, y1 + h], -1)

    def anchors(h, w, stride):
        cy, cx = np.meshgrid((np.arange(h) + 0.5) * stride,
                             (np.arange(w) + 0.5) * stride, indexing="ij")
        out = [np.stack([cx - s * np.sqrt(q) / 2, cy - s / np.sqrt(q) / 2,
                         cx + s * np.sqrt(q) / 2, cy + s / np.sqrt(q) / 2],
                        -1) for s, q in ((10, 1.0), (16, 0.5), (14, 2.0))]
        return np.stack(out, 2)

    x4 = f(2, 3, 8, 9)
    rois = boxes((5,), 0, 6, 1, 4)
    gt = boxes((2, 4), 0, 35, 6, 20)
    gt[1, 3] = 0.0
    anc = anchors(4, 5, 10.0)
    quads = np.array([[0, 2, 2, 8, 3, 9, 8, 1, 7],
                      [1, 3, 1, 10, 2, 9, 7, 2, 6]], np.float64)
    segs = np.zeros((2, 3, 2, 6, 2))
    lens = r.randint(3, 7, (2, 3, 2))
    lens[0, 1, 1] = 0
    for idx in np.ndindex(2, 3, 2):
        t = np.sort(r.uniform(0, 2 * np.pi, lens[idx]))
        c, rad = r.uniform(10, 30, 2), r.uniform(4, 9)
        segs[idx][:lens[idx]] = np.stack([c[0] + rad * np.cos(t),
                                          c[1] + rad * np.sin(t)], -1)
    det = np.concatenate([r.randint(0, 4, (3, 8, 1)),
                          np.round(r.uniform(0.05, 1, (3, 8, 1)), 2),
                          boxes((3, 8), 0, 60, 8, 30)], -1)
    label = np.concatenate([r.randint(-1, 4, (3, 5, 1)),
                            (r.uniform(0, 1, (3, 5, 1)) < 0.3),
                            boxes((3, 5), 0, 60, 8, 30)], -1)
    det[:, :5, 2:] = label[:, :, 2:] + r.normal(0, 2, (3, 5, 4))
    det[:, :5, :1] = np.maximum(label[:, :, :1], 0)
    yolo_gt = np.array([[[0.3, 0.4, 0.3, 0.4], [0.7, 0.2, 0.5, 0.9],
                         [0.55, 0.6, 0.9, 0.7], [0.0, 0.0, 0.0, 0.0]],
                        [[0.3, 0.4, 0.3, 0.4], [0.3, 0.4, 0.3, 0.4],
                         [0.2, 0.7, 0.5, 0.9], [0.8, 0.3, 0.3, 0.45]]])
    i32 = np.int32
    return [
        ("roi_align", {"X": [x4], "ROIs": [rois],
                       "BatchId": [np.array([0, 1, 1, 0, 1], i32)]},
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 1.0,
          "sampling_ratio": 2}),
        ("roi_pool", {"X": [x4], "ROIs": [rois]},
         {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}),
        ("psroi_pool", {"X": [f(2, 8, 6, 7)], "ROIs": [np.concatenate(
            [np.array([[0], [1], [1]]), boxes((3,), 0, 4, 1, 3)], 1)]},
         {"output_channels": 2, "pooled_height": 2, "pooled_width": 2,
          "spatial_scale": 1.0}),
        ("roi_perspective_transform", {"X": [f(2, 3, 10, 12)],
                                       "ROIs": [quads]},
         {"transformed_height": 4, "transformed_width": 5,
          "spatial_scale": 1.0}),
        ("yolo_box", {"X": [f(2, 16, 4, 5)],
                      "ImgSize": [np.array([[64, 80], [60, 70]], i32)]},
         {"anchors": [10, 13, 16, 30], "class_num": 3, "conf_thresh": 0.3,
          "downsample_ratio": 16}),
        ("box_clip", {"Input": [f(2, 5, 4, scale=40.0)],
                      "ImInfo": [np.array([[30, 40, 1.0], [50, 20, 2.0]])]},
         {}),
        ("density_prior_box", {"Input": [f(1, 2, 4, 4)],
                               "Image": [f(1, 3, 32, 32)]},
         {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0, 2.0],
          "densities": [2, 1]}),
        ("conv3d", {"Input": [f(2, 4, 5, 6, 5)],
                    "Filter": [f(6, 2, 3, 3, 2)]},
         {"strides": [1, 2, 1], "paddings": [1, 0, 1],
          "dilations": [1, 1, 2], "groups": 2}),
        ("conv3d_transpose", {"Input": [f(2, 4, 3, 4, 3)],
                              "Filter": [f(4, 3, 2, 3, 2)]},
         {"strides": [2, 1, 2], "paddings": [1, 1, 0]}),
        ("pool3d", {"X": [f(2, 2, 5, 6, 4)]},
         {"ksize": [3, 3, 2], "strides": [2, 2, 2], "paddings": [1, 1, 1],
          "pooling_type": "avg"}),
        ("max_pool2d_with_index", {"X": [f(2, 3, 7, 6)]},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
        ("max_pool3d_with_index", {"X": [f(2, 2, 5, 4, 6)]},
         {"ksize": [2, 3, 2], "strides": [2, 1, 2], "paddings": [0, 1, 1]}),
        ("unpool", {"X": [f(2, 3, 3, 3)],
                    "Indices": [r.randint(0, 49, (2, 3, 3, 3)).astype(i32)]},
         {"unpooled_height": 7, "unpooled_width": 7}),
        ("spp", {"X": [f(2, 3, 7, 5)]},
         {"pyramid_height": 3, "pooling_type": "max"}),
        ("lrn", {"X": [f(2, 7, 3, 4)]},
         {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}),
        ("affine_grid", {"Theta": [f(2, 2, 3)]},
         {"output_shape": [2, 3, 4, 5]}),
        ("random_crop", {"X": [f(2, 3, 9, 11)]}, {"shape": [3, 5, 4]}),
        ("polygon_box_transform", {"Input": [f(2, 8, 3, 4)]}, {}),
        ("depthwise_conv2d_transpose", {"Input": [f(2, 3, 4, 4)],
                                        "Filter": [f(3, 1, 3, 3)]},
         {"strides": [2, 2], "paddings": [1, 1]}),
        ("similarity_focus", {"X": [f(2, 3, 4, 5)]},
         {"axis": 1, "indexes": [0, 2]}),
        ("adaptive_pool2d", {"X": [f(2, 3, 7, 5)]},
         {"ksize": [3, 2], "pooling_type": "max"}),
        ("adaptive_pool3d", {"X": [f(1, 2, 5, 4, 7)]},
         {"ksize": [2, 3, 3], "pooling_type": "avg"}),
        ("generate_proposals", {
            "Scores": [np.round(r.uniform(0, 1, (2, 3, 4, 5)), 1)],
            "BboxDeltas": [f(2, 12, 4, 5, scale=0.3)],
            "ImInfo": [np.array([[40, 50, 1.0], [36, 44, 0.8]])],
            "Anchors": [anc],
            "Variances": [np.broadcast_to([0.1, 0.1, 0.2, 0.2],
                                          anc.shape).copy()]},
         {"pre_nms_topN": 30, "post_nms_topN": 12, "nms_thresh": 0.6,
          "min_size": 2.0}),
        ("rpn_target_assign", {
            "Anchor": [anc.reshape(-1, 4)], "GtBoxes": [gt],
            "ImInfo": [np.array([[40, 50, 1.0], [45, 45, 1.0]])],
            "IsCrowd": [np.array([[0, 0, 1, 0], [0, 0, 0, 0]], i32)]},
         {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.5,
          "rpn_positive_overlap": 0.6, "rpn_negative_overlap": 0.3,
          "use_random": True}),
        ("generate_proposal_labels", {
            "RpnRois": [np.concatenate([gt[:, :, None].repeat(3, 2).reshape(
                2, 12, 4) + r.normal(0, 1.5, (2, 12, 4)),
                boxes((2, 8), 0, 40, 4, 25)], 1)],
            "GtClasses": [np.array([[1, 3, 2, 4], [2, 4, 1, 0]], i32)],
            "GtBoxes": [gt], "ImInfo": [np.array([[40, 50, 1.0]] * 2)],
            "IsCrowd": [np.zeros((2, 4), i32)]},
         {"batch_size_per_im": 12, "fg_fraction": 0.25, "fg_thresh": 0.5,
          "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 5,
          "use_random": True}),
        ("distribute_fpn_proposals", {
            "FpnRois": [boxes((2, 10), 0, 300, 10, 500)]},
         {"min_level": 2, "max_level": 5, "refer_level": 4,
          "refer_scale": 224}),
        ("collect_fpn_proposals", {
            "MultiLevelRois": [boxes((2, 5), 0, 50, 3, 20),
                               boxes((2, 4), 0, 50, 3, 20)],
            "MultiLevelScores": [np.round(r.uniform(0, 1, (2, 5)), 1),
                                 np.round(r.uniform(0, 1, (2, 4, 1)), 1)]},
         {"post_nms_topN": 8}),
        ("box_decoder_and_assign", {
            "PriorBox": [boxes((5,), 0, 40, 5, 20)],
            "PriorBoxVar": [np.array([0.1, 0.1, 0.2, 0.2])],
            "TargetBox": [f(5, 12, scale=2.0)],
            "BoxScore": [r.uniform(0, 1, (5, 3))]}, {"box_clip": 2.0}),
        ("yolov3_loss", {"X": [f(2, 16, 4, 4)], "GTBox": [yolo_gt],
                         "GTLabel": [r.randint(0, 3, (2, 4)).astype(i32)],
                         "GTScore": [r.uniform(0.5, 1, (2, 4))]},
         {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 1],
          "class_num": 3, "ignore_thresh": 0.5, "downsample_ratio": 8}),
        ("detection_map", {
            "DetectRes": [det], "Label": [label.astype(np.float64)],
            "HasState": [np.ones(1)], "PosCount": [np.array([2, 0, 1, 3.])],
            "TruePos": [r.randint(0, 3, (4, 16)).astype(np.float64)],
            "FalsePos": [r.randint(0, 3, (4, 16)).astype(np.float64)]},
         {"class_num": 4, "ap_type": "11point", "evaluate_difficult": False,
          "score_bins": 16}),
        ("generate_mask_labels", {
            "ImInfo": [np.array([[40, 40, 1.0], [80, 80, 2.0]])],
            "GtClasses": [np.array([[1, 3, 0], [2, 2, 1]], i32)],
            "IsCrowd": [np.array([[0, 0, 0], [0, 1, 0]], i32)],
            "GtSegms": [segs], "PolyLens": [lens.astype(i32)],
            "Rois": [boxes((2, 5), 0, 30, 6, 20) * [[[1.0]], [[2.0]]]],
            "LabelsInt32": [np.array([[2, 0, 1, 3, 0], [0, 1, 0, 0, 4]],
                                     i32)]},
         {"num_classes": 4, "resolution": 7}),
    ]


# ops that compute in f32 whatever their inputs' dtype (the JAX ops cast
# to f32): their f64 outputs and gradients are held to TOL_SLICE_F32_REL.
# On the card PyTorch divides an f32 tensor by a Python number as a
# product with its reciprocal, on the CPU as a division: one f32 ulp
# (read 2.2e-7 in roi_align's output on an H100)
F32_ARITHMETIC_OPS = ("roi_align", "roi_perspective_transform",
                      "yolov3_loss")
# the sampling ops' outputs held card = CPU bit for bit (the selections,
# labels and weights; their float targets are encodings held as values)
_SAMPLED_EXACT = {"rpn_target_assign": ("ScoreLabel", "ScoreWeight",
                                        "BboxWeight"),
                  "generate_proposal_labels": ("Rois", "LabelsInt32",
                                               "BboxInsideWeights",
                                               "BboxOutsideWeights"),
                  "random_crop": ("Out",)}


def _sampled_properties(torch, np, op, got, ins, attrs):
    """The sampling ops' draws on the card held to their properties, the
    bands computed from the inputs as the ops compute them (gt boxes in
    f32, box_util's IoU): rpn_target_assign per image exactly min(#pos,
    batch * fraction) positives and min(batch - #fg, #neg) negatives, each
    in its band (a positive at >= the positive overlap or a gt's best
    anchor, a negative below the negative overlap);
    generate_proposal_labels per image exactly min(#fg, batch * fraction)
    foreground rows first, then min(batch - #fg, #bg) background rows,
    then -1, each row's best IoU in its band; random_crop's output a crop
    of X."""
    from paddle_tpu_torch.ops.box_util import iou_xyxy, xyxy_area

    if op == "random_crop":
        x, out = ins["X"][0], got["Out"]
        s = attrs["shape"]
        hits = [(a, b, c) for a in range(x.shape[1] - s[0] + 1)
                for b in range(x.shape[2] - s[1] + 1)
                for c in range(x.shape[3] - s[2] + 1)
                if np.array_equal(out, x[:, a:a + s[0], b:b + s[1],
                                         c:c + s[2]])]
        assert hits, "random_crop: not a crop"
        return {"start": list(hits[0])}
    gt = torch.from_numpy(ins["GtBoxes"][0]).to(torch.float32)
    valid = (xyxy_area(gt) > 0).numpy() & (ins["IsCrowd"][0] == 0)
    if op == "rpn_target_assign":
        label = got["ScoreLabel"]
        a = torch.from_numpy(ins["Anchor"][0])
        an, im = ins["Anchor"][0], ins["ImInfo"][0]
        batch = attrs["rpn_batch_size_per_im"]
        for i in range(label.shape[0]):
            inside = ((an[:, 0] >= 0) & (an[:, 1] >= 0)
                      & (an[:, 2] < im[i, 1]) & (an[:, 3] < im[i, 0]))
            iou = np.where(valid[i][None] & inside[:, None],
                           iou_xyxy(a, gt[i]).numpy(), -1.0)
            best, gt_best = iou.max(1), iou.max(0)
            pos = (best >= attrs["rpn_positive_overlap"]) | (
                (iou >= gt_best[None]) & (gt_best[None] > 0)
                & valid[i][None]).any(1)
            neg = (best < attrs["rpn_negative_overlap"]) & (best >= 0) & ~pos
            fg, bg = label[i] == 1, label[i] == 0
            assert fg.sum() == min(pos.sum(), int(
                batch * attrs["rpn_fg_fraction"])), (i, fg.sum(), pos.sum())
            assert bg.sum() == min(batch - fg.sum(), neg.sum()), (
                i, bg.sum(), neg.sum())
            assert pos[fg].all() and neg[bg].all(), i
        return {"fg": int((label == 1).sum()), "bg": int((label == 0).sum())}
    labels, rois = got["LabelsInt32"], torch.from_numpy(got["Rois"])
    batch = attrs["batch_size_per_im"]
    rpn = torch.from_numpy(ins["RpnRois"][0]).to(torch.float32)
    cand = torch.cat([rpn, gt], 1)
    cand_valid = np.concatenate([(xyxy_area(rpn) > 0).numpy(), valid], 1)
    for i in range(labels.shape[0]):
        best = np.where(cand_valid[i], np.where(
            valid[i][None], iou_xyxy(cand[i], gt[i]).numpy(), 0.0).max(1),
            -1.0)
        n_fg = min(int((best >= attrs["fg_thresh"]).sum()),
                   int(batch * attrs["fg_fraction"]))
        n_bg = min(batch - n_fg, int(((best < attrs["bg_thresh_hi"])
                                      & (best >= attrs["bg_thresh_lo"]))
                                     .sum()))
        row = labels[i]
        assert (row[:n_fg] > 0).all() and (row[n_fg:n_fg + n_bg] == 0).all()
        assert (row[n_fg + n_bg:] == -1).all(), (i, n_fg, n_bg, row)
        got_best = np.where(valid[i][None], iou_xyxy(rois[i], gt[i]).numpy(),
                            0.0).max(1)
        assert (got_best[:n_fg] >= attrs["fg_thresh"]).all(), i
        band = got_best[n_fg:n_fg + n_bg]
        assert ((band < attrs["bg_thresh_hi"])
                & (band >= attrs["bg_thresh_lo"])).all(), i
    return {"fg": int((labels > 0).sum()), "bg": int((labels == 0).sum())}


def vision_ops_vs_cpu_18a(torch, np):
    """18a's op check: every op type of the slice on the card against the
    CPU (``slice_op_run``: f64 inputs, one normal cotangent an output, the
    random ops from one op seed): f64 values and gradients within
    TOL_SLICE_F64_REL of their largest element, f32 values (and those of
    F32_ARITHMETIC_OPS) within TOL_SLICE_F32_REL, integers exactly, the
    sampling ops' selections bit for bit (``_SAMPLED_EXACT``) and held to
    their properties."""
    from paddle_tpu_torch.core.registry import get_op_def

    gpu_dev, cpu_dev = torch.device("cuda", 0), torch.device("cpu")
    rows = {}
    for op, ins, attrs in vision_op_cases(np):
        gpu, cpu = (slice_op_run(torch, np, op, ins, attrs, d, SEED)
                    for d in (gpu_dev, cpu_dev))
        assert sorted(gpu) == sorted(cpu), (op, sorted(gpu), sorted(cpu))
        errs = {}
        for k, c in cpu.items():
            g = gpu[k]
            assert g.shape == c.shape and g.dtype == c.dtype, (op, k)
            if k in _SAMPLED_EXACT.get(op, ()) or not np.issubdtype(
                    c.dtype, np.floating):
                assert np.array_equal(g, c), (op, k)
                errs[k] = 0.0
                continue
            tol = (TOL_SLICE_F64_REL if c.dtype == np.float64
                   and op not in F32_ARITHMETIC_OPS else TOL_SLICE_F32_REL)
            finite = np.isfinite(c)
            assert np.array_equal(finite, np.isfinite(g)), (op, k)
            assert np.array_equal(g[~finite], c[~finite]), (op, k)
            errs[k] = (_rel_err(np, g[finite], c[finite]) if finite.any()
                       else 0.0)
            assert errs[k] <= tol, (op, k, errs[k], tol)
        row = {"max_rel_err": max(errs.values(), default=None),
               "values": len(cpu)}
        if get_op_def(op).needs_rng:
            row["properties"] = _sampled_properties(torch, np, op, gpu, ins,
                                                    attrs)
        rows[op] = row
    assert len(rows) == 31, sorted(rows)
    return {"op_types": len(rows), "tol_f64_rel": TOL_SLICE_F64_REL,
            "tol_f32_rel": TOL_SLICE_F32_REL, "ops": rows}


def nms_sets(torch, np, sets, m, seed):
    """Score-sorted candidate sets on the card for the sweep: boxes
    [sets, m, 4] f32 in clusters (overlaps above and below the
    thresholds), zero-width and inverted boxes, exact duplicates, NaN and
    infinite coordinates, scores with ties and zeros; keep0 = score > 0,
    as multiclass_nms makes it. Returns (boxes, keep0)."""
    from paddle_tpu_torch.ops.vision_ops import desc_order

    r = np.random.RandomState(seed)
    centers = r.uniform(10, 590, (sets, m // 8 + 1, 2))
    pick = r.randint(0, centers.shape[1], (sets, m))
    c = np.take_along_axis(centers, pick[..., None], 1) + r.normal(
        0, 6, (sets, m, 2))
    wh = r.uniform(8, 60, (sets, m, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], -1)
    b[:, ::7, 2] = b[:, ::7, 0]                        # zero width
    b[:, 3::11, 3] = b[:, 3::11, 1] - 2.0              # inverted height
    b[:, 5::13] = b[:, 4::13][:, :b[:, 5::13].shape[1]]  # duplicates
    b[:, 2::17, 0] = np.nan
    b[:, 6::19, 2] = np.inf
    b[:, 8::23, 1] = -np.inf
    b[:, 10::29] = [-np.inf, -np.inf, np.inf, np.inf]
    s = np.round(r.uniform(0, 1, (sets, m)), 2)        # ties
    s[:, ::9] = 0.0
    dev = torch.device("cuda", 0)
    boxes = torch.from_numpy(b.astype(np.float32)).to(dev)
    scores = torch.from_numpy(s.astype(np.float32)).to(dev)
    order = desc_order(scores)
    boxes = torch.gather(boxes, 1, order[..., None].expand(sets, m, 4))
    scores = torch.gather(scores, 1, order)
    return boxes, scores > 0


def nms_tests_needed(torch, over, keep0, keep):
    """The IoU tests this data needs of a sequential sweep: row i (a
    candidate, keep0) is tested against the kept j < i in order, all of
    them if it is kept, else up to the first that suppresses it."""
    kept_before = torch.cumsum(keep.to(torch.int64), 1) - keep.to(
        torch.int64)                                    # [B, m]
    m = keep.shape[1]
    earlier = torch.ones(m, m, dtype=torch.bool,
                         device=keep.device).tril(-1)
    hits = over & earlier & keep[:, None, :]            # [B, m, m]
    first = torch.argmax(hits.to(torch.uint8), dim=2)   # [B, m]
    upto = torch.gather(kept_before, 1, first) + 1
    need = torch.where(keep, kept_before,
                       torch.where(keep0 & hits.any(2), upto, 0))
    return int(need.sum())


def check_nms_sweep(torch, np, vision_ops, sets, m):
    """The NMS sweep's kernels (``vision_ops.nms_sweep``) against
    ``nms_sweep_plain`` on the card at one shape, bit for bit, at the
    case's threshold and at -0.1 (where every pair but one with a NaN IoU
    suppresses), and a second launch equal to the first; in the RPN's
    convention too: detection_ops' ``_nms_mask`` (the kernels at the
    case's threshold; its own rule below 0) against the plain sweep over
    box_util.iou_xyxy at both thresholds; the mask kernel's words
    (``nms_mask_words``) equal to ``nms_mask_words_plain``'s;
    ``max_abs_err`` the largest |kernel - plain| of the masks as 0 / 1.
    The sweep timed by events and from the trace (both kernels, and each),
    the plain loop by events and, up to NMS_TRACE_PLAIN_M, its launches
    traced; the bound: the sorted boxes, keep0 and keep moved once, and
    the IoU tests this data needs of a sequential sweep
    (``nms_tests_needed``) at NMS_IOU_FLOPS each on the f32 CUDA cores
    (the mask kernel does every upper-triangle test,
    ``upper_triangle_tests``)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.ops import detection_ops
    from paddle_tpu_torch.ops.box_util import iou_xyxy

    boxes, keep0 = nms_sets(torch, np, sets, m, SEED + m)
    thr = 0.45 if m <= 1000 else 0.7
    before = kernels.launch_counts["nms_sweep"]
    before_mask = kernels.launch_counts["nms_sweep_mask"]
    got = vision_ops.nms_sweep(boxes, keep0, thr)
    again = vision_ops.nms_sweep(boxes, keep0, thr)
    got_neg = vision_ops.nms_sweep(boxes, keep0, -0.1)
    got_rpn = detection_ops._nms_mask(boxes, keep0, thr)
    got_rpn_neg = detection_ops._nms_mask(boxes, keep0, -0.1)
    words = vision_ops.nms_mask_words(boxes, thr)
    torch.cuda.synchronize()
    assert kernels.launch_counts["nms_sweep"] == before + 4
    assert kernels.launch_counts["nms_sweep_mask"] == before_mask + 1
    words_mismatched = int((words != vision_ops.nms_mask_words_plain(
        boxes, thr)).sum())
    assert words_mismatched == 0, (sets, m, words_mismatched)
    del words
    want = vision_ops.nms_sweep_plain(boxes, keep0, thr)
    want_neg = vision_ops.nms_sweep_plain(boxes, keep0, -0.1)
    iou = iou_xyxy(boxes, boxes)
    want_rpn = vision_ops.sweep_mask(iou > thr, keep0)
    want_rpn_neg = vision_ops.sweep_mask(iou > -0.1, keep0)
    del iou
    pairs = ((got, want), (again, got), (got_neg, want_neg),
             (got_rpn, want_rpn), (got_rpn_neg, want_rpn_neg))
    mismatched = sum(int((a != b).sum()) for a, b in pairs)
    err = max(float((a.to(torch.int32) - b.to(torch.int32)).abs().max())
              for a, b in pairs)
    assert mismatched == 0, (sets, m, mismatched)
    tests = nms_tests_needed(torch, vision_ops._iou_matrix(boxes) > thr,
                             keep0, want)
    torch.cuda.empty_cache()
    # the plain loop (warm from ``want``) timed once, its launches traced
    plain_ms = _time_ms(lambda: vision_ops.nms_sweep_plain(
        boxes, keep0, thr), iters=1, warmup=0)
    plain_counts = {}
    if m <= NMS_TRACE_PLAIN_M:
        _device_times(lambda: vision_ops.nms_sweep_plain(boxes, keep0, thr),
                      iters=1, counts=plain_counts)
    # the IoU tests run on the CUDA cores (no tensor-core route)
    op_ms = tests * NMS_IOU_FLOPS / PEAK_FLOPS["float32"]["f32 CUDA cores"] \
        * 1e3
    byte_ms = (boxes.numel() * 4 + 2 * keep0.numel()) / PEAK_BYTES_PER_S \
        * 1e3
    bound = {"bound_ms": max(op_ms, byte_ms),
             "bound_by": "operations" if op_ms >= byte_ms else "bytes"}
    times = _device_times(lambda: vision_ops.nms_sweep(boxes, keep0, thr),
                          20, expect={NMS_KERNELS: 2})
    device_ms = _device_ms(None, NMS_KERNELS, times=times)
    torch.cuda.empty_cache()
    return {"case": f"nms_sweep {sets} x {m}", "sets": sets, "m": m,
            "threshold": thr, "mismatched": mismatched,
            "words_mismatched": words_mismatched,
            "kept": int(want.sum()), "candidates": int(keep0.sum()),
            "kept_at_minus_0.1": int(want_neg.sum()),
            "kept_rpn_convention": int(want_rpn.sum()),
            "iou_tests_needed": tests,
            "upper_triangle_tests": sets * m * (m - 1) // 2,
            "max_abs_err": err,
            "ms": _time_ms(lambda: vision_ops.nms_sweep(boxes, keep0, thr),
                           iters=20),
            "device_ms": device_ms,
            "mask_device_ms": _device_ms(None, NMS_KERNELS[0], times=times),
            "scan_device_ms": _device_ms(None, NMS_KERNELS[1], times=times),
            "share_of_bound": bound["bound_ms"] / device_ms,
            "plain_ms": plain_ms,
            "plain_launches": sum(plain_counts.values()) or None,
            "library_ms": None, **bound}


def multiclass_nms_kernel_vs_plain(torch, np, vision_ops, n, classes, priors,
                                   nms_top_k, keep_top_k, seed):
    """The multiclass_nms op on the card through the sweep's kernels against
    the same op through the plain sweep, bit for bit, at SSD-300's
    evaluation shape (phase 13's detection_output): decoded boxes [n,
    priors, 4] and softmax scores [n, classes, priors]."""
    from paddle_tpu_torch.core.registry import get_op_def

    r = np.random.RandomState(seed)
    dev = torch.device("cuda", 0)
    c = r.uniform(0, 1, (n, priors, 2))
    wh = r.uniform(0.02, 0.4, (n, priors, 2))
    boxes = torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                             .astype(np.float32)).to(dev)
    logits = torch.from_numpy(r.normal(0, 2, (n, classes, priors))
                              .astype(np.float32)).to(dev)
    ins = {"BBoxes": [boxes], "Scores": [torch.softmax(logits, 1)]}
    attrs = {"score_threshold": SSD_EVAL["score_thresh"],
             "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
             "nms_threshold": SSD_EVAL["nms_thresh"], "background_label": 0}
    op = get_op_def("multiclass_nms")
    got = op.compute(ins, dict(attrs), dev)["Out"][0]
    kernel = vision_ops.nms_sweep
    vision_ops.nms_sweep = vision_ops.nms_sweep_plain
    try:
        want = op.compute(ins, dict(attrs), dev)["Out"][0]
    finally:
        vision_ops.nms_sweep = kernel
    equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert equal, "multiclass_nms: the kernel's rows differ from the plain"
    return {"shape": [n, classes, priors], "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k, "bit_equal": equal,
            "kept_rows": int((got[..., 0] >= 0).sum())}


def nms_18a(torch, np):
    """18a's kernel check: ``check_nms_sweep`` at every NMS_CASES shape,
    and SSD-300's multiclass_nms through the kernels equal to the plain
    sweep's."""
    from paddle_tpu_torch.ops import vision_ops

    rows = [check_nms_sweep(torch, np, vision_ops, sets, m)
            for m, sets in NMS_CASES]
    for r in rows:
        print("nms " + json.dumps(r), flush=True)
    ssd = multiclass_nms_kernel_vs_plain(
        torch, np, vision_ops, SSD_EVAL["batch"], SSD_CLASSES,
        SSD300_PRIORS, SSD_EVAL["nms_top_k"], SSD_EVAL["keep_top_k"],
        SEED + 81)
    return {"cases": rows, "ssd300_multiclass_nms": ssd}


# --- 18b: the two-stage detector's heads ---


def _pattr(fluid, name):
    return fluid.ParamAttr(name=name)


def fpn_map_sizes(c):
    """(h, w) of P2-P6: the strides' maps of the padded image, P6 a
    stride-2 subsample of P5."""
    sizes = [(c["height"] // s, c["width"] // s) for s in c["strides"][:4]]
    h5, w5 = sizes[-1]
    return sizes + [((h5 - 1) // 2 + 1, (w5 - 1) // 2 + 1)]


def fpn_rcnn(fluid, c):
    """18b's network: FPN Faster R-CNN's heads over fed lateral sums
    (``c`` is FPN or FPN_TOY). The FPN's 3 x 3 output convolutions on
    P2-P5 and P6 (max pool 1, stride 2, of P5); per level anchors
    (anchor_generator: one size a level, three ratios, variances 1) and a
    shared RPN head (3 x 3 conv + relu, 1 x 1 to the objectness logits and
    the deltas), proposals (generate_proposals), the RPN targets over all
    levels (rpn_target_assign) and losses (sigmoid CE and smooth L1,
    sigma 3, over the sampled anchors); collect_fpn_proposals,
    generate_proposal_labels, distribute_fpn_proposals, roi_align on each
    level (BatchId from the fed ``roi_batch``) and the gather back to the
    sampled order; the box head (fc, fc, cls and box) with softmax CE
    (labels -1 ignored) and smooth L1; mask targets
    (generate_mask_labels), computed in the step. Returns {"loss",
    "mask_num", "rois_num", ...}."""
    layers = fluid.layers
    det = layers.detection
    n, ch, a = c["images"], c["channels"], len(c["ratios"])
    sizes = fpn_map_sizes(c)

    def data(name, shape, dtype="float32"):
        return layers.data(name, shape=shape, dtype=dtype,
                           append_batch_size=False)

    lateral = [data(f"fpn_c{l + 2}", [n, ch, c["height"] // s,
                                      c["width"] // s])
               for l, s in enumerate(c["strides"][:4])]
    im_info = data("im_info", [n, 3])
    gt_box = data("gt_box", [n, c["gt"], 4])
    gt_class = data("gt_class", [n, c["gt"]], "int32")
    is_crowd = data("is_crowd", [n, c["gt"]], "int32")
    gt_segms = data("gt_segms", [n, c["gt"], c["parts"], c["verts"], 2])
    poly_lens = data("poly_lens", [n, c["gt"], c["parts"]], "int32")
    b = c["rcnn_batch"]
    roi_batch = data("roi_batch", [n * b], "int32")
    roi_base = data("roi_base", [n * b], "int32")

    p = [layers.conv2d(x, ch, 3, padding=1,
                       param_attr=_pattr(fluid, f"fpn_out{l + 2}.w"),
                       bias_attr=_pattr(fluid, f"fpn_out{l + 2}.b"))
         for l, x in enumerate(lateral)]
    p.append(layers.pool2d(p[-1], 1, "max", 2))
    rois_l, probs_l, cls_all, box_all, anc_all, var_all = ([] for _ in
                                                           range(6))
    for l, (h, w) in enumerate(sizes):
        s = float(c["strides"][l])
        t = layers.conv2d(p[l], ch, 3, padding=1, act="relu",
                          param_attr=_pattr(fluid, "rpn_conv.w"),
                          bias_attr=_pattr(fluid, "rpn_conv.b"))
        cls = layers.conv2d(t, a, 1, param_attr=_pattr(fluid, "rpn_cls.w"),
                            bias_attr=_pattr(fluid, "rpn_cls.b"))
        box = layers.conv2d(t, 4 * a, 1,
                            param_attr=_pattr(fluid, "rpn_bbox.w"),
                            bias_attr=_pattr(fluid, "rpn_bbox.b"))
        anchors, var = det.anchor_generator(
            p[l], anchor_sizes=[c["anchor_sizes"][l]],
            aspect_ratios=list(c["ratios"]), variance=[1.0, 1.0, 1.0, 1.0],
            stride=[s, s], offset=0.5)
        rois, probs, _ = det.generate_proposals(
            layers.sigmoid(cls), box, im_info, anchors, var,
            pre_nms_top_n=c["pre_nms"], post_nms_top_n=c["post_nms"],
            nms_thresh=c["rpn_nms"], min_size=c["min_size"])
        rois_l.append(rois)
        probs_l.append(probs)
        cls_all.append(layers.reshape(layers.transpose(cls, [0, 2, 3, 1]),
                                      [n, -1]))
        box_t = layers.transpose(layers.reshape(box, [n, a, 4, h, w]),
                                 [0, 3, 4, 1, 2])
        box_all.append(layers.reshape(box_t, [n, -1, 4]))
        anc_all.append(layers.reshape(anchors, [-1, 4]))
        var_all.append(layers.reshape(var, [-1, 4]))
    cls_cat = layers.concat(cls_all, axis=1)
    box_cat = layers.concat(box_all, axis=1)
    anc_cat = layers.concat(anc_all, axis=0)
    var_cat = layers.concat(var_all, axis=0)
    label, weight, target, t_weight = det.rpn_target_assign(
        box_cat, cls_cat, anc_cat, var_cat, gt_box, is_crowd=is_crowd,
        im_info=im_info, rpn_batch_size_per_im=c["rpn_batch"],
        rpn_straddle_thresh=0.0, rpn_fg_fraction=c["rpn_fg"],
        rpn_positive_overlap=c["rpn_pos"], rpn_negative_overlap=c["rpn_neg"],
        use_random=c["use_random"])
    norm = 1.0 / (n * c["rpn_batch"])
    rpn_cls = layers.scale(layers.reduce_sum(layers.elementwise_mul(
        layers.sigmoid_cross_entropy_with_logits(cls_cat, label,
                                                 ignore_index=-1), weight)),
        scale=norm)
    rpn_box = layers.scale(layers.reduce_sum(layers.smooth_l1(
        layers.reshape(box_cat, [-1, 4]), layers.reshape(target, [-1, 4]),
        inside_weight=layers.reshape(t_weight, [-1, 4]),
        outside_weight=layers.reshape(t_weight, [-1, 4]), sigma=3.0)),
        scale=norm)

    fpn_rois = det.collect_fpn_proposals(rois_l, probs_l, 2, 6,
                                         c["collect_post"])
    rois, labels, targets, w_in, w_out = det.generate_proposal_labels(
        fpn_rois, gt_class, is_crowd, gt_box, im_info, batch_size_per_im=b,
        fg_fraction=c["rcnn_fg"], fg_thresh=c["fg_thresh"],
        bg_thresh_hi=c["bg_hi"], bg_thresh_lo=c["bg_lo"],
        bbox_reg_weights=c["reg_weights"], class_nums=c["classes"],
        use_random=c["use_random"])
    multi, restore = det.distribute_fpn_proposals(
        rois, c["min_level"], c["max_level"], c["refer_level"],
        c["refer_scale"])
    feats = []
    for l, lv_rois in enumerate(multi):
        f = fluid.layer_helper.append_simple_op("roi_align", {
            "X": p[l], "ROIs": layers.reshape(lv_rois, [-1, 4]),
            "BatchId": roi_batch},
            {"pooled_height": c["roi"], "pooled_width": c["roi"],
             "spatial_scale": 1.0 / c["strides"][l],
             "sampling_ratio": c["sampling_ratio"]})
        feats.append(layers.reshape(f, [n, b, ch * c["roi"] ** 2]))
    flat = layers.reshape(layers.concat(feats, axis=1),
                          [-1, ch * c["roi"] ** 2])
    zero = layers.fill_constant([1], "int32", 0)
    index = layers.elementwise_add(layers.elementwise_max(
        layers.reshape(restore, [-1]), zero), roi_base)
    x = layers.gather(flat, index)
    fc6 = layers.fc(x, c["fc"], act="relu", param_attr=_pattr(fluid, "fc6.w"),
                    bias_attr=_pattr(fluid, "fc6.b"))
    fc7 = layers.fc(fc6, c["fc"], act="relu",
                    param_attr=_pattr(fluid, "fc7.w"),
                    bias_attr=_pattr(fluid, "fc7.b"))
    cls_score = layers.fc(fc7, c["classes"],
                          param_attr=_pattr(fluid, "cls_score.w"),
                          bias_attr=_pattr(fluid, "cls_score.b"))
    bbox_pred = layers.fc(fc7, 4 * c["classes"],
                          param_attr=_pattr(fluid, "bbox_pred.w"),
                          bias_attr=_pattr(fluid, "bbox_pred.b"))
    loss_cls = layers.mean(layers.softmax_with_cross_entropy(
        cls_score, layers.cast(layers.reshape(labels, [-1, 1]), "int64"),
        ignore_index=-1))
    loss_box = layers.scale(layers.reduce_sum(layers.smooth_l1(
        bbox_pred, layers.reshape(targets, [-1, 4 * c["classes"]]),
        inside_weight=layers.reshape(w_in, [-1, 4 * c["classes"]]),
        outside_weight=layers.reshape(w_out, [-1, 4 * c["classes"]]),
        sigma=1.0)), scale=1.0 / (n * b))
    mask_rois, _, mask_int32, mask_num = det.generate_mask_labels(
        im_info, gt_class, is_crowd, gt_segms, rois, labels, c["classes"],
        c["mask_res"], poly_lens=poly_lens)
    loss = layers.sums([rpn_cls, rpn_box, loss_cls, loss_box])
    return {"loss": loss, "rpn_cls": rpn_cls, "rpn_box": rpn_box,
            "loss_cls": loss_cls, "loss_box": loss_box, "mask_num": mask_num,
            "mask_int32": mask_int32, "labels": labels, "rois": rois}


def fpn_feeds(np, c, steps, seed):
    """18b's feeds: the lateral sums N(0, 1); per image 3/4 of ``gt`` rows
    valid (sizes 32-400 px at the full size, scaled with the image), the
    rest zero-area padding, one crowd box, classes in 1..classes-1; each
    gt's polygon a jittered ellipse inside its box (first part, 6 to
    ``verts`` points; second part empty or a triangle); the fixed RoI
    batch ids and gather bases."""
    r = np.random.RandomState(seed)
    n, g, b = c["images"], c["gt"], c["rcnn_batch"]
    scale = c["im_w"] / 1333.0
    out = []
    for _ in range(steps):
        feed = {f"fpn_c{l + 2}": r.normal(0, 1, (
            n, c["channels"], c["height"] // s, c["width"] // s)).astype(
                np.float32) for l, s in enumerate(c["strides"][:4])}
        wh = r.uniform(32, 400, (n, g, 2)) * scale
        x1 = r.uniform(0, 1, (n, g)) * (c["im_w"] - wh[..., 0])
        y1 = r.uniform(0, 1, (n, g)) * (c["im_h"] - wh[..., 1])
        box = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1)
        valid = np.arange(g)[None] < (3 * g) // 4
        box = np.where(valid[..., None], box, 0.0)
        cls = np.where(valid, r.randint(1, c["classes"], (n, g)), 0)
        crowd = np.zeros((n, g), np.int32)
        crowd[:, 1] = 1
        segs = np.zeros((n, g, c["parts"], c["verts"], 2))
        lens = np.zeros((n, g, c["parts"]), np.int32)
        for i, j in zip(*np.nonzero(valid)):
            k = r.randint(6, c["verts"] + 1)
            t = np.sort(r.uniform(0, 2 * np.pi, k))
            cx, cy = (box[i, j, 0] + box[i, j, 2]) / 2, \
                (box[i, j, 1] + box[i, j, 3]) / 2
            rx, ry = (box[i, j, 2] - box[i, j, 0]) / 2, \
                (box[i, j, 3] - box[i, j, 1]) / 2
            jit = r.uniform(0.6, 1.0, k)
            segs[i, j, 0, :k] = np.stack([cx + rx * jit * np.cos(t),
                                          cy + ry * jit * np.sin(t)], -1)
            lens[i, j, 0] = k
            if c["parts"] > 1 and r.uniform() < 0.5:
                segs[i, j, 1, :3] = [[box[i, j, 0], box[i, j, 1]],
                                     [cx, box[i, j, 1]], [box[i, j, 0], cy]]
                lens[i, j, 1] = 3
        feed.update({
            "im_info": np.tile([[c["im_h"], c["im_w"], 1.0]], (n, 1)).astype(
                np.float32),
            "gt_box": box.astype(np.float32),
            "gt_class": cls.astype(np.int32), "is_crowd": crowd,
            "gt_segms": segs.astype(np.float32), "poly_lens": lens,
            "roi_batch": np.repeat(np.arange(n), b).astype(np.int32),
            "roi_base": np.repeat(np.arange(n) * 4 * b, b).astype(np.int32)})
        out.append(feed)
    return out


def fpn_18b(torch, np, fluid, fa):
    """18b: FPN Faster R-CNN's heads at Detectron's published widths
    (``fpn_rcnn`` on FPN): FPN_STEPS steps on a repeated batch, eager and
    captured equal bit for bit and the loss falling (``train_family``),
    the captured step timed (wall and device ms, launches, idle share,
    images/s, kernel families) with the NMS sweep's launches a step
    (counted in every turn, and traced) and device ms a step; and two f32
    steps of FPN_TOY on the card against the CPU (``family_vs_cpu``).
    Returns (row, the sweep's launches in a captured turn's window)."""
    feeds = fpn_feeds(np, FPN, 1, SEED)

    def build():
        return fpn_rcnn(fluid, FPN)

    def make_opt():
        return fluid.optimizer.Momentum(FPN_LR, momentum=FPN_MOMENTUM)

    window = 4
    row, _ = train_family(torch, np, fluid, fa, "fpn_rcnn_heads", build,
                          make_opt, feeds, amp=False, items=FPN["images"],
                          unit="images", window=window,
                          equal_steps=FPN_STEPS,
                          watch={"nms_sweep": NMS_KERNELS})
    _falls(np, "fpn_rcnn_heads", row)
    torch.cuda.empty_cache()
    w = row["watch"]["nms_sweep"]
    # one call a level a step, counted in every turn; its two kernels
    # traced
    assert all(n == len(FPN["strides"]) for mode in w["launches_per_step"]
               .values() for n in mode), w
    assert w["traced_launches_per_step"] == 2 * len(FPN["strides"]), w
    row["nms"] = {"nms_launches_per_step": w["traced_launches_per_step"],
                  "nms_device_ms": w["device_ms"],
                  "nms_share": w["device_ms"] / row["step_device_ms"]}
    # the main path's launches: the second captured turn's window
    launches = w["launches_per_step"]["captured"][1] * window
    row["reduced"] = ("the ResNet-50-FPN backbone (not a model of the JAX "
                      "package): its lateral sums P2-P5 fed from a seed; "
                      f"{FPN['gt']} padded gt rows, synthetic polygons")
    row["anchors_per_image"] = len(FPN["ratios"]) * sum(
        h * w for h, w in fpn_map_sizes(FPN))

    def toy():
        return fpn_rcnn(fluid, FPN_TOY)

    row["vs_cpu"] = family_vs_cpu(
        torch, np, fluid, "fpn_rcnn_toy", toy, make_opt,
        fpn_feeds(np, FPN_TOY, 2, SEED + 1),
        ["fpn_out2.w@GRAD", "rpn_conv.w@GRAD", "rpn_cls.w@GRAD",
         "fc6.w@GRAD", "cls_score.w@GRAD", "bbox_pred.w@GRAD"])
    return row, launches


# --- 18c: YOLOv3 ---


def yolov3_heads(fluid, c, is_test=False):
    """18c's network: the three YOLOv3 output convolutions (1 x 1 to 3 x
    (5 + classes) channels) over fed Darknet maps at strides 32, 16, 8;
    training: the sum of the three yolov3_loss ops (the paper's anchors
    and masks, ignore_thresh, label smoothing), mean over the batch;
    ``is_test``: yolo_box on each map, concatenated, multiclass_nms over
    every class (background_label -1). Returns {"loss"} or {"nmsed"}."""
    layers = fluid.layers
    det = layers.detection
    n, k = c["batch"], 3 * (5 + c["classes"])

    def data(name, shape, dtype="float32"):
        return layers.data(name, shape=shape, dtype=dtype,
                           append_batch_size=False)

    outs = []
    for l, (ch, s) in enumerate(zip(c["channels"], c["strides"])):
        x = data(f"yolo_c{l}", [n, ch, c["size"] // s, c["size"] // s])
        outs.append(layers.conv2d(x, k, 1,
                                  param_attr=_pattr(fluid, f"yolo_out{l}.w"),
                                  bias_attr=_pattr(fluid, f"yolo_out{l}.b")))
    anchors = list(c["anchors"])
    if not is_test:
        gt_box = data("gt_box", [n, c["gt"], 4])
        gt_label = data("gt_label", [n, c["gt"]], "int32")
        losses = [det.yolov3_loss(o, gt_box, gt_label, anchors, list(mask),
                                  c["classes"], c["ignore_thresh"], s,
                                  use_label_smooth=True)
                  for o, mask, s in zip(outs, c["masks"], c["strides"])]
        return {"loss": layers.mean(layers.sums(losses))}
    img_size = data("img_size", [n, 2], "int32")
    boxes, scores = [], []
    for o, mask, s in zip(outs, c["masks"], c["strides"]):
        b, sc = layers.yolo_box(o, img_size,
                                [v for i in mask for v in anchors[2 * i:
                                                                  2 * i + 2]],
                                c["classes"], c["conf_thresh"], s)
        boxes.append(b)
        scores.append(sc)
    nmsed = layers.multiclass_nms(
        layers.concat(boxes, axis=1),
        layers.transpose(layers.concat(scores, axis=1), [0, 2, 1]),
        score_threshold=c["conf_thresh"], nms_top_k=c["nms_top_k"],
        keep_top_k=c["keep_top_k"], nms_threshold=c["nms_thresh"],
        background_label=-1)
    return {"nmsed": nmsed}


def yolo_feeds(np, c, steps, seed, is_test=False):
    """18c's feeds: the Darknet maps N(0, 1) (at a quarter of the scale,
    so a random head's boxes stay in range); 1 to 50 gt rows an image,
    centre-format and normalized, sizes 0.02-0.6 of the image, the rest
    zero padding, labels in 0..classes-1; the image size."""
    r = np.random.RandomState(seed)
    n, g = c["batch"], c["gt"]
    out = []
    for _ in range(steps):
        feed = {f"yolo_c{l}": r.normal(0, 0.25, (
            n, ch, c["size"] // s, c["size"] // s)).astype(np.float32)
            for l, (ch, s) in enumerate(zip(c["channels"], c["strides"]))}
        if is_test:
            feed["img_size"] = np.full((n, 2), c["size"], np.int32)
        else:
            box = np.concatenate([r.uniform(0.05, 0.95, (n, g, 2)),
                                  r.uniform(0.02, 0.6, (n, g, 2))], -1)
            valid = np.arange(g)[None] < r.randint(1, g + 1, (n, 1))
            feed["gt_box"] = np.where(valid[..., None], box, 0.0).astype(
                np.float32)
            feed["gt_label"] = np.where(valid, r.randint(
                0, c["classes"], (n, g)), 0).astype(np.int32)
        out.append(feed)
    return out


def yolo_18c(torch, np, fluid, fa):
    """18c: YOLOv3 at Darknet's yolov3.cfg widths: YOLO_STEPS steps on a
    repeated batch, eager and captured equal bit for bit, the loss
    falling, the captured step timed (``train_family``); the eval path
    (``yolov3_heads(is_test=True)``: 640 candidate sets of 1000 through the
    sweep kernel) timed in turns, eager and captured, with its launches
    (the counts set to 0 just before, read just after); and two f32 steps
    of YOLO_TOY on the card against the CPU. Returns (row, the sweep's
    launches in the eval window)."""
    from paddle_tpu_torch import kernels

    feeds = yolo_feeds(np, YOLO, 1, SEED)

    def build():
        return yolov3_heads(fluid, YOLO)

    def make_opt():
        return fluid.optimizer.Momentum(YOLO_LR, momentum=YOLO_MOMENTUM)

    row, _ = train_family(torch, np, fluid, fa, "yolov3_heads", build,
                          make_opt, feeds, amp=False, items=YOLO["batch"],
                          unit="images", window=4, equal_steps=YOLO_STEPS)
    _falls(np, "yolov3_heads", row)
    torch.cuda.empty_cache()
    row["reduced"] = ("the Darknet-53 backbone and the detection blocks "
                      "before the output convolutions (not a model of the "
                      "JAX package): their maps fed from a seed")

    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        model = yolov3_heads(fluid, YOLO, is_test=True)
    startup.random_seed = main_prog.random_seed = SEED
    dev = torch.device("cuda", 0)
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in yolo_feeds(np, YOLO, 1, SEED + 2, True)[0].items()}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    sets = YOLO["batch"] * YOLO["classes"]
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        first = exe.run(main_prog, feed=feed, fetch_list=[model["nmsed"]],
                        use_program_cache=False)[0]

        def turn(eager):
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            for _ in range(3):
                got = exe.run(main_prog, feed=feed,
                              fetch_list=[model["nmsed"]],
                              use_program_cache=not eager)[0]
            torch.cuda.synchronize()
            assert np.array_equal(got, first), "yolo eval: rows differ"
            return {"ms_a_batch": (time.perf_counter() - t0) / 3 * 1e3,
                    "nms_launches_a_batch":
                        kernels.launch_counts["nms_sweep"] / 3}

        turns = _turns(turn)
        launches = round(turns["eager"][-1]["nms_launches_a_batch"] * 3)
        times = _device_times(lambda: exe.run(
            main_prog, feed=feed, fetch_list=[model["nmsed"]]), iters=2,
            replay=True)
    exe.close()
    nms_ms = _device_ms(None, NMS_KERNELS, times=times)
    row["eval"] = {
        "batch": YOLO["batch"], "candidate_sets": sets,
        "nms_top_k": YOLO["nms_top_k"], "keep_top_k": YOLO["keep_top_k"],
        "kept_rows": int((first[..., 0] >= 0).sum()),
        "turns": _turn_summary(turns, ("ms_a_batch", "nms_launches_a_batch",
                                       "peak_mem_gib")),
        "device_ms_a_batch": sum(times.values()), "nms_device_ms": nms_ms,
        "top_kernels_ms": [[k[:80], ms] for k, ms in sorted(
            times.items(), key=lambda kv: -kv[1])[:6]]}
    assert row["eval"]["turns"]["nms_launches_a_batch"]["eager"][0] == 1
    torch.cuda.empty_cache()

    def toy():
        return yolov3_heads(fluid, YOLO_TOY)

    row["vs_cpu"] = family_vs_cpu(
        torch, np, fluid, "yolov3_toy", toy, make_opt,
        yolo_feeds(np, YOLO_TOY, 2, SEED + 1),
        ["yolo_out0.w@GRAD", "yolo_out1.w@GRAD", "yolo_out2.w@GRAD"])
    return row, launches


# --- 18d: SSD-300's VOC evaluation ---


def ssd_eval_program(fluid, SSD, batch, d=None):
    """18d's evaluation program: SSD-300's network (``ssd300_net``, the
    net of ``get_ssd300_model``), ``detection_output`` and
    ``metrics.DetectionMAP`` with gt_difficult; with ``d`` (the number of
    detection rows) the metric alone over fed detections (its CPU twin).
    Returns (main, startup, {"nmsed", "cur", "accum"}, the metric)."""
    layers = fluid.layers
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        def data(name, shape, dtype="float32"):
            return layers.data(name, shape=shape, dtype=dtype,
                               append_batch_size=False)

        if d is None:
            img = data("image", [batch, 3, 300, 300])
            locs, confs, boxes, variances = SSD.ssd300_net(img, SSD_CLASSES)
            nmsed = layers.detection.detection_output(
                locs, layers.softmax(confs), boxes, variances,
                nms_threshold=SSD_EVAL["nms_thresh"],
                nms_top_k=SSD_EVAL["nms_top_k"],
                keep_top_k=SSD_EVAL["keep_top_k"],
                score_threshold=SSD_EVAL["score_thresh"])
        else:
            nmsed = data("nmsed", [batch, d, 6])
        metric = fluid.metrics.DetectionMAP(
            nmsed, data("gt_label", [batch, SSD_GT, 1], "int64"),
            data("gt_box", [batch, SSD_GT, 4]),
            data("gt_difficult", [batch, SSD_GT, 1], "int64"),
            class_num=SSD_CLASSES, overlap_threshold=SSD_EVAL["overlap"],
            evaluate_difficult=False, ap_version=SSD_EVAL["ap_version"])
        cur, accum = metric.get_map_var()
    startup.random_seed = main_prog.random_seed = SEED
    return main_prog, startup, {"nmsed": nmsed, "cur": cur,
                                "accum": accum}, metric


def ssd_eval_feeds(np, batch, batches, seed):
    """SSD-300 evaluation batches: ``ssd300_feed``'s images and gt rows,
    padding rows labelled -1 (the metric's padding), a fifth of the real
    gts difficult."""
    out = []
    for i in range(batches):
        f = ssd300_feed(np, batch, seed + i)
        pad = (f["gt_box"] == 0).all(-1)
        r = np.random.RandomState(seed + 100 + i)
        out.append({
            "image": f["image"],
            "gt_box": f["gt_box"],
            "gt_label": np.where(pad, -1, f["gt_label"])[..., None]
            .astype(np.int64),
            "gt_difficult": (r.uniform(0, 1, pad.shape)
                             < SSD_EVAL["difficult_share"])[..., None]
            .astype(np.int64)})
    return out


def _metric_states(program, scope):
    """The DetectionMAP's persistable states: {name: numpy array}."""
    return {v.name: scope.find_var(v.name).cpu().numpy()
            for v in program.global_block().vars.values()
            if v.persistable and v.name.startswith("detection_map_")}


def ssd_eval_18d(torch, np, fluid):
    """18d: SSD-300's VOC evaluation on the card: SSD_EVAL batches of 32
    through ``ssd_eval_program`` with the metric accumulating, a reset,
    the first batch again; each batch's current and accumulated mAP and
    the metric's binned states equal, bit for bit, to the metric's program
    on the CPU fed the card's detections; ms a batch (a second pass, each
    batch a replay of the captured program), and a replayed batch's device
    ms traced, the sweep's kernels' part of it. Returns (row, the sweep's
    launches)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import ssd as SSD

    b = SSD_EVAL["batch"]
    feeds = ssd_eval_feeds(np, b, SSD_EVAL["batches"], SEED + 40)
    order = list(range(len(feeds))) + [0]
    main_prog, startup, v, metric = ssd_eval_program(fluid, SSD, b)
    dev = torch.device("cuda", 0)
    gpu_feeds = [{k: torch.from_numpy(x).to(dev) for k, x in f.items()}
                 for f in feeds]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    card, scope = [], fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        kernels.reset_counts()
        for step, i in enumerate(order):
            if step == len(feeds):
                metric.reset(exe)
            nmsed, cur, acc = exe.run(main_prog, feed=gpu_feeds[i],
                                      fetch_list=[v["nmsed"], v["cur"],
                                                  v["accum"]])
            card.append((nmsed, float(cur), float(acc),
                         _metric_states(main_prog, scope)))
        torch.cuda.synchronize()
        launches = kernels.launch_counts["nms_sweep"]
        # the same fetches as above: every timed batch a replay of the
        # captured program
        metric.reset(exe)
        t0 = time.perf_counter()
        for f in gpu_feeds:
            exe.run(main_prog, feed=f, fetch_list=[v["nmsed"], v["cur"],
                                                   v["accum"]])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / len(gpu_feeds) * 1e3
        # a batch's device time and the sweep's share of it (replays)
        times = _device_times(lambda: exe.run(
            main_prog, feed=gpu_feeds[0], fetch_list=[
                v["nmsed"], v["cur"], v["accum"]]), iters=2, replay=True)
    exe.close()
    torch.cuda.empty_cache()
    assert launches == len(order), launches
    c_main, c_start, cv, c_metric = ssd_eval_program(
        fluid, SSD, b, d=SSD_EVAL["keep_top_k"])
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    rows = []
    with fluid.scope_guard(cpu_scope):
        cpu_exe.run(c_start)
        for step, (i, (nmsed, cur, acc, states)) in enumerate(
                zip(order, card)):
            if step == len(feeds):
                c_metric.reset(cpu_exe)
            feed = dict(feeds[i], nmsed=nmsed)
            feed.pop("image")
            c_cur, c_acc = cpu_exe.run(c_main, feed=feed,
                                       fetch_list=[cv["cur"], cv["accum"]])
            c_states = _metric_states(c_main, cpu_scope)
            assert float(c_cur) == cur and float(c_acc) == acc, (
                step, cur, float(c_cur), acc, float(c_acc))
            assert sorted(c_states) == sorted(states)
            for n in states:
                assert np.array_equal(c_states[n], states[n]), (step, n)
            rows.append({"batch": i, "cur_map": cur, "accum_map": acc,
                         "detections": int((nmsed[..., 0] >= 0).sum())})
    cpu_exe.close()
    return {"batch": b, "batches": rows, "card_equals_cpu": True,
            "state_vars": sorted(card[0][3]), "ms_a_batch": ms,
            "device_ms_a_batch": sum(times.values()),
            "nms_device_ms": _device_ms(None, NMS_KERNELS, times=times),
            "nms_launches": launches, "ap_version": SSD_EVAL["ap_version"],
            "reduced": "random SSD-300 weights from a seed, synthetic VOC-"
                       "shaped batches (bench_family.py's)"}, launches


def vision_detection(torch, np, fluid, fa):
    """Phase 18: the slice's op types card against CPU and the NMS sweep's
    kernels against its plain version (18a), FPN Faster R-CNN's heads
    (18b), YOLOv3 (18c), SSD-300's VOC evaluation (18d). Returns
    ({sub-phase: row}, the sweep's launches on the main paths 18b-18d); a
    line names each sub-phase before it runs, and its ``vision_`` line
    follows."""
    out = {"t0": time.perf_counter()}

    def done(key, row):
        row["at_s"] = time.perf_counter() - out["t0"]
        out[key] = row
        print(f"vision_{key} " + json.dumps(row), flush=True)

    print("phase 18a: the slice's 31 op types card against CPU in f64; "
          "the NMS sweep's kernels against its plain version at m "
          f"{[m for m, _ in NMS_CASES]}",
          flush=True)
    row = vision_ops_vs_cpu_18a(torch, np)
    row["nms"] = nms_18a(torch, np)
    done("18a", row)
    launches = {}
    print(f"phase 18b: FPN Faster R-CNN heads (Detectron R-50-FPN_1x "
          f"widths), {FPN['images']} images of {FPN['height']} x "
          f"{FPN['width']}, {FPN_STEPS} steps; the backbone's lateral sums "
          f"fed (reduced: not a model of the JAX package)", flush=True)
    row, launches["18b"] = fpn_18b(torch, np, fluid, fa)
    done("18b", row)
    print(f"phase 18c: YOLOv3 heads at {YOLO['size']} x {YOLO['size']}, "
          f"batch {YOLO['batch']}, {YOLO_STEPS} steps; eval over "
          f"{YOLO['batch'] * YOLO['classes']} candidate sets; Darknet-53 "
          f"maps fed (reduced: not a model of the JAX package)", flush=True)
    row, launches["18c"] = yolo_18c(torch, np, fluid, fa)
    done("18c", row)
    print(f"phase 18d: SSD-300 VOC evaluation, {SSD_EVAL['batches']} "
          f"batches of {SSD_EVAL['batch']} and a reset, card = CPU",
          flush=True)
    row, launches["18d"] = ssd_eval_18d(torch, np, fluid)
    done("18d", row)
    out["seconds"] = time.perf_counter() - out.pop("t0")
    return out, launches


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
    # BERT-base's self-attention (phase 13a): b 64, t 128, 12 heads of 64,
    # the q/k/v views of the fused projection, a key-pad bias, dropout 0.1
    fwd.append(_case(BERT_ATTENTION_CASE, bf16, BERT_B, BERT_T, BERT_T,
                     "pad_b", True, 0.1, h=12, dh=64, split=True,
                     repeat=True))
    # the beam decode loop's two attention shapes (phase 12e reads them):
    # the decoder's self-attention over b * K rows of max_len (the causal
    # mask folded into the row bias) and its cross-attention
    fwd += [_case(name, f32, BEAM_SOURCES * BEAM_K, BEAM_LEN, BEAM_LEN, bias)
            for name, bias in zip(BEAM_ATTENTION_CASES,
                                  ("causal_pad", "pad_b"))]
    bwd = [c for c in fwd if c["name"].startswith(("train", "t1024",
                                                   "t4096", "t2048",
                                                   "bhtd", "dh256",
                                                   "bert"))] + [
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
        from paddle_tpu_torch.ops import nn_ops, vision_ops
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

    # 2. build every kernel source, one nvcc each, all started together.
    # The attention sources take minutes; the phases that launch none of
    # their kernels (17, 3c, 7, 8, 15) run on the card meanwhile, each
    # after the sources it launches have built
    sources = [fa._FWD_SOURCE, fa._BWD_SOURCE, fa._MASK_SOURCE, cb.SOURCE,
               gc.SOURCE, aa.SOURCE, vision_ops.NMS_SOURCE]
    build_pool = ThreadPoolExecutor(len(sources))
    builds = {src: build_pool.submit(kernels.build, src) for src in sources}
    reported = set()

    def built(*names):
        """Wait for ``names``' builds and print each one's line once."""
        for source in names:
            result = builds[source].result()
            if source in reported:
                continue
            reported.add(source)
            if result is None:
                print(f"build {source}: cached", flush=True)
            else:
                log, seconds = result
                print(f"build {source}: {seconds:.2f} s\n"
                      f"{_ptxas_report(log)}", flush=True)

    phase_done("build_started")

    # 17. the op-library slice: its 88 op types card against CPU (17a),
    # the N-gram model's four large-vocabulary heads at 10,000 words
    # (17b), the DCGAN generator at its published widths (17c)
    lib17 = op_library(torch, np, fluid, fa)
    b17, c17 = lib17["17b"], lib17["17c"]
    print(f"op library on {card}: {lib17['17a']['op_types']} op types card "
          f"= CPU; N-gram heads at {NGRAM_VOCAB} words, batch {NGRAM_B}: "
          + ", ".join(f"{h} {b17[h]['step_ms']:.2f} ms a step "
                      f"({b17[h]['step_device_ms']:.2f} device, "
                      f"{b17[h]['launches_per_step']:.0f} launches, "
                      f"{b17[h]['examples_per_s']:.0f} examples/s)"
                      for h in NGRAM_HEADS)
          + f"; DCGAN generator b {DCGAN_B} "
          f"{c17['f32']['step_ms']:.2f} / {c17['bf16']['step_ms']:.2f} ms a "
          f"step f32 / bf16 ({c17['f32']['images_per_s']:.0f} / "
          f"{c17['bf16']['images_per_s']:.0f} images/s); captured = eager "
          f"bit for bit in all six; step 1 = CPU (DCGAN at batch "
          f"{DCGAN_CPU_B}); phase 17 {lib17['seconds']:.1f} s", flush=True)

    phase_done("17")

    built(vision_ops.NMS_SOURCE)
    # 18. the vision and detection slice: its 31 op types card against CPU
    # and the NMS sweep's kernels against its plain version (18a), FPN Faster
    # R-CNN's heads (18b), YOLOv3 (18c), SSD-300's VOC evaluation (18d)
    vis18, nms_launches = vision_detection(torch, np, fluid, fa)
    b18, c18, d18 = vis18["18b"], vis18["18c"], vis18["18d"]
    print(f"vision and detection on {card}: {vis18['18a']['op_types']} op "
          f"types card = CPU, the NMS sweep = plain bit for bit at "
          f"{len(vis18['18a']['nms']['cases'])} shapes; FPN heads "
          f"{b18['step_ms']:.1f} ms a step ({b18['step_device_ms']:.1f} "
          f"device, {b18['images_per_s']:.1f} images/s, NMS "
          f"{b18['nms']['nms_device_ms']:.3f} ms a step); YOLOv3 "
          f"{c18['step_ms']:.1f} ms a step, eval "
          f"{min(c18['eval']['turns']['ms_a_batch']['captured']):.1f} ms a "
          f"batch of {YOLO['batch']}; SSD-300 eval "
          f"{d18['ms_a_batch']:.1f} ms a batch (NMS "
          f"{d18['nms_device_ms']:.3f}), mAP card = CPU; captured = "
          f"eager bit for bit in both trainings; phase 18 "
          f"{vis18['seconds']:.1f} s", flush=True)

    phase_done("18")

    built(cb.SOURCE, gc.SOURCE, aa.SOURCE)
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

    built(fa._MASK_SOURCE)  # the dropout op's kernel: 7 and 15 launch it
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
        main_prog, startup, model = _build_vision(fluid, build, VISION_LR,
                                                  amp=False)
        state = card_startup_state(fluid, startup)
        r = np.random.RandomState(SEED)
        feed = {"data": r.uniform(-1, 1, (4, 3, 64, 64)).astype(np.float32),
                "label": r.randint(0, 1000, (4, 1)).astype(np.int64)}
        # f32: the classifier head's gradients held (see TOL_VISION_F32)
        for double in (False, True):
            c8 = step_vs_cpu(np, fluid, name, main_prog, state,
                             model["loss"], feed, names,
                             names if double else head,
                             TOL_VISION_F64 if double else TOL_VISION_F32,
                             double=double)[0]
            print("vision_vs_cpu " + json.dumps(c8), flush=True)
        torch.cuda.empty_cache()

    phase_done("8")

    # 15. the recurrent family and the rest of the benchmark's zoo:
    # stacked_dynamic_lstm (15a), machine_translation (15b), VGG-16 f32 and
    # bf16 (15c), MNIST (15d) trained; VGG-16 served at mb 64 (15e); the
    # rnn ops and each model small against the CPU (15f)
    with tempfile.TemporaryDirectory() as tmp:
        zoo15 = zoo(torch, np, fluid, fa, tmp)
    a15, b15, e15 = zoo15["15a"], zoo15["15b"], zoo15["15e"]
    print(f"benchmark zoo on {card}: stacked_dynamic_lstm "
          f"{a15['examples_per_s']:.0f} examples/s ({a15['step_ms']:.2f} ms "
          f"a step, {a15['launches_per_step']:.0f} launches); "
          f"machine_translation {b15['examples_per_s']:.0f} examples/s "
          f"({b15['step_ms']:.2f} ms, {b15['launches_per_step']:.0f} "
          f"launches); VGG-16 {zoo15['15c_f32']['examples_per_s']:.1f} / "
          f"{zoo15['15c_bf16']['examples_per_s']:.1f} images/s f32 / bf16; "
          f"MNIST {zoo15['15d_conv']['examples_per_s']:.0f} / "
          f"{zoo15['15d_mlp']['examples_per_s']:.0f} examples/s conv / "
          f"MLP; VGG-16 Predictor at mb 64 "
          f"{e15['float32']['ms_a_batch']:.2f} / "
          f"{e15['bfloat16']['ms_a_batch']:.2f} ms a batch f32 / bf16; "
          f"captured = eager bit for bit in all six", flush=True)

    phase_done("15")

    built(*sources)
    build_pool.shutdown()

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

    # 10. the serving planes: supervised restart, wedge, containment, OOM,
    # telemetry cost and numerics, each on a fresh supervisor or engine
    with tempfile.TemporaryDirectory() as tmp:
        planes, p10_short, p10_long, p10_recipe = serving_planes(
            torch, np, fluid, T, fa, tmp)
    p10_dropout = kernels.launch_counts["dropout"]
    for key in ("10a", "10b", "10c", "10d"):
        print(f"serving_planes_{key} " + json.dumps(planes[key]),
              flush=True)
    for row in planes["10e"]:
        print("serving_telemetry " + json.dumps(row), flush=True)
    print("numerics_recipe " + json.dumps(planes["10f"]), flush=True)
    a10, f10 = planes["10a"], planes["10f"]
    print(f"serving planes on {card}: restart to first replayed token "
          f"{a10['failure_to_first_replayed_token_s']:.3f} s, reserved "
          f"after restarts 1/3 {a10['reserved_gib_after_restarts_1_2_3']}"
          f" GiB; host share of a decode step "
          f"{[round(r['host_share'], 3) for r in planes['10e']]} (128, "
          f"1024); numerics_stats adds {f10['added_device_ms']:.3f} ms "
          f"and {f10['added_launches']} launches a recipe step "
          f"({f10['instrumented_vars']} vars)", flush=True)

    phase_done("10")

    # 11. the fleet front door: replicas side by side on the card under
    # the capture gate, the kill drills, a rollout, autoscale
    with tempfile.TemporaryDirectory() as tmp:
        fleet11, p11 = fleet_front_door(torch, np, fluid, T, fa, tmp)
    for key in ("11a", "11b", "11c", "11d", "11e"):
        print(f"fleet_{key} " + json.dumps(fleet11[key]), flush=True)
    a11, d11, e11 = fleet11["11a"], fleet11["11d"], fleet11["11e"]
    print(f"serving fleet on {card}: {a11['replicas']} replicas "
          f"{a11['fleet_tokens_per_s']:.1f} tokens/s against one engine's "
          f"{a11['one_engine_tokens_per_s']:.1f} at {a11['requests']} "
          f"requests; scale-up to first token "
          f"{d11['scale_up_to_first_token_s']:.3f} s "
          f"({d11['spin_up_lowerings']} lowerings, "
          f"{d11['spin_up_graph_captures']} captures); {e11['captures']} "
          f"captures, {e11['captures_waited']} waited (longest "
          f"{e11['longest_capture_wait_s']:.3f} s), "
          f"{e11['capture_failures']} failed", flush=True)

    phase_done("11")

    # 12. beam-search translation: the while op's body as a captured
    # graph, against the serving engine, eager, and the CPU; (12e) the
    # fwd_kernel at the decode loop's two attention shapes, as phase 3
    # held it against its plain version, beside phase 12's launches
    beam12, p12 = beam_translate(torch, np, fluid, T, fa, serving)
    for key in ("12a", "12b", "12c", "12c_greedy", "12d"):
        print(f"beam_{key} " + json.dumps(beam12[key]), flush=True)
    print("phase 12e: fwd_kernel at the decode loop's attention shapes",
          flush=True)
    e12 = {name: {k: fwd_results[name][k] for k in (
        "route", "kernels", "err_out", "err_lse", "ms", "device_ms",
        "plain_ms", "library_ms", "bound_ms", "bound_by")}
        for name in BEAM_ATTENTION_CASES}
    assert all(r["route"] == "small" and r["kernels"] == ["fwd_kernel"]
               for r in e12.values()), e12
    print("beam_12e " + json.dumps({"cases": e12,
                                    "fwd_kernel_launches": p12}),
          flush=True)
    a12, b12, c12 = beam12["12a"], beam12["12b"], beam12["12c"]
    print(f"beam search on {card}: beam 4 over {BEAM_SOURCES} sources, "
          f"{b12['steps']} steps, "
          f"{b12['turns']['ms_a_step']['eager'][0]:.2f} ms a step eager, "
          f"{b12['turns']['ms_a_step']['captured'][1]:.2f} captured "
          f"({b12['profile']['eager']['launches_a_step']:.0f} / "
          f"{b12['profile']['captured']['launches_a_step']:.0f} launches "
          f"a step); beam 1 = the serving engine on "
          f"{BEAM_SOURCES - a12['diverged_rows']} of {BEAM_SOURCES} rows; "
          f"end_id {c12['end_id']}: {c12['ended_hypotheses']} of "
          f"{BEAM_SOURCES * BEAM_K} hypotheses end, {c12['steps']} steps; "
          f"greedy early exit after {beam12['12c_greedy']['steps']} steps; "
          f"{p12} fwd_kernel launches", flush=True)

    phase_done("12")

    # 13. the benchmark's other model families at its configurations:
    # BERT-base, DeepFM dense and row-sparse, SSD-300; (13d) each at two
    # layers or blocks against the CPU
    fam13 = families(torch, np, fluid, fa)
    a13, c13 = fam13["13a"], fam13["13c"]
    fm_dense, fm_sparse = fam13["13b_dense"], fam13["13b_sparse"]
    print(f"model families on {card}: BERT-base {a13['tokens_per_s']:.0f} "
          f"tokens/s ({a13['step_ms']:.2f} ms a step, "
          f"{a13['bf16_peak_share']:.3f} of the bf16 dense peak); DeepFM "
          f"{fm_dense['examples_per_s']:.0f} examples/s dense, "
          f"{fm_sparse['examples_per_s']:.0f} sparse; SSD-300 "
          f"{c13['images_per_s']:.1f} images/s ({c13['step_ms']:.1f} ms a "
          f"step); captured = eager bit for bit in all four", flush=True)

    phase_done("13")

    # 14. the training runtime: Transformer-base through contrib.Trainer
    # from dataset.wmt16 with prefetch and async checkpoints (14a), sync
    # against pipelined (14b), crash and resume (14c), captures beside a
    # streaming loader (14d), train_from_dataset (14e)
    with tempfile.TemporaryDirectory() as tmp:
        rt14, p14 = training_runtime(torch, np, fluid, T, fa, tmp)
    for key in ("14a", "14b", "14c", "14d", "14e"):
        print(f"runtime_{key} " + json.dumps(rt14[key]), flush=True)
    a14, b14 = rt14["14a"], rt14["14b"]
    print(f"training runtime on {card}: Trainer step "
          f"{a14['step_ms']:.1f} ms wall, {a14['step_device_ms']:.1f} ms "
          f"device (idle share {a14['idle_share']:.3f}), "
          f"{a14['target_tokens_per_s']:.0f} target tokens/s, peak reserved "
          f"{a14['peak_reserved_gib']:.2f} GiB, beside phase 5's run_steps "
          f"step {t['step_ms']:.1f} ms wall, {t['step_device_ms']:.1f} ms "
          f"device; snapshots "
          f"{[round(s['snapshot_s'] * 1e3, 1) for s in a14['saves']]} ms, "
          f"background writes "
          f"{[round(s['write_s'], 2) for s in a14['saves']]} s; sync / "
          f"pipelined {b14['transformer']['sync_over_pipelined']:.3f} "
          f"(Transformer), {b14['mlp']['sync_over_pipelined']:.3f} (MLP); "
          f"resume bit-equal, no capture failure", flush=True)

    phase_done("14")

    # 16. structured control flow, CRF / CTC and the label-semantic-roles
    # chapter: db_lstm trained at the book's widths (16a),
    # transformer.build_scan at Transformer-base (16b), the drills card
    # against CPU (16c)
    with tempfile.TemporaryDirectory() as tmp:
        cf16, p16 = control_flow(torch, np, fluid, T, fa, tmp)
    a16, b16 = cf16["16a"], cf16["16b"]
    print(f"control flow on {card}: SRL db_lstm "
          f"{a16['examples_per_s']:.0f} examples/s ({a16['step_ms']:.2f} ms "
          f"a step, {a16['step_device_ms']:.2f} device, "
          f"{a16['launches_per_step']:.0f} launches, chunk F1 "
          f"{a16['chunks']['f1']:.3f}); build_scan "
          f"{min(b16['unroll'][1]['step_ms']):.1f} ms a step (unroll 6 "
          f"{min(b16['unroll'][6]['step_ms']):.1f}) beside build()'s "
          f"{t['step_ms']:.1f}; captured = eager bit for bit in both; "
          f"{len(cf16['16c'])} drills card = CPU", flush=True)

    phase_done("16")

    print("phase_seconds " + json.dumps(phase_s), flush=True)
    assert phase_s["11"] < 150, phase_s["11"]
    assert phase_s["12"] < 120, phase_s["12"]
    assert phase_s["13"] < 150, phase_s["13"]
    assert phase_s["14"] < 150, phase_s["14"]
    assert phase_s["15"] < 150, phase_s["15"]
    assert phase_s["16"] < 120, phase_s["16"]
    assert phase_s["17"] < 120, phase_s["17"]
    assert phase_s["18"] < 120, phase_s["18"]

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

    bert_fwd = fwd_results[BERT_ATTENTION_CASE]
    bert_bwd = bwd_results[BERT_ATTENTION_CASE]
    # the BERT window's launches (the captured turn read last)
    bert_launches = {d: int(a13["attention_launches_per_step"][f"small/{d}"]
                            * a13["window_steps"]) for d in ("fwd", "bwd")}

    def err(row):
        return max(row["err_out"], row["err_lse"])

    nms_cases = vis18["18a"]["nms"]["cases"]
    nms_main = next(r for r in nms_cases if r["m"] == 1000)

    kernels_line = {"kernels": [
        _kernel_entry(
            "flash_attention_bthd_fwd, bf16 fwd_wgmma_kernel (small route)",
            _SRC_FWD, f"{_TPU_FA}:808",
            t["launches"]["small/fwd"] + p10_recipe["small/fwd"]
            + p14["small/fwd"] + p16["small/fwd"], fwd_main, err(fwd_main)),
        _kernel_entry(
            "flash_attention_bthd_fwd, f32 fwd_kernel (CUDA cores, 64-row "
            "tiles; small route, serving prefill and beam decode)",
            _SRC_FWD, f"{_TPU_FA}:808",
            s["launches"]["small/fwd"] + p10_short["small/fwd"]
            + p11["small/fwd"] + p12,
            fwd_prefill, err(fwd_prefill)),
        _kernel_entry(
            "flash_attention_bthd_bwd (bf16: bwd_dkdv_wgmma_kernel + "
            "bwd_dq_wgmma_kernel)", _SRC_BWD, f"{_TPU_FA}:861",
            t["launches"]["small/bwd"] + p10_recipe["small/bwd"]
            + p14["small/bwd"] + p16["small/bwd"], bwd_main,
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
            "flash_attention_bthd_fwd, bf16 fwd_wgmma_kernel (small route, "
            "BERT-base b64 t128 h12, phase 13a)", _SRC_FWD,
            f"{_TPU_FA}:808", bert_launches["fwd"], bert_fwd,
            err(bert_fwd)),
        _kernel_entry(
            "flash_attention_bthd_bwd (bf16: bwd_dkdv_wgmma_kernel + "
            "bwd_dq_wgmma_kernel; small route, BERT-base b64 t128 h12, "
            "phase 13a)", _SRC_BWD, f"{_TPU_FA}:861", bert_launches["bwd"],
            bert_bwd, max(bert_bwd["err_dq_dk_dv"])),
        _kernel_entry(
            "dropout op forward (dropout_apply_kernel; bf16 row)",
            "paddle_tpu_torch/csrc/dropout_mask.cu",
            "no Pallas source: the JAX dropout op draws its mask with "
            "jax.random, paddle_tpu/ops/nn_ops.py:244",
            t["launches"]["dropout"] + p10_dropout + p14["dropout"]
            + p16["dropout"], drop_rows[0], 0.0),
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
            sl["launches"]["bhtd/fwd"] + p10_long["bhtd/fwd"]
            + p11["bhtd/fwd"], bh_decode,
            err(bh_decode)),
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
            sl["launches"]["kblock/fwd"] + p10_long["kblock/fwd"]
            + p11["kblock/fwd"],
            kb_fwd_f32, err(kb_fwd_f32)),
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
        _kernel_entry(
            "nms_sweep_mask_kernel + nms_sweep_scan_kernel (the greedy NMS "
            "sweep, one call launching both; YOLOv3 eval's 640 sets of "
            "1000)", "paddle_tpu_torch/csrc/nms_sweep.cu",
            "no Pallas source: the JAX package sweeps in jax.lax.fori_loop, "
            "paddle_tpu/ops/vision_ops.py:228 and "
            "paddle_tpu/ops/detection_ops.py:455",
            sum(nms_launches.values()), nms_main,
            max(r["max_abs_err"] for r in nms_cases)),
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
