"""paddle_tpu_torch stands alone: it imports neither JAX nor any module of
the JAX package (paddle_tpu) or of its benchmark scripts (benchmarks/),
nor protobuf (``google``: the port reads and writes program bytes with
its own codec), and neither does chip_smoke.py, which runs on machines
that have no JAX and no protobuf."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")
FORBIDDEN_ROOTS = {"jax", "jaxlib", "paddle_tpu", "benchmarks", "google"}


def _port_sources():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "build")]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_of_the_port_is_scanned():
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("paddle_tpu_torch/benchmarks/conv_bwd.py",
                "paddle_tpu_torch/benchmarks/grouped_conv.py",
                "paddle_tpu_torch/benchmarks/attn_ablate.py",
                "paddle_tpu_torch/benchmarks/timing.py",
                "paddle_tpu_torch/dataset/imagenet.py",
                "paddle_tpu_torch/models/resnet.py",
                "paddle_tpu_torch/models/se_resnext.py",
                "paddle_tpu_torch/ops/nn_ops.py",
                "paddle_tpu_torch/layers/more.py",
                "paddle_tpu_torch/proto/framework_wire.py",
                "paddle_tpu_torch/inference.py",
                "paddle_tpu_torch/ops/quant_ops.py",
                "paddle_tpu_torch/slim/quantization.py",
                "paddle_tpu_torch/slim/calibration.py",
                "paddle_tpu_torch/slim/prune.py",
                "paddle_tpu_torch/slim/distill.py",
                "paddle_tpu_torch/flags.py", "paddle_tpu_torch/faults.py",
                "paddle_tpu_torch/retry.py", "paddle_tpu_torch/monitor.py",
                "paddle_tpu_torch/numerics.py",
                "paddle_tpu_torch/serving_trace.py",
                "paddle_tpu_torch/profiler.py",
                "paddle_tpu_torch/models/bert.py",
                "paddle_tpu_torch/models/deepfm.py",
                "paddle_tpu_torch/models/ssd.py",
                "paddle_tpu_torch/ops/sparse_ops.py",
                "paddle_tpu_torch/ops/box_util.py",
                "paddle_tpu_torch/ops/detection_ops.py",
                "paddle_tpu_torch/ops/vision_ops.py",
                "paddle_tpu_torch/layers/detection.py",
                "paddle_tpu_torch/data_feeder.py",
                "paddle_tpu_torch/dataset_api.py",
                "paddle_tpu_torch/metrics.py",
                "paddle_tpu_torch/contrib/__init__.py",
                "paddle_tpu_torch/contrib/trainer.py",
                "paddle_tpu_torch/parallel/checkpoint.py",
                "paddle_tpu_torch/reader/__init__.py",
                "paddle_tpu_torch/reader/decorator.py",
                "paddle_tpu_torch/reader/pipeline.py",
                "paddle_tpu_torch/layers/learning_rate_scheduler.py",
                "paddle_tpu_torch/dataset/cifar.py",
                "paddle_tpu_torch/dataset/conll05.py",
                "paddle_tpu_torch/dataset/flowers.py",
                "paddle_tpu_torch/dataset/imdb.py",
                "paddle_tpu_torch/dataset/mnist.py",
                "paddle_tpu_torch/dataset/movielens.py",
                "paddle_tpu_torch/dataset/sentiment.py",
                "paddle_tpu_torch/dataset/uci_housing.py",
                "paddle_tpu_torch/dataset/wmt14.py",
                "paddle_tpu_torch/dataset/wmt16.py",
                "paddle_tpu_torch/ops/rnn_ops.py",
                "paddle_tpu_torch/ops/sequence_ops.py",
                "paddle_tpu_torch/layers/rnn.py",
                "paddle_tpu_torch/models/mnist.py",
                "paddle_tpu_torch/models/vgg.py",
                "paddle_tpu_torch/models/stacked_lstm.py",
                "paddle_tpu_torch/models/seq2seq.py",
                "paddle_tpu_torch/ops/crf_ops.py",
                "paddle_tpu_torch/ops/metric_ops.py",
                "paddle_tpu_torch/ops/misc_ops.py",
                "paddle_tpu_torch/ops/control_flow_ops.py",
                "paddle_tpu_torch/layers/control_flow.py",
                "paddle_tpu_torch/ops/math_ops.py",
                "paddle_tpu_torch/ops/tensor_ops.py",
                "paddle_tpu_torch/ops/optimizer_ops.py",
                "paddle_tpu_torch/layers/nn.py",
                "paddle_tpu_torch/layers/tensor.py",
                "paddle_tpu_torch/initializer.py",
                "paddle_tpu_torch/core/rng.py", "chip_smoke.py"):
        assert rel in scanned, rel


def test_sources_import_no_jax_and_no_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN_ROOTS:
                    bad.append(f"{os.path.relpath(path, ROOT)}:"
                               f"{node.lineno}: import {n}")
    assert not bad, "\n".join(bad)


_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["google.protobuf"] = None   # nor of protobuf
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
leaked = sorted(n for n, m in sys.modules.items() if m is not None and (
                n in ("paddle_tpu", "benchmarks", "google.protobuf")
                or n.startswith(("paddle_tpu.", "benchmarks.",
                                 "google.protobuf."))))
assert not leaked, leaked
for name in ("benchmarks.conv_bwd", "benchmarks.grouped_conv",
             "benchmarks.attn_ablate", "dataset.imagenet", "models.resnet",
             "models.se_resnext", "layers.more", "proto.framework_wire",
             "inference", "ops.quant_ops", "slim.quantization",
             "slim.calibration", "slim.prune", "slim.distill", "flags",
             "faults", "retry", "monitor", "numerics", "serving_trace",
             "profiler", "ops.rnn_ops", "ops.sequence_ops", "layers.rnn",
             "models.mnist", "models.vgg", "models.stacked_lstm",
             "models.seq2seq"):
    assert "paddle_tpu_torch." + name in sys.modules, name
print("isolated", len([n for n in sys.modules
                       if n.startswith("paddle_tpu_torch")]))
"""


def test_package_imports_without_jax_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("isolated")
