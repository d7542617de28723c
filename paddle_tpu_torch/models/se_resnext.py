"""SE-ResNeXt (reference: benchmark/fluid/models/se_resnext.py and
tests/unittests/test_parallel_executor_seresnext.py flavor).

ResNeXt bottlenecks (grouped 3x3, cardinality 32) with squeeze-excitation
channel gating: convolutions plus, per block, a global pool and two tiny
fcs. Function and parameter names are the JAX package's.
"""

from __future__ import annotations

from typing import Sequence

from paddle_tpu_torch import layers
from paddle_tpu_torch.param_attr import ParamAttr


def conv_bn_layer(x, filters, size, stride=1, groups=1, act=None,
                  is_test=False, prefix=""):
    y = layers.conv2d(
        x, filters, size, stride=stride, padding=(size - 1) // 2,
        groups=groups, bias_attr=False,
        param_attr=ParamAttr(name=f"{prefix}_conv.w"),
    )
    return layers.batch_norm(
        y, act=act, is_test=is_test,
        param_attr=ParamAttr(name=f"{prefix}_bn.scale"),
        bias_attr=ParamAttr(name=f"{prefix}_bn.offset"),
        moving_mean_name=f"{prefix}_bn.mean",
        moving_variance_name=f"{prefix}_bn.var",
    )


def squeeze_excitation(x, num_channels, reduction_ratio, prefix=""):
    """SE gate (reference: se_resnext.py squeeze_excitation)."""
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    pool = layers.reshape(pool, [-1, num_channels])
    squeeze = layers.fc(
        pool, num_channels // reduction_ratio, act="relu",
        param_attr=ParamAttr(name=f"{prefix}_sqz.w"),
        bias_attr=ParamAttr(name=f"{prefix}_sqz.b"),
    )
    excite = layers.fc(
        squeeze, num_channels, act="sigmoid",
        param_attr=ParamAttr(name=f"{prefix}_exc.w"),
        bias_attr=ParamAttr(name=f"{prefix}_exc.b"),
    )
    scale = layers.reshape(excite, [-1, num_channels, 1, 1])
    return layers.elementwise_mul(x, scale)


def bottleneck_block(x, filters, stride, cardinality, reduction_ratio,
                     is_test, prefix):
    conv0 = conv_bn_layer(x, filters, 1, act="relu", is_test=is_test,
                          prefix=f"{prefix}_c0")
    conv1 = conv_bn_layer(conv0, filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_test=is_test,
                          prefix=f"{prefix}_c1")
    conv2 = conv_bn_layer(conv1, filters * 2, 1, is_test=is_test,
                          prefix=f"{prefix}_c2")
    scale = squeeze_excitation(conv2, filters * 2, reduction_ratio,
                               prefix=f"{prefix}_se")
    c_in = x.shape[1]
    if c_in == filters * 2 and stride == 1:
        short = x
    else:
        short = conv_bn_layer(x, filters * 2, 1, stride=stride,
                              is_test=is_test, prefix=f"{prefix}_sc")
    return layers.relu(layers.elementwise_add(short, scale))


def se_resnext_imagenet(
    img,
    class_dim: int = 1000,
    depth: int = 50,
    cardinality: int = 32,
    reduction_ratio: int = 16,
    is_test: bool = False,
):
    """SE-ResNeXt-50/101 backbone + classifier head."""
    supported = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}
    stages = supported[depth]
    filters_list = [128, 256, 512, 1024]

    x = conv_bn_layer(img, 64, 7, stride=2, act="relu", is_test=is_test,
                      prefix="stem")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for block, (n, filters) in enumerate(zip(stages, filters_list)):
        for i in range(n):
            x = bottleneck_block(
                x, filters, stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio,
                is_test=is_test, prefix=f"b{block}_{i}",
            )
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    pool = layers.reshape(pool, [-1, pool.shape[1]])
    drop = layers.dropout(pool, 0.2, is_test=is_test)
    return layers.fc(
        drop, class_dim,
        param_attr=ParamAttr(name="fc_out.w"),
        bias_attr=ParamAttr(name="fc_out.b"),
    )


def get_model(data_shape: Sequence[int] = (3, 224, 224),
              class_dim: int = 1000, depth: int = 50,
              is_test: bool = False):
    img = layers.data("data", shape=list(data_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    logits = se_resnext_imagenet(img, class_dim, depth, is_test=is_test)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return {"feeds": [img, label], "loss": loss, "acc": acc,
            "logits": logits}
