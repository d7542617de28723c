"""ResNet for ImageNet/cifar10 (reference: benchmark/fluid/models/resnet.py:171).

Bottleneck-v1 architecture matching the reference's conv_bn_layer /
shortcut / bottleneck_block composition, with the JAX package's function
and parameter names; NCHW API.
"""

from __future__ import annotations

from paddle_tpu_torch import layers
from paddle_tpu_torch.param_attr import ParamAttr


def conv_bn(x, filters, size, stride=1, groups=1, act=None, is_test=False,
            prefix=""):
    c = layers.conv2d(
        x, filters, size, stride=stride, padding=(size - 1) // 2,
        groups=groups, bias_attr=False,
        param_attr=ParamAttr(name=f"{prefix}_conv.w") if prefix else None,
    )
    return layers.batch_norm(c, act=act, is_test=is_test)


def shortcut(x, filters, stride, is_test):
    if x.shape[1] != filters or stride != 1:
        return conv_bn(x, filters, 1, stride, is_test=is_test)
    return x


def bottleneck(x, filters, stride, is_test):
    c0 = conv_bn(x, filters, 1, act="relu", is_test=is_test)
    c1 = conv_bn(c0, filters, 3, stride=stride, act="relu", is_test=is_test)
    c2 = conv_bn(c1, filters * 4, 1, is_test=is_test)
    short = shortcut(x, filters * 4, stride, is_test)
    return layers.elementwise_add(c2, short, act="relu")


def basic_block(x, filters, stride, is_test):
    c0 = conv_bn(x, filters, 3, stride=stride, act="relu", is_test=is_test)
    c1 = conv_bn(c0, filters, 3, is_test=is_test)
    short = shortcut(x, filters, stride, is_test)
    return layers.elementwise_add(c1, short, act="relu")


_DEPTHS = {
    50: ([3, 4, 6, 3], bottleneck),
    101: ([3, 4, 23, 3], bottleneck),
    152: ([3, 8, 36, 3], bottleneck),
    18: ([2, 2, 2, 2], basic_block),
    34: ([3, 4, 6, 3], basic_block),
}


def resnet_imagenet(img, class_dim=1000, depth=50, is_test=False):
    stages, block = _DEPTHS[depth]
    x = conv_bn(img, 64, 7, stride=2, act="relu", is_test=is_test)
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    for s, n in enumerate(stages):
        for i in range(n):
            x = block(x, 64 * (2 ** s), 2 if i == 0 and s > 0 else 1, is_test)
    x = layers.pool2d(x, 7, "avg", global_pooling=True)
    logits = layers.fc(x, class_dim)
    return logits


def resnet_cifar10(img, class_dim=10, depth=32, is_test=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    x = conv_bn(img, 16, 3, act="relu", is_test=is_test)
    for s, filters in enumerate([16, 32, 64]):
        for i in range(n):
            x = basic_block(x, filters, 2 if i == 0 and s > 0 else 1, is_test)
    x = layers.pool2d(x, 8, "avg", global_pooling=True)
    logits = layers.fc(x, class_dim)
    return logits


def get_model(batch_size=32, data_shape=(3, 224, 224), class_dim=1000,
              depth=50, is_test=False):
    img = layers.data("data", shape=list(data_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    if data_shape[-1] == 32:
        logits = resnet_cifar10(img, class_dim, is_test=is_test)
    else:
        logits = resnet_imagenet(img, class_dim, depth, is_test=is_test)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return {"feeds": [img, label], "loss": loss, "acc": acc, "logits": logits}
