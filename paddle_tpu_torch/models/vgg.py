"""VGG-16, the port of the JAX package's models/vgg.py (reference:
benchmark/fluid/models/vgg.py): five blocks of 3x3 convolutions (2, 2,
3, 3, 3 of them; 64-512 filters) with max pooling, then two fc layers
(4096 wide at 224 x 224, 512 below) with dropout 0.5 in training."""

from __future__ import annotations

from paddle_tpu_torch import layers


def conv_block(x, filters, n, is_test=False):
    for _ in range(n):
        x = layers.conv2d(x, filters, 3, padding=1, act="relu")
    return layers.pool2d(x, 2, "max", 2)


def vgg16(img, class_dim=1000, is_test=False, fc_dim=4096):
    x = img
    for filters, n in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        x = conv_block(x, filters, n, is_test)
    for _ in range(2):
        x = layers.fc(x, fc_dim, act="relu")
        if not is_test:
            x = layers.dropout(x, 0.5)
    return layers.fc(x, class_dim)


def get_model(batch_size=32, data_shape=(3, 224, 224), class_dim=1000,
              is_test=False):
    """Feeds ``data`` [b, *data_shape] f32 and ``label`` [b, 1] int64;
    returns {feeds, loss, acc, logits}."""
    img = layers.data("data", shape=list(data_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    fc_dim = 4096 if data_shape[-1] >= 224 else 512
    logits = vgg16(img, class_dim, is_test, fc_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return {"feeds": [img, label], "loss": loss, "acc": acc, "logits": logits}
