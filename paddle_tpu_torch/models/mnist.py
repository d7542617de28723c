"""MNIST models, the port of the JAX package's models/mnist.py
(reference: benchmark/fluid/models/mnist.py and
tests/book/test_recognize_digits.py's conv and MLP variants)."""

from __future__ import annotations

from paddle_tpu_torch import layers


def _head(logits, label):
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return loss, layers.accuracy(logits, label), logits


def mlp(img, label):
    h1 = layers.fc(img, 200, act="relu")
    h2 = layers.fc(h1, 200, act="relu")
    return _head(layers.fc(h2, 10), label)


def conv_net(img, label):
    """LeNet-style conv net (reference: benchmark/fluid/models/mnist.py
    cnn_model)."""
    x = layers.reshape(img, [-1, 1, 28, 28])
    c1 = layers.conv2d(x, 20, 5, act="relu")
    p1 = layers.pool2d(c1, 2, "max", 2)
    c2 = layers.conv2d(p1, 50, 5, act="relu")
    p2 = layers.pool2d(c2, 2, "max", 2)
    return _head(layers.fc(p2, 10), label)


def get_model(batch_size: int = 64, use_conv: bool = True):
    """The benchmark harness's entry: feeds ``pixel`` [b, 784] f32 and
    ``label`` [b, 1] int64; returns {feeds, loss, acc, logits}."""
    img = layers.data("pixel", shape=[784], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    loss, acc, logits = (conv_net if use_conv else mlp)(img, label)
    return {"feeds": [img, label], "loss": loss, "acc": acc, "logits": logits}
