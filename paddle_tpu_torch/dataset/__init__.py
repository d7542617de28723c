"""Synthetic offline datasets (numpy only): the JAX package's readers,
each a deterministic generator with the shapes and vocabulary of the real
dataset (the same seeds give the same samples in both packages).
``mnist`` reads local idx files only when given a ``data_dir``; nothing
is downloaded."""

from paddle_tpu_torch.dataset import (  # noqa: F401
    cifar,
    conll05,
    flowers,
    imagenet,
    imdb,
    mnist,
    movielens,
    sentiment,
    uci_housing,
    wmt14,
    wmt16,
)
