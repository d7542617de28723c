"""Model zoo: the Transformer (trained and served), ResNet, SE-ResNeXt,
BERT, DeepFM, SSD, VGG-16, MNIST, the stacked dynamic LSTM and the LSTM
seq2seq (reference: benchmark/fluid/models/ and the book models)."""

from paddle_tpu_torch.models import (  # noqa: F401
    bert,
    deepfm,
    mnist,
    resnet,
    se_resnext,
    seq2seq,
    ssd,
    stacked_lstm,
    transformer,
    vgg,
)
