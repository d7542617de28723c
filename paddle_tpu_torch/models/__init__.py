"""Model zoo: the Transformer (trained and served), ResNet and
SE-ResNeXt."""
