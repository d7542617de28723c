"""Kernel studies: the counterparts of the JAX package's benchmark
scripts that hold a hand-written kernel (``conv_bwd``, ``grouped_conv``,
``attn_ablate``). Each module holds the kernel's wrapper with its launch
count, the plain PyTorch version, the library call it is timed against,
and a ``main()`` that runs on the card and prints the study's table:

    python3 -m paddle_tpu_torch.benchmarks.conv_bwd

As in the JAX package, no model's op calls these kernels.
"""
