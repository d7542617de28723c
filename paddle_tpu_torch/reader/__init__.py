"""Data pipeline (reference: python/paddle/reader/ + fluid/reader.py): the
JAX package's reader decorators and ``batch``, host-only, and the
``DeviceLoader`` / ``PyReader`` that stage batches on the card."""

from paddle_tpu_torch.reader.decorator import (  # noqa: F401
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    multiprocess_reader,
    shuffle,
    xmap_readers,
)


def batch(reader, batch_size: int, drop_last: bool = True):
    """Group samples into batches (reference: python/paddle/batch.py).

    ``drop_last`` defaults True: a captured step wants uniform batches.
    """

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


from paddle_tpu_torch.reader.pipeline import DeviceLoader, PyReader  # noqa: F401,E402
