"""The port's random streams: step seeds, op seeds and the dropout hash.

The JAX package derives a step's PRNG key inside the compiled step,
``fold_in(base_key, step)``, from the executor's step counter, and each
random op folds in its own index. Here the same structure is spelled in
integers:

- the executor counts steps (one a run, ``steps`` a ``run_steps``
  window); step ``s`` of a program whose ``random_seed`` is ``r`` has the
  step seed ``mix64(r, s)``;
- random op ``i`` of the block (a grad op: its forward's index) has the
  op seed ``mix64(step seed, i)``;
- ``mix64(base, i)`` is splitmix64 of ``base + (i + 1) * golden``, cut to
  63 bits.

A run's step seed lives on the device, in a 0-d int64 tensor (the run's
seed buffer). An eager run sets it with ``fill_`` (a kernel argument: no
copy, no sync); a CUDA graph derives it from a device step counter with
``mix64_tensor``, which gives ``mix64``'s bits in int64 tensor ops (the
products wrap mod 2**64, shifts are masked to be logical). A random op
receives a ``SeedHandle`` (the buffer and its index) and never reads the
value on the host: the kernels read the buffer and mix the op seed in
their prologue (csrc/attention_common.cuh), the plain versions mix it
with tensor ops (``op_seed_tensor``).

The dropout keep bits of an op seed ``s``: the stream key ``k =
fmix32(fmix32(lo32(s) ^ 0x9E3779B9) ^ hi32(s))``, then ``row_hash(k, a,
b) = fmix32(fmix32(k ^ a) ^ b)`` and ``bits = fmix32(row_hash ^ c)``:
(a, b, c) = (batch * heads + head, query row, key column) for attention,
(hi32(i), lo32(i), none: ``row_hash`` itself) for element ``i`` of the
``dropout`` op. A value is kept iff ``bits < keep_threshold(p)`` and
scaled by ``keep_scale(p)``, 1/(1 - p) rounded to f32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

MASK64 = (1 << 64) - 1
U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_KEY_SALT = 0x9E3779B9


def signed64(x: int) -> int:
    """The int64 whose bits are the unsigned 64-bit ``x``."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def mix64(base: int, idx: int) -> int:
    """A 63-bit seed from ``base`` and index ``idx`` (splitmix64 of their
    combination): the step seed of step ``idx`` of a program seed, and the
    op seed of op ``idx`` of a step seed."""
    z = (base + (idx + 1) * _GOLDEN) & MASK64
    z = ((z ^ (z >> 30)) * _M1) & MASK64
    z = ((z ^ (z >> 27)) * _M2) & MASK64
    return (z ^ (z >> 31)) >> 1


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 tensors holding 64-bit words."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64_tensor(base: torch.Tensor, idx) -> torch.Tensor:
    """``mix64`` over int64 tensors: ``base`` a tensor, ``idx`` an int or
    an int64 tensor (a device step counter). The same bits as ``mix64``;
    graph-safe (no host value is read)."""
    if isinstance(idx, torch.Tensor):
        z = base + (idx + 1) * signed64(_GOLDEN)
    else:
        z = base + signed64((idx + 1) * _GOLDEN)
    z = (z ^ _srl(z, 30)) * signed64(_M1)
    z = (z ^ _srl(z, 27)) * signed64(_M2)
    return _srl(z ^ _srl(z, 31), 1)


def step_seed(program_seed, step: int) -> int:
    """The step seed of step ``step`` of a program whose ``random_seed`` is
    ``program_seed`` (None counts as 0)."""
    return mix64((program_seed or 0) & MASK64, step)


@dataclasses.dataclass(frozen=True)
class SeedHandle:
    """What a random op receives: the run's seed buffer (0-d int64, on the
    run's device) and the op's index; its op seed is ``mix64(buffer,
    idx)``."""

    buf: torch.Tensor
    idx: int

    def op_seed_tensor(self) -> torch.Tensor:
        return mix64_tensor(self.buf, self.idx)


Seed = Union[int, torch.Tensor, SeedHandle]


def kernel_seed(seed: Seed, device) -> Tuple[torch.Tensor, int]:
    """(seed tensor, op index) as the kernels take them: they read the
    0-d int64 tensor and, for an index >= 0, mix the op seed from it
    (csrc/attention_common.cuh); -1 means the tensor holds the op seed
    itself. An int seed becomes a device scalar through ``torch.full``."""
    if isinstance(seed, SeedHandle):
        buf, idx = seed.buf, seed.idx
    elif isinstance(seed, torch.Tensor):
        buf, idx = seed, -1
    else:
        return torch.full((), signed64(int(seed)), dtype=torch.int64,
                          device=device), -1
    if buf.dim() != 0 or buf.dtype != torch.int64 or buf.device != \
            torch.device(device):
        raise ValueError(f"seed tensor must be a 0-d int64 tensor on "
                         f"{device}, got {buf.dtype} {tuple(buf.shape)} on "
                         f"{buf.device}")
    return buf, idx


def op_seed_tensor(seed: Seed, device) -> torch.Tensor:
    """The op seed as a 0-d int64 tensor on ``device``: an int as given, a
    tensor as it holds it, a handle mixed from its buffer."""
    if isinstance(seed, SeedHandle):
        t = seed.op_seed_tensor()
    elif isinstance(seed, torch.Tensor):
        t = seed.to(torch.int64).reshape(())
    else:
        return torch.full((), signed64(int(seed)), dtype=torch.int64,
                          device=device)
    return t.to(device)


# --- the 32-bit hash (attention_common.cuh holds the device twin) ---


def fmix32_int(x: int) -> int:
    """MurmurHash3's 32-bit finalizer."""
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & U32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & U32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors holding uint32 values, split in
    16-bit halves so no int64 product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & U32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """``fmix32_int`` over int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stream_key_tensor(op_seed: torch.Tensor) -> torch.Tensor:
    """The 32-bit stream key of an op seed (int64 tensor -> int64 tensor
    holding a uint32)."""
    lo, hi = op_seed & U32, _srl(op_seed, 32)
    return fmix32(fmix32(lo ^ _KEY_SALT) ^ hi)


def row_hash(key: torch.Tensor, a, b) -> torch.Tensor:
    """fmix32(fmix32(key ^ a) ^ b) over broadcasting int64 tensors."""
    return fmix32(fmix32(key ^ a) ^ b)


def keep_threshold(p: float) -> int:
    """Keep a value iff its 32-bit hash is below this: min(floor((1 - p) *
    2**32), 2**32 - 1)."""
    return min(int((1.0 - p) * 4294967296.0), U32)


def keep_scale(p: float) -> float:
    """1/(1 - p) rounded to f32: the scale of a kept value."""
    return float(np.float32(1.0) / np.float32(1.0 - p))
