"""Block -> callable.

The JAX package traces a block into one jitted XLA computation. Here the
same analysis (which persistable vars the block reads and writes) feeds a
plain Python callable that runs the block's ops eagerly on one device;
PyTorch needs no compile step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from paddle_tpu_torch.core.interp import exec_ops, resolve_op_def
from paddle_tpu_torch.framework import Block, Program


@dataclasses.dataclass
class LoweredBlock:
    """A runnable block: ``fn(state, feeds, generator) -> (fetches,
    new_state)``.

    ``state_in_names``: persistable vars read before being written —
    gathered from the Scope. ``state_out_names``: every state-in var plus
    every persistable var the block writes; the executor commits them
    back to the Scope.
    """

    fn: Callable
    state_in_names: Tuple[str, ...]
    state_out_names: Tuple[str, ...]
    feed_names: Tuple[str, ...]
    fetch_names: Tuple[str, ...]
    needs_rng: bool


def analyze_state(
    block: Block, feed_names: Sequence[str]
) -> Tuple[List[str], List[str]]:
    """(state_in, state_out) persistable-var lists for the block."""
    feed = set(feed_names)
    written: set = set()
    state_in: List[str] = []
    seen_in: set = set()
    written_persistable: List[str] = []

    def is_persistable(name: str) -> bool:
        v = block._find_var_recursive(name)
        return v is not None and v.persistable

    for op in block.ops:
        for name in op.input_arg_names:
            if not name or name in feed or name in written or name in seen_in:
                continue
            if is_persistable(name):
                state_in.append(name)
                seen_in.add(name)
        for name in op.output_arg_names:
            if name and name not in written:
                written.add(name)
                if is_persistable(name):
                    written_persistable.append(name)
    state_out = list(state_in)
    out_seen = set(state_in)
    for name in written_persistable:
        if name not in out_seen:
            state_out.append(name)
            out_seen.add(name)
    return state_in, state_out


def lower_block(
    program: Program,
    block_idx: int,
    feed_names: Sequence[str],
    fetch_names: Sequence[str],
    device: torch.device,
) -> LoweredBlock:
    block = program.blocks[block_idx]
    state_in, state_out = analyze_state(block, feed_names)
    state_out = tuple(state_out)
    fetch_names = tuple(fetch_names)
    # resolve every compute up front so unknown ops fail before running
    op_defs = [resolve_op_def(op.type) for op in block.ops]
    ops = list(block.ops)

    def run_block(state: Dict[str, Any], feeds: Dict[str, Any], generator):
        env: Dict[str, Any] = {}
        env.update(state)
        env.update(feeds)
        exec_ops(ops, env, device=device, generator=generator,
                 op_defs=op_defs)
        fetches = [env[n] for n in fetch_names]
        return fetches, {n: env[n] for n in state_out}

    return LoweredBlock(
        fn=run_block,
        state_in_names=tuple(state_in),
        state_out_names=state_out,
        feed_names=tuple(feed_names),
        fetch_names=fetch_names,
        needs_rng=any(d.needs_rng for d in op_defs),
    )
