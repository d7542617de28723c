"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

from __future__ import annotations

import collections
import contextlib


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.ids = collections.defaultdict(int)
        self.prefix = prefix

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    """Scope within which name counters restart (used by Program.clone etc.)."""
    global generator
    old = generator
    generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        generator = old
