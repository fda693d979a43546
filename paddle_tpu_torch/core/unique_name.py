"""Unique name generator for program variables.

TPU-native re-implementation of the naming facility the reference keeps in
``python/paddle/fluid/unique_name.py``: a per-process counter map keyed by
prefix, plus a guard to switch generators (used by Program.clone and tests).
"""

import contextlib


class UniqueNameGenerator:
    def __init__(self):
        self.ids = {}

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{tmp}"


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


@contextlib.contextmanager
def guard(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    try:
        yield
    finally:
        generator = old
