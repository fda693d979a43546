"""fluid.average parity (``python/paddle/fluid/average.py``): pure-host
accumulators, no Program involvement.

The port's own copy of ``paddle_tpu/average.py``, which needs numpy
only."""

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(v):
    return isinstance(v, (int, float)) or (isinstance(v, np.ndarray)
                                           and v.shape == (1,))


class WeightedAverage:
    """Weighted running average (average.py:36)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number(value) and not isinstance(value, np.ndarray):
            raise ValueError("The 'value' must be a number or a numpy "
                             "ndarray.")
        if not _is_number(weight):
            raise ValueError("The 'weight' must be a number.")
        value = np.asarray(value, np.float64)
        weight = float(np.asarray(weight).reshape(()))
        if self.numerator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator = self.numerator + value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator == 0.0:
            raise ValueError("There is no data to be averaged in "
                             "WeightedAverage.")
        return self.numerator / self.denominator
