"""fluid.layers parity namespace (the layers the port has copied)."""

from . import io, nn, nn_extra, ops, sequence, tensor  # noqa: F401
from .io import data                                   # noqa: F401
from .nn import *          # noqa: F401,F403
from .nn_extra import *    # noqa: F401,F403
from .sequence import *    # noqa: F401,F403
from .ops import *         # noqa: F401,F403
from .tensor import (create_tensor, create_global_var,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like, cast,
                     concat, sums, assign, zeros, ones, zeros_like,
                     ones_like, argmax, argmin)
