"""fluid.layers parity namespace (the layers the port has copied)."""

from . import (control_flow, io, nn, nn_extra, ops, rnn,  # noqa: F401
               sequence, tensor)
from .io import data                                   # noqa: F401
from .nn import *          # noqa: F401,F403
from .nn_extra import *    # noqa: F401,F403
from .sequence import *    # noqa: F401,F403
from .rnn import (dynamic_lstm, dynamic_lstmp, dynamic_gru,  # noqa: F401
                  gru_unit, lstm_unit)
from .ops import *         # noqa: F401,F403
from .tensor import (create_tensor, create_global_var,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like, cast,
                     concat, sums, assign, zeros, ones, zeros_like,
                     ones_like, argmax, argmin)
from .control_flow import DynamicRNN, PipelineStack  # noqa: F401
