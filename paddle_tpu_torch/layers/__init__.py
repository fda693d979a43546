"""fluid.layers parity namespace (the layers the port has copied)."""

from . import (control_flow, io, learning_rate_scheduler,  # noqa: F401
               nn, nn_extra, ops, parity_extra, rnn, sequence, tensor)
from .io import data, py_reader, read_file             # noqa: F401
from .nn import *          # noqa: F401,F403
from .nn_extra import *    # noqa: F401,F403
# after nn and nn_extra, as in the JAX package: its names shadow theirs
from .parity_extra import *  # noqa: F401,F403
from .sequence import *    # noqa: F401,F403
from .rnn import (dynamic_lstm, dynamic_lstmp, dynamic_gru,  # noqa: F401
                  gru_unit, lstm_unit, StaticRNN)
from .ops import *         # noqa: F401,F403
from .tensor import (create_tensor, create_global_var,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like, cast,
                     concat, sums, assign, zeros, ones, zeros_like,
                     ones_like, argmax, argmin)
from .control_flow import (While, Switch, DynamicRNN,  # noqa: F401
                           IfElse, PipelineStack, increment,
                           create_array, array_write, array_read,
                           array_length, less_than, less_equal,
                           greater_than, greater_equal, equal, not_equal,
                           logical_and, logical_or, logical_xor,
                           logical_not, cond_block, lod_rank_table,
                           max_sequence_len, lod_tensor_to_array,
                           array_to_lod_tensor,
                           reorder_lod_tensor_by_rank)
from .learning_rate_scheduler import (  # noqa: F401
    exponential_decay, natural_exp_decay, inverse_time_decay,
    polynomial_decay, piecewise_decay, noam_decay, cosine_decay,
    linear_lr_warmup)
