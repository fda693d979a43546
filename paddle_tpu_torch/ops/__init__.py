"""Op kernel library — importing registers all kernels."""

from . import registry      # noqa: F401
from . import math_ops      # noqa: F401
from . import nn_ops        # noqa: F401
from . import conv_ops      # noqa: F401
from . import tensor_ops    # noqa: F401
from . import attention_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import rnn_ops       # noqa: F401
from . import sampling_kernels  # noqa: F401
from . import pipeline_ops  # noqa: F401
from . import array_ops     # noqa: F401
from . import misc_ops      # noqa: F401
