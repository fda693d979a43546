"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, the framework
with the capability surface of PaddlePaddle Fluid 1.3.

The public API mirrors ``paddle.fluid`` (``import paddle_tpu_torch as
fluid``) with the same Program IR, on-disk model format and layer
builders as the JAX package, executed by an op-by-op interpreter over
torch tensors.  The kernels the JAX package wrote in Pallas for the TPU
are written by hand for Hopper under ``csrc/``.  This package imports
torch, never jax, and nothing of ``paddle_tpu``.

Entry points run on the card unless the caller asks for the CPU:
``Executor()`` is ``Executor(CUDAPlace(0))`` and ``AnalysisConfig`` runs
on the GPU until ``disable_gpu()``; with no CUDA device both raise.

It serves: fluid layers -> ``io.save_inference_model`` ->
``create_paddle_predictor(AnalysisConfig(dir))`` -> ``serving.
ServingEngine``, with the BERT encoder of ``models/bert.py``.  And it
trains: fluid layers -> ``optimizer.Adam(...).minimize(loss)``
(``append_backward`` plus update ops) -> ``Executor.run(startup)`` ->
``Executor.run(main, feed, fetch_list=[loss])`` step after step.  And it
serves with int8 weights: ``AnalysisConfig.enable_quantize()`` runs the
Predictor's verifier (``analysis/``) and pass pipeline (``passes/``), and
each annotated matmul runs the int8 kernel ``csrc/quant_matmul.cu``.
And it trains RNNs over lod (ragged) inputs: ``layers.dynamic_lstm``,
``dynamic_gru`` and ``DynamicRNN`` loop over the padded time steps, the
cells running ``csrc/rnn_cells.cu`` and ``sequence_softmax`` running
``csrc/masked_softmax.cu`` on the card (the seq2seq model of Paddle's
book).
"""

from .core import framework, unique_name  # noqa: F401
from .core.framework import (Program, Block, Operator,  # noqa: F401
                             Variable, Parameter, default_main_program,
                             default_startup_program, program_guard,
                             name_scope, CPUPlace, CUDAPlace)
from .core.executor import (Executor, Scope, global_scope,  # noqa: F401
                            scope_guard)
from .core.lod import LoDTensor, create_lod_tensor  # noqa: F401
from .core import backward  # noqa: F401
from .core.backward import append_backward, calc_gradient  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from . import initializer  # noqa: F401
from . import layers       # noqa: F401
from . import optimizer    # noqa: F401
from . import regularizer  # noqa: F401
from . import clip         # noqa: F401
from . import io           # noqa: F401
from .io import (save_vars, save_params, save_persistables,  # noqa: F401
                 load_vars, load_params, load_persistables,
                 save_inference_model, load_inference_model,
                 state_from_numpy)
from . import profiler     # noqa: F401
from . import observability  # noqa: F401
from .flags import set_flags, get_flags  # noqa: F401
from . import inference    # noqa: F401
from . import serving      # noqa: F401
from .inference import (AnalysisConfig, PaddleTensor,  # noqa: F401
                        create_paddle_predictor)

__version__ = "0.1.0"
