"""Inference predictor (port of ``paddle_tpu/inference.py``, program
mode).

Reference: ``paddle/fluid/inference/api/paddle_api.h:186``
(PaddlePredictor), ``analysis_predictor.h:44``, created via
``create_paddle_predictor(AnalysisConfig)``.

The predictor loads an inference model dir (``io.load_inference_model``)
into its own Scope, runs the static verifier (``FLAGS_validate_program``)
and the IR pass pipeline (``FLAGS_pass_pipeline``) over the loaded
program in the reference's order, and runs the result with the port's
Executor in inference mode.  With ``enable_quantize()`` the pipeline's
``quantize_weights`` pass annotates the program's matmuls and the
predictor converts their weights to int8 with per-channel scales once, at
load; the annotated ops run the int8 kernel K6
(``ops/quant_kernels.py``).  ``AnalysisConfig`` runs on the GPU unless
``disable_gpu()`` is called; with no CUDA device it raises rather than
run on the CPU.  Not ported yet: AOT ``export_serialized``,
``ZeroCopyTensor``, ``enable_bf16``, and the quantize-at-swap of a warm
reload (``passes.quantize.quantize_values`` exists; the engine has no
warm reload to call it).
"""

import numpy as np

from .core.framework import CPUPlace, CUDAPlace


class AnalysisConfig:
    """AnalysisConfig surface (analysis_config.cc)."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._use_feed_fetch_ops = True
        self._ir_optim = True

    def disable_gpu(self):
        self._use_gpu = False

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = device_id

    def use_gpu(self):
        return self._use_gpu

    def place(self):
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    # accepted for API parity; recorded, not acted on
    def switch_ir_optim(self, x=True):
        self._ir_optim = x

    def switch_use_feed_fetch_ops(self, x=True):
        self._use_feed_fetch_ops = x

    def enable_mkldnn(self):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_bf16(self):
        raise NotImplementedError(
            "enable_bf16 is not ported to the PyTorch package yet")

    def enable_quantize(self):
        """Serve the loaded program with per-channel int8 weights
        (``passes.quantize``): the pass pipeline annotates matmul-class
        ops and the Predictor quantizes the scope weights ONCE at load.
        Requires the pass pipeline (no effect under
        FLAGS_pass_pipeline=off)."""
        self._quant = True


class PaddleTensor:
    """paddle_api.h:64 value object."""

    def __init__(self, data=None, name=""):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        self.shape = list(self.data.shape) if data is not None else []

    def as_ndarray(self):
        return self.data


class Predictor:
    """PaddlePredictor parity: run(inputs) -> outputs (program mode)."""

    def __init__(self, config):
        from . import io as io_mod
        from .core.executor import Executor, Scope, scope_guard

        self.config = config
        self._scope = Scope()
        self._exe = Executor(config.place())
        with scope_guard(self._scope):
            program, feed_names, fetch_vars = io_mod.load_inference_model(
                config.model_dir, self._exe,
                model_filename=config.prog_file,
                params_filename=config.params_file)
        self._feed_names = list(feed_names)
        self._fetch_names = [v.name for v in fetch_vars]
        if getattr(config, "_quant", False):
            program._quant = True
            program._version += 1
        # FLAGS_validate_program seam: a deserialized program never went
        # through the layer functions' checks, so desc corruption surfaces
        # here as located findings
        from .analysis.verifier import validate_at_seam
        validate_at_seam(program, feed_names=sorted(self._feed_names),
                         fetch_names=self._fetch_names, where="Predictor")
        # FLAGS_pass_pipeline seam (cse, dce, ..., quantize_weights)
        from .passes import apply_at_seam
        program = apply_at_seam(program,
                                feed_names=sorted(self._feed_names),
                                fetch_names=self._fetch_names,
                                where="Predictor")
        self._program = program
        if getattr(program, "_quant", False):
            # quantize-at-load: the fp32 weights the pass annotated become
            # int8 + per-channel scales on the executor's device, once
            from .passes import quantize as quantize_mod
            quantize_mod.apply_to_scope(program, self._scope)

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def _run_feeds(self, feed):
        """{name: array} -> list of np arrays, in inference mode."""
        from .ops import registry

        with registry.test_mode():
            return self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_names,
                                 scope=self._scope)

    def run(self, inputs):
        """inputs: dict name->array, or list of PaddleTensor/arrays in
        get_input_names() order.  Returns list of np arrays."""
        if isinstance(inputs, dict):
            feed = {k: (v.data if isinstance(v, PaddleTensor) else v)
                    for k, v in inputs.items()}
        else:
            feed = {}
            for name, v in zip(self._feed_names, inputs):
                if isinstance(v, PaddleTensor):
                    feed[v.name or name] = v.data
                else:
                    feed[name] = v
        return self._run_feeds({n: feed[n] for n in self._feed_names})

    def serving_handle(self):
        """Input specs + per-signature callables for
        ``serving.ServingEngine``.  The engine takes ownership: don't
        call run() concurrently."""
        return _ServingHandle(self)


class _ServingHandle:
    """The bridge `serving.ServingEngine` drives.  `compile(feeds)`
    records the padded shape signature and returns the callable that
    serves it (no compilation happens here yet, so the engine's
    compile/hit counters count signatures); `call(compiled, feeds)` runs
    one batch and returns its fetches as numpy arrays."""

    retry_safe = True       # no donated state: a failed call consumes nothing
    fixed_shapes = None

    def __init__(self, predictor):
        from .ops.registry import np_dtype

        p = self._p = predictor
        block = p._program.global_block()
        self.feed_order = sorted(p._feed_names)
        self.declared_order = list(p._feed_names)
        self.feed_dtypes = [
            np_dtype(block.var(n).dtype) if block.has_var(n)
            else np.dtype(np.float32) for n in self.feed_order]
        self.fetch_names = list(p._fetch_names)
        self.signatures = []

    def compile(self, feeds):
        self.signatures.append(
            tuple((n, tuple(feeds[n].shape), str(feeds[n].dtype))
                  for n in self.feed_order))
        return self._p._run_feeds

    def example_feeds(self, batch, seq=None, axis=1):
        """Zero feeds for one (batch bucket, seq bucket) grid point, or
        None when an input's non-batch dims can't be determined (a -1
        dim with no seq bucket covering it)."""
        block = self._p._program.global_block()
        out = {}
        for idx, n in enumerate(self.feed_order):
            if not block.has_var(n):
                return None
            dims = list(block.var(n).shape or [])
            if not dims:
                return None
            dims[0] = batch
            if seq is not None and len(dims) > axis:
                dims[axis] = seq
            if any(d is None or int(d) < 0 for d in dims[1:]):
                return None
            out[n] = np.zeros(tuple(int(d) for d in dims),
                              self.feed_dtypes[idx])
        return out

    def call(self, compiled, feeds):
        return compiled(feeds)


def create_paddle_predictor(config):
    """create_paddle_predictor (paddle_api.h:314)."""
    return Predictor(config)
