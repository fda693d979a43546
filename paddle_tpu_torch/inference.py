"""Inference predictor (port of ``paddle_tpu/inference.py``, program
mode).

Reference: ``paddle/fluid/inference/api/paddle_api.h:186``
(PaddlePredictor), ``analysis_predictor.h:44``, created via
``create_paddle_predictor(AnalysisConfig)``.

The predictor loads an inference model dir (``io.load_inference_model``)
into its own Scope, runs the static verifier (``FLAGS_validate_program``)
and the IR pass pipeline (``FLAGS_pass_pipeline``) over the loaded
program in the reference's order, and runs the result with the port's
Executor in inference mode.  With ``enable_bf16()`` the program runs
under the bf16 cast policy (``contrib/mixed_precision.py``), its
precision decided op by op by the pipeline's ``amp_propagate``.  With
``enable_quantize()`` the pipeline's ``quantize_weights`` pass annotates
the program's matmuls and the predictor converts their weights to int8
with per-channel scales once, at load; the annotated ops run the int8
kernel K6
(``ops/quant_kernels.py``).  ``AnalysisConfig`` runs on the GPU unless
``disable_gpu()`` is called; with no CUDA device it raises rather than
run on the CPU.

Zero-copy (``AnalysisPredictor::ZeroCopyRun``): ``get_input_tensor(n).
copy_from_cpu(a)`` stages an input on the predictor's device once (a
non-blocking copy from pinned memory on CUDA), ``zero_copy_run()`` runs on
the staged tensors with no host-to-device feed copy, and the outputs stay
on the device until ``get_output_tensor(n).copy_to_cpu()``.

AOT (the reference's save-optimized-model analogue):
``export_serialized(example_feed)`` exports the loaded program with
``torch.export`` at the example's static shapes, as an ``nn.Module`` whose
buffers are the Scope's persistables and whose forward runs the block
through the port's interpreter in test mode.  K1's forward and K6 are
``torch.library`` custom ops, so the exported graph holds them as nodes and
launches them; a wrapper of any other kernel refuses the trace
(``ops/cuda_build.refuse_export``).  The directory gains
``__serialized__.pt2`` (``torch.export.save``), ``__serialized__.json``
(the reference's keys, with ``"format": "torch.export"`` and the export's
device) and the plain-text ``__manifest__.txt``.  A Predictor over that
directory loads the artifact and never rebuilds the Program; its serving
handle captures one CUDA graph of the exported module per feed signature.
The reference's ``__stablehlo__.bin`` has no counterpart (a LibTorch
counterpart of ``csrc/predictor.cc`` would read the ``.pt2``: ROADMAP
queue 1 item 13).  Not ported yet: the quantize-at-swap of a warm reload
(``passes.quantize.quantize_values`` exists; the engine has no warm
reload to call it).
"""

import json
import os
import sys

import numpy as np
import torch

from .core.framework import CPUPlace, CUDAPlace

SERIALIZED_PT2 = "__serialized__.pt2"
SERIALIZED_META = "__serialized__.json"
MANIFEST = "__manifest__.txt"
# the JAX package's artifact (a jax.export executable): not loadable here
JAX_SERIALIZED = "__serialized__.bin"
# the custom ops an exported graph may hold, by the kernel they launch
CUSTOM_OPS = {"K1": "paddle_tpu_torch.flash_attention_fwd.default",
              "K6": "paddle_tpu_torch.int8_matmul.default"}

# model dirs already warned about enable_bf16 on an AOT artifact: once per
# directory per process, not per predictor or per call
_BF16_AOT_WARNED = set()


class AOTArtifactError(RuntimeError):
    """An AOT artifact this predictor refuses: the JAX package's
    executable, one exported on another device kind, or a program that
    cannot be exported."""


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
        """Run the loaded program under the bf16 cast policy (the
        float16_transpiler capability): the pass pipeline's
        amp_propagate annotates the program, and matmuls run in bf16 on
        the tensor cores.  Requires nothing of the saved model: its
        weights stay fp32."""
        self._bf16 = True

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


class ZeroCopyTensor:
    """ZeroCopyTensor parity (``paddle_api.h:86``,
    ``details/zero_copy_tensor.cc``): ``copy_from_cpu`` stages an input on
    the predictor's device once, and ``zero_copy_run`` reads it there with
    no host-to-device feed copy.  An output stays on the device until
    ``copy_to_cpu`` (the reference's deferred fetch); after ``run()`` it
    holds that run's host array."""

    def __init__(self, name, dtype=None, device=None):
        self.name = name
        self._dtype = np.dtype(dtype) if dtype is not None else None
        self._device = device if device is not None else \
            torch.device("cpu")
        self._buf = None
        self._shape = None
        self._pinned = None          # the source of an in-flight copy

    def reshape(self, shape):
        self._shape = list(shape)

    def shape(self):
        return [] if self._buf is None else list(self._buf.shape)

    def copy_from_cpu(self, arr):
        """Stage `arr` (cast to the input's dtype, reshaped as set) on the
        device: on CUDA through pinned host memory with a non-blocking
        copy on the current stream, which the run that reads it follows;
        on the CPU as a copy of its own."""
        a = np.asarray(arr)
        if self._dtype is not None:
            a = a.astype(self._dtype, copy=False)
        if self._shape is not None:
            a = a.reshape(self._shape)
        host = torch.from_numpy(np.array(a, copy=True, order="C"))
        if self._device.type == "cuda":
            # kept until the next staging: the copy reads it
            self._pinned = host.pin_memory()
            self._buf = self._pinned.to(self._device, non_blocking=True)
        else:
            self._buf = host

    def copy_to_cpu(self):
        if self._buf is None:
            raise RuntimeError(
                f"ZeroCopyTensor '{self.name}' holds no data — run "
                f"zero_copy_run() (outputs) or copy_from_cpu (inputs) "
                f"first")
        if isinstance(self._buf, torch.Tensor):
            from .core.executor import _to_numpy
            return _to_numpy(self._buf)
        return np.asarray(self._buf)


class Predictor:
    """PaddlePredictor parity: run(inputs) -> outputs.

    Two load paths:
    - program mode: load_inference_model, the verifier and the pass
      pipeline, then the port's Executor (captured on a CUDA place);
    - AOT mode: ``__serialized__.pt2`` present -> ``torch.export.load``;
      the Program is never rebuilt.
    """

    def __init__(self, config):
        from .core.executor import device_of

        self.config = config
        self._device = device_of(config.place())
        self._zc_in, self._zc_out = {}, {}
        self._aot = self._meta = self._program = None
        d = config.model_dir
        if os.path.exists(os.path.join(d, SERIALIZED_PT2)):
            self._load_aot(d)
        elif os.path.exists(os.path.join(d, JAX_SERIALIZED)):
            raise AOTArtifactError(
                f"{d!r} holds {JAX_SERIALIZED}, the JAX package's "
                "jax.export executable, which this package cannot run: "
                "export it again with this package's "
                "Predictor.export_serialized (it writes "
                f"{SERIALIZED_PT2}), or load the program-mode model from a "
                "directory without it")
        else:
            self._load_program(d)

    # ---- loading ---------------------------------------------------------

    def _load_program(self, d):
        from . import io as io_mod
        from .core.executor import Executor, Scope, scope_guard

        config = self.config
        self._scope = Scope()
        self._exe = Executor(config.place())
        with scope_guard(self._scope):
            program, feed_names, fetch_vars = io_mod.load_inference_model(
                d, self._exe, model_filename=config.prog_file,
                params_filename=config.params_file)
        self._feed_names = list(feed_names)
        self._fetch_names = [v.name for v in fetch_vars]
        if getattr(config, "_bf16", False):
            program._amp = True
            program._version += 1
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

    def _load_aot(self, d):
        with open(os.path.join(d, SERIALIZED_META)) as f:
            meta = json.load(f)
        if meta.get("format") != "torch.export":
            raise AOTArtifactError(
                f"{os.path.join(d, SERIALIZED_META)} does not describe a "
                f"torch.export artifact (format {meta.get('format')!r})")
        here = self._device.type
        if meta["device"] != here:
            raise AOTArtifactError(
                f"the artifact in {d!r} was exported on {meta['device']!r} "
                f"({meta.get('device_name') or meta['device']}) and cannot "
                f"run on {here!r} ({self._device}): its graph and weights "
                f"were fixed on the export's device; export it again from a "
                f"program-mode predictor on {here!r}")
        self._meta = meta
        self._feed_names = list(meta["feed_names"])
        self._fetch_names = list(meta["fetch_names"])
        self._aot = _AOTModule(
            torch.export.load(os.path.join(d, SERIALIZED_PT2)),
            self._device)
        if getattr(self.config, "_bf16", False):
            self._warn_bf16_aot(d)

    def _warn_bf16_aot(self, d):
        """enable_bf16() cannot reach an exported graph, whose dtypes were
        fixed at export: say so once per directory."""
        if d in _BF16_AOT_WARNED:
            return
        _BF16_AOT_WARNED.add(d)
        ser = "bfloat16 (exported under enable_bf16)" \
            if self._meta.get("amp") else "float32"
        if self._meta.get("quant"):
            ser += ("; int8-quantized weights baked in (exported under "
                    "enable_quantize)")
        print(f"[paddle_tpu_torch.inference] WARNING: enable_bf16() has no "
              f"effect on the exported program in {d!r} — its dtypes were "
              f"fixed at export (serialized compute dtype: {ser}; "
              f"requested: bfloat16).  Export again from a program-mode "
              f"predictor whose AnalysisConfig had enable_bf16() to change "
              f"it.", file=sys.stderr)

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    # ---- program mode ----------------------------------------------------

    def _run_feeds(self, feed, return_numpy=True):
        """{name: array or tensor} -> list of fetches, in inference
        mode."""
        from .ops import registry

        with registry.test_mode():
            return self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_names,
                                 scope=self._scope,
                                 return_numpy=return_numpy)

    def _precompile(self, feed):
        """Capture `feed`'s signature in inference mode without running a
        batch (``Executor.precompile``; nothing on the CPU)."""
        from .ops import registry

        with registry.test_mode():
            self._exe.precompile(self._program, feed=feed,
                                 fetch_list=self._fetch_names,
                                 scope=self._scope)

    # ---- both modes ------------------------------------------------------

    def _feed_dtypes(self):
        """{feed name: numpy dtype} the program (or the artifact) takes."""
        if self._meta is not None:
            return dict(zip(self._meta["feed_order"],
                            (np.dtype(t) for t in self._meta["feed_dtypes"])))
        from .ops.registry import np_dtype

        block = self._program.global_block()
        return {n: np.dtype(np_dtype(block.var(n).dtype))
                if block.has_var(n) else None for n in self._feed_names}

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
        if self._aot is not None:
            outs = self._aot.run_numpy([
                np.asarray(feed[n]).astype(t, copy=False)
                for n, t in zip(self._meta["feed_order"],
                                self._meta["feed_dtypes"])])
        else:
            outs = self._run_feeds({n: feed[n] for n in self._feed_names})
        # keep the zero-copy output views coherent when the APIs are mixed
        for name, o in zip(self._fetch_names, outs):
            self.get_output_tensor(name)._buf = o
        return outs

    # ---- zero-copy (AnalysisPredictor::GetInputTensor / GetOutputTensor /
    # ZeroCopyRun, analysis_predictor.h:78-90) ------------------------------

    def get_input_tensor(self, name):
        if name not in self._feed_names:
            raise KeyError(f"{name!r} is not an input of this predictor "
                           f"({self._feed_names})")
        t = self._zc_in.get(name)
        if t is None:
            t = self._zc_in[name] = ZeroCopyTensor(
                name, self._feed_dtypes().get(name), self._device)
        return t

    def get_output_tensor(self, name):
        t = self._zc_out.get(name)
        if t is None:
            t = self._zc_out[name] = ZeroCopyTensor(name,
                                                    device=self._device)
        return t

    def zero_copy_run(self):
        """Run on the staged device tensors; the outputs stay on the
        device (read them with get_output_tensor(n).copy_to_cpu()).  Does
        not wait for the card."""
        def staged(n):
            t = self._zc_in.get(n)
            if t is None or t._buf is None:
                raise RuntimeError(
                    f"zero_copy_run: input '{n}' was never staged — call "
                    f"get_input_tensor('{n}').copy_from_cpu(...) first")
            return t._buf

        if self._aot is not None:
            outs = self._aot.run([staged(n)
                                  for n in self._meta["feed_order"]])
        else:
            outs = self._run_feeds({n: staged(n) for n in self._feed_names},
                                   return_numpy=False)
        for name, o in zip(self._fetch_names, outs):
            self.get_output_tensor(name)._buf = o

    # ---- serving and export ----------------------------------------------

    def serving_handle(self):
        """Input specs + per-signature callables for
        ``serving.ServingEngine`` (program or AOT mode).  The engine takes
        ownership: don't call run() concurrently."""
        return _ServingHandle(self)

    def export_serialized(self, example_feed, dirname=None):
        """Export the loaded program with ``torch.export`` at
        `example_feed`'s static shapes, weights included, into `dirname`
        (the model dir by default): ``__serialized__.pt2``,
        ``__serialized__.json`` and ``__manifest__.txt``.  Refuses a
        program the compiled step refuses (host ops, host reads,
        ``while``, ``conditional_block``, generator ops: the names
        ``executor.capture_refusals`` gives).  Returns the ``.pt2``
        path."""
        from .core.executor import capture_refusals
        from .ops import registry

        if self._program is None:
            raise AOTArtifactError("this predictor already runs from an "
                                   "exported program")
        refused = capture_refusals(self._program)
        if refused:
            raise AOTArtifactError(
                f"export_serialized: the program holds ops a static export "
                f"cannot carry ({refused}: host ops, host reads of values, "
                f"loops, branches and generator-seeded draws); serve it in "
                f"program mode")
        d = dirname or self.config.model_dir
        os.makedirs(d, exist_ok=True)
        order = sorted(self._feed_names)
        dtypes = self._feed_dtypes()
        args = tuple(registry.cast_feed(
            np.asarray(example_feed[n]).astype(dtypes[n] or np.float32),
            self._program.global_block().var(n).dtype
            if self._program.global_block().has_var(n) else "float32",
            self._device) for n in order)
        module = _ProgramModule(self._program, order, self._fetch_names,
                                self._scope, self._device)
        # the interpreter's Python frames are no node's source: skip
        # recording a stack trace a node, most of the trace's time
        config = torch.fx.config
        emit = getattr(config, "do_not_emit_stack_traces", None)
        try:
            if emit is not None:
                config.do_not_emit_stack_traces = True
            with torch.no_grad():
                ep = torch.export.export(module, args, strict=False)
        finally:
            if emit is not None:
                config.do_not_emit_stack_traces = emit
        outs = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
        out_vals = [n.meta["val"] for n in outs]
        counts = {}
        for node in ep.graph.nodes:
            for k, target in CUSTOM_OPS.items():
                if node.op == "call_function" and str(node.target) == target:
                    counts[k] = counts.get(k, 0) + 1
        path = os.path.join(d, SERIALIZED_PT2)
        torch.export.save(ep, path)
        meta = {
            "format": "torch.export",
            "device": self._device.type,
            "device_name": torch.cuda.get_device_name(self._device)
            if self._device.type == "cuda" else "cpu",
            "feed_names": list(self._feed_names),
            "feed_order": order,
            "feed_dtypes": [np.dtype(dtypes[n] or np.float32).name
                            for n in order],
            "feed_shapes": [list(a.shape) for a in args],
            "fetch_names": list(self._fetch_names),
            "fetch_dtypes": [str(v.dtype).replace("torch.", "")
                             for v in out_vals],
            # what a later enable_bf16-on-AOT warning names
            "amp": bool(getattr(self._program, "_amp", False)),
            "quant": bool(getattr(self._program, "_quant", False)),
            "custom_ops": counts,
        }
        with open(os.path.join(d, SERIALIZED_META), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(d, MANIFEST), "w") as f:
            f.write(f"{len(order)}\n")
            for n, a in zip(order, args):
                dims = " ".join(str(x) for x in a.shape)
                f.write(f"{n} {meta['feed_dtypes'][order.index(n)]} "
                        f"{a.dim()} {dims}\n")
            f.write(f"{len(out_vals)}\n")
            for name, v, t in zip(self._fetch_names, out_vals,
                                  meta["fetch_dtypes"]):
                dims = " ".join(str(x) for x in v.shape)
                f.write(f"{name} {t} {v.dim()} {dims}\n")
        return path


class _ProgramModule(torch.nn.Module):
    """What ``export_serialized`` exports: the Scope's persistables that
    the block reads as buffers, and a forward(*feeds in sorted name order)
    that runs the block through the port's interpreter in test mode and
    returns the fetches."""

    def __init__(self, program, feed_order, fetch_names, scope, device):
        from .core.executor import _scope_read, _upward_reads, read_names

        super().__init__()
        block = program.global_block()
        self._program = program
        self._feed_order = list(feed_order)
        self._fetch_names = list(fetch_names)
        self._device = device
        self._reads = read_names(block, fetch_names)
        self._state = sorted(_upward_reads(block, feed_order) |
                             {n for n in fetch_names
                              if n not in _written(block, feed_order)})
        # buffer names may not hold the program's dots.  An int8 weight
        # laid out K-major for K6 (the [K, N] view of a zero-padded
        # [N, Kp] buffer, quant_kernels.k_major) is kept as that whole
        # buffer and viewed again in forward, so the artifact saves whole
        # tensors and K6 finds its layout after a load
        self._k_major = {}            # buffer index -> K
        for i, n in enumerate(self._state):
            t = _scope_read(scope, n, device)
            if isinstance(t, torch.Tensor) and not t.is_contiguous():
                self._k_major[i] = t.shape[0]
                t = _k_major_base(t, n)
            self.register_buffer(f"state_{i}", t)

    def forward(self, *feeds):
        from .core.executor import _run_block
        from .ops import registry

        program = self._program
        block = program.global_block()
        env = dict(zip(self._feed_order, feeds))
        state = {}
        for i, n in enumerate(self._state):
            t = getattr(self, f"state_{i}")
            k = self._k_major.get(i)
            state[n] = t if k is None else t[:, :k].t()

        def read(n):
            env[n] = state[n]
            return env[n]

        ctx = registry.ExecContext(
            device=self._device, seed=program.random_seed, step=0,
            is_test=True, masks={}, reads=self._reads,
            amp=getattr(program, "_amp", False))
        with registry.exec_context(ctx):
            _run_block(block, env, read)
            return tuple(env[n] if n in env else read(n)
                         for n in self._fetch_names)


def _k_major_base(t, name):
    """The [N, Kp] buffer under a K-major [K, N] view (stride (1, Kp),
    offset 0, Kp >= K): what ``_ProgramModule`` saves in its place."""
    if t.dim() != 2 or t.stride(0) != 1 or t.stride(1) < t.shape[0] or \
            t.storage_offset() or t.untyped_storage().nbytes() < \
            t.shape[1] * t.stride(1) * t.element_size():
        raise AOTArtifactError(
            f"export_serialized: state {name!r} is a strided view "
            f"{tuple(t.shape)} / {t.stride()} that is not a K-major weight; "
            "an export saves whole tensors")
    n, kp = t.shape[1], t.stride(1)
    return t.as_strided((n, kp), (kp, 1))


def _written(block, feed_order):
    from .core.executor import _block_io

    return set(feed_order) | _block_io(block)[1]


class _AOTModule:
    """A loaded exported program on its device: eager calls, and on CUDA
    one captured graph per input signature (``capture``), as the
    compiled step captures a program (``core/executor._CompiledBlock``):
    the first call of a signature runs op by op (the warm-up of cuBLAS and
    the kernels' build), the capture runs nothing, and each replay adds
    the launch counters' captured deltas."""

    def __init__(self, ep, device):
        self.ep = ep
        self.module = ep.module()
        self.device = device
        self.graphs = {}             # signature -> _AOTGraph
        self._pool = self._stream = None

    def run(self, args):
        """The fetches of one eager call, as tensors on the device."""
        with torch.no_grad():
            outs = self.module(*args)
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]

    def run_numpy(self, arrays):
        from .core.executor import _to_numpy

        args = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]
        return [_to_numpy(o) for o in self.run(args)]

    def capture(self, arrays):
        """The callable that serves `arrays`' signature: a replay of its
        captured graph on CUDA, an eager call on the CPU."""
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in arrays)
        g = self.graphs.get(sig)
        if g is None:
            g = self.graphs[sig] = _AOTGraph(self, arrays)
        return g

    def _capture_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        return self._pool, self._stream


class _AOTGraph:
    """One input signature of an exported module: static input buffers,
    the captured graph and its outputs, each launch counter's delta."""

    def __init__(self, aot, arrays):
        from .core.executor import capture_graph

        self.aot = aot
        self.graph = None
        self.launches = ()
        self.inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(
            aot.device) for a in arrays]
        if aot.device.type != "cuda":
            return
        aot.run(self.inputs)                   # warm-up, op by op
        torch.cuda.synchronize(aot.device)
        self.graph, self.outputs, self.launches = capture_graph(
            lambda: aot.run(self.inputs), *aot._capture_pool())

    def __call__(self, arrays):
        """The fetches of one batch as numpy arrays."""
        from .core.executor import _to_numpy

        if self.graph is None:
            return self.aot.run_numpy(arrays)
        for buf, a in zip(self.inputs, arrays):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        self.graph.replay()
        for counter, delta in self.launches:
            counter.launches += delta
        return [_to_numpy(o) for o in self.outputs]


class _ServingHandle:
    """The bridge `serving.ServingEngine` drives.  `compile(feeds)`
    records the padded shape signature and returns the callable that
    serves it: in program mode it captures the signature on a CUDA place
    (``Executor.precompile``: one CUDA graph per bucket, as the reference
    AOT-compiles one executable per bucket); in AOT mode one CUDA graph
    of the exported module (an eager call on the CPU), whose shapes were
    fixed at export (``fixed_shapes``: one batch bucket).  `call(compiled,
    feeds)` runs one batch and returns its fetches as numpy arrays."""

    retry_safe = True       # no donated state: a failed call consumes nothing

    def __init__(self, predictor):
        p = self._p = predictor
        if p._aot is not None:
            meta = p._meta
            self.feed_order = list(meta["feed_order"])
            self.declared_order = list(meta["feed_names"])
            self.feed_dtypes = [np.dtype(t) for t in meta["feed_dtypes"]]
            self.fetch_names = list(meta["fetch_names"])
            # the engine pads the batch onto the exported row count; the
            # other dims must match the export already
            self.fixed_shapes = [tuple(s) for s in meta["feed_shapes"]]
        else:
            dtypes = p._feed_dtypes()
            self.feed_order = sorted(p._feed_names)
            self.declared_order = list(p._feed_names)
            self.feed_dtypes = [dtypes[n] or np.dtype(np.float32)
                                for n in self.feed_order]
            self.fetch_names = list(p._fetch_names)
            self.fixed_shapes = None
        self.signatures = []

    def check_reloadable(self):
        """An exported program holds its weights as its own buffers: a
        warm reload cannot reach them."""
        if self._p._aot is not None:
            raise RuntimeError(
                "weight reload requires a program-mode predictor (an "
                "exported program holds its weights; export again from a "
                "reloaded program-mode predictor)")

    def compile(self, feeds):
        self.signatures.append(
            tuple((n, tuple(feeds[n].shape), str(feeds[n].dtype))
                  for n in self.feed_order))
        if self._p._aot is not None:
            return self._p._aot.capture([feeds[n] for n in self.feed_order])
        self._p._precompile(feeds)
        return self._p._run_feeds

    def example_feeds(self, batch, seq=None, axis=1):
        """Zero feeds for one (batch bucket, seq bucket) grid point, or
        None when an input's non-batch dims can't be determined (a -1
        dim with no seq bucket covering it)."""
        out = {}
        for idx, n in enumerate(self.feed_order):
            if self.fixed_shapes is not None:
                dims = list(self.fixed_shapes[idx])
            else:
                block = self._p._program.global_block()
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
        if self._p._aot is not None:
            return compiled([feeds[n] for n in self.feed_order])
        return compiled(feeds)


def create_paddle_predictor(config):
    """create_paddle_predictor (paddle_api.h:314)."""
    return Predictor(config)
