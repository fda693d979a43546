"""CompiledProgram — a Program run over a device mesh (the port of
``paddle_tpu/compiler.py``).

Reference: ``python/paddle/fluid/compiler.py:39`` — CompiledProgram
.with_data_parallel wires BuildStrategy/ExecutionStrategy into the C++
ParallelExecutor.  The JAX package collapses the multi-device graph into
one pjit computation over a ``jax.sharding.Mesh``, where the data and
model axes only place values (GSPMD keeps the math of one device) and
the ring attention and gpipe ops run per-shard programs over the seq and
pipe axes.

The port keeps that contract single-controller: ``_run`` interprets the
program with the Executor on the executor's place, with the mesh in the
run's context (``registry.ExecContext.mesh``, the reference's
``TRACE_CTX.mesh``).  Dense ops run on that one device, so the data and
model axes change no number; ``ring_attention`` and ``gpipe`` place their
shards and stages on the mesh's entries.  Spreading the dense ops over
several cards waits for the multi-process mesh (ROADMAP queue 1).
"""

from .core.executor import (_as_fetch_name, _normalize_feed, device_of,
                            global_scope, read_names)
from .parallel.mesh import Mesh, MeshAxes, cuda_devices


class BuildStrategy:
    """Knob surface of details/build_strategy.h:55-83."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = False
        self.enable_inplace = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_relu_depthwise_conv = False
        self.fuse_broadcast_ops = False
        self.fuse_all_optimizer_ops = False
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """pybind.cc:981 surface; the scheduling knobs have no effect on the
    op-by-op interpreter and are kept for API parity."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


def _default_mesh(places=None):
    """A data-axis mesh: over every visible CUDA device (places None), the
    first `places` of them (an int), or the devices of a list of places
    (``CPUPlace()`` entries give a CPU mesh).  With no CUDA device and no
    places it raises, as ``Executor()`` does."""
    if places is not None and not isinstance(places, int):
        devices = [device_of(p) for p in places]
    else:
        devices = cuda_devices()
        if not devices:
            raise RuntimeError(
                "CompiledProgram.with_data_parallel() meshes the CUDA "
                "devices, and PyTorch sees none; pass places=[fluid."
                "CPUPlace()] to run on the CPU")
        if places is not None:
            devices = devices[:places]
    return Mesh(devices, (MeshAxes.DATA,))


class CompiledProgram:
    def __init__(self, program_or_graph):
        self._program = program_or_graph
        self._is_data_parallel = False
        self._is_inference = False
        self._mesh = None
        self._loss_name = None
        self._build_strategy = None
        self._exec_strategy = None
        self._share_vars_from = None
        self._cache = {}

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        self._is_data_parallel = True
        self._loss_name = loss_name
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._share_vars_from = share_vars_from
        self._mesh = _default_mesh(places)
        return self

    def with_inference_optimize(self, config=None):
        self._is_inference = True
        return self

    @property
    def program(self):
        return self._program

    def _run(self, executor, feed=None, fetch_list=None, scope=None,
             return_numpy=True):
        """One run of the program on `executor` with the mesh in the run's
        context.  The verifier and the pass pipeline run once per
        (program version, feed names, fetch names), with the mesh, so
        auto_shard sees the model axis; their program and its read set
        are cached under that key."""
        program = self._program
        feed = _normalize_feed(program, dict(feed) if feed else {})
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]
        scope = scope if scope is not None else global_scope()
        feed_names = sorted(feed)
        key = (program._version, tuple(feed_names), tuple(fetch_names))
        prepared = self._cache.get(key)
        if prepared is None:
            from .analysis.verifier import validate_at_seam
            from .passes import apply_at_seam

            validate_at_seam(program, feed_names=feed_names,
                             fetch_names=fetch_names,
                             where="CompiledProgram.run")
            run_program = apply_at_seam(program, feed_names=feed_names,
                                        fetch_names=fetch_names,
                                        where="CompiledProgram.run",
                                        mesh=self._mesh)
            prepared = self._cache[key] = (
                run_program,
                read_names(run_program.global_block(), fetch_names))
        run_program, reads = prepared
        out = executor._run_program(run_program, feed, fetch_names, scope,
                                    return_numpy, reads, mesh=self._mesh)
        executor.last_guard = None       # no StepGuard in the port yet
        return out
