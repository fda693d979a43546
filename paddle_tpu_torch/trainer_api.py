"""High-level Trainer/Inferencer (reference
``python/paddle/fluid/contrib/trainer.py:169`` /
``contrib/inferencer.py:31`` — the book chapters' "high-level API"; a
port of ``paddle_tpu/trainer_api.py``).

Trainer(train_func, optimizer_func) builds train+startup programs from
the user's program function, runs the epoch/step loop with
Begin/End{Epoch,Step}Event callbacks, and save_params/Inferencer round-
trip through io.save_params/load_params.  The loop is synchronous
(``dataio=False``: convert and feed on the training thread) or, by
default, pipelined over the port's ``dataio``: a ``DataPipeline`` thread
converts batch k+1 while step k runs and a ``DeviceStager`` copies it to
the executor's device from pinned memory on a side stream.
``parallel=True`` maps to the port's ``CompiledProgram`` (the reference's
ParallelExecutor slot).  The Executor runs on the card unless `place` is
a ``CPUPlace``.

Not ported yet (ROADMAP queue 1 item 12), and raising
``NotImplementedError`` naming it: manifest checkpoints and resume
(``CheckpointConfig(manifest=True)``, the reference's ``checkpoint/``),
the numerics watchdog (``stepguard``) and preemption handling
(``preempt``, ``resilience/``), the step timeline and flight recorder
(``FLAGS_telemetry``, ``FLAGS_flight_recorder``, ``observability/``),
and ``ElasticTrainer`` (``elastic/``).  The epoch checkpoints of
``CheckpointConfig(manifest=False)`` are ``save_params`` and run.
"""

import os
import shutil

import numpy as np

from .core import unique_name
from .core.executor import Executor, Scope, scope_guard
from .core.framework import Program, program_guard

_ITEM_12 = "ROADMAP queue 1 item 12 (runtime services)"


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet: {_ITEM_12}")


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """contrib/trainer.py CheckpointConfig surface: param saves under
    checkpoint_dir every epoch_interval epochs, the newest
    max_num_checkpoints kept.  ``manifest=True`` (step-granular manifest
    checkpoints with optimizer state and resume) needs the reference's
    ``checkpoint/`` subsystem, which is not ported yet."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10, manifest=False,
                 async_save=True, keep_every_k=0, resume=False):
        self.checkpoint_dir = checkpoint_dir or "checkpoints"
        self.max_num_checkpoints = max(int(max_num_checkpoints), 1)
        self.epoch_interval = max(int(epoch_interval), 1)
        self.step_interval = max(int(step_interval), 1)
        self.manifest = bool(manifest)
        self.async_save = bool(async_save)
        self.keep_every_k = int(keep_every_k)
        self.resume = bool(resume)


class Trainer:
    """contrib/trainer.py:169 surface."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        if checkpoint_config is not None and (checkpoint_config.manifest or
                                              checkpoint_config.resume):
            raise _not_ported("CheckpointConfig(manifest=True) / resume "
                              "(the checkpoint/ subsystem)")
        self.__stop = False
        self.parallel = parallel
        self.place = place
        self.checkpoint_cfg = checkpoint_config
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()

        with program_guard(self.train_program, self.startup_program), \
                unique_name.guard():
            outs = train_func()
            self.train_func_outputs = outs if isinstance(
                outs, (list, tuple)) else [outs]
            loss = self.train_func_outputs[0]
            # the test program is cloned BEFORE minimize (as the contrib
            # trainer does), so evaluation never updates parameters
            self.test_program = self.train_program.clone(for_test=True)
            optimizer = optimizer_func()
            optimizer.minimize(loss)

        self.exe = Executor(place)
        self._global_step = 0
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            if param_path:
                from . import io as io_mod
                io_mod.load_params(self.exe, param_path,
                                   main_program=self.train_program)

        self._run_program = self.train_program
        if parallel:
            from .compiler import CompiledProgram
            self._run_program = CompiledProgram(
                self.train_program).with_data_parallel(loss_name=loss.name)

    def stop(self):
        self.__stop = True

    def _default_feed_order(self):
        block = self.train_program.global_block()
        return [n for n, v in block.vars.items()
                if getattr(v, "is_data", False) and
                not n.endswith("@SEQ_LEN") and
                not n.endswith("@SEQ_LEN2")]

    def train(self, num_epochs, event_handler, reader=None,
              feed_order=None, dataio=None, stepguard=None,
              preempt=None):
        """reader yields BATCHES of sample tuples (wrap a per-sample
        generator with a batching reader, as the book chapters do); tuple
        positions follow feed_order (default: the program's data vars in
        definition order).

        dataio: None or True (the default) runs the pipelined loop over
        the port's ``dataio`` with a default ``DataioConfig``; a
        ``DataioConfig`` tunes its queue; False runs the synchronous
        loop.  `stepguard` and `preempt` are not ported yet (ROADMAP
        queue 1 item 12)."""
        from .data_feeder import DataFeeder
        from .dataio import DataioConfig

        if reader is None:
            raise ValueError("Trainer.train needs a (batched) reader")
        if stepguard:
            raise _not_ported("Trainer.train(stepguard=...) (the "
                              "resilience.stepguard watchdog)")
        if preempt:
            raise _not_ported("Trainer.train(preempt=...) (the "
                              "resilience.preempt grace handling)")
        for flag in ("FLAGS_telemetry", "FLAGS_flight_recorder"):
            # the port defines neither flag; a run that sets one asks for
            # the reference's step timeline or flight recorder
            if os.environ.get(flag, "") not in ("", "0", "false", "False"):
                raise _not_ported(f"{flag} (the observability timeline "
                                  "and flight recorder)")
        if dataio is None or dataio is True:
            cfg = DataioConfig()
        elif isinstance(dataio, DataioConfig):
            cfg = dataio
        elif dataio is False:
            cfg = None
        else:
            raise TypeError(
                "dataio must be a DataioConfig, True/None (default "
                "pipeline) or False (synchronous loop)")
        feed_order = feed_order or self._default_feed_order()
        feeder = DataFeeder(feed_list=list(feed_order),
                            program=self.train_program)
        fetch_names = [v.name for v in self.train_func_outputs]
        if cfg is None:
            self._train_sync(num_epochs, event_handler, reader, feeder,
                             fetch_names)
        else:
            self._train_pipelined(num_epochs, event_handler, reader,
                                  feeder, fetch_names, cfg)

    def _step(self, epoch_id, step_id, event_handler, feed, fetch_names):
        begin = BeginStepEvent(epoch_id, step_id)
        event_handler(begin)
        if begin.fetch_metrics:
            metrics = self.exe.run(self._run_program, feed=feed,
                                   fetch_list=fetch_names)
        else:
            self.exe.run(self._run_program, feed=feed, fetch_list=[])
            metrics = []
        event_handler(EndStepEvent(epoch_id, step_id, metrics))
        self._global_step += 1

    def _train_sync(self, num_epochs, event_handler, reader, feeder,
                    fetch_names):
        """Synchronous loop: decode and feed on the training thread, every
        step pays the host input time."""
        with scope_guard(self.scope):
            for epoch_id in range(num_epochs):
                if self.__stop:
                    break
                event_handler(BeginEpochEvent(epoch_id))
                for step_id, data in enumerate(reader()):
                    if self.__stop:
                        break
                    self._step(epoch_id, step_id, event_handler,
                               feeder.feed(data), fetch_names)
                if self.__stop:
                    # stopped mid-epoch: no EndEpochEvent or checkpoint for
                    # a partial epoch (the contrib trainer returns from
                    # inside the step loop)
                    break
                event_handler(EndEpochEvent(epoch_id))
                self._maybe_epoch_checkpoint(epoch_id)

    def _train_pipelined(self, num_epochs, event_handler, reader, feeder,
                         fetch_names, cfg):
        """dataio loop: the pipeline's thread converts batch k+1 while step
        k computes, and the stager copies it to the executor's device
        from pinned memory on a side stream (double-buffered)."""
        from .dataio import DataPipeline, DeviceStager

        with scope_guard(self.scope):
            for epoch_id in range(num_epochs):
                if self.__stop:
                    break
                event_handler(BeginEpochEvent(epoch_id))
                pipe = DataPipeline(reader, feed_fn=feeder.feed, config=cfg)
                stager = DeviceStager(self.exe.device)
                pipe.start()
                stager.start(pipe.next_feed)
                step_id = 0
                try:
                    while not self.__stop:
                        handle = stager.next_handle()
                        if handle is None:
                            break
                        self._step(epoch_id, step_id, event_handler,
                                   handle.ready(), fetch_names)
                        step_id += 1
                finally:
                    pipe.reset()        # before stager.stop(): unblocks
                    stager.stop()
                if self.__stop:
                    break
                event_handler(EndEpochEvent(epoch_id))
                self._maybe_epoch_checkpoint(epoch_id)

    def _maybe_epoch_checkpoint(self, epoch_id):
        cfg = self.checkpoint_cfg
        if cfg is not None and (epoch_id + 1) % cfg.epoch_interval == 0:
            self._save_checkpoint(epoch_id)

    def _save_checkpoint(self, epoch_id):
        cfg = self.checkpoint_cfg
        self.save_params(os.path.join(cfg.checkpoint_dir,
                                      f"epoch_{epoch_id}"))
        # prune beyond max_num_checkpoints, oldest first
        kept = sorted((d for d in os.listdir(cfg.checkpoint_dir)
                       if d.startswith("epoch_")),
                      key=lambda d: int(d.split("_")[1]))
        for stale in kept[:-cfg.max_num_checkpoints]:
            shutil.rmtree(os.path.join(cfg.checkpoint_dir, stale),
                          ignore_errors=True)

    def save_params(self, param_path):
        from . import io as io_mod
        with scope_guard(self.scope):
            io_mod.save_params(self.exe, param_path,
                               main_program=self.train_program)

    def test(self, reader, feed_order):
        """Mean of the train_func outputs over the reader (a test pass)."""
        from .data_feeder import DataFeeder

        test_prog = self.test_program
        feeder = DataFeeder(feed_list=list(feed_order), program=test_prog)
        fetch_names = [v.name for v in self.train_func_outputs]
        totals, count = None, 0
        with scope_guard(self.scope):
            for data in reader():
                vals = self.exe.run(test_prog, feed=feeder.feed(data),
                                    fetch_list=fetch_names)
                vals = [float(np.asarray(v).mean()) for v in vals]
                totals = vals if totals is None else \
                    [a + b for a, b in zip(totals, vals)]
                count += 1
        return [t / max(count, 1) for t in (totals or [])]


def __getattr__(name):
    # the reference's elastic re-mesh loop (PEP 562 lazy re-export)
    if name in ("ElasticTrainer", "ElasticConfig"):
        raise _not_ported(f"trainer_api.{name} (the elastic/ re-mesh "
                          "loop)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Inferencer:
    """contrib/inferencer.py:31 surface."""

    def __init__(self, infer_func, param_path, place=None, parallel=False):
        if parallel:
            raise NotImplementedError(
                "Inferencer(parallel=True): compile the program with "
                "CompiledProgram.with_data_parallel instead")
        self.param_path = param_path
        self.scope = Scope()
        self.place = place
        self.inference_program = Program()
        startup = Program()
        with program_guard(self.inference_program, startup), \
                unique_name.guard():
            self.predict_var = infer_func()
        self.inference_program = self.inference_program.clone(
            for_test=True)
        self.exe = Executor(place)
        with scope_guard(self.scope):
            from . import io as io_mod
            io_mod.load_params(self.exe, param_path,
                               main_program=self.inference_program)

    def infer(self, inputs, return_numpy=True):
        """inputs: dict name -> array."""
        with scope_guard(self.scope):
            return self.exe.run(self.inference_program, feed=inputs,
                                fetch_list=[self.predict_var],
                                return_numpy=return_numpy)
