"""Legacy ParallelExecutor compat wrapper (fluid/parallel_executor.py; the
port of ``paddle_tpu/parallel_executor.py``).

The reference keeps this thin Python wrapper for pre-CompiledProgram
code; so does the port: it delegates to CompiledProgram.with_data_parallel
on one Executor.  ``use_cuda`` (default True: the card unless the caller
asks for the CPU) picks the Executor's place and the mesh's devices.
"""

import torch

from .compiler import CompiledProgram, BuildStrategy, ExecutionStrategy
from .core.executor import Executor, global_scope
from .core.framework import CPUPlace, CUDAPlace, default_main_program


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self._program = main_program or default_main_program()
        place = CUDAPlace(0) if use_cuda else CPUPlace()
        self._exe = Executor(place)
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy,
            exec_strategy=exec_strategy,
            share_vars_from=share_vars_from._compiled
            if isinstance(share_vars_from, ParallelExecutor)
            else share_vars_from,
            places=None if use_cuda else [place])
        self._scope = scope or global_scope()

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._compiled._run(self._exe, feed=feed,
                                   fetch_list=fetch_list, scope=self._scope,
                                   return_numpy=return_numpy)

    @property
    def device_count(self):
        return torch.cuda.device_count()


__all__ = ["ParallelExecutor", "BuildStrategy", "ExecutionStrategy"]
