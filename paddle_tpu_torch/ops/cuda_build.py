"""Build and load the port's hand-written CUDA kernels.

Each source ``paddle_tpu_torch/csrc/<name>.cu`` exposes a plain C interface
and is compiled by ``nvcc`` for ``sm_90a`` into a shared library, at first
use, under ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``), then
loaded with ``ctypes``.  The library's file name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module on
a machine with no ``nvcc``.

Two kernels are ``torch.library`` custom ops as well (K1's forward,
``paddle_tpu_torch::flash_attention_fwd``, and K6,
``paddle_tpu_torch::int8_matmul``), so ``torch.export`` records them as
graph nodes and an exported program launches them.  Every other
wrapper calls :func:`refuse_export` first: under ``torch.export`` it
raises :class:`KernelNotExportable` naming its kernel, rather than let
the trace record the wrapper's plain version in the kernel's place.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "quant_matmul",
           "rnn_cells", "masked_softmax", "gather_rows", "fused_dropout",
           "paged_attention")

_LIBS = {}
_LOCK = threading.Lock()


def nvcc():
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from paddle_tpu_torch/csrc at first use")
    return path


def lib_path(name):
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    for f in [name + ".cu"] + sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name):
    """Start nvcc for `name` unless its library exists.  Returns
    (library path, (process, temp path) or None)."""
    out = lib_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name, out, job):
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees half a .so
    return log


def build_all(names=SOURCES):
    """Compile every named source, one nvcc each, all started together.
    Returns {name: nvcc/ptxas report} ('' where the library was built
    already)."""
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, out, job) if job else ""
            for n, (out, job) in jobs.items()}


def load(name):
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out, job = _start(name)
            if job:
                _finish(name, out, job)
            lib = _LIBS[name] = ctypes.CDLL(out)
        return lib


# every kernel wrapper that counts its launches: (module, wrapper names)
_COUNTED = ((".attention_kernels", ("flash_attention",
                                    "flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_with_lse")),
            (".dropout_kernels", ("fused_dropout",)),
            (".quant_kernels", ("int8_matmul", "paged_attention_quant")),
            (".rnn_kernels", ("fused_lstm_cell", "fused_gru_output")),
            (".sequence_kernels", ("masked_softmax",)),
            (".paged_kernels", ("paged_attention",)),
            ("..sparse.gather", ("gather_rows",)))


def launch_counters():
    """The wrappers whose ``launches`` attribute counts their kernel's
    launches, one per launch.  A captured CUDA graph's replay runs no
    Python, so the Executor adds each counter's delta over the captured
    step at every replay (``core/executor.py``)."""
    import importlib

    return [getattr(importlib.import_module(mod, __package__), name)
            for mod, names in _COUNTED for name in names]


class KernelNotExportable(RuntimeError):
    """A hand kernel's wrapper was reached while ``torch.export`` traced a
    program, and the kernel has no custom op an exported graph could
    hold."""


def refuse_export(kernel):
    """Raise :class:`KernelNotExportable` for `kernel` (its name and
    wrapper) when ``torch.export`` is tracing; nothing otherwise."""
    import torch

    if torch.compiler.is_exporting():
        raise KernelNotExportable(
            f"{kernel} has no torch.library custom op, so an exported "
            "program cannot launch it: export a program that does not "
            "reach it (only K1's forward and K6 export; ROADMAP queue 1 "
            "item 13 lists the rest)")
