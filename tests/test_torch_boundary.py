"""The port's package boundary: paddle_tpu_torch imports neither jax nor
paddle_tpu, and its entry points never move to the CPU behind the
caller's back."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as fluid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, "paddle_tpu_torch"))
    if "_build" not in os.path.relpath(d, REPO).split(os.sep)
    for f in fs if f.endswith(".py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def test_import_leaves_jax_and_paddle_tpu_out():
    code = ("import sys, paddle_tpu_torch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the modules of the pass pipeline, the int8 serving path, the RNN slice
# and the CTR slice, imported with jax and paddle_tpu made unimportable (a
# None entry in sys.modules)
NEW_MODULES = ("paddle_tpu_torch.analysis", "paddle_tpu_torch.passes",
               "paddle_tpu_torch.passes.quantize",
               "paddle_tpu_torch.ops.quant_kernels",
               "paddle_tpu_torch.inference",
               "paddle_tpu_torch.ops.rnn_kernels",
               "paddle_tpu_torch.ops.sequence_kernels",
               "paddle_tpu_torch.ops.rnn_ops",
               "paddle_tpu_torch.ops.sequence_ops",
               "paddle_tpu_torch.layers.rnn",
               "paddle_tpu_torch.layers.control_flow",
               "paddle_tpu_torch.sparse",
               "paddle_tpu_torch.sparse.engine",
               "paddle_tpu_torch.sparse.gather",
               "paddle_tpu_torch.sparse.shard_server",
               "paddle_tpu_torch.distributed.transport",
               "paddle_tpu_torch.distributed.rpc",
               "paddle_tpu_torch.distributed.host_ops",
               "paddle_tpu_torch.resilience.breaker",
               "paddle_tpu_torch.core.selected_rows",
               "paddle_tpu_torch.observability.propagate",
               "paddle_tpu_torch.models.ctr")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_without_jax_or_paddle_tpu(module):
    code = ("import sys\n"
            f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
            f"import importlib; importlib.import_module({module!r})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} and sys.modules[m] is not None))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_source_imports_no_jax_or_paddle_tpu(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {n}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="disable_gpu"):
        fluid.create_paddle_predictor(fluid.AnalysisConfig(str(tmp_path)))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.io.state_from_numpy({}, scope=fluid.Scope())
    assert fluid.Executor(fluid.CPUPlace()).device == torch.device("cpu")


def test_analysis_config_defaults_to_gpu():
    cfg = fluid.AnalysisConfig("d")
    assert cfg.use_gpu() and isinstance(cfg.place(), fluid.CUDAPlace)
    cfg.disable_gpu()
    assert not cfg.use_gpu() and isinstance(cfg.place(), fluid.CPUPlace)
    with pytest.raises(NotImplementedError):
        cfg.enable_bf16()
    cfg.enable_quantize()
    assert cfg._quant


def test_flags_define_only_what_the_port_reads(monkeypatch):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.observability import trace

    for name in ("use_pallas", "FLAGS_check_nan_inf", "enable_64bit"):
        with pytest.raises(KeyError, match="unknown flag"):
            fluid.set_flags({name: 1})
        with pytest.raises(KeyError, match="unknown flag"):
            fluid.get_flags(name)
    monkeypatch.setenv("FLAGS_seq_len_min_bucket", "32")
    assert fluid.get_flags("FLAGS_seq_len_min_bucket") == {
        "FLAGS_seq_len_min_bucket": 32}
    monkeypatch.setattr(flags, "_overrides", {})
    fluid.set_flags({"FLAGS_trace_sample_rate": 1.0})
    try:
        assert trace.TRACER.enabled()
    finally:
        fluid.set_flags({"trace_sample_rate": 0.0})
    assert not trace.TRACER.enabled()
