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
    for f in fs if f.endswith(".py")) + ["chip_smoke.py"] + sorted(
        f for f in os.listdir(REPO) if f.endswith("_compare.py"))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def test_import_leaves_jax_and_paddle_tpu_out():
    code = ("import sys, paddle_tpu_torch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the modules of the pass pipeline, the int8 serving path, the RNN slice,
# the CTR slice, the NMT slice (K10, decode serving), the disaggregated
# tier (K4, K5, fault plans, the fleet router, kv_stream) and the
# sequence-parallel slice (the mesh, ring attention with K3, gpipe,
# CompiledProgram) and the dense image slice (conv ops, nets, ResNet, VGG,
# the zoo, DataFeeder, dataio, PyReader) and the control-flow slice (the
# tensor-array and IfElse ops, contrib.decoder, host decoding, the book's
# machine-translation model) and the sequence-labelling slice (the CRF,
# CTC and cos_sim ops, the learning-rate schedules, the book's
# semantic-role labeller and recommender), imported with jax and
# paddle_tpu made unimportable (a None entry in sys.modules)
NEW_MODULES = ("paddle_tpu_torch.analysis", "paddle_tpu_torch.passes",
               "paddle_tpu_torch.contrib",
               "paddle_tpu_torch.contrib.mixed_precision",
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
               "paddle_tpu_torch.models.ctr",
               "paddle_tpu_torch.models.transformer",
               "paddle_tpu_torch.ops.dropout_kernels",
               "paddle_tpu_torch.ops.sampling_kernels",
               "paddle_tpu_torch.serving.kv",
               "paddle_tpu_torch.serving.kv.pool",
               "paddle_tpu_torch.serving.kv.speculative",
               "paddle_tpu_torch.serving.sampling",
               "paddle_tpu_torch.serving.sampling.sampler",
               "paddle_tpu_torch.serving.fleet",
               "paddle_tpu_torch.serving.fleet.continuous",
               "paddle_tpu_torch.ops.paged_kernels",
               "paddle_tpu_torch.resilience.faults",
               "paddle_tpu_torch.serving.fleet.replica",
               "paddle_tpu_torch.serving.fleet.router",
               "paddle_tpu_torch.serving.disagg",
               "paddle_tpu_torch.serving.disagg.kvstream",
               "paddle_tpu_torch.serving.disagg.prefill",
               "paddle_tpu_torch.serving.disagg.router",
               "paddle_tpu_torch.parallel",
               "paddle_tpu_torch.parallel.mesh",
               "paddle_tpu_torch.parallel.env",
               "paddle_tpu_torch.parallel.ring_attention",
               "paddle_tpu_torch.ops.pipeline_ops",
               "paddle_tpu_torch.compiler",
               "paddle_tpu_torch.parallel_executor",
               "paddle_tpu_torch.models.dryrun",
               "paddle_tpu_torch.ops.conv_ops",
               "paddle_tpu_torch.nets",
               "paddle_tpu_torch.models.resnet",
               "paddle_tpu_torch.models.vgg",
               "paddle_tpu_torch.models.zoo",
               "paddle_tpu_torch.data_feeder",
               "paddle_tpu_torch.dataio",
               "paddle_tpu_torch.pyreader",
               "paddle_tpu_torch.ops.array_ops",
               "paddle_tpu_torch.ops.misc_ops",
               "paddle_tpu_torch.contrib.decoder",
               "paddle_tpu_torch.models.decoding",
               "paddle_tpu_torch.models.machine_translation",
               "paddle_tpu_torch.ops.crf_ops",
               "paddle_tpu_torch.ops.ctc_ops",
               "paddle_tpu_torch.ops.loss_ops",
               "paddle_tpu_torch.layers.learning_rate_scheduler",
               "paddle_tpu_torch.models.label_semantic_roles",
               "paddle_tpu_torch.models.recommender_system")


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
    cfg.enable_bf16()
    assert cfg._bf16
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


@pytest.mark.parametrize("name,default", [("use_fused_dropout", False),
                                          ("kv_block_size", 16),
                                          ("kv_num_blocks", 0)])
def test_nmt_slice_flags_have_the_reference_defaults(name, default,
                                                     monkeypatch):
    from paddle_tpu_torch import flags

    monkeypatch.setattr(flags, "_overrides", {})
    monkeypatch.delenv(f"FLAGS_{name}", raising=False)
    assert fluid.get_flags(name) == {f"FLAGS_{name}": default}
    monkeypatch.setenv(f"FLAGS_{name}", "1")
    assert fluid.get_flags(name)[f"FLAGS_{name}"] == type(default)(1)


def test_program_decode_step_runs_on_the_card_unless_asked(monkeypatch):
    """The decode engine's program step runs through an Executor, which
    means the card unless the caller passes CPUPlace(): without CUDA the
    default raises, and with CPUPlace the engine decodes on the CPU."""
    import numpy as np

    from paddle_tpu_torch.serving.fleet import (ContinuousBatchingEngine,
                                                ContinuousConfig,
                                                make_program_step_fn)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[-1, -1], dtype="int64",
                                append_batch_size=False)
        emb = fluid.layers.embedding(ids, size=[6, 4])
        logits = fluid.layers.fc(emb, size=6, num_flatten_dims=2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        step = make_program_step_fn(exe, main, logits,
                                    lambda p, n, c: {"ids": p})
        eng = ContinuousBatchingEngine(step, ContinuousConfig(
            slots=2, max_len=6, bos_id=0, eos_id=-1))
        try:
            out = eng.decode([0], max_new_tokens=3)
        finally:
            eng.stop()
    assert out.shape == (4,) and out.dtype == np.int64


def test_parallel_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """CompiledProgram.with_data_parallel, ParallelExecutor and make_mesh
    mesh the CUDA devices: without one they raise instead of moving to
    the CPU, and run on the CPU when the caller passes CPU places."""
    from paddle_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    main = fluid.Program()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.CompiledProgram(main).with_data_parallel()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.ParallelExecutor(main_program=main)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        make_mesh({"seq": 2})
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        places=[fluid.CPUPlace()] * 2)
    assert compiled._mesh.shape == {"data": 2}
    assert {d.type for d in compiled._mesh.devices.flat} == {"cpu"}
    pe = fluid.ParallelExecutor(use_cuda=False, main_program=main)
    assert pe._exe.device == torch.device("cpu") and pe.device_count == 0
