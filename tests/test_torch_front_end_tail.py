"""The front end's tail on the port against the JAX package, on the CPU:

- ``layers/parity_extra.py``: every layer builds the JAX package's ops op
  for op (types, slots, names, attrs), and each op type it brought with
  it runs as the JAX kernel does on the same seeded inputs (brelu,
  stanh, soft_relu with their clips' ties planted, prelu in its three
  modes, pad2d in its three modes, unstack, add_position_encoding,
  mean_iou, auc, the SelectedRows pair), forward and ``jax.vjp`` grads
  (elementwise 1e-6; the grads 1e-5 relative, ``torch_op_parity``); the
  batch-size-like random ops give the JAX kernel's answer when the JAX
  side is fed the port's draw (its ``jax.random`` patched), and the draws
  are uniform / normal and keyed by the op's seed; ``print`` runs on the
  host-op path;
- ``autoincreased_step_counter(begin=5, step=3)`` seeds its counter at
  begin - 1 and counts 7, 10, 13 in both packages, and a second call by
  the same name adds no increment;
- ``metrics``, ``average`` and ``data_feed_desc``: the port's copies give
  the reference's answers on the same inputs;
- ``Trainer`` on the book's ``fit_a_line`` (13 -> 1, SGD, batches of 8)
  from the JAX trainer's parameters: the port's losses, synchronous and
  pipelined over ``dataio``, within 1e-5 of the JAX ``Trainer``'s over
  two epochs, with the four events in order; ``Trainer.test``,
  ``save_params`` and ``Inferencer`` against the JAX package's; the
  item-12 arms (manifest checkpoints, stepguard, preempt, the telemetry
  flags, ElasticTrainer) raise naming ROADMAP queue 1 item 12;
- the ``fit_a_line`` flow (train, ``save_inference_model``, load, infer)
  on the port against the same flow in the JAX package from one state
  (the reference's ``tests/book/test_fit_a_line.py`` is red, so the flow
  is compared function by function), and the port's model dir served by
  the JAX package and back.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import average as jax_average
from paddle_tpu import data_feed_desc as jax_dfd
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu import metrics as jax_metrics
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch import average as port_average
from paddle_tpu_torch import data_feed_desc as port_dfd
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import metrics as port_metrics
from paddle_tpu_torch import trainer_api as port_trainer_api
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops import registry as port_registry
from torch_op_parity import (assert_grads_equal, assert_outputs_match,
                             case_ids, differentiable, f32, grad_call,
                             jax_outputs_of, run_port)

EW, RED = 1e-6, 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_jax(monkeypatch):
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


# -- the op types of parity_extra ---------------------------------------------

def _cases(rng):
    ties = np.array([[-1.0, 1.0, 0.5, -0.5], [2.0, -2.0, 0.0, 3.0]],
                    np.float32)
    x4 = f32(rng, 2, 3, 4, 5)
    stat = np.floor(np.abs(f32(rng, 11)) * 3).astype(np.float32)
    probs = rng.rand(12, 1).astype(np.float32)
    return [
        ("brelu", {"X": [ties]}, {"t_min": -1.0, "t_max": 1.0}, EW),
        ("brelu", {"X": [f32(rng, 3, 4, scale=20.0)]}, {}, EW),
        ("stanh", {"X": [f32(rng, 3, 4)]},
         {"scale_a": 0.67, "scale_b": 1.7159}, EW),
        ("soft_relu", {"X": [ties]}, {"threshold": 2.0}, EW),
        ("soft_relu", {"X": [f32(rng, 3, 4, scale=30.0)]}, {}, EW),
        ("prelu", {"X": [x4], "Alpha": [np.array([0.25], np.float32)]},
         {"mode": "all"}, EW),
        ("prelu", {"X": [x4], "Alpha": [f32(rng, 3)]}, {"mode": "channel"},
         EW),
        ("prelu", {"X": [x4], "Alpha": [f32(rng, 3, 4, 5)]},
         {"mode": "element"}, EW),
        ("pad2d", {"X": [x4]}, {"paddings": [1, 2, 0, 3], "mode":
                                "constant", "pad_value": 0.5}, EW),
        ("pad2d", {"X": [x4]}, {"paddings": [1, 2, 2, 1],
                                "mode": "reflect"}, EW),
        ("pad2d", {"X": [x4]}, {"paddings": [2, 0, 1, 3], "mode": "edge"},
         EW),
        ("unstack", {"X": [f32(rng, 2, 3, 4)]}, {"axis": 1}, EW),
        ("unstack", {"X": [f32(rng, 2, 3, 4)]}, {"axis": -1}, EW),
        ("add_position_encoding", {"X": [f32(rng, 2, 5, 6)]},
         {"alpha": 0.5, "beta": 2.0}, EW),
        ("mean_iou", {"Predictions": [rng.randint(0, 4, (3, 5)).astype(
            np.int32)], "Labels": [rng.randint(0, 4, (3, 5)).astype(
                np.int32)]}, {"num_classes": 5}, EW),
        ("auc", {"Predict": [np.concatenate([1 - probs, probs], 1)],
                 "Label": [rng.randint(0, 2, (12, 1)).astype(np.int64)],
                 "StatPos": [stat], "StatNeg": [stat[::-1].copy()]}, {},
         RED),
        ("get_tensor_from_selected_rows", {"X": [f32(rng, 4, 3)]}, {}, EW),
        ("merge_selected_rows", {"X": [f32(rng, 4, 3)]}, {}, EW),
    ]


CASES = _cases(np.random.RandomState(31))
GRAD_CASES = differentiable(CASES)


@pytest.fixture(scope="module")
def jax_forward():
    return jax_outputs_of([c[:3] for c in CASES])


@pytest.fixture(scope="module")
def jax_grads():
    return jax_outputs_of([grad_call(*c[:3]) for c in GRAD_CASES])


@pytest.mark.parametrize("k", range(len(CASES)), ids=case_ids(CASES))
def test_op_matches_jax(k, jax_forward):
    op, ins, attrs, tol = CASES[k]
    assert_outputs_match(op, jax_forward[k], run_port(op, ins, attrs), tol)


@pytest.mark.parametrize("k", range(len(GRAD_CASES)),
                         ids=case_ids(GRAD_CASES))
def test_generic_grad_matches_jax(k, jax_grads):
    op, ins, attrs, tol = GRAD_CASES[k]
    assert_grads_equal(op, jax_grads[k], run_port(*grad_call(op, ins, attrs)),
                       summed=tol == RED)


def test_ops_keep_the_jax_packages_differentiability():
    ops = sorted({c[0] for c in CASES} | {"uniform_random_batch_size_like",
                                          "gaussian_random_batch_size_like"})
    assert [o for o in ops if port_registry.is_differentiable(o)
            != jax_registry.is_differentiable(o)] == []


def test_selected_rows_to_dense():
    """A SelectedRows becomes its dense [height, D] tensor, duplicate rows
    added; merge_selected_rows hands the rows on (they add up where they
    are applied)."""
    sr = SelectedRows(torch.tensor([2, 0, 2]),
                      torch.arange(6, dtype=torch.float32).reshape(3, 2), 4)
    out = port_registry.run_op("get_tensor_from_selected_rows",
                               {"X": [sr]}, {})["Out"][0]
    assert torch.equal(out, torch.tensor([[2.0, 3.0], [0.0, 0.0],
                                          [4.0, 6.0], [0.0, 0.0]]))
    merged = port_registry.run_op("merge_selected_rows", {"X": [sr]},
                                  {})["Out"][0]
    assert torch.equal(merged.to_dense(), out)


RANDOM_ATTRS = {"shape": [-1, 7], "input_dim_idx": 0, "output_dim_idx": 0,
                "seed": 13, "dtype": "float32"}


@pytest.mark.parametrize("op,extra,patched", [
    ("uniform_random_batch_size_like", {"min": -2.0, "max": 3.0},
     "uniform"),
    ("gaussian_random_batch_size_like", {"mean": 1.5, "std": 0.5},
     "normal")])
def test_random_batch_size_like_on_the_ports_draw(op, extra, patched,
                                                   monkeypatch):
    ins = {"Input": [np.zeros((5, 3), np.float32)]}
    attrs = dict(RANDOM_ATTRS, **extra)
    got = run_port(op, ins, attrs)["Out"][0]
    assert got.shape == (5, 7)
    if patched == "uniform":
        lo, hi = extra["min"], extra["max"]
        unit = (got - lo) / (hi - lo)
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape, dtype, a, b: jnp.asarray(
                                unit.numpy()).reshape(shape) * (b - a) + a)
    else:
        unit = (got - extra["mean"]) / extra["std"]
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype: jnp.asarray(
                                unit.numpy()).reshape(shape))
    want = jax_registry.run_op(
        op, {"Input": [jnp.asarray(ins["Input"][0])]}, dict(attrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want["Out"][0]),
                               rtol=EW, atol=EW)
    # another op seed draws other values
    other = run_port(op, ins, dict(attrs, seed=14))["Out"][0]
    assert not torch.equal(other, got)


def test_random_batch_size_like_draws_are_uniform_and_normal():
    ins = {"Input": [np.zeros((4000, 1), np.float32)]}
    u = run_port("uniform_random_batch_size_like", ins,
                 dict(RANDOM_ATTRS, shape=[-1, 50], min=0.0, max=1.0)
                 )["Out"][0].numpy().ravel()
    g = run_port("gaussian_random_batch_size_like", ins,
                 dict(RANDOM_ATTRS, shape=[-1, 50], mean=0.0, std=1.0)
                 )["Out"][0].numpy().ravel()
    n = u.size
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    assert abs(u.var() - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
    assert abs(g.mean()) < 5 / np.sqrt(n) and abs(g.var() - 1) < 5 * \
        np.sqrt(2 / n)
    # the share within one standard deviation
    assert abs(np.mean(np.abs(g) < 1) - 0.682689) < 0.005


# -- the layers ---------------------------------------------------------------

def build_layers(pkg):
    fluid, init, names = (jfluid, jax_init, jax_unique_name) if pkg == "jax" \
        else (pfluid, port_init, port_unique_name)
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with names.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[3, 8, 8], dtype="float32")
        seq = L.data(name="seq", shape=[5, 6], dtype="float32")
        lab = L.data(name="lab", shape=[1], dtype="int64")
        L.brelu(x, t_min=0.5, t_max=4.0)
        L.stanh(x)
        L.soft_relu(x, threshold=10.0)
        for mode in ("all", "channel", "element"):
            L.prelu(x, mode)
        L.pad2d(x, paddings=[1, 1, 2, 0], mode="reflect")
        L.unstack(seq, axis=1)
        L.add_position_encoding(seq, alpha=0.5, beta=1.0)
        L.uniform_random([2, 3], seed=3)
        L.gaussian_random([2, 3])
        L.uniform_random_batch_size_like(x, [1, 4])
        L.gaussian_random_batch_size_like(x, [1, 4], std=0.1)
        probs = L.softmax(L.fc(input=x, size=2))
        L.dice_loss(probs, lab)
        L.isfinite(x)
        L.mean_iou(L.argmax(probs, axis=1), lab, 2)
        L.mul(x, L.create_parameter([192, 4], "float32", name="w_mul"))
        L.image_resize_short(x, 4)
        L.adaptive_pool2d(x, [2, 2], pool_type="avg")
        L.Print(x, message="x")
        L.get_tensor_from_selected_rows(x)
        L.merge_selected_rows(x)
        L.autoincreased_step_counter(begin=5, step=3)
        L.auc(probs, lab)
    return main, startup


def _op_list(program):
    out = []
    for op in program.global_block().ops:
        attrs = {k: v for k, v in op.attrs.items()
                 if not k.startswith("__") and k != "op_callstack"}
        out.append((op.type, dict(op.inputs), dict(op.outputs), attrs))
    return out


def test_layers_build_the_jax_packages_ops():
    jmain, jstart = build_layers("jax")
    pmain, pstart = build_layers("port")
    assert _op_list(pmain) == _op_list(jmain)
    assert _op_list(pstart) == _op_list(jstart)
    types = {op.type for op in pmain.global_block().ops}
    for t in ("brelu", "stanh", "soft_relu", "prelu", "pad2d", "unstack",
              "add_position_encoding", "uniform_random_batch_size_like",
              "gaussian_random_batch_size_like", "mean_iou", "auc", "print",
              "get_tensor_from_selected_rows", "merge_selected_rows"):
        assert t in types, t


def test_parity_extra_names_resolve_as_in_the_jax_package():
    """``fluid.layers`` imports parity_extra where the JAX package does, so
    each of its names resolves to the same module's definition in both
    packages (the detection layers stay with the detection ops)."""
    from paddle_tpu.layers import parity_extra as jax_extra
    from paddle_tpu_torch.layers import parity_extra as port_extra

    def origins(layers, extra):
        return {n: getattr(layers, n).__module__.rsplit(".", 1)[-1]
                for n in extra.__all__ if hasattr(layers, n)}

    port = origins(pfluid.layers, port_extra)
    jax_side = origins(jfluid.layers, jax_extra)
    assert set(jax_side) - set(port) == {"generate_proposals",
                                         "rpn_target_assign"}
    assert port == {n: jax_side[n] for n in port}
    assert port["isfinite"] == "parity_extra"


def step_counter_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        c = fluid.layers.autoincreased_step_counter(begin=5, step=3)
        again = fluid.layers.autoincreased_step_counter(begin=100, step=7)
    return main, startup, c, again


def test_step_counter_starts_at_begin_minus_one():
    values = {}
    for pkg, fluid in (("jax", jfluid), ("port", pfluid)):
        main, startup, c, again = step_counter_program(fluid)
        assert again is c or again.name == c.name
        assert [op.type for op in main.global_block().ops] == ["increment"]
        exe = fluid.Executor(pfluid.CPUPlace()) if pkg == "port" \
            else fluid.Executor()
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            start = int(np.asarray(scope.find_var(c.name)).reshape(()))
            got = [int(np.asarray(exe.run(main, fetch_list=[c])[0])
                       .reshape(())) for _ in range(3)]
        values[pkg] = [start] + got
    assert values["port"] == values["jax"] == [4, 7, 10, 13]


def test_print_runs_on_the_host_op_path(capsys):
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data(name="x", shape=[2], dtype="float32")
        y = pfluid.layers.scale(pfluid.layers.Print(x, message="seen"),
                                scale=2.0)
    from paddle_tpu_torch.core import executor as pexec
    assert pexec.capture_refusals(main) == ["print"]
    out = pfluid.Executor(pfluid.CPUPlace()).run(
        main, feed={"x": np.array([[1.0, 2.0]], np.float32)},
        fetch_list=[y])[0]
    assert np.array_equal(out, [[2.0, 4.0]])
    assert "seen: [[1. 2.]]" in capsys.readouterr().out


# -- metrics, average, data_feed_desc -----------------------------------------

def _metric_pairs(rng):
    preds = rng.rand(20, 2).astype(np.float32)
    labels = rng.randint(0, 2, (20, 1))
    hard = (preds[:, 1] > 0.5).astype(np.int64)
    return preds, labels, hard


@pytest.mark.parametrize("name", ["Accuracy", "Precision", "Recall", "Auc",
                                  "EditDistance", "ChunkEvaluator",
                                  "CompositeMetric", "DetectionMAP"])
def test_metrics_match_the_reference(name):
    rng = np.random.RandomState(41)
    results = []
    for mod in (jax_metrics, port_metrics):
        m = getattr(mod, name)()
        r = np.random.RandomState(7)
        for _ in range(3):
            preds, labels, hard = _metric_pairs(r)
            if name == "Accuracy":
                m.update(value=r.rand(), weight=int(r.randint(1, 9)))
            elif name in ("Precision", "Recall"):
                m.update(hard, labels)
            elif name == "Auc":
                m.update(preds, labels)
            elif name == "EditDistance":
                m.update(r.randint(0, 3, (6, 1)).astype(np.float32), 6)
            elif name == "ChunkEvaluator":
                m.update(*r.randint(1, 9, 3))
            elif name == "CompositeMetric":
                if not m._metrics:
                    m.add_metric(mod.Precision())
                    m.add_metric(mod.Recall())
                m.update(hard, labels)
            else:
                dets = np.concatenate([
                    r.randint(0, 2, (2, 4, 1)), r.rand(2, 4, 1),
                    np.sort(r.rand(2, 4, 4) * 10, axis=-1)], -1)
                gts = np.sort(r.rand(2, 3, 4) * 10, axis=-1)
                m.update(dets, [4, 3], gts, r.randint(0, 2, (2, 3)),
                         [3, 2])
        results.append(m.eval())
    del rng
    np.testing.assert_allclose(np.asarray(results[1], np.float64),
                               np.asarray(results[0], np.float64),
                               rtol=0, atol=0)


def test_weighted_average_matches_the_reference():
    outs = []
    for mod in (jax_average, port_average):
        avg = mod.WeightedAverage()
        r = np.random.RandomState(3)
        for _ in range(5):
            avg.add(r.rand(3).astype(np.float32), float(r.randint(1, 5)))
        outs.append(avg.eval())
        with pytest.raises(ValueError):
            avg.add("x", 1)
    assert np.array_equal(outs[0], outs[1])


DATA_FEED = '''name: "MultiSlotDataFeed"
batch_size: 2
multi_slot_desc {
  slots {
    name: "words"
    type: "uint64"
    is_dense: false
    is_used: true
  }
  slots {
    name: "label"
    type: "uint64"
    is_dense: false
    is_used: false
  }
}
'''


def test_data_feed_desc_matches_the_reference(tmp_path):
    path = tmp_path / "feed.prototxt"
    path.write_text(DATA_FEED)
    descs = []
    for mod in (jax_dfd, port_dfd):
        d = mod.DataFeedDesc(str(path))
        d.set_batch_size(128)
        d.set_use_slots(["label"])
        d.set_dense_slots(["words"])
        descs.append((d.name, d.batch_size, d.slot_names,
                      d.used_slot_indices, d.desc()))
    assert descs[0] == descs[1]
    assert descs[1][2] == ["words", "label"]


# -- Trainer / Inferencer on fit_a_line ----------------------------------------

FAL_B, FAL_STEPS = 8, 6


def fit_a_line(fluid):
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1, act=None)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(input=pred,
                                                            label=y))
    return loss, pred


def fal_reader(seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        w = np.linspace(-1, 1, 13).astype(np.float32)
        for _ in range(FAL_STEPS):
            x = rng.randn(FAL_B, 13).astype(np.float32)
            y = x @ w + 0.5
            yield [(x[i], np.array([y[i]], np.float32))
                   for i in range(FAL_B)]
    return reader


def train_func(fluid):
    def f():
        return [fit_a_line(fluid)[0]]
    return f


def infer_func(fluid):
    def f():
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        return fluid.layers.fc(input=x, size=1, act=None)
    return f


def opt_func(fluid):
    return lambda: fluid.optimizer.SGD(learning_rate=0.05)


def run_trainer(trainer, epochs, **kw):
    events, losses = [], []

    def handler(e):
        events.append(type(e).__name__)
        if isinstance(e, (jfluid.EndStepEvent, pfluid.EndStepEvent)):
            losses.append(float(np.asarray(e.metrics[0]).reshape(())))

    trainer.train(epochs, handler, reader=fal_reader(),
                  feed_order=["x", "y"], **kw)
    return events, losses


@pytest.fixture(scope="module")
def jax_trainer_run(tmp_path_factory):
    jax_init._auto_seed_counter[0] = 1
    tr = jfluid.Trainer(train_func(jfluid), opt_func(jfluid))
    start = {n: np.array(np.asarray(v), copy=True)
             for n, v in tr.scope.vars.items() if v is not None}
    events, losses = run_trainer(tr, 2, dataio=False)
    path = str(tmp_path_factory.mktemp("jax_params"))
    tr.save_params(path)
    test_loss = tr.test(fal_reader(seed=5), ["x", "y"])
    xb = np.random.RandomState(8).randn(4, 13).astype(np.float32)
    inferred = np.asarray(jfluid.Inferencer(infer_func(jfluid), path)
                          .infer({"x": xb})[0])
    return dict(start=start, events=events, losses=losses, test=test_loss,
                xb=xb, inferred=inferred)


def port_trainer(state, **kw):
    port_init._auto_seed_counter[0] = 1
    tr = pfluid.Trainer(train_func(pfluid), opt_func(pfluid),
                        place=pfluid.CPUPlace(), **kw)
    pfluid.io.state_from_numpy(state, scope=tr.scope, place=pfluid.CPUPlace(),
                               main_program=tr.train_program)
    return tr


@pytest.mark.parametrize("dataio", [False, None], ids=["sync", "pipelined"])
def test_trainer_matches_the_jax_trainer(dataio, jax_trainer_run, tmp_path):
    want = jax_trainer_run
    tr = port_trainer(want["start"])
    events, losses = run_trainer(tr, 2, dataio=dataio)
    assert events == want["events"]
    assert events[:3] == ["BeginEpochEvent", "BeginStepEvent",
                          "EndStepEvent"]
    assert len(losses) == 2 * FAL_STEPS and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tr.test(fal_reader(seed=5), ["x", "y"]),
                               want["test"], rtol=LOSS_RTOL)
    path = str(tmp_path / "params")
    tr.save_params(path)
    got = pfluid.Inferencer(infer_func(pfluid), path,
                            place=pfluid.CPUPlace()).infer(
                                {"x": want["xb"]})[0]
    np.testing.assert_allclose(got, want["inferred"], rtol=LOSS_RTOL,
                               atol=1e-6)


def test_trainer_stop_and_epoch_checkpoints(jax_trainer_run, tmp_path):
    cfg = port_trainer_api.CheckpointConfig(str(tmp_path / "ck"),
                                            max_num_checkpoints=1)
    tr = port_trainer(jax_trainer_run["start"], checkpoint_config=cfg)
    seen = []

    def handler(e):
        seen.append(type(e).__name__)
        if isinstance(e, pfluid.EndStepEvent) and e.epoch == 1 and \
                e.step == 2:
            tr.stop()

    tr.train(3, handler, reader=fal_reader(), feed_order=["x", "y"],
             dataio=False)
    assert seen.count("EndEpochEvent") == 1
    assert os.listdir(str(tmp_path / "ck")) == ["epoch_0"]


def test_item_12_arms_raise_naming_it(jax_trainer_run, monkeypatch):
    start = jax_trainer_run["start"]
    with pytest.raises(NotImplementedError, match="item 12"):
        port_trainer(start, checkpoint_config=port_trainer_api
                     .CheckpointConfig(manifest=True))
    tr = port_trainer(start)
    for kw in ({"stepguard": True}, {"preempt": True}):
        with pytest.raises(NotImplementedError, match="item 12"):
            tr.train(1, lambda e: None, reader=fal_reader(),
                     feed_order=["x", "y"], **kw)
    monkeypatch.setenv("FLAGS_telemetry", "1")
    with pytest.raises(NotImplementedError, match="item 12"):
        tr.train(1, lambda e: None, reader=fal_reader(),
                 feed_order=["x", "y"])
    with pytest.raises(NotImplementedError, match="item 12"):
        port_trainer_api.ElasticTrainer


def test_fit_a_line_flow_matches_jax(tmp_path):
    runs = {}
    for pkg, fluid in (("jax", jfluid), ("port", pfluid)):
        init = jax_init if pkg == "jax" else port_init
        names = jax_unique_name if pkg == "jax" else port_unique_name
        init._auto_seed_counter[0] = 1
        main, startup = fluid.Program(), fluid.Program()
        with names.guard(), fluid.program_guard(main, startup):
            loss, pred = fit_a_line(fluid)
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
        exe = fluid.Executor() if pkg == "jax" else \
            fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if pkg == "jax":
                state = {n: np.array(np.asarray(v), copy=True)
                         for n, v in scope.vars.items() if v is not None}
            else:
                fluid.io.state_from_numpy(state, scope=scope,
                                          place=fluid.CPUPlace(),
                                          main_program=main)
            losses = []
            for batch in fal_reader()():
                feed = {"x": np.stack([b[0] for b in batch]),
                        "y": np.stack([b[1] for b in batch])}
                losses.append(float(np.asarray(exe.run(
                    main, feed=feed, fetch_list=[loss])[0]).reshape(())))
            d = str(tmp_path / pkg)
            fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                          main_program=main)
            prog, feeds, fetches = fluid.io.load_inference_model(d, exe)
            xb = np.random.RandomState(8).randn(4, 13).astype(np.float32)
            inferred = np.asarray(exe.run(prog, feed={feeds[0]: xb},
                                          fetch_list=fetches)[0])
        runs[pkg] = (losses, inferred, d)
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1],
                               rtol=LOSS_RTOL, atol=1e-6)
    assert runs["port"][0][-1] < runs["port"][0][0]
    # each package serves the other's model dir
    xb = np.random.RandomState(8).randn(4, 13).astype(np.float32)
    cfg = pfluid.AnalysisConfig(runs["jax"][2])
    cfg.disable_gpu()
    np.testing.assert_allclose(
        pfluid.create_paddle_predictor(cfg).run({"x": xb})[0],
        runs["jax"][1], rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jfluid.create_paddle_predictor(jfluid.AnalysisConfig(
            runs["port"][2])).run({"x": xb})[0]),
        runs["port"][1], rtol=LOSS_RTOL, atol=1e-6)
