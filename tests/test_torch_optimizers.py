"""The port's six optimizers that followed SGD, Momentum, Adagrad and
Adam, their eight update ops, gradient clipping and ``L1Decay`` against
the JAX package on the CPU:

- each update op (``lars_momentum``, ``decayed_adagrad``, ``adamax``,
  ``adadelta``, ``rmsprop`` centered and not, ``ftrl`` at two rate
  powers, ``proximal_gd``, ``proximal_adagrad``) on the same seeded
  state: every output within 1e-6 relative and absolute;
- a small two-layer regression net (13 -> 16 tanh -> 1, batch 8) trained
  3 steps from the JAX package's startup state (``zoo.snapshot_startup``
  / ``zoo.run_steps``) by each optimizer (RMSProp centered and not),
  under ``GradientClipByValue``, ``GradientClipByNorm`` and
  ``GradientClipByGlobalNorm``, and under ``L1Decay``: the programs
  equal op for op, and the port's losses within 1e-5 relative of the
  JAX package's, each step moving the loss.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import zoo
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from torch_op_parity import assert_outputs_match, f32, run_both

UPDATE_TOL = 1e-6
LOSS_RTOL = 1e-5
N = 8


@pytest.fixture(autouse=True)
def fresh_jax_steps(monkeypatch):
    # the JAX side compiles its steps afresh: the persistent jit cache is
    # shared by the test workers (ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def _update_cases():
    rng = np.random.RandomState(41)
    p, g = f32(rng, 5, 3), f32(rng, 5, 3)
    pos = np.abs(f32(rng, 5, 3)) + 0.1
    lr = np.array([0.05], np.float32)
    return [
        ("lars_momentum", {"Param": [p], "Grad": [g],
                           "Velocity": [f32(rng, 5, 3)],
                           "LearningRate": [lr]},
         {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
        ("decayed_adagrad", {"Param": [p], "Grad": [g], "Moment": [pos],
                             "LearningRate": [lr]},
         {"decay": 0.95, "epsilon": 1e-6}),
        ("adamax", {"Param": [p], "Grad": [g], "Moment": [f32(rng, 5, 3)],
                    "InfNorm": [pos], "Beta1Pow": [np.array([0.81],
                                                            np.float32)],
                    "LearningRate": [lr]},
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        ("adadelta", {"Param": [p], "Grad": [g], "AvgSquaredGrad": [pos],
                      "AvgSquaredUpdate": [pos * 0.5]},
         {"rho": 0.95, "epsilon": 1e-6}),
        ("rmsprop", {"Param": [p], "Grad": [g], "MeanSquare": [pos],
                     "Moment": [f32(rng, 5, 3)], "LearningRate": [lr]},
         {"decay": 0.9, "momentum": 0.9, "epsilon": 1e-6}),
        ("rmsprop", {"Param": [p], "Grad": [g], "MeanSquare": [pos + 1.0],
                     "Moment": [f32(rng, 5, 3)],
                     "MeanGrad": [f32(rng, 5, 3) * 0.3],
                     "LearningRate": [lr]},
         {"decay": 0.9, "momentum": 0.5, "epsilon": 1e-6,
          "centered": True}),
        ("ftrl", {"Param": [p], "Grad": [g], "SquaredAccumulator": [pos],
                  "LinearAccumulator": [f32(rng, 5, 3)],
                  "LearningRate": [lr]},
         {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
        ("ftrl", {"Param": [p], "Grad": [g], "SquaredAccumulator": [pos],
                  "LinearAccumulator": [f32(rng, 5, 3)],
                  "LearningRate": [lr]},
         {"l1": 0.0, "l2": 0.1, "lr_power": -0.3}),
        ("proximal_gd", {"Param": [p], "Grad": [g], "LearningRate": [lr]},
         {"l1": 0.5, "l2": 0.1}),
        ("proximal_adagrad", {"Param": [p], "Grad": [g], "Moment": [pos],
                              "LearningRate": [lr]},
         {"l1": 0.2, "l2": 0.3}),
    ]


UPDATE_CASES = _update_cases()


@pytest.mark.parametrize("op_type,ins,attrs", UPDATE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(UPDATE_CASES)])
def test_update_op_matches_jax(op_type, ins, attrs):
    want, got = run_both(op_type, ins, attrs)
    assert_outputs_match(op_type, want, got, UPDATE_TOL)


# name -> (optimizer(fluid), gradient clip(fluid) or None,
#          regularizer(fluid) or None)
SETUPS = {
    "lars_momentum": (lambda f: f.optimizer.LarsMomentum(
        learning_rate=0.5, momentum=0.9), None, None),
    "adamax": (lambda f: f.optimizer.Adamax(learning_rate=0.05), None,
               None),
    "decayed_adagrad": (lambda f: f.optimizer.DecayedAdagrad(
        learning_rate=0.05), None, None),
    "adadelta": (lambda f: f.optimizer.Adadelta(learning_rate=1.0,
                                                rho=0.9), None, None),
    "rmsprop": (lambda f: f.optimizer.RMSProp(learning_rate=0.01,
                                              momentum=0.9), None, None),
    "rmsprop_centered": (lambda f: f.optimizer.RMSProp(
        learning_rate=0.01, centered=True), None, None),
    "ftrl": (lambda f: f.optimizer.Ftrl(learning_rate=0.1, l1=0.01,
                                        l2=0.01), None, None),
    "clip_by_value": (lambda f: f.optimizer.SGD(learning_rate=0.1),
                      lambda f: f.clip.GradientClipByValue(0.05), None),
    "clip_by_norm": (lambda f: f.optimizer.SGD(learning_rate=0.1),
                     lambda f: f.clip.GradientClipByNorm(0.2), None),
    "clip_by_global_norm": (lambda f: f.optimizer.Adam(learning_rate=0.01),
                            lambda f: f.clip.GradientClipByGlobalNorm(0.3),
                            None),
    "l1_decay": (lambda f: f.optimizer.SGD(learning_rate=0.1), None,
                 lambda f: f.regularizer.L1Decay(0.05)),
}


def build(pkg, name):
    fluid, init, names = (
        (jfluid, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_init, port_unique_name))
    make_opt, make_clip, make_reg = SETUPS[name]
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    try:
        with names.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[13], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            h = fluid.layers.fc(input=x, size=16, act="tanh")
            pred = fluid.layers.fc(input=h, size=1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(input=pred, label=y))
            if make_clip is not None:
                fluid.clip.set_gradient_clip(make_clip(fluid))
            opt = make_opt(fluid)
            if make_reg is not None:
                opt.regularization = make_reg(fluid)
            opt.minimize(loss)
    finally:
        fluid.clip.set_gradient_clip(None)
    return main, startup, loss


def _ops(prog):
    return [(op.type, sorted(op.inputs), sorted(op.outputs))
            for op in prog.global_block().ops]


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_trajectory_matches_jax(name):
    jmain, jstart, jloss = build("jax", name)
    pmain, _, ploss = build("port", name)
    assert _ops(pmain) == _ops(jmain)
    feeds = {"x": ((N, 13), "float32"), "y": ((N, 1), "float32")}
    zp = zoo.ZooProgram(name, jmain, jstart, feeds, [jloss.name])
    state = zoo.snapshot_startup(zp)
    want = zoo.run_steps(zp, steps=3, init_state=state)
    feed = zoo.example_feed_arrays(zp)
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=pfluid.CPUPlace(),
                                       main_program=pmain)
    exe = pfluid.Executor(pfluid.CPUPlace())
    got = [float(exe.run(pmain, feed=feed, fetch_list=[ploss],
                         scope=scope)[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert len(set(got)) == 3, got
