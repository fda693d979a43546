"""The dense image slice against the JAX package on the CPU: the port's
model zoo, LeNet-5 (``recognize_digits_conv``), ResNet (``resnet_cifar10``
and ResNet-50 at full widths), VGG16, the book's image flows and
``py_reader``.

Every zoo builder emits the JAX package's program op for op.  From the
JAX package's startup state (``zoo.snapshot_startup``), the port's loss
lists match the JAX package's ``run_steps`` within relative 1e-4
(float32 through convolutions, batch norm and the optimizer in two
frameworks that sum in different orders; observed ≤ 2e-6).

VGG16 (at dropout 0) and ResNet-50 are compared step by step instead,
from one start state (the port's startup program run on the CPU, which
takes 0.3-0.4 s where the JAX package's takes 5-7 s): each step starts
both packages from the JAX package's own state before it.  Their
free-running trajectories are no test of the port, because the JAX
package's own are chaotic at these sizes: from a start state perturbed
by 1e-7 relative, its VGG16 (batch 2, Adam) and ResNet-50 ([4, 3, 64,
64], Momentum) losses move by percents at steps 2 and 3, and its
ResNet-50 gradients by up to 2% a leaf (batch norm over a few values a
channel at the last stage, and Adam's first step of lr·sign(g)).  Each
step's loss is held to relative 1e-4; each parameter's gradient to the
JAX package's within VGG16_GRAD_GAP or R50_GRAD_GAP of it (set from
that spread); the port's update of every parameter and optimizer
accumulator to the JAX package's optimizer rule on the port's gradient;
and ResNet-50's moving statistics after each step to the JAX package's
(one update a step).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.dataset.mnist as mnist
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu.models import zoo as jax_zoo
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.models import zoo as port_zoo

RTOL = 1e-4
CPU = pfluid.CPUPlace()
# the forced steps' gradients, leaf by leaf (2-norms): from a start state
# nudged by 1e-7 relative, the JAX package's own gradients move by up to
# 2.6e-3 (VGG16) and 2.0e-2 (ResNet-50) a leaf at step 1; the port's sat
# within 8.5e-3 and 4.0e-2 of the JAX package's over three steps
VGG16_GRAD_GAP, R50_GRAD_GAP = 0.05, 0.1


@pytest.fixture(autouse=True)
def fresh_jax_steps(monkeypatch):
    # the JAX side compiles its steps afresh: the persistent jit cache is
    # shared by the test workers (ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)


def build_zoo(name, pkg):
    zoo, init, names = (jax_zoo, jax_init, jax_unique_name) if pkg == "jax" \
        else (port_zoo, port_init, port_unique_name)
    init._auto_seed_counter[0] = 1
    with names.guard():
        return zoo.build(name)


def signature(prog):
    return [([(op.type, {k: list(v) for k, v in op.inputs.items()},
               {k: list(v) for k, v in op.outputs.items()}, op.attrs)
              for op in blk.ops],
             {n: (v.shape, v.dtype, v.persistable)
              for n, v in blk.vars.items()}) for blk in prog.blocks]


def test_port_zoo_has_every_builder():
    assert port_zoo.names() == jax_zoo.names()
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        port_zoo.measured_memory(build_zoo("fit_a_line", "port"))


@pytest.mark.parametrize("name", jax_zoo.names())
def test_zoo_builder_equals_the_jax_program(name):
    j, p = build_zoo(name, "jax"), build_zoo(name, "port")
    assert (p.feeds, p.fetch_names) == (j.feeds, j.fetch_names)
    for jp, pp in ((j.main, p.main), (j.startup, p.startup)):
        for (jops, jvars), (pops, pvars) in zip(signature(jp),
                                                signature(pp)):
            assert pvars == jvars
            assert len(pops) == len(jops)
            for jo, po in zip(jops, pops):
                assert po == jo


def image_layers(fluid):
    """Every image layer with its options off the defaults."""
    img = fluid.layers.data(name="img", shape=[4, 9, 9], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    x = fluid.layers.conv2d(img, num_filters=6, filter_size=3, stride=2,
                            padding=1, dilation=1, groups=2, act="relu")
    x = fluid.layers.conv2d_transpose(x, num_filters=4, filter_size=3,
                                      stride=2, padding=1, groups=2)
    x = fluid.layers.pool2d(x, pool_size=3, pool_type="avg",
                            pool_stride=2, pool_padding=1, ceil_mode=True,
                            exclusive=False)
    x = fluid.layers.batch_norm(x, act="relu", momentum=0.8,
                                epsilon=1e-3)
    y = fluid.layers.transpose(x, [0, 2, 3, 1])
    y = fluid.layers.batch_norm(y, data_layout="NHWC",
                                use_global_stats=True)
    pred = fluid.layers.fc(input=y, size=5, act="softmax")
    values, indices = fluid.layers.topk(pred, k=2)
    acc = fluid.layers.accuracy(input=pred, label=label, k=2)
    return [values, indices, acc]


def test_image_layers_emit_the_jax_ops():
    """conv2d, conv2d_transpose, pool2d, batch_norm (NCHW and NHWC),
    topk and accuracy: the same ops, attrs and variables as the JAX
    package's layers."""
    progs = []
    for fluid, init, names in ((jfluid, jax_init, jax_unique_name),
                               (pfluid, port_init, port_unique_name)):
        init._auto_seed_counter[0] = 1
        main, startup = fluid.Program(), fluid.Program()
        with names.guard(), fluid.program_guard(main, startup):
            image_layers(fluid)
        progs.append((main, startup))
    for jp, pp in zip(*progs):
        assert signature(pp) == signature(jp)
    types = {op.type for op in progs[1][0].global_block().ops}
    assert {"conv2d", "conv2d_transpose", "pool2d", "batch_norm", "top_k",
            "accuracy"} <= types


@pytest.mark.parametrize("name", ["recognize_digits_conv",
                                  "resnet_cifar10", "word2vec",
                                  "ctr_wide_deep"])
def test_zoo_losses_match_jax_from_its_startup_state(name):
    j, p = build_zoo(name, "jax"), build_zoo(name, "port")
    state = jax_zoo.snapshot_startup(j)
    want = jax_zoo.run_steps(j, steps=3, init_state=state)
    got = port_zoo.run_steps(p, steps=3, init_state=state, place=CPU)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert got[-1] < got[0]


def host_state(scope):
    return {n: np.array(np.asarray(v)) for n, v in scope.vars.items()
            if v is not None}


UPDATES = ("momentum", "adam")


def forced_steps(jmain, pmain, loss, state, feed, steps):
    """`steps` training steps, each run by both packages from the JAX
    package's state before it: for each step, the state before it and,
    by package, (loss, {parameter: gradient}, state after)."""
    grads = {op.inputs["Param"][0]: op.inputs["Grad"][0]
             for op in jmain.global_block().ops if op.type in UPDATES}
    fetch = [loss] + list(grads.values())
    exe, scope = jfluid.Executor(), jfluid.Scope()
    pexe = pfluid.Executor(CPU)
    out = []
    with jfluid.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, np.array(v, copy=True))
        for _ in range(steps):
            before = host_state(scope)
            jout = [np.asarray(v) for v in
                    exe.run(jmain, feed=feed, fetch_list=fetch)]
            pscope = pfluid.io.state_from_numpy(
                before, scope=pfluid.Scope(), place=CPU,
                main_program=pmain)
            pout = pexe.run(pmain, feed=feed, fetch_list=fetch,
                            scope=pscope)
            out.append({
                "before": before,
                "jax": (float(jout[0]), dict(zip(grads, jout[1:])),
                        host_state(scope)),
                "port": (float(pout[0]), dict(zip(grads, pout[1:])),
                         {n: pscope.find_var(n).numpy() for n in before})})
    return out


def vanishing_grads(prog):
    """Parameters whose gradient is 0 in exact arithmetic, so that
    rounding alone sets it: a bias added just before a batch_norm, which
    takes out the mean the bias shifts."""
    ops = prog.global_block().ops
    normed = {op.inputs["X"][0] for op in ops if op.type == "batch_norm"}
    return {op.inputs["Y"][0] for op in ops if op.type == "elementwise_add"
            and op.outputs["Out"][0] in normed}


def reference_update(op, before, g):
    """The JAX package's momentum or adam op (ops/optimizer_ops.py) in
    numpy float32 on `before` and the gradient `g`: {output name:
    value}."""
    x = {k: before[v[0]] for k, v in op.inputs.items() if k != "Grad"}
    lr = np.float32(x["LearningRate"].reshape(()))
    if op.type == "momentum":
        assert not op.attrs.get("use_nesterov", False)
        v = np.float32(op.attrs.get("mu", 0.9)) * x["Velocity"] + g
        new = {"ParamOut": x["Param"] - lr * v, "VelocityOut": v}
    else:
        b1, b2 = op.attrs.get("beta1", 0.9), op.attrs.get("beta2", 0.999)
        b1p, b2p = x["Beta1Pow"], x["Beta2Pow"]
        m1 = np.float32(b1) * x["Moment1"] + np.float32(1 - b1) * g
        m2 = np.float32(b2) * x["Moment2"] + np.float32(1 - b2) * g * g
        lr_t = np.float32(lr * np.sqrt(1 - float(b2p[0]) * b2) /
                          (1 - float(b1p[0]) * b1))
        new = {"ParamOut": x["Param"] - lr_t * m1 / (
            np.sqrt(m2) + np.float32(op.attrs.get("epsilon", 1e-8))),
            "Moment1Out": m1, "Moment2Out": m2,
            "Beta1PowOut": b1p * np.float32(b1),
            "Beta2PowOut": b2p * np.float32(b2)}
    return {op.outputs[k][0]: v for k, v in new.items()}


def assert_steps_match(prog, steps, grad_gap):
    """Each step's loss within RTOL of the JAX package's; each
    parameter's gradient within `grad_gap` of the JAX package's (2-norm
    of the leaf; parameters whose gradient vanishes in exact arithmetic
    aside); and the port's update of every parameter and optimizer
    accumulator is the JAX package's rule on the port's own gradient:
    the 2-norm of its distance from the rule's result within RTOL of the
    rule's change of the leaf, beside two float32 roundings of the
    result."""
    skip = vanishing_grads(prog)
    updates = [op for op in prog.global_block().ops if op.type in UPDATES]
    for i, step in enumerate(steps):
        (jl, jg, _), (pl, pg, pafter) = step["jax"], step["port"]
        before = step["before"]
        np.testing.assert_allclose(pl, jl, rtol=RTOL)
        gaps = {n: np.linalg.norm(pg[n] - jg[n]) / np.linalg.norm(jg[n])
                for n in jg if n not in skip}
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= grad_gap, (i, worst, gaps[worst])
        for op in updates:
            want = reference_update(op, before,
                                    pg[op.inputs["Param"][0]])
            for n, w in want.items():
                off = np.linalg.norm(pafter[n] - w)
                room = RTOL * np.linalg.norm(w - before[n]) + \
                    2 ** -23 * np.linalg.norm(w)
                assert off <= room, (i, n, off, room)


def without_dropout(prog):
    """Dropout at 0 in the forward op and its grad op's copy of it."""
    for op in prog.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
        elif op.type == "generic_grad" and op.attrs["fw_type"] == "dropout":
            op.attrs["fw_attrs"]["dropout_prob"] = 0.0


def test_vgg16_adam_steps_match_jax_step_by_step():
    j, p = build_zoo("vgg16", "jax"), build_zoo("vgg16", "port")
    without_dropout(j.main)
    without_dropout(p.main)
    state = port_zoo.snapshot_startup(p, place=CPU)
    steps = forced_steps(j.main, p.main, j.fetch_names[0], state,
                         jax_zoo.example_feed_arrays(j), 3)
    assert_steps_match(j.main, steps, VGG16_GRAD_GAP)
    assert steps[-1]["jax"][0] < steps[0]["jax"][0]


def resnet50(pkg, is_test):
    """ResNet-50 at its full widths on 64x64 images (every stage keeps
    2x2 maps or more), 1000 classes; training adds bench.py's
    Momentum(0.001, 0.9)."""
    fluid, resnet, init, names = (
        (jfluid, jax_resnet, jax_init, jax_unique_name) if pkg == "jax"
        else (pfluid, port_resnet, port_init, port_unique_name))
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 64, 64],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = resnet.resnet_imagenet(img, class_dim=1000, depth=50,
                                      is_test=is_test)
        if is_test:
            return main, startup, pred
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=0.001,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


@pytest.fixture(scope="module")
def resnet50_state():
    """The training program's start state, whose parameters carry the
    inference program's names too."""
    _, startup, _ = resnet50("port", False)
    return port_zoo.snapshot_startup(
        port_zoo.ZooProgram("", None, startup, {}, []), place=CPU)


def test_resnet50_inference_matches_jax(resnet50_state):
    """The is_test forward (``__graft_entry__.entry``'s program) at
    [2, 3, 64, 64] over moving statistics other than the startup's 0
    and 1: the logits within 1e-4 of their largest magnitude, the
    probabilities within 1e-5."""
    jmain, _, jpred = resnet50("jax", True)
    pmain, _, ppred = resnet50("port", True)
    assert signature(pmain) == signature(jmain)
    rng = np.random.RandomState(2)
    state = dict(resnet50_state)
    for op in jmain.global_block().ops:
        if op.type == "batch_norm":
            c = state[op.inputs["Mean"][0]].shape
            state[op.inputs["Mean"][0]] = rng.normal(0, 0.5, c).astype(
                np.float32)
            state[op.inputs["Variance"][0]] = rng.uniform(
                0.5, 4.0, c).astype(np.float32)
    logits = [op for op in jmain.global_block().ops
              if op.type == "softmax"][-1].inputs["X"][0]
    img = rng.randn(2, 3, 64, 64).astype(np.float32)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, np.array(v, copy=True))
        want = [np.asarray(v) for v in jfluid.Executor().run(
            jmain, feed={"img": img}, fetch_list=[logits, jpred])]
    scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                       place=CPU, main_program=pmain)
    got = pfluid.Executor(CPU).run(pmain, feed={"img": img},
                                   fetch_list=[logits, ppred], scope=scope)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL,
                               atol=RTOL * np.abs(want[0]).max())
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=1e-5)


def test_resnet50_momentum_steps_match_jax_step_by_step(resnet50_state):
    jmain, _, jloss = resnet50("jax", False)
    pmain, _, _ = resnet50("port", False)
    assert signature(pmain) == signature(jmain)
    rng = np.random.RandomState(3)
    feed = {"img": rng.randn(4, 3, 64, 64).astype(np.float32),
            "label": rng.randint(0, 1000, (4, 1)).astype(np.int64)}
    steps = forced_steps(jmain, pmain, jloss.name, resnet50_state, feed, 3)
    assert_steps_match(jmain, steps, R50_GRAD_GAP)
    moving = [n for op in jmain.global_block().ops
              if op.type == "batch_norm"
              for n in op.outputs["MeanOut"] + op.outputs["VarianceOut"]]
    assert len(moving) == 2 * 53
    for step in steps:
        jafter, pafter = step["jax"][2], step["port"][2]
        for n in moving:
            np.testing.assert_allclose(
                pafter[n], jafter[n], rtol=RTOL,
                atol=RTOL * np.abs(jafter[n]).max(), err_msg=n)
    assert steps[-1]["jax"][0] < steps[0]["jax"][0]


def lenet(fluid, img, filters=(20, 50)):
    c1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=filters[0], pool_size=2,
        pool_stride=2, act="relu")
    c2 = fluid.nets.simple_img_conv_pool(
        input=c1, filter_size=5, num_filters=filters[1], pool_size=2,
        pool_stride=2, act="relu")
    return fluid.layers.fc(input=c2, size=10, act="softmax")


def test_recognize_digits_book_flow_on_the_port(tmp_path):
    """``tests/book/test_recognize_digits.py``'s conv flow on the port:
    train through DataFeeder, save_inference_model, load, infer; fed the
    JAX package's generated MNIST."""
    main, startup = pfluid.Program(), pfluid.Program()
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        img = pfluid.layers.data(name="img", shape=[1, 28, 28],
                                 dtype="float32")
        label = pfluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = lenet(pfluid, img)
        loss = pfluid.layers.mean(
            pfluid.layers.cross_entropy(input=pred, label=label))
        acc = pfluid.layers.accuracy(input=pred, label=label)
        test_prog = main.clone(for_test=True)
        pfluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    exe, scope = pfluid.Executor(CPU), pfluid.Scope()
    exe.run(startup, scope=scope)
    feeder = pfluid.DataFeeder(feed_list=[img, label], place=CPU)
    accs = []
    for i, batch in enumerate(jfluid.reader.batch(mnist.train(), 64)()):
        _, a = exe.run(main, feed=feeder.feed(batch),
                       fetch_list=[loss, acc], scope=scope)
        accs.append(float(a))
        if i + 1 >= 60:
            break
    assert np.mean(accs[-10:]) > 0.7, accs[-10:]
    with pfluid.scope_guard(scope):
        pfluid.io.save_inference_model(str(tmp_path), ["img"], [pred], exe,
                                       main_program=test_prog)
    test_batch = list(next(jfluid.reader.batch(mnist.test(), 32)()))
    imgs = np.stack([b[0] for b in test_batch]).reshape(-1, 1, 28, 28)
    labels = np.array([b[1] for b in test_batch])
    with pfluid.scope_guard(pfluid.Scope()):
        prog, feeds, fetches = pfluid.io.load_inference_model(str(tmp_path),
                                                              exe)
        (probs,) = exe.run(prog, feed={feeds[0]: imgs}, fetch_list=fetches)
    assert (probs.argmax(1) == labels).mean() > 0.7


def test_image_classification_book_flow_on_the_port(tmp_path):
    """``tests/book/test_image_classification.py``'s resnet_cifar10
    flow on the port: 25 Adam steps on fresh class-blob batches (window
    means of the loss fall), save_inference_model, load, infer."""
    main, startup = pfluid.Program(), pfluid.Program()
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        images = pfluid.layers.data(name="pixel", shape=[3, 32, 32],
                                    dtype="float32")
        label = pfluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = port_resnet.resnet_cifar10(images, depth=20)
        avg_cost = pfluid.layers.mean(
            pfluid.layers.cross_entropy(input=predict, label=label))
        test_prog = main.clone(for_test=True)
        pfluid.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    exe, scope = pfluid.Executor(CPU), pfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    protos = rng.uniform(-1, 1, (10, 3, 32, 32)).astype(np.float32)

    def batch(n=32):
        lbl = rng.randint(0, 10, n)
        img = protos[lbl] + 0.3 * rng.randn(n, 3, 32, 32).astype(np.float32)
        return img.astype(np.float32), lbl.reshape(-1, 1).astype(np.int64)

    losses = []
    for _ in range(25):
        img, lbl = batch()
        (lv,) = exe.run(main, feed={"pixel": img, "label": lbl},
                        fetch_list=[avg_cost], scope=scope)
        losses.append(float(lv))
    k = len(losses) // 3
    assert np.mean(losses[-k:]) < np.mean(losses[:k]), losses
    with pfluid.scope_guard(scope):
        pfluid.io.save_inference_model(str(tmp_path), ["pixel"], [predict],
                                       exe, main_program=test_prog)
    with pfluid.scope_guard(pfluid.Scope()):
        prog, feeds, fetches = pfluid.io.load_inference_model(str(tmp_path),
                                                              exe)
        img, _ = batch(8)
        (probs,) = exe.run(prog, feed={feeds[0]: img}, fetch_list=fetches)
    assert probs.shape == (8, 10)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-4)


def reader_program(cache_budget_bytes=None):
    main, startup = pfluid.Program(), pfluid.Program()
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        reader = pfluid.layers.py_reader(
            capacity=2, shapes=[(-1, 1, 28, 28), (-1, 1)],
            dtypes=["float32", "int64"], name="mnist",
            cache_on_device=True)
        if cache_budget_bytes is not None:
            reader.cache_budget_bytes = cache_budget_bytes
        img, label = pfluid.layers.read_file(reader)
        loss = pfluid.layers.mean(pfluid.layers.cross_entropy(
            input=lenet(pfluid, img, (6, 16)), label=label))
        pfluid.optimizer.Momentum(learning_rate=0.01,
                                  momentum=0.9).minimize(loss)
    return main, startup, reader, loss


def run_epoch(exe, main, loss, scope):
    losses = []
    while True:
        try:
            losses.append(float(exe.run(main, fetch_list=[loss],
                                        scope=scope)[0]))
        except pfluid.EOFException:
            return losses


@pytest.mark.parametrize("budget", [None, 8 * 28 * 28 * 4],
                         ids=["whole pool", "one image batch"])
def test_py_reader_runs_to_eof_with_its_device_cache(budget):
    """bench.py's reader flow at LeNet-5 size: a generator cycling over a
    pool of two batches through ``py_reader(cache_on_device=True)``; runs
    with no feed take its batches until EOFException, with the losses of
    the same batches fed by hand.  The cache keeps one device copy of
    each distinct array, within its byte budget (FIFO).  A start() after
    EOF or after a reset() mid-epoch runs a whole epoch; a start()
    mid-epoch raises."""
    main, startup, reader, loss = reader_program(budget)
    assert main._py_readers == [reader]
    rng = np.random.RandomState(4)
    pool = [(rng.randn(8, 1, 28, 28).astype(np.float32),
             rng.randint(0, 10, (8, 1)).astype(np.int64)) for _ in range(2)]
    reader.decorate_batch_generator(lambda: (pool[i % 2] for i in range(5)))
    exe = pfluid.Executor(CPU)
    init = pfluid.Scope()
    exe.run(startup, scope=init)
    state = {n: t.numpy() for n, t in init.vars.items() if t is not None}

    def scope():
        return pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                          place=CPU, main_program=main)

    reader.start()
    got = run_epoch(exe, main, loss, scope())
    by_hand, s = [], scope()
    for i in range(5):
        img, lbl = pool[i % 2]
        by_hand.append(float(exe.run(
            main, feed={"mnist_slot0": img, "mnist_slot1": lbl},
            fetch_list=[loss], scope=s)[0]))
    assert got == by_hand
    if budget is None:
        assert len(reader._dev_cache) == 4        # 2 slots x 2 batches
        assert reader._cache_bytes == sum(a.nbytes for b in pool for a in b)
    else:
        assert reader._cache_bytes <= budget
    reader.start()                        # after EOF: a whole new epoch
    assert run_epoch(exe, main, loss, scope()) == got
    reader.start()
    exe.run(main, fetch_list=[loss], scope=scope())
    with pytest.raises(RuntimeError, match="still active"):
        reader.start()
    reader.reset()                        # mid-epoch: a whole new epoch
    reader.start()
    assert run_epoch(exe, main, loss, scope()) == got


def test_py_reader_surfaces_a_reader_crash_and_a_device_change():
    from paddle_tpu_torch.dataio import WorkerCrashed

    main, startup, reader, loss = reader_program()
    exe, scope = pfluid.Executor(CPU), pfluid.Scope()
    exe.run(startup, scope=scope)

    def broken():
        yield (np.zeros((2, 1, 28, 28), np.float32),
               np.zeros((2, 1), np.int64))
        raise OSError("disk gone")

    reader.decorate_batch_generator(broken)
    reader.start()
    exe.run(main, fetch_list=[loss], scope=scope)
    with pytest.raises(WorkerCrashed, match="disk gone"):
        exe.run(main, fetch_list=[loss], scope=scope)
    reader.reset()
    reader.start()
    exe.run(main, fetch_list=[loss], scope=scope)
    with pytest.raises(RuntimeError, match="stages this epoch onto cpu"):
        reader.next_feed("meta")
    reader.reset()
