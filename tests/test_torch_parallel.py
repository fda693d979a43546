"""The sequence-parallel training path of the port (paddle_tpu_torch.parallel,
K3, the ring_attention and gpipe ops, CompiledProgram) against the JAX
package, on the CPU at small sizes, inputs from numpy with a seed.

- the port's ring over a mesh of eight CPU entries against the JAX
  package's ring over its eight virtual devices, causal and not, and the
  blocked in-shard path with small blocks: outputs and grads, atol 1e-5
  (float32; the two packages merge the same partials in the same order);
- K3's plain version (``flash_attention_with_lse`` on CPU tensors, the
  ring's in-shard tier under ``FLAGS_ring_flash=true``) against the JAX
  package's ``flash_attention_with_lse`` in interpret mode: out, lse and
  grads under a nonzero lse cotangent, atol 1e-5, and the ring with K3 as
  its in-shard tier in both packages;
- a dp x sp mesh;
- ``gpipe`` off the mesh and on a pipe mesh against the serial run (the
  behaviours of tests/test_pipeline.py), its stage bodies checkpointed on
  the mesh;
- the dry-run training step of ``__graft_entry__._dryrun_one`` built by
  both packages: equal op for op; from the JAX package's startup state the
  port's losses equal the JAX package's within 1e-4 (relative), and the
  port's mesh run equals its single-device run within 1e-5 on (dp, tp,
  sp, pp) = (2, 2, 1, 2) and (2, 2, 2, 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import paddle_tpu as jfluid
import paddle_tpu_torch as pfluid
from paddle_tpu import flags as jax_flags
from paddle_tpu import initializer as jax_init
from paddle_tpu.compiler import CompiledProgram as JaxCompiledProgram
from paddle_tpu.core import unique_name as jax_unique_name
from paddle_tpu.models import zoo
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.parallel import make_mesh as jax_make_mesh
from paddle_tpu.parallel import ring_attention as jra
from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch.core import unique_name as port_unique_name
from paddle_tpu_torch.models import dryrun
from paddle_tpu_torch.ops import attention_kernels as ak
from paddle_tpu_torch.parallel import env, make_mesh, mesh as mesh_mod
from paddle_tpu_torch.parallel import ring_attention as pra

ATOL = 1e-5
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def clean_flags(monkeypatch):
    # the JAX side compiles its steps afresh (the persistent jit cache is
    # shared by the test workers; ROADMAP queue 3)
    monkeypatch.setitem(jax_flags._overrides, "jit_cache", False)
    monkeypatch.setattr(port_flags, "_overrides", {})


def _arrays(seed, shape, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _ring_pair(arrays, port_mesh, jax_mesh, causal, batch_axis=None):
    """(port out and grads, JAX out and grads) of sum(ring(q, k, v) * w)."""
    q, k, v, w = arrays
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = pra.ring_attention(*leaves, port_mesh, axis_name="seq",
                             causal=causal, batch_axis=batch_axis)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    got = [out.detach().numpy()] + [g.numpy() for g in grads]

    def loss(qq, kk, vv):
        o = jra.ring_attention(qq, kk, vv, jax_mesh, axis_name="seq",
                               causal=causal, batch_axis=batch_axis)
        return jnp.sum(o * jnp.asarray(w)), o

    jargs = [jnp.asarray(a) for a in (q, k, v)]
    # under jit the ring compiles once (eager shard_map takes ~10x longer)
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*jargs)
    want = [np.asarray(jout)] + [np.asarray(g) for g in jgrads]
    return got, want


def _assert_close(got, want, atol, names=("out", "dq", "dk", "dv")):
    for g, w, n in zip(got, want, names):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=n)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_on_eight_devices(causal):
    arrays = _arrays(0, (2, 32, 2, 8))
    got, want = _ring_pair(arrays, make_mesh({"seq": 8}, devices=CPU8),
                           JaxMesh(np.array(jax.devices()[:8]), ("seq",)),
                           causal)
    _assert_close(got, want, ATOL)
    full = pra.full_attention(*(torch.from_numpy(a) for a in arrays[:3]),
                              causal=causal)
    np.testing.assert_allclose(got[0], full.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_blocked_inner_path_matches_jax(causal, monkeypatch):
    """Blocks of 4 rows over shards of 16: the in-shard Q and K block
    loops (and the causal block skip) run in both packages."""
    for mod in (pra, jra):
        monkeypatch.setattr(mod, "_Q_BLOCK", 4)
        monkeypatch.setattr(mod, "_K_BLOCK", 4)
    got, want = _ring_pair(_arrays(2, (2, 64, 2, 8)),
                           make_mesh({"seq": 4}, devices=CPU8),
                           JaxMesh(np.array(jax.devices()[:4]), ("seq",)),
                           causal)
    _assert_close(got, want, ATOL)


def test_ring_dp_sp_mesh_matches_jax():
    got, want = _ring_pair(
        _arrays(1, (4, 16, 2, 8)),
        make_mesh({"data": 2, "seq": 4}, devices=CPU8),
        jax_make_mesh({"data": 2, "seq": 4}), True, batch_axis="data")
    _assert_close(got, want, ATOL)


def test_ring_checks_that_shards_divide():
    q = torch.zeros(2, 30, 2, 8)
    with pytest.raises(ValueError, match="does not divide"):
        pra.ring_attention(q, q, q, make_mesh({"seq": 4}, devices=CPU8))


@pytest.mark.parametrize("causal", [False, True])
def test_k3_plain_matches_jax_flash_attention_with_lse(causal):
    """Port K3 on CPU tensors (its plain version) against the JAX
    package's K3 in interpret mode (two 32-row tiles each way): out, lse,
    and grads of q, k, v under cotangents on both outputs (a nonzero
    dlse)."""
    q, k, v, dout = _arrays(11 + causal, (2, 2, 64, 64))
    dlse = np.random.RandomState(5).randn(2, 2, 64).astype(np.float32)
    scale = 0.125

    def f(qq, kk, vv):
        return pk.flash_attention_with_lse(qq, kk, vv, causal, scale,
                                           32, 32, True)

    (jout, jlse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

    ak.flash_attention_with_lse.launches = 0
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = ak.flash_attention_with_lse(*leaves, causal=causal,
                                           scale=scale)
    grads = torch.autograd.grad(
        (out, lse), leaves, (torch.from_numpy(dout),
                             torch.from_numpy(dlse)))
    assert ak.flash_attention_with_lse.launches == 0   # CPU: plain
    assert lse.shape == (2, 2, 64) and lse.dtype == torch.float32
    _assert_close([out.detach().numpy(), lse.detach().numpy()],
                  [np.asarray(jout), np.asarray(jlse)], ATOL,
                  ("out", "lse"))
    _assert_close([g.numpy() for g in grads],
                  [np.asarray(g) for g in jgrads], ATOL,
                  ("dq", "dk", "dv"))
    # the plain backward with the dlse term, called directly
    ref = ak.flash_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), None, out.detach(),
        lse.detach(), torch.from_numpy(dout), causal, scale,
        dlse=torch.from_numpy(dlse))
    for a, b in zip(grads, ref[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_tier_matches_jax_flash_tier(causal):
    """FLAGS_ring_flash=true in both packages: the in-shard attention is
    K3 (the port's plain version, the JAX package's Pallas kernel in
    interpret mode), whose lse cotangent the ring's merge feeds; shards of
    128 rows at D 64, the smallest the JAX tier tiles."""
    jax_flags._overrides["ring_flash"] = True
    port_flags.set_flags({"ring_flash": True})
    try:
        arrays = [a * 0.5 for a in _arrays(9, (1, 256, 2, 64))]
        got, want = _ring_pair(arrays, make_mesh({"seq": 2}, devices=CPU8),
                               JaxMesh(np.array(jax.devices()[:2]),
                                       ("seq",)), causal)
    finally:
        jax_flags._overrides.pop("ring_flash", None)
    _assert_close(got, want, ATOL)
    blocked = pra.full_attention(*(torch.from_numpy(a)
                                   for a in arrays[:3]), causal=causal)
    np.testing.assert_allclose(got[0], blocked.numpy(), atol=ATOL, rtol=0)


def test_ring_flash_flag_picks_the_tier(monkeypatch):
    """CUDA shards take K3 under every value but false, which raises
    rather than run the blocked path on the card; CPU shards take K3's
    plain version under true and the blocked path otherwise.  A K3
    failure under true raises (no fallback to the blocked path)."""
    for mode, cpu in (("auto", False), ("true", True), ("false", False)):
        port_flags.set_flags({"ring_flash": mode})
        assert pra._use_ring_flash("cpu") is cpu
        if mode == "false":
            with pytest.raises(ValueError, match="CPU shards only"):
                pra._use_ring_flash("cuda")
        else:
            assert pra._use_ring_flash("cuda") is True
    port_flags.set_flags({"ring_flash": "true"})

    def broken(*a, **kw):
        raise RuntimeError("K3 launch failed")

    monkeypatch.setattr(ak, "flash_attention_with_lse", broken)
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(RuntimeError, match="K3 launch failed"):
        pra.ring_attention(q, q, q, make_mesh({"seq": 2}, devices=CPU8))


def test_mesh_and_env():
    mesh = make_mesh({"data": 2, "model": 2, "seq": 2}, devices=CPU8)
    assert mesh.shape == {"data": 2, "model": 2, "seq": 2}
    assert mesh.axis_names == ("data", "model", "seq") and mesh.size == 8
    assert mesh.device(seq=1) == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh({"data": 4, "seq": 4}, devices=CPU8)
    assert make_mesh([2, 4], devices=CPU8).axis_names == ("data", "model")
    assert mesh_mod.elastic_factorization(3, local_devices=4) == {
        "data": 12}
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs that many; have 0"):
            mesh_mod.data_parallel_mesh()


def test_init_distributed_single_endpoint_and_many(monkeypatch):
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS", "3")
    assert env.get_num_trainers() == 3 and not env.init_distributed()
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "h0:1,h1:1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    assert env.get_trainer_id() == 1 and env.get_num_trainers() == 2
    with pytest.raises(NotImplementedError, match="multi-process mesh"):
        env.init_distributed()


# ---------------------------------------------------------------------------
# gpipe: the behaviours of tests/test_pipeline.py on the port
# ---------------------------------------------------------------------------

D, STAGES, MICRO, BATCH = 16, 4, 4, 16


def _pipe_program(seed):
    port_init._auto_seed_counter[0] = 1
    main, startup = pfluid.Program(), pfluid.Program()
    main.random_seed = startup.random_seed = seed
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data(name="x", shape=[D], dtype="float32")
        y = pfluid.layers.data(name="y", shape=[D], dtype="float32")
        pipe = pfluid.layers.PipelineStack(num_stages=STAGES,
                                           num_microbatches=MICRO)
        with pipe.block():
            h = pipe.stage_input(x)
            h = pfluid.layers.fc(h, size=D, act="tanh")
            pipe.output(h)
        loss = pfluid.layers.reduce_mean(pfluid.layers.square(
            pfluid.layers.elementwise_sub(pipe(), y)))
        pfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _pipe_data(step):
    rng = np.random.RandomState(400 + step)
    xv = rng.randn(BATCH, D).astype(np.float32)
    return {"x": xv, "y": np.tanh(xv)[:, ::-1].copy()}


def _pipe_losses(mesh, steps, seed=33):
    main, startup, loss = _pipe_program(seed)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    prog = main
    if mesh is not None:
        prog = pfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=[pfluid.CPUPlace()])
        prog._mesh = mesh
    return [float(exe.run(prog, feed=_pipe_data(s), fetch_list=[loss],
                          scope=scope)[0]) for s in range(steps)]


def test_pipeline_stacks_stage_parameters():
    main, startup, _ = _pipe_program(21)
    blk = main.global_block()
    stacked = [p.name for p in main.all_parameters()
               if p.name.endswith("@STACKED")]
    assert len(stacked) == 2                     # fc w + b, hoisted
    w = next(p for p in stacked if ".w" in p)
    assert tuple(blk.var(w).shape) == (STAGES, D, D)
    assert blk.var(w).sharding[0] == "pipe"
    assert [op.type for op in blk.ops].count("gpipe") == 1


def test_pipeline_serial_trains():
    losses = _pipe_losses(None, 40)
    assert losses[-1] < losses[0] * 0.75, (losses[0], losses[-1])


def test_pipeline_on_mesh_matches_serial():
    """dp2 x pp4: the GPipe schedule against the serial stages."""
    serial = _pipe_losses(None, 5)
    piped = _pipe_losses(make_mesh({"data": 2, "pipe": 4}, devices=CPU8),
                         5)
    np.testing.assert_allclose(piped, serial, rtol=2e-4, atol=1e-6)


def test_pipeline_on_mesh_checkpoints_stage_bodies(monkeypatch):
    """On a pipe mesh under grad, every stage tick that computes (M x S a
    step, the bubble ticks skipped) runs its stage body under
    torch.utils.checkpoint; off the mesh none does."""
    from paddle_tpu_torch.ops import pipeline_ops

    calls = []

    def counting(fn, *args, **kw):
        calls.append(len(args))
        return pipeline_ops.checkpoint.__wrapped__(fn, *args, **kw)

    counting.__wrapped__ = pipeline_ops.checkpoint
    monkeypatch.setattr(pipeline_ops, "checkpoint", counting)
    _pipe_losses(None, 1, seed=44)
    assert calls == []
    _pipe_losses(make_mesh({"data": 2, "pipe": 4}, devices=CPU8), 2,
                 seed=44)
    assert len(calls) == 2 * MICRO * STAGES
    assert set(calls) == {3}                     # h, the fc's w and b


def test_pipeline_mesh_errors():
    main, startup, loss = _pipe_program(5)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    prog = pfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[pfluid.CPUPlace()])
    prog._mesh = make_mesh({"pipe": 2}, devices=CPU8)
    with pytest.raises(ValueError, match="4 stages but mesh 'pipe' axis"):
        exe.run(prog, feed=_pipe_data(0), fetch_list=[loss], scope=scope)
    prog._mesh = make_mesh({"pipe": 4}, devices=CPU8)
    feed = {n: a[:6] for n, a in _pipe_data(0).items()}
    with pytest.raises(ValueError, match="not divisible by"):
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)


# ---------------------------------------------------------------------------
# the dry-run training step (__graft_entry__._dryrun_one) in both packages
# ---------------------------------------------------------------------------

def _dryrun_build(pkg, sp, pp):
    fluid, init, names = ((jfluid, jax_init, jax_unique_name)
                          if pkg == "jax" else
                          (pfluid, port_init, port_unique_name))
    d_model, n_heads, seq_len, bs, micro = dryrun.configs(sp)[0]
    init._auto_seed_counter[0] = 1
    main, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(main, startup):
        loss = dryrun.dryrun_program(fluid, d_model, n_heads, seq_len, pp,
                                     micro)
    return main, startup, loss, seq_len, bs


def _signature(prog):
    out = []
    for blk in prog.blocks:
        ops = [(op.type, {k: list(v) for k, v in op.inputs.items()},
                {k: list(v) for k, v in op.outputs.items()},
                {k: v for k, v in op.attrs.items()
                 if not hasattr(v, "ops")})
               for op in blk.ops]
        vs = {n: (v.shape, v.dtype, v.persistable,
                  getattr(v, "sharding", None))
              for n, v in blk.vars.items()}
        out.append((ops, vs))
    return out


FACTORIZATIONS = dryrun.factorizations(8)


@pytest.mark.parametrize("dp,tp,sp,pp", FACTORIZATIONS)
def test_dryrun_program_equals_jax_program(dp, tp, sp, pp):
    jmain, jstart, jloss = _dryrun_build("jax", sp, pp)[:3]
    pmain, pstart, ploss = _dryrun_build("port", sp, pp)[:3]
    assert ploss.name == jloss.name
    types = [op.type for op in pmain.global_block().ops]
    assert {"ring_attention", "gpipe", "split", "reduce_mean",
            "momentum"} <= set(types)
    for jp, pp_ in ((jmain, pmain), (jstart, pstart)):
        js, ps = _signature(jp), _signature(pp_)
        assert len(js) == len(ps)
        for (jops, jvars), (pops, pvars) in zip(js, ps):
            assert pvars == jvars
            assert pops == jops


@pytest.mark.parametrize("dp,tp,sp,pp", FACTORIZATIONS)
def test_dryrun_losses_match_jax_and_single_device(dp, tp, sp, pp):
    """From the JAX package's startup state, over 2 Momentum steps (the
    second reads the first's grads through the ring and the pipeline):
    port single device = JAX single device (1e-4 relative), port mesh =
    port single device (1e-5) and JAX mesh = JAX single device (1e-3, the
    dry run's bar)."""
    jmain, jstart, jloss, seq_len, bs = _dryrun_build("jax", sp, pp)
    feed = dryrun.dryrun_feed(bs * dp, seq_len)
    zp = zoo.ZooProgram("dryrun", jmain, jstart,
                        {k: (v.shape, str(v.dtype)) for k, v in feed.items()},
                        [jloss.name])
    state = zoo.snapshot_startup(zp)
    axes = {"data": dp, "model": tp, "seq": sp, "pipe": pp}

    def jax_losses(on_mesh):
        scope = jfluid.Scope()
        for n, v in state.items():
            scope.set_var(n, np.array(v, copy=True))
        exe = jfluid.Executor()
        prog = jmain
        if on_mesh:
            prog = JaxCompiledProgram(jmain).with_data_parallel(
                loss_name=jloss.name)
            prog._mesh = jax_make_mesh(axes, devices=jax.devices()[:8])
        with jfluid.scope_guard(scope):
            return [float(np.asarray(exe.run(prog, feed=feed,
                                             fetch_list=[jloss])[0]))
                    for _ in range(2)]

    pmain, _, ploss = _dryrun_build("port", sp, pp)[:3]

    def port_losses(on_mesh):
        scope = pfluid.io.state_from_numpy(state, scope=pfluid.Scope(),
                                           place=pfluid.CPUPlace(),
                                           main_program=pmain)
        exe = pfluid.Executor(pfluid.CPUPlace())
        prog = pmain
        if on_mesh:
            prog = pfluid.CompiledProgram(pmain).with_data_parallel(
                loss_name=ploss.name, places=[pfluid.CPUPlace()])
            prog._mesh = make_mesh(axes, devices=CPU8)
        return [float(exe.run(prog, feed=feed, fetch_list=[ploss],
                              scope=scope)[0]) for _ in range(2)]

    want, want_mesh = jax_losses(False), jax_losses(True)
    got, got_mesh = port_losses(False), port_losses(True)
    assert np.all(np.isfinite(got + got_mesh))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # the port's mesh and single-device runs do the same dense math, so
    # they are held far tighter than the dry run's 1e-3, which a ring
    # that drops a past shard or leaks the diagonal's future can still
    # meet (test_dryrun_loss_bar_catches_a_broken_ring)
    np.testing.assert_allclose(got_mesh, got, rtol=1e-5, atol=0)
    np.testing.assert_allclose(want_mesh, want, rtol=1e-3, atol=0)
    assert got[1] != got[0]                 # the update moved the loss


def _planted_fault(fault):
    """A broken in-shard tier for the blocked path: "leak" lets the
    diagonal step attend to its own future, "drop" merges nothing from a
    past shard."""
    shard_attn = pra._shard_attn

    def broken(q, k, v, q_off, k_off, scale, causal):
        if fault == "leak":
            return shard_attn(q, k, v, q_off, k_off, scale,
                              causal and q_off != k_off)
        if k_off < q_off:
            return pra._init_partial(q)
        return shard_attn(q, k, v, q_off, k_off, scale, causal)
    return broken


@pytest.mark.parametrize("fault", ["leak", "drop"])
def test_dryrun_loss_bar_catches_a_broken_ring(monkeypatch, fault):
    """The 1e-5 the port's mesh run is held to fails a ring with a planted
    fault at the BERT-block-shaped config (d_model 256, 4 heads, seq 1024)
    on (2, 2, 2, 1), where the dry run's 1e-3 passes it: the loss, a mean
    over the sequence, barely feels one shard."""
    d_model, n_heads, seq_len, bs, micro = dryrun.configs(2)[1]
    main, startup = pfluid.Program(), pfluid.Program()
    main.random_seed = startup.random_seed = 7
    with port_unique_name.guard(), pfluid.program_guard(main, startup):
        loss = dryrun.dryrun_program(pfluid, d_model, n_heads, seq_len, 1,
                                     micro)
    feed = dryrun.dryrun_feed(bs * 2, seq_len)
    exe = pfluid.Executor(pfluid.CPUPlace())
    state = pfluid.Scope()
    exe.run(startup, scope=state)

    def first_loss(mesh):
        scope = pfluid.Scope()
        for n, x in state.vars.items():
            if x is not None:
                scope.set_var(n, x.clone())
        prog = main
        if mesh is not None:
            prog = pfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, places=[pfluid.CPUPlace()])
            prog._mesh = mesh
        return float(exe.run(prog, feed=feed, fetch_list=[loss],
                             scope=scope)[0])

    mesh = make_mesh({"data": 2, "model": 2, "seq": 2, "pipe": 1},
                     devices=CPU8)
    want = first_loss(None)
    assert abs(first_loss(mesh) - want) <= 1e-5 * abs(want)
    monkeypatch.setattr(pra, "_shard_attn", _planted_fault(fault))
    rel = abs(first_loss(mesh) - want) / abs(want)
    assert 1e-5 < rel < 1e-3, rel


def test_compiled_program_caches_and_runs_the_seams(monkeypatch):
    """CompiledProgram verifies and runs the pass pipeline once per
    (program version, feeds, fetches), with the mesh in the run's
    context and out of it after."""
    from paddle_tpu_torch.ops import registry

    main, startup, loss = _pipe_program(3)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    mesh = make_mesh({"data": 2, "pipe": 4}, devices=CPU8)
    prog = pfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[pfluid.CPUPlace()] * 2)
    assert prog._mesh.shape == {"data": 2}
    prog._mesh = mesh
    seen = []
    gpipe = registry._KERNELS["gpipe"]
    monkeypatch.setitem(registry._KERNELS, "gpipe", lambda ins, attrs: (
        seen.append(registry.current().mesh), gpipe(ins, attrs))[1])
    for step in range(2):
        exe.run(prog, feed=_pipe_data(step), fetch_list=[loss],
                scope=scope)
    assert len(prog._cache) == 1 and exe.last_guard is None
    assert seen and all(m is mesh for m in seen)
    assert registry.current().mesh is None
    exe.run(main, feed=_pipe_data(0), fetch_list=[loss], scope=scope)
    assert seen[-1] is None


def test_parallel_executor_runs_on_the_cpu_when_asked():
    main, startup, loss = _pipe_program(7)
    scope = pfluid.Scope()
    pfluid.Executor(pfluid.CPUPlace()).run(startup, scope=scope)
    pe = pfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=main, scope=scope)
    assert pe.device_count == torch.cuda.device_count()
    (lv,) = pe.run([loss], feed=_pipe_data(0))
    assert np.isfinite(lv).all()
