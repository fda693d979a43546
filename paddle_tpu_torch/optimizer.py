"""Optimizers: minimize = append_backward + per-param update ops (a copy
of ``paddle_tpu/optimizer.py``: the ten optimizers SGD, Momentum,
LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp
and Ftrl, with ``GradientMergeOptimizer`` and ``ModelAverage``).

Both of the last two stay branch-free, so a step under them is still
one captured CUDA graph (``core/executor.capturable``): gradient merging
runs the inner optimizer at every step and rolls its writes back off the
k-step boundary with ``gradient_merge_select`` (a device select), and
the model average's window is ``average_accumulates``' selects.

Reference: ``python/paddle/fluid/optimizer.py`` — `Optimizer.minimize`
(:357) = `backward()` + `apply_gradients` (:286,318);
`_create_optimization_pass` (:198) creates the global lr var, per-param
accumulators (initialized in the startup program) and one update op per
param.  An update op writes its new value under the state var's own
name, and the Executor stores persistable writes back into the Scope, so
the next run sees them.
"""

from .core import unique_name
from .core.framework import (Operator, Program, Variable,
                             default_main_program, default_startup_program,
                             program_guard)
from .core.backward import append_backward
from .layer_helper import LayerHelper
from .initializer import ConstantInitializer
from .regularizer import append_regularization_ops
from .clip import append_gradient_clip_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._learning_rate_var = None
        self._accumulators = {}      # acc name -> {param name: var}
        self.helper = None

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        if self._learning_rate_var is not None:
            return
        from .layers import tensor as tensor_layers
        self._learning_rate_var = tensor_layers.create_global_var(
            shape=[1], value=float(self._learning_rate), dtype="float32",
            persistable=True,
            name=unique_name.generate("learning_rate"))

    def _global_learning_rate(self):
        return self._learning_rate_var

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        factor = param.optimize_attrs.get("learning_rate", 1.0)
        if factor == 1.0:
            return self._global_learning_rate()
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference("float32", True)
        out.shape = (1,)
        helper.append_op(type="scale",
                         inputs={"X": [self._global_learning_rate()]},
                         outputs={"Out": [out]},
                         attrs={"scale": float(factor), "bias": 0.0,
                                "bias_after_scale": True})
        return out

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        main_block = default_main_program().global_block()
        var_name = unique_name.generate(f"{param.name}_{name}")
        var = main_block.create_var(name=var_name, shape=shape, dtype=dtype,
                                    persistable=True, stop_gradient=True)
        # moment buffers inherit the param's TP sharding (same shape)
        if shape == list(param.shape or []):
            var.sharding = getattr(param, "sharding", None)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=var_name, shape=shape, dtype=dtype,
                           persistable=True, stop_gradient=True)
        sv.sharding = var.sharding
        ConstantInitializer(float(fill_value))(sv, sb)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, parameters_and_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- the pass ----------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        block = program.global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        optimize_ops = []
        for pg in parameters_and_grads:
            if pg[1] is None:
                continue
            optimize_ops.append(self._append_optimize_op(block, pg))
        self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads, loss=None):
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        loss = loss if loss is not None else _FakeLoss(params_grads)
        return self._create_optimization_pass(params_grads, loss)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        return optimize_ops, params_grads


class _FakeLoss:
    def __init__(self, params_grads):
        self.block = params_grads[0][0].block


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=1.0)
            self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                  fill_value=1.0)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="adam",
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "lazy_mode": self._lazy_mode})




class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        op = block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "InfNorm": [inf], "Beta1Pow": [b1p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name],
                     "InfNormOut": [inf.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        # β1^t advances after the update (the reference's _finish_update)
        block.append_op(type="scale", inputs={"X": [b1p]},
                        outputs={"Out": [b1p.name]},
                        attrs={"scale": self._beta1, "bias": 0.0,
                               "bias_after_scale": True})
        return op


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("__avg_squared_grad", p)
        upd = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [sq],
                    "AvgSquaredUpdate": [upd]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [sq.name],
                     "AvgSquaredUpdateOut": [upd.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        inputs = {"Param": [p], "Grad": [g], "Moment": [mom],
                  "MeanSquare": [ms],
                  "LearningRate": [self._create_param_lr(param_and_grad)]}
        outputs = {"ParamOut": [p.name], "MomentOut": [mom.name],
                   "MeanSquareOut": [ms.name]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            inputs["MeanGrad"] = [mg]
            outputs["MeanGradOut"] = [mg.name]
        return block.append_op(
            type="rmsprop", inputs=inputs, outputs=outputs,
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


# fluid-style lowercase aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer


class GradientMergeOptimizer:
    """Gradient accumulation (the multi_batch_merge_pass capability /
    fluid GradientMergeOptimizer): k micro-batch gradients add up in
    persistable buffers, and the inner optimizer's update takes effect
    only on every k-th step.

    The reference's lowering, kept op for op: a persistable ``gm_step``
    counter, ``increment``, ``elementwise_mod`` and ``equal`` make the
    boundary predicate; each grad is ``sum``-med into its accumulator
    (and ``scale``-d by 1/k with `avg`); the inner optimizer runs
    unconditionally on the merged grads, and every state var it writes
    that existed before (params, moments, beta pows) is snapshotted
    before it and rolled back off the boundary by
    ``gradient_merge_select``; the accumulators reset to
    ``fill_zeros_like`` on the boundary.  No op reads a value on the
    host, so the step stays one CUDA graph."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def backward(self, *args, **kwargs):
        return self.inner.backward(*args, **kwargs)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        block = loss.block
        params_grads = self.inner.backward(loss, startup_program,
                                           parameter_list, no_grad_set)
        helper = LayerHelper("gradient_merge")
        sb = default_startup_program().global_block()

        def pvar(name, shape, dtype):
            v = block.create_var(name=name, shape=shape, dtype=dtype,
                                 persistable=True, stop_gradient=True)
            sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                               persistable=True, stop_gradient=True)
            ConstantInitializer(0.0)(sv, sb)
            return v

        def temp(dtype, shape):
            v = helper.create_variable_for_type_inference(dtype, True)
            v.shape = shape
            return v

        counter = pvar(unique_name.generate("gm_step"), (1,), "int32")
        block.append_op(type="increment", inputs={"X": [counter]},
                        outputs={"Out": [counter]}, attrs={"step": 1.0})
        k_var = temp("int32", (1,))
        block.append_op(type="fill_constant", inputs={},
                        outputs={"Out": [k_var]},
                        attrs={"shape": [1], "value": self.k_steps,
                               "dtype": "int32"})
        mod = temp("int32", (1,))
        block.append_op(type="elementwise_mod",
                        inputs={"X": [counter], "Y": [k_var]},
                        outputs={"Out": [mod]}, attrs={"axis": -1})
        zero = temp("int32", (1,))
        block.append_op(type="fill_constant", inputs={},
                        outputs={"Out": [zero]},
                        attrs={"shape": [1], "value": 0, "dtype": "int32"})
        cond = temp("bool", (1,))
        block.append_op(type="equal", inputs={"X": [mod], "Y": [zero]},
                        outputs={"Out": [cond]})

        merged_pg = []
        acc_updates = []            # (accumulator, merged grad)
        for p, g in params_grads:
            acc = pvar(unique_name.generate(p.name + "@GRAD_MERGE"),
                       tuple(p.shape), g.dtype)
            merged = temp(g.dtype, p.shape)
            block.append_op(type="sum", inputs={"X": [acc, g]},
                            outputs={"Out": [merged]})
            scaled = merged
            if self.avg:
                scaled = temp(g.dtype, p.shape)
                block.append_op(type="scale", inputs={"X": [merged]},
                                outputs={"Out": [scaled]},
                                attrs={"scale": 1.0 / self.k_steps,
                                       "bias": 0.0,
                                       "bias_after_scale": True})
            merged_pg.append((p, scaled))
            acc_updates.append((acc, merged))

        # the inner optimizer on the merged grads (clip and regularization
        # applied to the aggregate, as the reference does)
        merged_pg = append_gradient_clip_ops(merged_pg)
        merged_pg = append_regularization_ops(merged_pg,
                                              self.inner.regularization)
        opt_start = len(block.ops)
        self.inner._create_optimization_pass(merged_pg, loss)
        opt_ops = block.ops[opt_start:]
        # roll back only state that existed before the pass: a temp first
        # defined inside it (a per-param LR scale) has no prior value and
        # is recomputed every step
        pre_defined = {n for op in block.ops[:opt_start]
                       for n in op.output_arg_names}
        pre_defined |= {n for n, v in block.vars.items()
                        if getattr(v, "persistable", False)}
        written = sorted({n for op in opt_ops for n in op.output_arg_names
                          if n in pre_defined})
        snaps = []
        for w in written:
            wv = block.var(w)
            snap = block.create_var(
                name=unique_name.generate(w + "@GM_SNAP"), shape=wv.shape,
                dtype=wv.dtype, stop_gradient=True)
            snaps.append((Operator(block, "assign", inputs={"X": [w]},
                                   outputs={"Out": [snap.name]}),
                          snap.name))
        block.ops = block.ops[:opt_start] + [op for op, _ in snaps] + \
            opt_ops
        block.program._bump_version()
        for (_, snap_name), w in zip(snaps, written):
            block.append_op(type="gradient_merge_select",
                            inputs={"Cond": [cond], "X": [w],
                                    "Y": [snap_name]},
                            outputs={"Out": [w]})
        # the boundary resets each accumulator, off it the sum is kept
        for acc, merged in acc_updates:
            zeros = temp(acc.dtype, acc.shape)
            block.append_op(type="fill_zeros_like", inputs={"X": [merged]},
                            outputs={"Out": [zeros]})
            block.append_op(type="gradient_merge_select",
                            inputs={"Cond": [cond], "X": [zeros],
                                    "Y": [merged]},
                            outputs={"Out": [acc.name]})
        return [], params_grads


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (reference optimizer.py:1484,
    average_accumulates_op.h): the main program accumulates each
    parameter every step (``average_accumulates``); ``apply(exe)`` swaps
    the averaged values in, backing up the live ones bit for bit, and
    ``restore(exe)`` swaps them back.

    Construct it after ``minimize()``, as in the reference: its
    accumulate ops ride the main program's step."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization=regularization, name=name)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)

        block = default_main_program().global_block()
        self.params = [p for p in block.all_parameters()
                       if getattr(p, "do_model_average", None) is not False]
        self._backups = {}
        for p in self.params:
            self._append_accumulate(block, p)

        self.apply_program = Program()
        with program_guard(self.apply_program):
            for p in self.params:
                self._add_apply_ops(p)
        self.restore_program = Program()
        with program_guard(self.restore_program):
            for p in self.params:
                self._add_restore_ops(p)

    @staticmethod
    def _ref(block, var):
        """A persistable var of `var`'s name in a side program, so that
        program reads and writes the training Scope's value."""
        return block.create_var(name=var.name, shape=var.shape,
                                dtype=var.dtype, persistable=True,
                                stop_gradient=True)

    def _append_accumulate(self, block, param):
        s1 = self._add_accumulator("sum_1", param)
        s2 = self._add_accumulator("sum_2", param)
        s3 = self._add_accumulator("sum_3", param)
        n_acc = self._add_accumulator("num_accumulates", param,
                                      dtype="int64", shape=[1])
        o_acc = self._add_accumulator("old_num_accumulates", param,
                                      dtype="int64", shape=[1])
        n_upd = self._add_accumulator("num_updates", param, dtype="int64",
                                      shape=[1])
        backup = block.create_var(
            name=unique_name.generate(f"{param.name}_ma_backup"),
            shape=param.shape, dtype=param.dtype, persistable=True,
            stop_gradient=True)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=backup.name, shape=param.shape,
                           dtype=param.dtype, persistable=True,
                           stop_gradient=True)
        ConstantInitializer(0.0)(sv, sb)
        self._backups[param.name] = backup
        block.append_op(
            type="average_accumulates",
            inputs={"Param": [param], "InSum1": [s1], "InSum2": [s2],
                    "InSum3": [s3], "InNumAccumulates": [n_acc],
                    "InOldNumAccumulates": [o_acc],
                    "InNumUpdates": [n_upd]},
            outputs={"OutSum1": [s1], "OutSum2": [s2], "OutSum3": [s3],
                     "OutNumAccumulates": [n_acc],
                     "OutOldNumAccumulates": [o_acc],
                     "OutNumUpdates": [n_upd]},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window})

    def _add_apply_ops(self, param):
        from .layers import tensor as tl
        from .layers.nn import elementwise_div

        block = default_main_program().global_block()
        acc = {n: self._ref(block, self._get_accumulator(n, param))
               for n in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                         "old_num_accumulates")}
        p = self._ref(block, param)
        backup = self._ref(block, self._backups[param.name])
        tl.assign(p, output=backup)
        total = tl.sums([acc["num_accumulates"],
                         acc["old_num_accumulates"]])
        ssum = tl.sums([acc["sum_1"], acc["sum_2"], acc["sum_3"]])
        avg = elementwise_div(ssum, tl.cast(total, param.dtype))
        tl.assign(avg, output=p)

    def _add_restore_ops(self, param):
        from .layers import tensor as tl

        block = default_main_program().global_block()
        tl.assign(self._ref(block, self._backups[param.name]),
                  output=self._ref(block, param))

    def apply(self, executor, need_restore=True):
        """Context manager: the averaged parameters are in effect inside
        it, and the live ones come back on exit (unless `need_restore`
        is False)."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            executor.run(self.apply_program)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)
        return _ctx()

    def restore(self, executor):
        executor.run(self.restore_program)
