"""Weight-decay regularizers appended as grad ops.

Reference: ``python/paddle/fluid/regularizer.py:112,171`` — L2/L1 decay
append ops transforming each grad before the optimizer update.
"""

from .layer_helper import LayerHelper


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype, True)
        decay.shape = param.shape
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "bias": 0.0,
                               "bias_after_scale": True})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype, True)
        sign.shape = param.shape
        # sign(p) = p / |p| safe form via clip of |p|: use where-free trick
        absv = helper.create_variable_for_type_inference(param.dtype, True)
        absv.shape = param.shape
        block.append_op(type="abs", inputs={"X": [param]},
                        outputs={"Out": [absv]})
        eps = helper.create_variable_for_type_inference(param.dtype, True)
        eps.shape = param.shape
        block.append_op(type="scale", inputs={"X": [absv]},
                        outputs={"Out": [eps]},
                        attrs={"scale": 1.0, "bias": 1e-12,
                               "bias_after_scale": True})
        block.append_op(type="elementwise_div",
                        inputs={"X": [param], "Y": [eps]},
                        outputs={"Out": [sign]}, attrs={"axis": -1})
        decay = helper.create_variable_for_type_inference(param.dtype, True)
        decay.shape = param.shape
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "bias": 0.0,
                               "bias_after_scale": True})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        reg = param.regularizer if param.regularizer is not None \
            else regularization
        if reg is not None:
            regularization_term = reg(param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        helper = LayerHelper("regularized_grad")
        new_grad = helper.create_variable_for_type_inference(grad.dtype, True)
        new_grad.shape = grad.shape
        grad.block.append_op(type="sum",
                             inputs={"X": [grad, regularization_term]},
                             outputs={"Out": [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads


# fluid public aliases
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
