"""Gradient clipping rewrites (python/paddle/fluid/clip.py:120,166,212)."""

from .layer_helper import LayerHelper

_gradient_clip_attr = None


class BaseGradientClipAttr:
    def _process(self, param, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def _process(self, param, grad):
        helper = LayerHelper("clip_grad")
        out = helper.create_variable_for_type_inference(grad.dtype, True)
        out.shape = grad.shape
        grad.block.append_op(type="clip", inputs={"X": [grad]},
                             outputs={"Out": [out]},
                             attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _process(self, param, grad):
        helper = LayerHelper("clip_grad_by_norm")
        out = helper.create_variable_for_type_inference(grad.dtype, True)
        out.shape = grad.shape
        grad.block.append_op(type="clip_by_norm", inputs={"X": [grad]},
                             outputs={"Out": [out]},
                             attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name


def set_gradient_clip(clip, param_list=None, program=None):
    global _gradient_clip_attr
    _gradient_clip_attr = clip
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    clips = [(p, g, p.gradient_clip_attr if getattr(
        p, "gradient_clip_attr", None) is not None else _gradient_clip_attr)
        for p, g in params_grads]
    if all(c is None for _, _, c in clips):
        return params_grads
    # global-norm groups need the sum of squared norms across params first
    global_groups = {}
    for p, g, c in clips:
        if isinstance(c, GradientClipByGlobalNorm) and g is not None:
            global_groups.setdefault(c.group_name, (c, []))[1].append((p, g))
    scales = {}
    for gname, (c, pgs) in global_groups.items():
        from .layers import nn, tensor, ops as lops
        sq_norms = []
        block = pgs[0][1].block
        helper = LayerHelper("global_norm_clip")
        for p, g in pgs:
            sq = helper.create_variable_for_type_inference(g.dtype, True)
            sq.shape = (1,)
            block.append_op(type="squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [sq]})
            sq_norms.append(sq)
        total = helper.create_variable_for_type_inference("float32", True)
        total.shape = (1,)
        block.append_op(type="sum", inputs={"X": sq_norms},
                        outputs={"Out": [total]})
        gn = helper.create_variable_for_type_inference("float32", True)
        gn.shape = (1,)
        block.append_op(type="sqrt", inputs={"X": [total]},
                        outputs={"Out": [gn]})
        # scale = clip_norm / max(global_norm, clip_norm)
        mx = helper.create_variable_for_type_inference("float32", True)
        mx.shape = (1,)
        cn = tensor.fill_constant([1], "float32", c.clip_norm)
        block.append_op(type="elementwise_max", inputs={"X": [gn], "Y": [cn]},
                        outputs={"Out": [mx]}, attrs={"axis": -1})
        sc = helper.create_variable_for_type_inference("float32", True)
        sc.shape = (1,)
        block.append_op(type="elementwise_div", inputs={"X": [cn], "Y": [mx]},
                        outputs={"Out": [sc]}, attrs={"axis": -1})
        scales[gname] = sc

    out = []
    for p, g, c in clips:
        if c is None or g is None:
            out.append((p, g))
            continue
        if isinstance(c, GradientClipByGlobalNorm):
            helper = LayerHelper("scaled_grad")
            ng = helper.create_variable_for_type_inference(g.dtype, True)
            ng.shape = g.shape
            g.block.append_op(type="elementwise_mul",
                              inputs={"X": [g], "Y": [scales[c.group_name]]},
                              outputs={"Out": [ng]}, attrs={"axis": -1})
            out.append((p, ng))
        else:
            out.append(c._process(p, g))
    return out


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


def error_clip_callback(block, context):
    pass
