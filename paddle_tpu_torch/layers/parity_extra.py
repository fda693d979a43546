"""The layer-builder tail of ``fluid.layers`` (a copy of
``paddle_tpu/layers/parity_extra.py``): reference layer names whose
kernels had no builder.  Reference: ``python/paddle/fluid/layers/
{nn,ops,tensor,metric_op}.py``.

``layers/__init__.py`` imports this module after ``nn`` and ``nn_extra``,
as the JAX package does, so its definitions shadow same-named earlier
ones (``isfinite``).  ``Print`` emits the host op ``print``
(``distributed/host_ops.py``): a program holding it runs op by op.  The
detection layers of the reference's file (``generate_proposals``,
``rpn_target_assign``) wait with the detection ops (ROADMAP queue 1
item 13).
"""

from ..layer_helper import LayerHelper
from .tensor import create_global_var

__all__ = ["brelu", "stanh", "soft_relu", "prelu", "pad2d", "unstack",
           "add_position_encoding", "uniform_random", "gaussian_random",
           "uniform_random_batch_size_like",
           "gaussian_random_batch_size_like", "dice_loss", "isfinite",
           "mean_iou", "mul", "create_parameter", "image_resize_short",
           "adaptive_pool2d", "adaptive_pool3d", "Print",
           "get_tensor_from_selected_rows", "merge_selected_rows",
           "autoincreased_step_counter", "auc"]


def _unary_attr(op_type, x, attrs, name=None, out_shape=None,
                dtype=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        dtype or getattr(x, "dtype", "float32"))
    if out_shape is not None:
        out.shape = tuple(out_shape)
    elif x is not None:
        out.shape = x.shape
    helper.append_op(type=op_type,
                     inputs=({"X": [x]} if x is not None else {}),
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _unary_attr("brelu", x, {"t_min": t_min, "t_max": t_max},
                       name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _unary_attr("stanh", x, {"scale_a": scale_a,
                                    "scale_b": scale_b}, name)


def soft_relu(x, threshold=40.0, name=None):
    return _unary_attr("soft_relu", x, {"threshold": threshold}, name)


def prelu(x, mode, param_attr=None, name=None):
    """prelu_op.cc: mode in {all, channel, element}."""
    helper = LayerHelper("prelu", name=name, param_attr=param_attr)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    from ..initializer import ConstantInitializer
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def pad2d(x, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    if data_format != "NCHW":
        raise NotImplementedError("pad2d: only NCHW")
    n, c, h, w = x.shape
    out_shape = (n, c, h + paddings[0] + paddings[1],
                 w + paddings[2] + paddings[3])
    return _unary_attr("pad2d", x,
                       {"paddings": list(paddings), "mode": mode,
                        "pad_value": pad_value}, name,
                       out_shape=out_shape)


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    axis_ = axis if axis >= 0 else axis + len(x.shape)
    n = num if num is not None else x.shape[axis_]
    if n is None or n < 0:
        raise ValueError("unstack: axis dim is dynamic — pass num")
    outs = []
    rest = tuple(s for i, s in enumerate(x.shape) if i != axis_)
    for _ in range(n):
        o = helper.create_variable_for_type_inference(x.dtype)
        o.shape = rest
        outs.append(o)
    helper.append_op(type="unstack", inputs={"X": [x]},
                     outputs={"Y": outs}, attrs={"axis": axis})
    return outs


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _unary_attr("add_position_encoding", input,
                       {"alpha": alpha, "beta": beta}, name)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    from ..initializer import _next_seed

    return _unary_attr("uniform_random", None,
                       {"shape": list(shape), "dtype": dtype,
                        "min": min, "max": max,
                        "seed": _next_seed(seed or 0)}, name,
                       out_shape=shape, dtype=dtype)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    from ..initializer import _next_seed

    return _unary_attr("gaussian_random", None,
                       {"shape": list(shape), "dtype": dtype,
                        "mean": mean, "std": std,
                        "seed": _next_seed(seed or 0)}, name,
                       out_shape=shape, dtype=dtype)


def _random_batch_size_like(op_type, input, shape, extra, dtype,
                            input_dim_idx, output_dim_idx, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype)
    oshape = list(shape)
    oshape[output_dim_idx] = input.shape[input_dim_idx]
    out.shape = tuple(oshape)
    from ..initializer import _next_seed

    attrs = {"shape": list(shape), "dtype": dtype,
             "input_dim_idx": input_dim_idx,
             "output_dim_idx": output_dim_idx}
    attrs.update(extra)
    attrs["seed"] = _next_seed(attrs.get("seed") or 0)
    helper.append_op(type=op_type, inputs={"Input": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0,
                                   name=None):
    return _random_batch_size_like(
        "uniform_random_batch_size_like", input, shape,
        {"min": min, "max": max, "seed": seed}, dtype, input_dim_idx,
        output_dim_idx, name)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0,
                                    std=1.0, seed=0, dtype="float32",
                                    name=None):
    return _random_batch_size_like(
        "gaussian_random_batch_size_like", input, shape,
        {"mean": mean, "std": std, "seed": seed}, dtype, input_dim_idx,
        output_dim_idx, name)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """The reference's python composition exactly (nn.py dice_loss):
    one-hot the class-id label to input's last dim, per-sample dice
    over all non-batch dims, mean over the batch:
    mean(1 - 2·∑(input·onehot)/(∑input + ∑onehot + eps))."""
    from .nn import (reduce_sum, reduce_mean, elementwise_mul,
                     elementwise_add, elementwise_div, one_hot)
    from .tensor import cast
    from .nn import scale as _scale

    oh = cast(one_hot(label, depth=input.shape[-1]), input.dtype)
    dims = list(range(1, len(input.shape)))
    inse = reduce_sum(elementwise_mul(input, oh), dim=dims)
    den = elementwise_add(reduce_sum(input, dim=dims),
                          reduce_sum(oh, dim=dims))
    frac = elementwise_div(_scale(inse, scale=2.0),
                           _scale(den, scale=1.0, bias=epsilon))
    return reduce_mean(_scale(frac, scale=-1.0, bias=1.0))


def isfinite(x, name=None):
    return _unary_attr("isfinite", x, {}, name, out_shape=(1,),
                       dtype="bool")


def mean_iou(input, label, num_classes, name=None):
    helper = LayerHelper("mean_iou", name=name)
    miou = helper.create_variable_for_type_inference("float32")
    miou.shape = ()
    wrong = helper.create_variable_for_type_inference("int32")
    wrong.shape = (num_classes,)
    correct = helper.create_variable_for_type_inference("int32")
    correct.shape = (num_classes,)
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": num_classes})
    return miou, wrong, correct


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(x.shape[:x_num_col_dims]) + \
        tuple(y.shape[y_num_col_dims:])
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """layers.create_parameter (tensor.py): a raw trainable parameter."""
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name,
                         param_attr=attr or ParamAttr(name=name))
    return helper.create_parameter(
        attr=helper.param_attr, shape=list(shape), dtype=dtype,
        is_bias=is_bias, default_initializer=default_initializer)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """nn.py image_resize_short: scale so the SHORT side equals
    out_short_len."""
    from .nn_extra import resize_bilinear, resize_nearest

    h, w = input.shape[2], input.shape[3]
    short = min(h, w)
    # reference rounds half-up (int(x + 0.5)), not banker's round()
    oh = int(h * out_short_len / short + 0.5)
    ow = int(w * out_short_len / short + 0.5)
    fn = resize_bilinear if resample.upper() == "BILINEAR" \
        else resize_nearest
    return fn(input, out_shape=[oh, ow])


def adaptive_pool2d(input, pool_size, pool_type="max",
                    require_index=False, name=None):
    if require_index:
        raise NotImplementedError("adaptive_pool2d: require_index")
    n, c = input.shape[0], input.shape[1]
    return _unary_attr("adaptive_pool2d", input,
                       {"pooled_size": list(pool_size),
                        "pooling_type": pool_type}, name,
                       out_shape=(n, c) + tuple(pool_size))


def adaptive_pool3d(input, pool_size, pool_type="max",
                    require_index=False, name=None):
    if require_index:
        raise NotImplementedError("adaptive_pool3d: require_index")
    n, c = input.shape[0], input.shape[1]
    return _unary_attr("adaptive_pool3d", input,
                       {"pooled_size": list(pool_size),
                        "pooling_type": pool_type}, name,
                       out_shape=(n, c) + tuple(pool_size))


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Debug print (control_flow.py Print): host-side; a program
    containing it runs on the eager interpreter."""
    helper = LayerHelper("print")
    attrs = {"message": message} if message else {}
    helper.append_op(type="print", inputs={"In": [input]}, outputs={},
                     attrs=attrs)
    return input


def get_tensor_from_selected_rows(x, name=None):
    return _unary_attr("get_tensor_from_selected_rows", x, {}, name)


def merge_selected_rows(x, name=None):
    return _unary_attr("merge_selected_rows", x, {}, name)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """nn.py autoincreased_step_counter: persistable int counter +=
    step each run.  Idempotent per name — a second call returns the
    SAME counter without appending another increment (the reference
    guards on is_new_var; two increments would double-count)."""
    from ..core.framework import default_main_program

    name = counter_name or "@STEP_COUNTER@"
    block = default_main_program().global_block()
    if block.has_var(name):
        # the reference's is_new_var guard: the FIRST call's begin and
        # its single increment op win; later calls just return the var
        return block.var(name)
    # init to begin - 1 regardless of step (reference nn.py seeds the
    # counter at begin-1 and the first increment lands on begin-1+step;
    # begin-step would shift every value when step != 1)
    counter = create_global_var(
        shape=[1], value=begin - 1, dtype="int64", persistable=True,
        name=name)
    helper = LayerHelper("increment")
    helper.append_op(type="increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]},
                     attrs={"step": float(step)})
    return counter


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """metric_op.py auc: running bucketed AUC over persistable stat
    vars + the batch-local AUC (fresh stats each step).  Only the
    reference's default configuration is lowered; anything else must
    fail loudly rather than report the wrong metric."""
    if curve != "ROC" or topk != 1 or slide_steps != 1:
        raise NotImplementedError(
            "layers.auc: only curve='ROC', topk=1, slide_steps=1")
    helper = LayerHelper("auc")
    stat_pos = create_global_var(shape=[num_thresholds + 1], value=0.0,
                                 dtype="float32", persistable=True)
    stat_neg = create_global_var(shape=[num_thresholds + 1], value=0.0,
                                 dtype="float32", persistable=True)

    def one(pos_in, neg_in):
        auc_out = helper.create_variable_for_type_inference("float32")
        auc_out.shape = ()
        pos_out = helper.create_variable_for_type_inference("float32")
        pos_out.shape = (num_thresholds + 1,)
        neg_out = helper.create_variable_for_type_inference("float32")
        neg_out.shape = (num_thresholds + 1,)
        helper.append_op(
            type="auc",
            inputs={"Predict": [input], "Label": [label],
                    "StatPos": [pos_in], "StatNeg": [neg_in]},
            outputs={"AUC": [auc_out], "StatPosOut": [pos_out],
                     "StatNegOut": [neg_out]})
        return auc_out, pos_out, neg_out

    auc_out, pos_out, neg_out = one(stat_pos, stat_neg)
    # running stats persist across steps
    helper.append_op(type="assign", inputs={"X": [pos_out]},
                     outputs={"Out": [stat_pos]})
    helper.append_op(type="assign", inputs={"X": [neg_out]},
                     outputs={"Out": [stat_neg]})
    from .tensor import fill_constant
    zero_pos = fill_constant([num_thresholds + 1], "float32", 0.0)
    zero_neg = fill_constant([num_thresholds + 1], "float32", 0.0)
    batch_auc, _, _ = one(zero_pos, zero_neg)
    return auc_out, batch_auc, [stat_pos, stat_neg]
