"""ParamAttr / WeightNormParamAttr (python/paddle/fluid/param_attr.py)."""

from .initializer import ConstantInitializer, XavierInitializer


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False, sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        # TPU-only: PartitionSpec-style tuple of mesh-axis names (or None
        # per dim) consumed by the pjit lowering — tensor parallelism is
        # declared per-parameter, GSPMD inserts the collectives.
        self.sharding = sharding

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        if isinstance(arg, bool):
            return ParamAttr()
        from .initializer import Initializer
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")

    def _default_initializer(self, is_bias):
        if self.initializer is not None:
            return self.initializer
        return ConstantInitializer(0.0) if is_bias else XavierInitializer()


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
