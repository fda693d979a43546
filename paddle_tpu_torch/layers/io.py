"""Input layers: fluid.layers.data (layers/io.py:39 in the reference)."""

from ..core.framework import default_main_program, default_startup_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare a feed variable.  append_batch_size prepends -1 (dynamic
    batch), matching fluid's convention."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level > 0:
        # ragged var: dense [batch, max_len, ...] + lengths companion
        # (the SEQ_LEN lowering of SURVEY §5.7); the declared per-token
        # shape gains one dynamic dim per lod level
        shape = [shape[0]] + [-1] * lod_level + shape[1:]
    main = default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
    default_startup_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
    if lod_level > 0:
        from ..core.lod import seq_lenk_name
        # one int32 lengths companion per LoD level (arbitrary depth,
        # lod_tensor.h:44-58 parity): lens_k is [B, S1, ..., S_{k-1}]
        for k in range(1, lod_level + 1):
            default_main_program().global_block().create_var(
                name=seq_lenk_name(name, k), shape=[-1] * k,
                dtype="int32", stop_gradient=True, is_data=True)
    return main

