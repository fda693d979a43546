"""Input layers: fluid.layers.data (layers/io.py:39 in the reference),
py_reader and read_file."""

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


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True, cache_on_device=False):
    """Background host->device staged reader (layers/io.py:636 +
    buffered_reader.cc double-buffer parity).  Returns a PyReader; unpack
    its data variables with :func:`read_file`.  A run with no feed takes
    its next batch on the run's device."""
    from ..core import unique_name
    from ..pyreader import PyReader

    name = name or unique_name.generate("py_reader")
    lod_levels = lod_levels or [0] * len(shapes)
    feed_vars = []
    for i, (shape, dtype, lod) in enumerate(zip(shapes, dtypes, lod_levels)):
        feed_vars.append(data(name=f"{name}_slot{i}", shape=list(shape),
                              dtype=dtype, lod_level=lod,
                              append_batch_size=False))
    reader = PyReader(feed_vars, capacity=capacity,
                      cache_on_device=cache_on_device)
    prog = default_main_program()
    if not hasattr(prog, "_py_readers"):
        prog._py_readers = []
    prog._py_readers.append(reader)
    return reader


def read_file(reader):
    """Unpack a py_reader's staged data variables (layers/io.py parity)."""
    vs = reader.feed_vars
    return vs[0] if len(vs) == 1 else tuple(vs)
