"""Paged decode attention — the port of the TPU kernel K4 of
``paddle_tpu/ops/pallas_kernels.py``: ``_paged_attn_kernel_impl`` (:958),
reached through ``_paged_attention_call`` -> ``pl.pallas_call`` (:1064),
becomes ``csrc/paged_attention.cu``, written by hand for Hopper.  The same
source serves K5, the int8-arena arm (``quant_kernels.
paged_attention_quant``): above head dim 256 in K4's wide loop, at and
below it in a split-KV kernel of its own, whose split plan
(:func:`split_plan`) this module fixes from the shapes alone.

- :func:`paged_attention` ``(q, k_arena, v_arena, block_table, lengths)``
  is the kernel's wrapper, with the reference's signature: one decode
  query per slot ``q [S, H, D]`` over ``[N, Bs, H, D]`` arenas (a
  ``KVBlockPool``'s value planes) gathered through an ``[S, MB]`` block
  table, ``lengths [S]`` valid tokens per slot (0: the slot's row is
  zeros), at every head dim D (above 256 the kernel splits the head dim
  into column groups over a second grid axis).  On a CUDA ``q`` it
  launches the kernel (counted in
  ``paged_attention.launches``) or raises; on a CPU ``q`` it runs the
  plain version :func:`paged_attention_reference`.  Numpy operands (the
  pool keeps its arenas, table and lengths on the host) move to q's
  device.  ``select`` and ``interpret`` are accepted and change nothing:
  the port has no kernel selection, so every shape launches the kernel
  (the reference composed unless ``d % 128 == 0`` and ``bs % 8 == 0``,
  :1132, and measured the rest).

Inference only: no backward.
"""

import collections
import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

_SOURCE = "paged_attention"
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_libs = {}
# the split-KV kernel's constants (csrc/paged_attention.cu): warps a CTA at
# most, tokens staged at a time, a head group's padded row in bytes, and
# the most CTAs a launch is cut into (two an SM of an H100's 132: fewer,
# longer CTAs beat more, shorter ones on the card, PERF.md §6)
SPLIT_WARPS, SPLIT_TILE, SPLIT_GROUP_BYTES = 8, 16, 1024
SPLIT_CTAS = 2 * 132
# per (device, stream): the split kernel's arrival counters, zeroed once
# here and left zero by every launch
_counters = {}

SplitPlan = collections.namedtuple("SplitPlan",
                                   "heads groups tile splits blocks")


@functools.lru_cache(maxsize=256)
def split_plan(s, h, d, bs, mb):
    """How K5's split-KV kernel cuts the work of ``q [s, h, d]`` over
    ``[N, bs, h, d]`` arenas and an ``[s, mb]`` table (head dims up to
    256), from the shapes alone: the lengths are never read to the host.

    - ``heads``: heads a group, at most ``1024 // roundup(d, 16)`` (a
      tile's K and V rows of the group stay within 32 KB) and 8 (a warp a
      head); ``groups = ceil(h / heads)``; ``s * groups`` rows;
    - ``blocks`` a split and ``splits = ceil(mb / blocks)``: the most
      splits that keep ``rows * splits <= SPLIT_CTAS`` (one wave of two
      CTAs an SM), at least one, at most ``mb``;
    - ``tile``: positions staged at a time, ``min(bs, 16)``: a block, or
      16 positions of a larger one.
    """
    dp = -(-d // 16) * 16
    heads = max(1, min(h, SPLIT_GROUP_BYTES // dp, SPLIT_WARPS))
    groups = -(-h // heads)
    blocks = -(-mb // max(1, min(mb, SPLIT_CTAS // (s * groups))))
    return SplitPlan(heads, groups, min(bs, SPLIT_TILE), -(-mb // blocks),
                     blocks)


def split_counters(device, n):
    """The split kernel's n arrival counters for `device` and its current
    stream: int32, zero between launches (each launch's last CTA of a row
    sets its counter back to 0), allocated with zeros at first use and when
    a launch needs more; calls on one stream run in order, so they share
    them."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 1024, 2 * (buf.numel() if buf is not None else 0))
        buf = _counters[key] = torch.zeros(size, dtype=torch.int32,
                                           device=device)
    return buf


def paged_attention_reference(q, k_arena, v_arena, block_table, lengths,
                              scale):
    """Plain version of K4, the reference's ``_paged_attn_reference``
    (:936): gather each slot's blocks densely, mask positions past its
    length, run the composed softmax in float32 (an empty slot gives
    zeros).  Returns q's dtype."""
    table = block_table.long()
    s_, mb = table.shape
    _, bs, h, d = k_arena.shape
    k = k_arena[table].reshape(s_, mb * bs, h, d).float()
    v = v_arena[table].reshape(s_, mb * bs, h, d).float()
    sc = torch.einsum("shd,sthd->sht", q.float() * scale, k)
    valid = torch.arange(mb * bs, device=q.device)[None, None, :] < \
        lengths.to(q.device).long()[:, None, None]
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(sc - m_safe), torch.zeros_like(sc))
    denom = torch.clamp_min(p.sum(-1, keepdim=True), 1e-20)
    return torch.einsum("sht,sthd->shd", p / denom, v).to(q.dtype)


def _kernel():
    """(entry point, error-string function), built and loaded at first
    use."""
    fn = _libs.get(_SOURCE)
    if fn is None:
        lib = cuda_build.load(_SOURCE)
        entry = lib.paged_attention_fwd
        entry.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        entry.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        fn = _libs[_SOURCE] = (entry, lib.paged_attention_error_string)
    return fn


def as_operand(x, device, dtype=None):
    """A tensor on `device` (numpy arrays and lists are copied there),
    cast to `dtype` when given."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)


def operands(q, k_arena, v_arena, block_table, lengths, scales=()):
    """Check the shapes and move every operand to q's device: arenas
    (and scale planes) keep their dtype, the table and lengths become
    int32.  Returns (k, v, table, lengths, scales)."""
    if not isinstance(q, torch.Tensor) or q.dim() != 3:
        raise ValueError(f"paged attention takes a tensor q [S, H, D], not "
                         f"{getattr(q, 'shape', type(q))}")
    dev = q.device
    k, v = as_operand(k_arena, dev), as_operand(v_arena, dev)
    table = as_operand(block_table, dev, torch.int32)
    lens = as_operand(lengths, dev, torch.int32)
    scs = tuple(as_operand(t, dev, torch.float32) for t in scales)
    s_, h, d = q.shape
    if k.dim() != 4 or tuple(k.shape) != tuple(v.shape) or \
            tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"paged attention: arenas {tuple(k.shape)} and "
                         f"{tuple(v.shape)} must be [N, Bs, {h}, {d}]")
    if table.dim() != 2 or table.shape[0] != s_ or \
            tuple(lens.shape) != (s_,):
        raise ValueError(f"paged attention: block table "
                         f"{tuple(table.shape)} must be [{s_}, MB] and "
                         f"lengths {tuple(lens.shape)} [{s_}]")
    for t in scs:
        if tuple(t.shape) != tuple(k.shape[:2]):
            raise ValueError(f"paged attention: scale plane "
                             f"{tuple(t.shape)} must be "
                             f"{tuple(k.shape[:2])}")
    return k, v, table, lens, scs


def launch(q, k, v, table, lens, scale, k_scale=None, v_scale=None):
    """Run csrc/paged_attention.cu on CUDA operands that `operands`
    prepared; returns out [S, H, D] in q's dtype.  Int8 arenas at head
    dims up to 256 take the split-KV kernel under :func:`split_plan`
    (with a workspace from torch.empty and the stream's counters), every
    other arm its own loop.  One launch; raises on anything the kernel does
    not take (no fallback)."""
    s_, h, d = q.shape
    n, bs = k.shape[:2]
    mb = table.shape[1]
    if q.dtype not in _Q_CODES or k.dtype not in _KV_CODES:
        raise TypeError(f"paged attention kernel takes a float32/bfloat16 "
                        f"q and float32/bfloat16/int8 arenas, not "
                        f"{q.dtype}, {k.dtype}")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise TypeError("paged attention kernel: int8 arenas take scale "
                        "planes, float arenas none")
    if n == 0 or mb == 0:
        raise ValueError("paged attention kernel: empty arena or table")
    ops = [t.contiguous() for t in (q, k, v, table, lens)]
    scs = [t.contiguous() if t is not None else None
           for t in (k_scale, v_scale)]
    out = torch.empty((s_, h, d), dtype=q.dtype, device=q.device)
    if s_ == 0 or h == 0 or d == 0:
        return out
    fn, err_str = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan, work, counters = (0, 0, 0, 0), None, None
    if k.dtype == torch.int8 and d <= 256:
        p = split_plan(s_, h, d, bs, mb)
        plan = (p.heads, p.tile, p.splits, p.blocks)
        if p.splits > 1:
            rows = s_ * p.groups
            work = torch.empty(rows * p.splits * p.heads * (d + 2),
                               dtype=torch.float32, device=q.device)
            counters = split_counters(q.device, rows)
    with torch.cuda.device(q.device):
        rc = fn(ops[0].data_ptr(), _Q_CODES[q.dtype], ops[1].data_ptr(),
                ops[2].data_ptr(), _KV_CODES[k.dtype],
                scs[0].data_ptr() if scs[0] is not None else None,
                scs[1].data_ptr() if scs[1] is not None else None,
                ops[3].data_ptr(), ops[4].data_ptr(), out.data_ptr(),
                s_, h, d, bs, mb, n, float(scale), *plan,
                work.data_ptr() if work is not None else None,
                counters.data_ptr() if counters is not None else None,
                stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: "
                           f"{err_str(rc).decode()}")
    return out


def paged_attention(q, k_arena, v_arena, block_table, lengths, scale=None,
                    select=True, interpret=None):
    """Block-table paged attention for decode (K4): ``q [S, H, D]`` over
    ``[N, Bs, H, D]`` float32 or bfloat16 arenas through ``block_table
    [S, MB]`` with ``lengths [S]`` -> ``[S, H, D]`` in q's dtype.
    ``scale`` defaults to 1/sqrt(D).  The kernel on a CUDA ``q``, its
    plain version on a CPU ``q``; ``select``/``interpret`` have no
    effect (see the module docstring)."""
    del select, interpret
    cuda_build.refuse_export("K4 (paged_attention)")
    k, v, table, lens, _ = operands(q, k_arena, v_arena, block_table,
                                    lengths)
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k, v, table, lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    if k.dtype == torch.int8:
        raise TypeError("paged_attention takes float arenas; int8 arenas "
                        "go through quant_kernels.paged_attention_quant")
    out = launch(q, k, v, table, lens, scale)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
