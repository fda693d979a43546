"""Recurrent kernels over padded sequences (port of
``paddle_tpu/ops/rnn_ops.py``): ``lstm``, ``lstmp``, ``gru``, ``gru_unit``,
``lstm_unit`` and ``dynamic_rnn``.

Reference semantics: ``lstm_op.cc`` (Input = x·W_x pre-projected [T, 4D],
Weight [D, 4D] = {W_c, W_i, W_f, W_o}, Bias [1, 4D] = {b_c, b_i, b_f, b_o}
+ optional peepholes {W_ic, W_fc, W_oc}), ``lstmp_op.cc`` (adds ProjWeight
[D, P], recurrence over the projection), ``gru_op.cc`` (Input [T, 3D] =
{u, r, c}, Weight [D, 3D], default h = (1-u)h_prev + u c̃, origin_mode
flips it), ``gru_unit_op.cc``, ``lstm_unit_op.cc``.

The minibatch is padded dense [B, T, ...] with an int32 ``SeqLen`` [B].
Where the reference scans with ``lax.scan``, the recurrence here is a
Python loop over T with the same per-step validity mask: past a row's
length its memories freeze and its outputs are 0; ``is_reverse`` walks T
backwards, so a short row's reverse scan holds h0 and c0 over its pad
positions until its real last token.  Without a projection, each LSTM
time step is one call of ``rnn_kernels.lstm_step`` (K8: the step's
product, cell, peepholes and mask in one launch on a CUDA tensor, under
any of the op's activation sets; the reference composes the cell when it
has peepholes or other activations), and under the default activations
each GRU time
step is ``rnn_kernels.gru_gate_pre`` (one ``torch.addmm``) and
``rnn_kernels.gru_step`` (K9: the candidate's product, the output gate and
the mask); on CPU tensors these run their plain versions, the reference's
composition.  The other configurations compose the step from torch ops,
exactly as the reference does.  None of these ops has a custom grad: the
generic grad recomputes the loop under torch autograd, through the
kernels' ``autograd.Function`` s.
"""

import torch

from . import rnn_kernels
from .registry import register, first

_ACT = rnn_kernels.ACTIVATIONS


def _steps(t, is_reverse):
    return range(t - 1, -1, -1) if is_reverse else range(t)


def _lstm_scan(x, lens, w, bias, h0, c0, gate_act, cell_act, cand_act,
               use_peepholes, is_reverse, proj=None, proj_act=None):
    """x: [B, T, 4D]; returns hidden [B, T, D or P], cell [B, T, D]."""
    b, t, four_d = x.shape
    d = four_d // 4
    p = proj.shape[1] if proj is not None else d
    if bias is not None:
        x = x + bias[..., :4 * d].reshape(1, 1, 4 * d)
        if use_peepholes:
            w_ic = bias[..., 4 * d:5 * d].reshape(1, d)
            w_fc = bias[..., 5 * d:6 * d].reshape(1, d)
            w_oc = bias[..., 6 * d:7 * d].reshape(1, d)
    h_prev = torch.zeros((b, p), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    c_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device) \
        if c0 is None else c0
    # K8 takes every activation set of the op, with or without peepholes;
    # only a projection (lstmp) takes the composed cell.  The reference's
    # _pallas_cell_ok (:33) also sends peepholes and every set but the
    # default to the composed cell
    fused = proj is None and (bias is not None or not use_peepholes)

    hs, cs = [None] * t, [None] * t
    if fused:
        x = x.contiguous()
        peep = bias.reshape(-1)[4 * d:7 * d].contiguous() \
            if use_peepholes else None
        acts = (gate_act, cell_act, cand_act)
        for step in _steps(t, is_reverse):
            h_prev, c_prev, hs[step], cs[step] = rnn_kernels.lstm_step(
                x[:, step], h_prev, c_prev, w, lens, step, peep, acts)
        return torch.stack(hs, dim=1), torch.stack(cs, dim=1)
    for step in _steps(t, is_reverse):
        gates = x[:, step] + h_prev @ w                 # [B, 4D]
        gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
        if use_peepholes:
            gi = gi + c_prev * w_ic
            gf = gf + c_prev * w_fc
        i = _ACT[gate_act](gi)
        f = _ACT[gate_act](gf)
        cand = _ACT[cand_act](gc)
        c = f * c_prev + i * cand
        if use_peepholes:
            go = go + c * w_oc
        o = _ACT[gate_act](go)
        h = o * _ACT[cell_act](c)
        if proj is not None:
            h = h @ proj
            if proj_act and proj_act != "identity":
                h = _ACT[proj_act](h)
        valid = rnn_kernels.valid_mask(lens, step, x.dtype)
        h = h * valid + h_prev * (1 - valid)
        c = c * valid + c_prev * (1 - valid)
        # emit zeros at pad positions (lod outputs are masked-dense)
        hs[step], cs[step] = h * valid, c * valid
        h_prev, c_prev = h, c
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


@register("lstm")
def lstm(ins, attrs):
    x = first(ins, "Input")
    lens = first(ins, "SeqLen")
    hs, cs = _lstm_scan(
        x, lens, first(ins, "Weight"), first(ins, "Bias"), first(ins, "H0"),
        first(ins, "C0"),
        attrs.get("gate_activation", "sigmoid"),
        attrs.get("cell_activation", "tanh"),
        attrs.get("candidate_activation", "tanh"),
        attrs.get("use_peepholes", True),
        attrs.get("is_reverse", False))
    return {"Hidden": [hs], "Cell": [cs], "OutLen": [lens]}


@register("lstmp")
def lstmp(ins, attrs):
    lens = first(ins, "SeqLen")
    hs, cs = _lstm_scan(
        first(ins, "Input"), lens,
        first(ins, "Weight"),                # [P, 4D]
        first(ins, "Bias"), first(ins, "H0"), first(ins, "C0"),
        attrs.get("gate_activation", "sigmoid"),
        attrs.get("cell_activation", "tanh"),
        attrs.get("candidate_activation", "tanh"),
        attrs.get("use_peepholes", True),
        attrs.get("is_reverse", False),
        proj=first(ins, "ProjWeight"),       # [D, P]
        proj_act=attrs.get("proj_activation", "tanh"))
    return {"Projection": [hs], "Cell": [cs], "OutLen": [lens]}


@register("gru")
def gru(ins, attrs):
    x = first(ins, "Input")                  # [B, T, 3D] = {u, r, c}
    lens = first(ins, "SeqLen")
    w = first(ins, "Weight")        # [D, 3D]: [:, :2D] = {u, r}, [:, 2D:] = c
    bias = first(ins, "Bias")
    h0 = first(ins, "H0")
    gate_act = attrs.get("gate_activation", "sigmoid")
    cand_act = attrs.get("activation", "tanh")
    origin_mode = attrs.get("origin_mode", False)
    b, t, three_d = x.shape
    d = three_d // 3
    if bias is not None:
        x = x + bias.reshape(1, 1, 3 * d)
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    h_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    fused = gate_act == "sigmoid" and cand_act == "tanh"

    hs = [None] * t
    if fused:
        x = x.contiguous()
        for step in _steps(t, attrs.get("is_reverse", False)):
            xg = x[:, step]
            ur_pre = rnn_kernels.gru_gate_pre(xg[:, :2 * d], h_prev, w_ur)
            h_prev, hs[step] = rnn_kernels.gru_step(
                ur_pre, xg[:, 2 * d:], h_prev, w_c, lens, step, origin_mode)
        return {"Hidden": [torch.stack(hs, dim=1)], "OutLen": [lens]}
    for step in _steps(t, attrs.get("is_reverse", False)):
        xg = x[:, step]
        ur_pre = xg[:, :2 * d] + h_prev @ w_ur
        u, r = torch.chunk(_ACT[gate_act](ur_pre), 2, dim=-1)
        cand = _ACT[cand_act](xg[:, 2 * d:] + (r * h_prev) @ w_c)
        h = u * h_prev + (1 - u) * cand if origin_mode \
            else (1 - u) * h_prev + u * cand
        valid = rnn_kernels.valid_mask(lens, step, x.dtype)
        h = h * valid + h_prev * (1 - valid)
        hs[step] = h * valid
        h_prev = h
    return {"Hidden": [torch.stack(hs, dim=1)], "OutLen": [lens]}


_GRU_UNIT_ACTS = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _gru_unit_act(value, default):
    """gru_unit's activation attrs come as names or as the reference's
    integer codes."""
    if isinstance(value, int):
        return _ACT[_GRU_UNIT_ACTS.get(value, default)]
    return _ACT[value]


@register("gru_unit")
def gru_unit(ins, attrs):
    """Single GRU step (gru_unit_op.cc): Input [B, 3D], HiddenPrev [B, D]."""
    x = first(ins, "Input")
    h_prev = first(ins, "HiddenPrev")
    w = first(ins, "Weight")
    bias = first(ins, "Bias")
    gate_act = _gru_unit_act(attrs.get("gate_activation", 1), "sigmoid")
    cand_act = _gru_unit_act(attrs.get("activation", 2), "tanh")
    origin_mode = attrs.get("origin_mode", False)
    d = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(1, 3 * d)
    u, r = torch.chunk(gate_act(x[:, :2 * d] + h_prev @ w[:, :2 * d]), 2,
                       dim=-1)
    cand = cand_act(x[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:])
    if origin_mode:
        h = u * h_prev + (1 - u) * cand
    else:
        h = (1 - u) * h_prev + u * cand
    return {"Gate": [torch.cat([u, r, cand], dim=-1)],
            "ResetHiddenPrev": [r * h_prev], "Hidden": [h]}


@register("lstm_unit")
def lstm_unit(ins, attrs):
    """Single LSTM step (lstm_unit_op.cc): X [B, 4D] pre-projected, C_prev.
    Gate order in lstm_unit is {i, f, o, c} (see lstm_unit_op kernel)."""
    x = first(ins, "X")
    c_prev = first(ins, "C_prev")
    forget_bias = attrs.get("forget_bias", 0.0)
    i, f, o, cand = torch.chunk(x, 4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev + \
        torch.sigmoid(i) * torch.tanh(cand)
    h = torch.sigmoid(o) * torch.tanh(c)
    return {"C": [c], "H": [h]}


# ---------------------------------------------------------------------------
# dynamic_rnn: a user-authored step block run once per time step.
#
# Reference: DynamicRNN (layers/control_flow.py:1394) lowers to
# lod_rank_table + lod_tensor_to_array + a `while` running the step block on
# shrinking, length-sorted batches (math/sequence2batch.h).  Here, as in the
# JAX package, it is ONE op over the padded time dim: a validity mask
# (t < len) freezes finished sequences' memories and zeroes their outputs,
# so no reorder or rank table is needed.  Every value the step block reads
# from the enclosing scope is an explicit "Static" input, which makes the
# op self-contained: the generic grad re-runs the loop under torch autograd
# (the grad of while_op.cc:162) and the Static parameters get their grads.
# ---------------------------------------------------------------------------

@register("dynamic_rnn")
def dynamic_rnn(ins, attrs):
    from ..core import executor as executor_mod

    sub = attrs["sub_block"]
    step_names = attrs["step_names"]
    mem_names = attrs["mem_names"]
    next_names = attrs["next_names"]
    out_names = attrs["out_names"]
    static_names = attrs["static_names"]

    xs = list(ins.get("X", []))
    lens = first(ins, "SeqLen")
    env_static = dict(zip(static_names, ins.get("Static", [])))
    carry = dict(zip(mem_names, ins.get("Init", [])))

    def read(name):
        raise KeyError(
            f"dynamic_rnn: the step block reads {name!r}, which is neither "
            f"a step input {step_names}, a memory {mem_names} nor a Static "
            f"input {static_names}")

    stacked = [[] for _ in out_names]
    for t in range(xs[0].shape[1]):
        local = dict(env_static)
        local.update(carry)
        local.update((n, x[:, t]) for n, x in zip(step_names, xs))
        executor_mod._run_block(sub, local, read)
        active = t < lens                                   # [B]

        def sel(new, old):
            return torch.where(
                active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        carry = {m: sel(local[nx], carry[m])
                 for m, nx in zip(mem_names, next_names)}
        for outs, n in zip(stacked, out_names):
            outs.append(sel(local[n], torch.zeros_like(local[n])))
    return {"Out": [torch.stack(s, dim=1) for s in stacked],
            "OutLen": [lens]}
