"""The tail of the reference's operators the front end's layers emit
(port of part of ``paddle_tpu/ops/tail_ops.py``): ``im2sequence``,
``tensor_array_to_tensor``, ``sample_logits``, ``chunk_eval``,
``tree_conv``, ``hash`` and ``similarity_focus``.

Reference semantics: ``paddle/fluid/operators/`` — ``im2sequence_op.h``,
``tensor_array_to_tensor_op.cc``, ``sample_logits_op.h``
(``math/sampler.cc``'s log-uniform sampler), ``chunk_eval_op.h``,
``tree_conv_op.h`` with ``math/tree2col.cc``, ``hash_op.h`` (XXH64),
``similarity_focus_op.h``.

Four of them are sequential algorithms over data values that the
reference's kernels run on the CPU, and the JAX package on the host
through ``jax.pure_callback``: ``chunk_eval``'s span extraction,
``tree_conv``'s patch coefficients (from the tree's edges; the feature
contraction stays on the device), ``hash`` and ``similarity_focus``'s
greedy tagging.  Here too they read their inputs on the host, and are
registered ``host_read``, so the Executor runs a program that holds one
op by op instead of capturing it (``executor.capture_refusals``).
``sample_logits`` draws its negative classes from the op's Philox stream
(``registry.uniforms``), on the device.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register, first, op_seed, uniforms


@register("im2sequence")
def im2sequence(ins, attrs):
    """[B, C, H, W] -> the sequence of its flattened kh × kw patches
    [B, OH·OW, C·kh·kw] (channel-major within a patch), with OutLen
    OH·OW a row.  ``paddings`` are (up, left, down, right)."""
    x = first(ins, "X")
    kh, kw = attrs["kernels"]
    strides = attrs.get("strides", [1, 1])
    up, left, down, right = attrs.get("paddings", [0, 0, 0, 0])
    b = x.shape[0]
    cols = F.unfold(F.pad(x, (left, right, up, down)), (kh, kw),
                    stride=tuple(strides))             # [B, C·kh·kw, L]
    out = cols.transpose(1, 2)
    lens = torch.full((b,), out.shape[1], dtype=torch.int32,
                      device=x.device)
    return {"Out": [out], "OutLen": [lens]}


@register("tensor_array_to_tensor")
def tensor_array_to_tensor(ins, attrs):
    """Concatenate (or stack) a tensor array's entries along ``axis``.
    An array is a (buffer [C, ...], count) pair (``array_ops``): the
    whole buffer is emitted with the entries at and past `count` zeroed,
    and OutIndex holds each entry's size along ``axis`` (0 past
    `count`), as the JAX package's static-shape contract has it.  A
    plain tensor counts as a full array."""
    ta = first(ins, "X")
    buf, count = ta if isinstance(ta, (tuple, list)) else (ta, None)
    axis = attrs.get("axis", 0)
    use_stack = attrs.get("use_stack", False)
    t = buf.shape[0]
    pos = torch.arange(t, device=buf.device)
    size = 1 if use_stack else buf.shape[1 + axis]
    sizes = torch.full((t,), size, dtype=torch.int32, device=buf.device)
    if count is not None:
        live = pos < count
        buf = torch.where(live.reshape((t,) + (1,) * (buf.ndim - 1)), buf,
                          torch.zeros_like(buf))
        sizes = torch.where(live, sizes, torch.zeros_like(sizes))
    if use_stack:
        out = torch.movedim(buf, 0, axis) if axis else buf
    else:
        out = torch.cat(list(buf.unbind(0)), dim=axis)
    return {"Out": [out], "OutIndex": [sizes]}


# Philox stream tag of sample_logits' negative classes (registry.uniforms)
_TAG_SAMPLE_LOGITS = 4


@register("sample_logits")
def sample_logits(ins, attrs):
    """Sampled-softmax helper: per row, the true labels then
    ``num_samples`` classes from the log-uniform (Zipfian) sampler over
    [0, C) — P(k) = log((k + 2) / (k + 1)) / log(C + 1), drawn as
    floor(exp(u · log(C + 1))) - 1 — or the customized samples.  The
    sampled logits are gathered, a sample equal to one of the row's
    other true labels loses 1e20 (``remove_accidental_hits``), and log Q
    is subtracted."""
    logits = first(ins, "Logits")                      # [B, C]
    labels = first(ins, "Labels").long()               # [B, NT]
    num_samples = attrs["num_samples"]
    b, c = logits.shape
    nt = labels.shape[1]
    if ins.get("CustomizedSamples") and \
            ins["CustomizedSamples"][0] is not None:
        samples = first(ins, "CustomizedSamples").long()
        probs = first(ins, "CustomizedProbabilities")
    else:
        # in float64: the floor of a float32 exp near an integer would
        # part the card from the CPU by one ulp
        u = uniforms(op_seed(attrs), (b, num_samples), logits.device,
                     _TAG_SAMPLE_LOGITS).double()
        neg = (torch.exp(u * math.log(c + 1)).long() - 1).clamp(0, c - 1)
        samples = torch.cat([labels, neg], dim=1)       # [B, NT + S]
        s = samples.to(torch.float32)
        probs = (torch.log((s + 2.0) / (s + 1.0))
                 / np.log(np.float32(c + 1))).to(logits.dtype)
    sampled = torch.gather(logits, 1, samples)
    if attrs.get("remove_accidental_hits", True):
        hit = torch.zeros_like(samples, dtype=torch.bool)
        for j in range(nt):
            h = samples == labels[:, j:j + 1]
            h[:, j] = False
            hit = hit | h
        sampled = torch.where(hit, sampled - 1e20, sampled)
    sampled = sampled - torch.log(torch.clamp_min(probs, 1e-30)).to(
        sampled.dtype)
    sampled_labels = torch.arange(nt, dtype=torch.int32,
                                  device=logits.device).expand(b, nt)
    return {"Samples": [samples.to(torch.int32)], "Probabilities": [probs],
            "SampledLogits": [sampled], "SampledLabels": [sampled_labels]}


# ---------------------------------------------------------------------------
# chunk_eval: chunk-level precision / recall over tag sequences
# ---------------------------------------------------------------------------

_TAGS_PER_TYPE = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _extract_chunks(tags, scheme, num_types):
    """Tag ids -> set of (type, start, end) chunks (chunk_eval_op.h)."""
    chunks = []
    n_tag = _TAGS_PER_TYPE[scheme]
    start = cur_type = -1
    for i, t in enumerate(list(tags) + [-1]):
        if t < 0 or t >= n_tag * num_types:
            tag_kind, typ = -1, -1
        else:
            tag_kind, typ = int(t) % n_tag, int(t) // n_tag
        if scheme == "plain":
            is_start = typ != cur_type
            is_end = cur_type != -1 and typ != cur_type
        elif scheme == "IOB":
            is_start = tag_kind == 0 or typ != cur_type
            is_end = cur_type != -1 and (tag_kind == 0 or typ != cur_type)
        elif scheme == "IOE":
            is_start = typ != cur_type
            is_end = cur_type != -1 and (typ != cur_type or (
                i > 0 and int(tags[i - 1]) % n_tag == 1))
        else:                                           # IOBES
            is_start = tag_kind in (0, 3) or typ != cur_type
            is_end = cur_type != -1 and (tag_kind in (0, 3) or
                                         typ != cur_type)
        if is_end and cur_type != -1:
            chunks.append((cur_type, start, i - 1))
            cur_type = -1
        if is_start and typ != -1:
            start, cur_type = i, typ
    return set(chunks)


@register("chunk_eval", not_differentiable=True, host_read=True)
def chunk_eval(ins, attrs):
    """Precision, recall and F1 of the inferred chunks against the
    labelled ones over every sequence of the batch (a dense input counts
    each row as one full sequence), with the three counts."""
    inference = first(ins, "Inference")
    label = first(ins, "Label")
    lens = first(ins, "SeqLen")
    scheme = attrs.get("chunk_scheme", "IOB")
    num_types = attrs.get("num_chunk_types", 1)
    excluded = set(attrs.get("excluded_chunk_types", []) or [])
    b = inference.shape[0]
    inf = inference.detach().cpu().numpy().reshape(b, -1)
    lab = label.detach().cpu().numpy().reshape(b, -1)
    ls = np.full(b, inf.shape[1]) if lens is None else \
        lens.detach().cpu().numpy().reshape(-1)
    n_inf = n_lab = n_corr = 0
    for i, n in enumerate(ls):
        a = {c for c in _extract_chunks(inf[i, :n], scheme, num_types)
             if c[0] not in excluded}
        g = {c for c in _extract_chunks(lab[i, :n], scheme, num_types)
             if c[0] not in excluded}
        n_inf += len(a)
        n_lab += len(g)
        n_corr += len(a & g)
    p = n_corr / n_inf if n_inf else 0.0
    r = n_corr / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    dev = inference.device

    def one(v, dtype):
        return [torch.tensor([v], dtype=dtype).to(dev)]

    return {"Precision": one(p, torch.float32),
            "Recall": one(r, torch.float32),
            "F1-Score": one(f1, torch.float32),
            "NumInferChunks": one(n_inf, torch.int64),
            "NumLabelChunks": one(n_lab, torch.int64),
            "NumCorrectChunks": one(n_corr, torch.int64)}


# ---------------------------------------------------------------------------
# tree_conv: continuous-binary-tree convolution (TBCNN)
# ---------------------------------------------------------------------------

def _tree_patch_coeffs(edges, n_nodes, max_depth):
    """EdgeSet [(u, v), ...] (1-based, ended by a 0) -> coeff [N, N, 3]:
    coeff[p, u, k] accumulates eta_k of node u in the patch rooted at
    node p + 1 (tree2col.cc's construct_patch and TreeNode::eta_*)."""
    tr = [[] for _ in range(n_nodes + 2)]
    count = 0
    for u, v in edges:
        if u != 0 and v != 0:
            tr[int(u)].append(int(v))
            count += 1
        else:
            break
    coeff = np.zeros((n_nodes, n_nodes, 3), np.float32)
    for root in range(1, count + 2):
        # iterative DFS: each visit pushes ALL unvisited children, a
        # parent precedes its children in the patch
        stack = [(root, 1, 1, 0)]
        patch = [(root, 1, 1, 0)]
        visited = {root}
        while stack:
            node, _, _, depth = stack[-1]
            end = True
            kids = tr[node] if node < len(tr) else []
            for i, v in enumerate(kids):
                if v not in visited and depth + 1 < max_depth:
                    visited.add(v)
                    stack.append((v, i, len(kids), depth + 1))
                    patch.append((v, i + 1, len(kids), depth + 1))
                    end = False
            if end:
                stack.pop()
        for u, idx, pclen, depth in patch:
            eta_t = (max_depth - depth) / max_depth
            tmp = 0.5 if pclen == 1 else (idx - 1.0) / (pclen - 1.0)
            eta_l = (1.0 - eta_t) * tmp
            eta_r = (1.0 - eta_t) * (1.0 - eta_l)
            coeff[root - 1, u - 1, 0] += eta_l
            coeff[root - 1, u - 1, 1] += eta_r
            coeff[root - 1, u - 1, 2] += eta_t
    return coeff


@register("tree_conv", host_read=True)
def tree_conv(ins, attrs):
    """NodesVector [B, N, F], EdgeSet [B, E, 2], Filter [F, 3, O, M] ->
    Out [B, N, O, M].  The patch coefficients come from the edges on the
    host; patches[p, f, k] = sum_u coeff[p, u, k] · nodes[u, f] and the
    filter contraction run on the device, in float32."""
    nodes = first(ins, "NodesVector")
    edges = first(ins, "EdgeSet").detach().cpu().numpy()
    filt = first(ins, "Filter")
    max_depth = attrs.get("max_depth", 2)
    b, n, _ = nodes.shape
    coeff = torch.from_numpy(np.stack([
        _tree_patch_coeffs(edges[i].reshape(-1, 2), n, max_depth)
        for i in range(b)])).to(nodes.device)             # [B, N, N, 3]
    patches = torch.einsum("bpuk,buf->bpfk", coeff, nodes.float())
    out = torch.einsum("bpfk,fkom->bpom", patches, filt.float())
    return {"Out": [out.to(nodes.dtype)]}


# ---------------------------------------------------------------------------
# hash: XXH64 of each row's first 4·L bytes, num_hash seeds, mod mod_by
# ---------------------------------------------------------------------------

_P1 = np.uint64(11400714785074694791)
_P2 = np.uint64(14029467366897019727)
_P3 = np.uint64(1609587929392839161)
_P4 = np.uint64(9650029242287828579)
_P5 = np.uint64(2870177450012600261)


def _rotl(x, r):
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _le_words(chunk):
    """Little-endian words of each row of `chunk` ([N, k] uint8)."""
    k = chunk.shape[1]
    return chunk.astype(np.uint64) @ (
        np.uint64(1) << (np.arange(k, dtype=np.uint64) * np.uint64(8)))


def _xxh64(data, seed):
    """XXH64 of each row of `data` ([N, L] uint8), one seed for all."""
    with np.errstate(over="ignore"):
        n, length = data.shape
        seed = np.uint64(seed)
        off = 0
        if length >= 32:
            v = [seed + _P1 + _P2, seed + _P2, seed + np.uint64(0),
                 seed - _P1]
            v = [np.full(n, x, np.uint64) for x in v]
            while off + 32 <= length:
                for lane in range(4):
                    u = _le_words(data[:, off + lane * 8:
                                       off + lane * 8 + 8])
                    v[lane] = _rotl(v[lane] + u * _P2, 31) * _P1
                off += 32
            h = _rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + \
                _rotl(v[3], 18)
            for lane in range(4):
                h = (h ^ (_rotl(v[lane] * _P2, 31) * _P1)) * _P1 + _P4
        else:
            h = np.full(n, seed + _P5, np.uint64)
        h = h + np.uint64(length)
        while off + 8 <= length:
            u = _le_words(data[:, off:off + 8])
            h = _rotl(h ^ (_rotl(u * _P2, 31) * _P1), 27) * _P1 + _P4
            off += 8
        if off + 4 <= length:
            u = _le_words(data[:, off:off + 4])
            h = _rotl(h ^ (u * _P1), 23) * _P2 + _P3
            off += 4
        while off < length:
            h = _rotl(h ^ (data[:, off].astype(np.uint64) * _P5), 11) * _P1
            off += 1
        h ^= h >> np.uint64(33)
        h *= _P2
        h ^= h >> np.uint64(29)
        h *= _P3
        h ^= h >> np.uint64(32)
        return h


@register("hash", not_differentiable=True, host_read=True)
def hash_op(ins, attrs):
    """X [N, L] ints -> Out [N, num_hash, 1]: for seed s, XXH64 over the
    FIRST 4·L bytes of the row's int64 buffer (hash_op.h hashes
    sizeof(int) · last_dim bytes of it: the raw first half of the row,
    low and high words of its first L/2 elements), modulo ``mod_by``."""
    x = first(ins, "X")
    mod_by = attrs["mod_by"]
    n, l = x.shape[0], x.shape[-1]
    rows = np.ascontiguousarray(
        x.detach().cpu().numpy().reshape(n, l).astype(np.int64)) \
        .view(np.uint8).reshape(n, l * 8)[:, :l * 4]
    rows = np.ascontiguousarray(rows)
    out = np.stack([(_xxh64(rows, s) % np.uint64(mod_by)).astype(np.int64)
                    for s in range(attrs.get("num_hash", 1))], axis=1)
    return {"Out": [torch.from_numpy(out.reshape(n, -1, 1)).to(x.device)]}


@register("similarity_focus", not_differentiable=True, host_read=True)
def similarity_focus(ins, attrs):
    """X [B, D1, D2, D3] -> a 0/1 mask of X's shape: for each index of
    ``indexes`` along ``axis``, walk that plane's cells by descending
    value and take a cell whose row and column are both untaken (a
    greedy bipartite matching), marking it across the ``axis`` dim."""
    x = first(ins, "X")
    axis = attrs["axis"]
    a = x.detach().cpu().numpy()
    out = np.zeros_like(a)
    for i in range(a.shape[0]):
        for index in attrs["indexes"]:
            plane = (a[i, index] if axis == 1 else a[i, :, index]
                     if axis == 2 else a[i, :, :, index])
            d_a, d_b = plane.shape
            tag_a = np.zeros(d_a, bool)
            tag_b = np.zeros(d_b, bool)
            order = np.argsort(plane, axis=None, kind="stable")[::-1]
            got, need = 0, min(d_a, d_b)
            for flat in order:
                ia, ib = divmod(int(flat), d_b)
                if tag_a[ia] or tag_b[ib]:
                    continue
                tag_a[ia] = tag_b[ib] = True
                got += 1
                if axis == 1:
                    out[i, :, ia, ib] = 1
                elif axis == 2:
                    out[i, ia, :, ib] = 1
                else:
                    out[i, ia, ib, :] = 1
                if got >= need:
                    break
    return {"Out": [torch.from_numpy(out).to(x.device)]}
