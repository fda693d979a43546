"""Ring attention: exact attention over sequence-sharded Q/K/V (the port of
``paddle_tpu/parallel/ring_attention.py``).

The sequence axis is cut into p shards along a mesh axis.  Each shard's
queries meet every K/V shard in turn as the K/V shards rotate around the
ring, and each step's partial attention is merged into the shard's
accumulator with the online-softmax (log-sum-exp) recurrence, so a
shard never holds more than O(T/p) keys.

The JAX package runs the ring SPMD under ``shard_map`` with ``ppermute``.
The port is single-controller: one process walks the p steps, and at
each step computes every shard on its own mesh device, then moves each
K/V shard to the next device of the ring (``Tensor.to``, a device-local
no-op when the mesh repeats one device).  Autograd runs back through the
same moves, so the backward is the ring in reverse.

The in-shard attention has two tiers:

- K3, ``ops/attention_kernels.flash_attention_with_lse`` (the reference's
  ``_shard_attn_pallas``, :159-185): one call gives a shard's (out, lse),
  which is the online-softmax partial with acc := out, m := lse, l := 1;
  the merge's gradient reaches lse, and K3's backward folds it in as
  ``delta - dlse``;
- the blocked torch path (``_shard_attn``): 1024-row Q and K blocks with
  the merge between them, each block's scores recomputed in the backward
  (``torch.utils.checkpoint``, where the reference has ``jax.checkpoint``).

CUDA shards always take K3: a head dim the kernel does not take raises in
its wrapper, and so does ``FLAGS_ring_flash=false``.  On CPU shards
``FLAGS_ring_flash`` picks the tier: "auto" and "false" take the blocked
path, "true" takes K3's plain version.  A K3 failure raises: there is no
fallback to the blocked path.

Layout: q/k/v are [B, T, H, D] with T cut over the sequence axis (and B
over `batch_axis`, when given); the output has q's shape, dtype and
device.  Causal masking uses global positions: a K/V shard wholly in a
query shard's future is skipped, and only the diagonal step masks.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import attention_kernels

_NEG = torch.finfo(torch.float32).min

# inner block sizes of the blocked path: bound the transient scores to
# [B, _Q_BLOCK, H, _K_BLOCK] whatever the shard length T/p
_Q_BLOCK = 1024
_K_BLOCK = 1024


def _block_attn_fn(q, k, v, q_pos, k_pos, scale, causal):
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    if causal:
        mask = q_pos[None, :, None, None] >= k_pos[None, None, None, :]
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    m = s.amax(dim=-1)                               # [B, Tq, H]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", p, v)
    return out, m, l


def _block_attn(q, k, v, q_pos, k_pos, scale, causal):
    """One Q block against one K/V block: q [B, Tq, H, D], k/v [B, Tk, H,
    D] -> (unnormalized out [B, Tq, H, D], running max m [B, Tq, H],
    denominator l [B, Tq, H]).  Under grad the [B, Tq, H, Tk] scores are
    not kept for the backward, which recomputes them one block at a time
    (the reference's ``jax.checkpoint``): what stays resident across the
    ring is the K/V blocks and the out/m/l partials, O(T), not the
    O(T²/p) score residuals."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return checkpoint(_block_attn_fn, q, k, v, q_pos, k_pos, scale,
                          causal, use_reentrant=False)
    return _block_attn_fn(q, k, v, q_pos, k_pos, scale, causal)


def _merge(acc, m_acc, l_acc, out, m, l):
    """Merge a new partial block into the online-softmax accumulator."""
    m_new = torch.maximum(m_acc, m)
    c_acc = torch.exp(m_acc - m_new)
    c_new = torch.exp(m - m_new)
    acc = acc * c_acc[..., None] + out * c_new[..., None]
    l_new = l_acc * c_acc + l * c_new
    return acc, m_new, l_new


def _init_partial(q):
    """The empty accumulator (acc 0, m at the float32 minimum, l 0)."""
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(q.shape[:3], _NEG, dtype=torch.float32,
                       device=q.device),
            torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device))


def _divisor_block(t, cap):
    # the largest power-of-two divisor of t up to cap, so any even-length
    # shard still gets a bounded transient
    blk = min(cap, t)
    while blk > 1 and t % blk:
        blk //= 2
    return blk


def _shard_attn(q, k, v, q_off, k_off, scale, causal):
    """One local Q shard against one K/V shard, blocked flash-style in
    torch: a loop over Q blocks, and inside it over K blocks with the
    online-softmax merge.  `q_off` and `k_off` are the shards' global
    offsets; positions are offset + arange.  Returns the same (out, m, l)
    contract as :func:`_block_attn`.  Causal: a K block starting past a
    Q block's last row is skipped (it would merge to nothing)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    q_pos = torch.arange(q_off, q_off + tq, device=q.device)
    k_pos = torch.arange(k_off, k_off + tk, device=q.device)
    qb = _divisor_block(tq, _Q_BLOCK)
    kb = _divisor_block(tk, _K_BLOCK)
    if qb < min(64, _Q_BLOCK) or kb < min(64, _K_BLOCK):
        # no usable divisor (an odd or tiny shard): one block
        return _block_attn(q, k, v, q_pos, k_pos, scale, causal)
    parts = []
    for i in range(0, tq, qb):
        q_i, qp_i = q[:, i:i + qb], q_pos[i:i + qb]
        part = _init_partial(q_i)
        for j in range(0, tk, kb):
            if causal and k_off + j > q_off + i + qb - 1:
                break                    # every later K block is later still
            part = _merge(*part, *_block_attn(
                q_i, k[:, j:j + kb], v[:, j:j + kb], qp_i, k_pos[j:j + kb],
                scale, causal))
        parts.append(part)
    return tuple(torch.cat(xs, dim=1) for xs in zip(*parts))


def _shard_attn_flash(q, k, v, scale, diag_causal):
    """One local Q shard against one K/V shard through K3.  (out, lse)
    converts exactly to the partial contract — acc := out (normalized),
    m := lse, l := 1 — since the merge weight exp(lse - m_new)·out equals
    exp(m_blk - m_new)·acc_blk / 1.  q/k/v: [B, T, H, D] float32, made
    contiguous [B, H, T, D] for the kernel.  diag_causal: True only on
    the ring's diagonal step (past shards attend in full; future shards
    are skipped by the caller)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, lse = attention_kernels.flash_attention_with_lse(
        qt, kt, vt, causal=diag_causal, scale=scale)
    m = lse.transpose(1, 2)                          # [B, T, H]
    return out.transpose(1, 2), m, torch.ones_like(m)


def _use_ring_flash(device):
    """Resolve FLAGS_ring_flash for shards on `device`: a CUDA shard takes
    K3 whatever its head dim (the kernel's wrapper raises for one it does
    not take), and raises under "false"; a CPU shard takes K3's plain
    version under "true" and the blocked path otherwise."""
    from ..flags import get_flag

    mode = str(get_flag("ring_flash")).lower()
    if torch.device(device).type == "cuda":
        if mode in ("false", "off", "0"):
            raise ValueError(
                "FLAGS_ring_flash=false keeps ring attention on the blocked "
                "torch path, which runs on CPU shards only; CUDA shards "
                "take K3 (flash_attention_with_lse)")
        return True
    return mode in ("true", "on", "1")


def _ring_attn_local(qs, ks, vs, devices, causal, scale, use_flash):
    """The ring over one batch slice: qs/ks/vs hold shard j on
    devices[j].  Step s computes every shard j against the K/V shard
    (j - s) mod p it holds, then rotates the K/V shards one device on
    (the reference's ``ppermute`` i -> i + 1).  Returns the normalized
    outputs, shard j on devices[j]."""
    p = len(qs)
    tq = qs[0].shape[1]
    qf = [q.float() for q in qs]
    parts = [_init_partial(q) for q in qf]
    k_blk, v_blk = list(ks), list(vs)
    for s in range(p):
        for j in range(p):
            blk = (j - s) % p
            if causal and blk > j:
                continue                 # a shard wholly in j's future
            kf, vf = k_blk[j].float(), v_blk[j].float()
            if use_flash:
                part = _shard_attn_flash(qf[j], kf, vf, scale,
                                         causal and blk == j)
            else:
                part = _shard_attn(qf[j], kf, vf, j * tq, blk * tq, scale,
                                   causal)
            parts[j] = _merge(*parts[j], *part)
        if s < p - 1:
            k_blk = [k_blk[j - 1].to(devices[j]) for j in range(p)]
            v_blk = [v_blk[j - 1].to(devices[j]) for j in range(p)]
    return [(acc / torch.clamp_min(l, 1e-20)[..., None]).to(q.dtype)
            for (acc, _, l), q in zip(parts, qs)]


def ring_attention(q, k, v, mesh, axis_name="seq", causal=False,
                   scale=None, batch_axis=None):
    """Exact attention with q/k/v [B, T, H, D], T cut over mesh axis
    `axis_name` and, with `batch_axis`, B over that axis (dp x sp in one
    call).  Shard (i, j) of the (batch, sequence) grid is computed on the
    mesh entry at those coordinates (the other axes at 0); the output is
    gathered back to q's device."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    p = mesh.shape[axis_name]
    dp = mesh.shape[batch_axis] if batch_axis else 1
    b, t = q.shape[:2]
    if t % p or b % dp:
        raise ValueError(f"ring_attention: [B, T] = [{b}, {t}] does not "
                         f"divide over {batch_axis}={dp} x {axis_name}={p}")
    tq, bb = t // p, b // dp
    rows = []
    for i in range(dp):
        at = {batch_axis: i} if batch_axis else {}
        devices = [mesh.device(**at, **{axis_name: j}) for j in range(p)]

        def shards(x):
            return [x[i * bb:(i + 1) * bb, j * tq:(j + 1) * tq]
                    .to(devices[j]) for j in range(p)]

        use_flash = _use_ring_flash(devices[0])
        outs = _ring_attn_local(shards(q), shards(k), shards(v), devices,
                                causal, scale, use_flash)
        rows.append(torch.cat([o.to(q.device) for o in outs], dim=1))
    return torch.cat(rows, dim=0)


def full_attention(q, k, v, causal=False, scale=None):
    """Reference (unsharded) attention over [B, T, H, D]."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    if causal:
        tq, tk = s.shape[1], s.shape[3]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask[None, :, None, :], s,
                        torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v)
