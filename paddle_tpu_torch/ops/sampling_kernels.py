"""Fixed-shape sampling: temperature / top-k / top-p / seeded draw — the
port of ``paddle_tpu/ops/sampling_kernels.py`` as torch ops (the
reference is jnp, not Pallas, so there is no hand kernel here).

The decode tier samples over a ``[slots, vocab]`` logits plane where every
per-request knob is a PER-ROW OPERAND — temperature, top-k, top-p, seed and
a per-request draw counter are ``[slots]`` vectors, and the logit-bias /
constraint mask plane a ``[slots, vocab]`` row operand.  Nothing about the
sampling configuration is baked into the shapes, so one step shape serves
every setting and every mix of settings.

Greedy is not a separate code path: it is the ``temperature == 0``
degenerate row.  :func:`warp_probs` collapses such rows to a one-hot at the
argmax of the *biased* logits, so greedy requests batch-mix freely with
sampled ones (and constrained-greedy works: the bias is applied before the
argmax).

Seeding contract (the whole stack leans on this): the uniform of stream
``(seed, counter, tag)`` is word 0 of Philox4x32-10
(``registry.philox4x32``) at counter ``(counter, tag, 0, 0)`` under key
``seed_key(seed)``, its top 24 bits scaled to [0, 1).  ``seed`` is the
per-request seed, ``counter`` the absolute index of the token being
generated (0 for the first generated token, advancing by one per
COMMITTED token — preemption-and-recompute replays the same counters, so
a preempted sampled sequence regenerates identical tokens), and ``tag``
separates the independent streams one position needs:

    TAG_DRAW      the committed draw at this position (plain decode, and
                  the speculative bonus token)
    TAG_DRAFT     the draft model's proposal at this position
    TAG_ACCEPT    the accept/reject uniform of the adjusted-acceptance rule
    TAG_RESIDUAL  the residual resample after a rejection

The reference folds (counter, tag) into a ``jax.random`` key; the bits
differ from it by design (as dropout's do), and are the same on the CPU
and on the card.  The host entry :func:`sample_step` runs on the CPU (its
operands are the engine's host planes); the ``sampling_decode`` op runs
on the device of its inputs.
"""

import numpy as np
import torch

from .registry import first, philox4x32, register

# Stream tags (see module docstring).
TAG_DRAW = 0
TAG_DRAFT = 1
TAG_ACCEPT = 2
TAG_RESIDUAL = 3

# -inf is the canonical "token forbidden" value and flows through
# warp_probs exactly (softmax assigns it probability 0.0, not epsilon).
MASKED = -np.inf

_MASK32 = 0xFFFFFFFF


def _rows(x, dtype, s, device):
    return torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x, device=device).to(dtype).reshape(s)


def warp_probs(logits, temperature, top_k, top_p, bias=None):
    """Warp a ``[S, V]`` logits plane into per-row sampling distributions.

    Pipeline (all fixed-shape, per-row vectorized):
      1. bias add — logit_bias and the constraint mask plane (-inf masks)
      2. temperature divide (rows with temperature <= 0 are greedy)
      3. top-k: rank every token by descending warped logit (a stable
         argsort of argsort), mask ranks >= k to -inf; k <= 0 disables
      4. softmax
      5. top-p nucleus: sort probs descending, keep tokens whose EXCLUSIVE
         prefix sum is < p (the top token always survives), renormalize
      6. greedy rows collapse to one-hot(argmax(biased logits))

    Returns ``[S, V]`` float32 probabilities summing to 1 per row.  Rows
    where the bias masks every token produce NaN — callers (the constraint
    plane) must never submit an empty allowed set.
    """
    logits = torch.as_tensor(logits).float()
    s, v = logits.shape
    dev = logits.device
    temperature = _rows(temperature, torch.float32, s, dev)
    top_k = _rows(top_k, torch.int64, s, dev)
    top_p = _rows(top_p, torch.float32, s, dev)
    if bias is not None:
        logits = logits + torch.as_tensor(bias, device=dev).float()
    greedy = temperature <= 0.0
    z = logits / torch.where(greedy, torch.ones_like(temperature),
                             temperature)[:, None]
    # Descending order is computed once; the top-k mask only ever removes
    # a suffix of it, so the same permutation serves the nucleus scan.
    order = torch.argsort(-z, dim=-1, stable=True)      # token ids, desc
    ranks = torch.argsort(order, dim=-1, stable=True)   # rank of each id
    k = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k)
    z = z.masked_fill(ranks >= k[:, None], float("-inf"))
    p = torch.softmax(z, dim=-1)
    sp = torch.gather(p, -1, order)                     # probs, descending
    excl = torch.cumsum(sp, dim=-1) - sp                # exclusive prefix
    keep = torch.gather(excl < top_p[:, None], -1, ranks)
    p = torch.where(keep, p, torch.zeros_like(p))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    one_hot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), v).to(p.dtype)
    return torch.where(greedy[:, None], one_hot, p)


def row_uniforms(seeds, counters, tag, device=None):
    """One uniform in [0, 1) per row from stream (seed_i, counter_i, tag):
    the top 24 bits of word 0 of Philox4x32-10 at counter (counter_i, tag,
    0, 0) under key seed_i, exact in float32."""
    seeds = torch.as_tensor(np.asarray(seeds, np.int64) if not isinstance(
        seeds, torch.Tensor) else seeds, device=device).long().reshape(-1)
    counters = torch.as_tensor(np.asarray(counters, np.int64)
                               if not isinstance(counters, torch.Tensor)
                               else counters, device=seeds.device)
    counters = counters.long().reshape(-1) & _MASK32
    seeds = seeds & _MASK32                 # the reference folds to uint32
    zero = torch.zeros_like(counters)
    ctr = torch.stack([counters, zero + int(tag), zero, zero])
    word = philox4x32(ctr, (seeds, zero))[0]
    return (word >> 8).float() * (1.0 / (1 << 24))


def categorical_from_probs(probs, uniforms):
    """Inverse-CDF draw: first index whose cumulative prob exceeds u.

    u is scaled by the row total so float drift in the cumsum can never
    push every comparison false (which would silently bias token 0).
    For one-hot (greedy) rows this is exactly the argmax.
    """
    cum = torch.cumsum(probs, dim=-1)
    u = torch.as_tensor(uniforms, device=probs.device).to(
        probs.dtype).clamp_max(1.0 - 1e-7)
    return torch.argmax((cum > u[:, None] * cum[:, -1:]).to(torch.uint8),
                        dim=-1)


def draw_tokens(logits, temperature, top_k, top_p, seeds, counters,
                bias=None, tag=TAG_DRAW):
    """warp + seeded draw; returns (tokens [S] int64, probs [S, V])."""
    p = warp_probs(logits, temperature, top_k, top_p, bias)
    u = row_uniforms(seeds, counters, tag, device=p.device)
    return categorical_from_probs(p, u), p


def sample_step(logits, temperature, top_k, top_p, seeds, counters,
                bias=None, tag=TAG_DRAW):
    """Host entry for one decode-step draw over the slot plane, on the
    CPU: numpy in / numpy out.  Returns (tokens ``[S]`` int64, probs
    ``[S, V]`` float32)."""
    logits = torch.from_numpy(np.ascontiguousarray(logits, np.float32))
    s = logits.shape[0]
    if bias is not None:
        bias = torch.from_numpy(np.ascontiguousarray(bias, np.float32))
    toks, p = draw_tokens(
        logits, np.asarray(temperature, np.float32).reshape(s),
        np.asarray(top_k, np.int64).reshape(s),
        np.asarray(top_p, np.float32).reshape(s),
        np.asarray(seeds, np.int64).reshape(s),
        np.asarray(counters, np.int64).reshape(s), bias=bias, tag=tag)
    return toks.numpy().astype(np.int64), p.numpy()


# ---- host-side helpers for the speculative accept path --------------------
# These run eagerly on the CPU (tiny arrays, a handful per round); they
# use the SAME stream derivation as the plane draw, so the speculative
# chain is as reproducible as the plain one.

def _philox_word0(c0, c1, k0, k1):
    """Word 0 of Philox4x32-10 at counter (c0, c1, 0, 0) under key (k0,
    k1), in Python ints: :func:`row_uniforms`'s bits for one row, without
    a torch op per round."""
    c2 = c3 = 0
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK32)
    return c0


def host_uniform(seed, counter, tag):
    """Scalar uniform from stream (seed, counter, tag): the value
    :func:`row_uniforms` gives that row."""
    word = _philox_word0(int(counter) & _MASK32, int(tag) & _MASK32,
                         int(seed) & _MASK32, 0)
    return (word >> 8) * (1.0 / (1 << 24))


def host_warp(logits, temperature=0.0, top_k=0, top_p=1.0, bias=None):
    """warp_probs for a single ``[V]`` row with scalar params -> np [V]."""
    row = torch.from_numpy(np.asarray(logits, np.float32)[None, :].copy())
    b = None if bias is None else torch.from_numpy(
        np.asarray(bias, np.float32)[None, :].copy())
    return warp_probs(row, [temperature], [top_k], [top_p], b)[0].numpy()


def host_draw(probs, seed, counter, tag):
    """Draw one token from a warped ``[V]`` prob row, stream-seeded with
    the same inverse-CDF convention as the plane draw."""
    p = np.asarray(probs, np.float64)
    cum = np.cumsum(p)
    u = min(host_uniform(seed, counter, tag), 1.0 - 1e-7) * cum[-1]
    return int(np.argmax(cum > u))


# ---- IR op -----------------------------------------------------------------

@register("sampling_decode", not_differentiable=True)
def sampling_decode(ins, attrs):
    """In-graph decode-step draw (the reference's :209).

    Inputs (all row operands — see module docstring):
      Logits [S, V] f32 · Temperature [S] f32 · TopK [S] i32 ·
      TopP [S] f32 · Seed [S] · Counter [S] · Bias [S, V] f32 (opt)
    Outputs: Out [S] sampled token ids, Probs [S, V] warped distribution.
    Attr ``stream_tag`` selects the stream (default TAG_DRAW).  A pure
    function of its inputs: same feeds, same tokens.
    """
    toks, p = draw_tokens(
        first(ins, "Logits"), first(ins, "Temperature"),
        first(ins, "TopK"), first(ins, "TopP"),
        first(ins, "Seed"), first(ins, "Counter"),
        bias=first(ins, "Bias"),
        tag=int(attrs.get("stream_tag", TAG_DRAW)))
    return {"Out": [toks.to(torch.int32)], "Probs": [p]}
