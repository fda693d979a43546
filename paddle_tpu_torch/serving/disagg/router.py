"""DisaggRouter: prefill/decode split dispatch with co-located fallback
(port of ``paddle_tpu/serving/disagg/router.py``, a copy: host Python).

The routing policy over the disaggregated tier (the DistServe/
Splitwise-shaped control plane, PAPERS.md):

- requests are classified by PROMPT LENGTH: long prompts (>=
  ``DisaggConfig.prefill_threshold`` tokens) take the split path —
  prefill on a prefill replica, KV streamed to a pinned decode
  replica's ingest listener, decode leg admitted there with the
  transferred chain already re-homed in its prefix cache (admission
  gates on free blocks exactly like a local prompt, and the admit
  prefix-hits every transferred block) — short prompts go straight to
  co-located decode (the transfer would cost more than the prefill).
- BOTH legs run through the inherited ``FleetRouter._dispatch`` core:
  SLA admission, per-replica-group circuit breakers, half-open-first
  ordering, failover on the prefill leg, and ``_watch`` completion
  accounting that feeds stream failures back into the prefill
  replica's breaker.  The decode leg is PINNED to the replica that
  received the KV (streaming to one replica and decoding on another
  would orphan the transfer).
- every split-path failure — no routable prefill replica, staging pool
  full, stream torn mid-transfer, decode pin refused — FALLS BACK to
  co-located serving on the ordinary decode path: degradation, never
  an outage.  Only client errors (SamplingConfigError) propagate.

The whole request is ONE traced causal tree: a ``disagg/request`` root
span parents the prefill-leg dispatch, the engine's ``disagg/prefill``
compute span, the ``disagg/kv_transfer`` leg with its ``rpc/kv_stream``
chunk spans, and the decode-leg dispatch — ``critical_path`` bills the
transfer to the ``kv_transfer`` stage.
"""

import contextlib
import itertools
import threading
import time

import numpy as np

from ...observability import trace as _trace
from ..batcher import ServingError
from ..fleet.router import FleetConfig, FleetRouter
from ..sampling import SamplingConfigError

__all__ = ["DisaggConfig", "DisaggRouter"]


class DisaggConfig(FleetConfig):
    """FleetConfig plus the split policy:

    - prefill_threshold: prompt length (tokens) at or above which the
      split path is attempted; shorter prompts always serve co-located
    - prefill_timeout_s: how long the router waits for the prefill+
      transfer leg before abandoning the split and falling back
    - bos_id: the decode tier's ``ContinuousConfig.bos_id`` — the
      router bos-prefixes the prompt ONCE, before the prefill leg, so
      the chain keys the prefill pool computes are byte-identical to
      the keys the decode engine's admit recomputes (a mismatched bos
      would silently zero the prefix-hit rate, turning every transfer
      into dead bytes)
    """

    def __init__(self, prefill_threshold=32, prefill_timeout_s=30.0,
                 bos_id=0, **kw):
        super().__init__(**kw)
        self.prefill_threshold = int(prefill_threshold)
        self.prefill_timeout_s = float(prefill_timeout_s)
        self.bos_id = int(bos_id)


class DisaggRouter(FleetRouter):
    """FleetRouter plus the disaggregated split path.

    Register prefill replicas (``PrefillReplica`` hosting the model
    kind="prefill") and decode replicas with
    ``add_replica(r, kv_endpoint="host:port")`` naming their
    ``KVStreamServer``; ``submit_disagg`` then routes each request down
    the split or co-located path by prompt length and fleet health.
    """

    def __init__(self, config=None):
        super().__init__(config or DisaggConfig())
        # kv endpoints + typed-removal membership live on FleetRouter
        # (add_replica(r, kv_endpoint=...) / remove_replica) — shared
        # with a drain path
        self._xfer_seq = itertools.count()
        self._disagg_lock = threading.Lock()
        self._disagg = {"split": 0, "fallback_short": 0,
                        "fallback_no_prefill": 0,
                        "fallback_stream_failed": 0,
                        "fallback_decode_pin": 0}

    # ---- the split path ----

    def submit_disagg(self, model, prompt, context=None, sampling=None,
                      max_new_tokens=None, sla="high", timeout_ms=None):
        """Route one decode request through the disaggregated tier.

        Long prompts attempt prefill-replica prefill + kv_stream to a
        pinned decode replica, then decode there; short prompts and
        every split-path failure serve co-located via the ordinary
        ``submit_decode`` path.  Returns the decode request future
        either way."""
        # bos-normalize HERE so prefill and decode legs hash identical
        # chains (the decode engine's submit would otherwise prepend
        # bos after the transfer already keyed the raw prompt)
        prompt = np.asarray(prompt if prompt is not None else [],
                            np.int64).reshape(-1)
        if prompt.size == 0 or prompt[0] != self.config.bos_id:
            prompt = np.concatenate(
                [np.array([self.config.bos_id], np.int64), prompt])
        n = int(prompt.size)
        root = _trace.TRACER.maybe_trace(
            "disagg/request", sla=sla,
            attrs={"model": model, "n_prompt": n},
            parent=_trace.current())
        ctx = _trace.use_context(root.ctx()) if root is not None \
            else contextlib.nullcontext()
        try:
            with ctx:
                if n < self.config.prefill_threshold:
                    return self._fallback(model, prompt, context,
                                          sampling, max_new_tokens, sla,
                                          timeout_ms, root,
                                          why="short")
                target = self._pick_decode(model)
                if target is None:
                    return self._fallback(model, prompt, context,
                                          sampling, max_new_tokens, sla,
                                          timeout_ms, root,
                                          why="decode_pin")
                name, endpoint = target
                xfer = f"disagg-{next(self._xfer_seq)}"
                pf = None
                try:
                    pf = self._dispatch(
                        model, sla, timeout_ms, kind="disagg/prefill",
                        hosts=lambda r: r.hosts(model, kind="prefill"),
                        attempt=lambda r, tmo, cls: r.submit_prefill(
                            model, prompt, endpoint, xfer=xfer,
                            timeout_ms=tmo))
                    manifest = pf.result(
                        self.config.prefill_timeout_s)
                except SamplingConfigError:
                    raise
                except (ServingError, ConnectionError, OSError,
                        TimeoutError) as e:
                    # prefill tier unroutable / staging full (dispatch
                    # itself refused: pf never assigned) vs. stream
                    # torn mid-transfer (the future failed; the sender
                    # already aborted, TTL reaper backstops) — then
                    # degrade to co-located either way
                    why = "no_prefill" if pf is None \
                        else "stream_failed"
                    if root is not None:
                        _trace.TRACER.event(
                            "split_failed", span=root,
                            error=f"{type(e).__name__}: {e}")
                    return self._fallback(model, prompt, context,
                                          sampling, max_new_tokens,
                                          sla, timeout_ms, root,
                                          why=why)
                # decode leg, PINNED to the replica holding the KV:
                # same dispatch core, candidate set of exactly one
                try:
                    req = self._dispatch(
                        model, sla, timeout_ms, kind="fleet/decode",
                        hosts=lambda r: (r.name == name
                                         and r.hosts_decode(model)),
                        attempt=lambda r, tmo, cls: r.submit_decode(
                            model, prompt, context=context,
                            sampling=sampling,
                            max_new_tokens=max_new_tokens,
                            timeout_ms=tmo, sla=cls.name))
                except SamplingConfigError:
                    raise
                except (ServingError, ConnectionError, OSError) as e:
                    if root is not None:
                        _trace.TRACER.event(
                            "split_failed", span=root, leg="decode",
                            error=f"{type(e).__name__}: {e}")
                    return self._fallback(model, prompt, context,
                                          sampling, max_new_tokens,
                                          sla, timeout_ms, root,
                                          why="decode_pin")
        except BaseException as e:
            _trace.TRACER.end_span(root, error=e)
            raise
        with self._disagg_lock:
            self._disagg["split"] += 1
        self._finish_root(root, req, path="split", decode=name,
                          kv_bytes=manifest["bytes"],
                          kv_blocks=manifest["n_blocks"],
                          kv_deduped=manifest["deduped"])
        return req

    def _pick_decode(self, model):
        """The decode pin: least-outstanding-per-chip replica that
        hosts `model` as decode, has a kv_stream listener, and whose
        breaker admits traffic right now.  None = no split target (the
        caller degrades to co-located)."""
        members, breakers = self._members()
        with self._member_lock:
            endpoints = dict(self._kv_endpoints)
        draining = self._draining
        best = None
        for r in members:
            if r.name in draining or r.name not in endpoints \
                    or not r.hosts_decode(model):
                continue
            # peek, don't allow(): consuming the half-open probe here
            # would waste it — the decode-leg _dispatch gates for real
            if breakers[r.name].export()["state"] == "open":
                continue
            load = r.outstanding() / max(1, getattr(r, "chips", 1))
            if best is None or load < best[0]:
                best = (load, r.name, endpoints[r.name])
        return None if best is None else (best[1], best[2])

    def _fallback(self, model, prompt, context, sampling,
                  max_new_tokens, sla, timeout_ms, root, why):
        """Co-located degradation: the ordinary submit_decode path over
        every decode-hosting replica (its own failover included)."""
        key = {"short": "fallback_short",
               "no_prefill": "fallback_no_prefill",
               "stream_failed": "fallback_stream_failed",
               "decode_pin": "fallback_decode_pin"}[why]
        with self._disagg_lock:
            self._disagg[key] += 1
        try:
            req = self.submit_decode(
                model, prompt, context=context, sampling=sampling,
                max_new_tokens=max_new_tokens, sla=sla,
                timeout_ms=timeout_ms)
        except BaseException as e:
            _trace.TRACER.end_span(root, error=e)
            raise
        self._finish_root(root, req, path="colocated", why=why)
        return req

    @staticmethod
    def _finish_root(root, req, **attrs):
        """Close the disagg/request root when the decode future
        resolves — the root's wall time is the whole request, split
        legs included."""
        if root is None:
            return
        t0 = time.perf_counter()

        def done(r):
            exc = r._exc
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            if exc is None:
                _trace.TRACER.end_span(root, outcome="completed",
                                       decode_ms=ms, **attrs)
            else:
                _trace.TRACER.end_span(root, error=exc, **attrs)

        req.add_done_callback(done)

    # ---- observability ----

    def stats(self):
        out = super().stats()
        with self._disagg_lock:
            out["disagg"] = dict(self._disagg)
        with self._member_lock:
            out["disagg"]["kv_endpoints"] = dict(self._kv_endpoints)
        return out
