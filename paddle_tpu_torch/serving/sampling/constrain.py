"""Constrained decode: the pluggable token-mask stepper.

A *mask stepper* is any object with three methods::

    start()                  -> initial state (opaque to the engine)
    allowed(state, vocab)    -> iterable of permitted token ids
    advance(state, token)    -> next state (called once per COMMITTED token)

At every token boundary the engine asks the stepper which tokens are
legal, writes ``-inf`` into the slot's bias row for everything else, and
the draw happens over the masked distribution — so a constrained request
can only ever emit tokens the grammar permits, at any temperature
(greedy rows argmax the masked logits).  State lives host-side and is
checkpointed with the request across preemption, so a recomputed
sequence resumes its grammar exactly where it left off.

``TokenDFA`` is the reference implementation: an explicit token-level
DFA, which is both the simplest useful grammar engine and the compile
target for richer frontends (a regex->DFA or JSON-schema->DFA compiler
plugs in above it without the engine changing).  ``json_list_dfa``
builds the DFA for a fixed-width JSON-ish list — the shape used by the
"constrained outputs always parse" acceptance tests and bench replay.
"""

from ..batcher import ServingError


class ConstraintError(ServingError):
    """The constraint reached an impossible position: an empty allowed
    set, or a token outside the current state's transitions."""


_DONE = "__dfa_done__"          # post-EOS sink state


class TokenDFA:
    """Explicit token-level DFA mask stepper.

    ``transitions`` maps state -> {token_id: next_state}.  In an accept
    state, ``eos_id`` (when given) is additionally allowed and steps to a
    terminal sink that only allows EOS again — committing EOS (which the
    engine does before it notices the stop condition) can never throw.
    """

    def __init__(self, transitions, start_state, accept=(), eos_id=None):
        self._t = {s: dict(edges) for s, edges in transitions.items()}
        self._start = start_state
        self._accept = frozenset(accept)
        self._eos = eos_id
        if start_state not in self._t and start_state not in self._accept:
            raise ConstraintError(
                f"start state {start_state!r} has no transitions and is "
                f"not accepting")

    def start(self):
        return self._start

    def allowed(self, state, vocab):
        if state == _DONE:
            return (self._eos,)
        toks = list(self._t.get(state, {}))
        if state in self._accept and self._eos is not None:
            toks.append(self._eos)
        return toks

    def advance(self, state, token):
        token = int(token)
        if state == _DONE:
            if token == self._eos:
                return _DONE
            raise ConstraintError(
                f"token {token} after the grammar finished")
        if (self._eos is not None and token == self._eos
                and state in self._accept):
            return _DONE
        nxt = self._t.get(state, {}).get(token)
        if nxt is None:
            raise ConstraintError(
                f"token {token} not permitted in state {state!r} "
                f"(allowed: {sorted(self._t.get(state, {}))})")
        return nxt

    def accepts(self, tokens):
        """True when `tokens` (EOS excluded or included) drives start ->
        an accept state — the parse check the acceptance tests run over
        engine output."""
        state = self.start()
        for t in tokens:
            t = int(t)
            if self._eos is not None and t == self._eos:
                return state in self._accept or state == _DONE
            try:
                state = self.advance(state, t)
            except ConstraintError:
                return False
        return state in self._accept or state == _DONE


def json_list_dfa(open_id, close_id, comma_id, value_ids, eos_id,
                  max_items=8):
    """DFA for a JSON-ish list: ``[ v (, v)* ]`` then EOS, with at most
    ``max_items`` values — every prefix the mask permits extends to a
    parseable list, so constrained outputs always parse."""
    t = {"s": {open_id: ("v", 0)}}
    for n in range(max_items):
        t[("v", n)] = {v: ("d", n + 1) for v in value_ids}
        nxt = {close_id: "end"}
        if n + 1 < max_items:
            nxt[comma_id] = ("v", n + 1)
        t[("d", n + 1)] = nxt
    return TokenDFA(t, "s", accept=("end",), eos_id=eos_id)
