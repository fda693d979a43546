"""Def-use / SSA-view dataflow analysis over Program blocks.

The analysis layer of the IR pass pipeline (ROADMAP item 5, PAPER.md
§L4): everything here is a PURE QUERY over the ``Program``/``Block``/
``Operator`` IR (core/framework.py) — no mutation, no version bumps, no
var creation — so program hint fingerprints (jitcache keys) are
byte-identical before and after an analysis run.

Model of execution (core/executor.py): ops run in list order; a
``while``/``conditional_block`` op's sub-block reads and writes the
ENCLOSING environment (its effects happen "at" the op's index in the
parent block), while ``dynamic_rnn``/``gpipe`` sub-blocks are
kernel-internal (every outer value they read is an explicit op input
and their own vars are loop-locals — ``SELF_CONTAINED_BLOCK_OPS``).
Grad ops carry the forward op's block as an attr but bind all reads as
explicit inputs, so they are not recursed either.
"""

import collections

from ..core import framework
from ..core.executor import _recurse_into_blocks

Site = collections.namedtuple("Site", ["block_idx", "op_idx"])


def sub_blocks(op, recurse_policy=True):
    """Block-valued attrs of an op.  With recurse_policy, only the
    blocks whose effects land in the enclosing env (the executor's
    _recurse_into_blocks contract)."""
    if recurse_policy and not _recurse_into_blocks(op):
        return []
    return [v for v in op.attrs.values()
            if isinstance(v, framework.Block)]


def op_reads_writes(op):
    """(reads, writes) of one op INCLUDING its env-transparent
    sub-blocks (while/conditional_block bodies), mirroring the
    executor's carry computation."""
    reads = set(op.input_arg_names)
    writes = set(op.output_arg_names)
    stack = list(sub_blocks(op))
    while stack:
        blk = stack.pop()
        for inner in blk.ops:
            reads.update(inner.input_arg_names)
            writes.update(inner.output_arg_names)
            stack.extend(sub_blocks(inner))
    return reads, writes


class BlockDataflow:
    """Per-block def/use structure.

    defs / uses: var name -> ordered [op_idx] within this block.  A
    control-flow op's sub-block effects count at the op's own index
    (that is when they happen at run time).
    """

    def __init__(self, block):
        self.block = block
        self.defs = collections.OrderedDict()
        self.uses = collections.OrderedDict()
        for i, op in enumerate(block.ops):
            reads, writes = op_reads_writes(op)
            for n in sorted(reads):
                self.uses.setdefault(n, []).append(i)
            for n in sorted(writes):
                self.defs.setdefault(n, []).append(i)

    def first_def(self, name):
        sites = self.defs.get(name)
        return sites[0] if sites else None

    def last_use(self, name):
        sites = self.uses.get(name)
        return sites[-1] if sites else None

    def multi_def_names(self):
        """Vars written by more than one op — the non-SSA set a real
        SSA construction would have to rename (optimizer in-place
        updates land here by design)."""
        return sorted(n for n, s in self.defs.items() if len(s) > 1)

    def live_interval(self, name):
        """(first def idx or None, last use idx or None): the op-index
        interval outside which the var's buffer is dead in this block."""
        return (self.first_def(name), self.last_use(name))

    def dead_after(self, keep=()):
        """name -> op index after which the value is dead (last use;
        defs count as uses-by-the-writer so a pure write keeps the var
        to its def site).  Names in `keep` (fetches, persistables,
        externally observed state) are excluded — they outlive the
        block."""
        keep = set(keep)
        out = {}
        for name in set(self.defs) | set(self.uses):
            if name in keep:
                continue
            v = self.block._find_var_recursive(name)
            if v is not None and (v.persistable or v.is_data):
                continue
            last = max([i for i in self.uses.get(name, [])] +
                       [i for i in self.defs.get(name, [])])
            out[name] = last
        return out

    def topo_order(self):
        """Dependency-derived topological order over this block's ops
        (Kahn, ties broken by program order so the result is stable and
        equals program order whenever program order is already
        topological).  Self-loops (an op reading and writing the same
        var, e.g. in-place optimizer updates) are ignored.  Returns a
        list of op indices; falls back to program order if the def-use
        graph is cyclic across distinct ops."""
        n = len(self.block.ops)
        succs = [set() for _ in range(n)]
        indeg = [0] * n
        for name, def_sites in self.defs.items():
            use_sites = self.uses.get(name, [])
            for d in def_sites:
                for u in use_sites:
                    if u > d and u not in succs[d]:
                        succs[d].add(u)
                        indeg[u] += 1
        import heapq
        ready = [i for i in range(n) if indeg[i] == 0]
        heapq.heapify(ready)
        order = []
        while ready:
            i = heapq.heappop(ready)
            order.append(i)
            for j in sorted(succs[i]):
                indeg[j] -= 1
                if indeg[j] == 0:
                    heapq.heappush(ready, j)
        if len(order) != n:          # cyclic (shouldn't happen): stable
            return list(range(n))    # program order is the safe answer
        return order


class ProgramDataflow:
    """Whole-program def-use view.

    - per-block :class:`BlockDataflow` (``self.blocks[idx]``)
    - global def/use sites as (block_idx, op_idx) pairs with
      cross-sub-block resolution: a name used in a sub-block resolves
      to defs in the sub-block itself or any ancestor (parent_block
      chain), matching Block._find_var_recursive / the executor's env
    - reachability of blocks from the global block through Block attrs
    - liveness intervals and dead-var sets per block
    """

    def __init__(self, program, feed_names=()):
        self.program = program
        self.feed_names = set(feed_names)
        self.blocks = [BlockDataflow(b) for b in program.blocks]
        self.def_sites = collections.defaultdict(list)
        self.use_sites = collections.defaultdict(list)
        for bdf in self.blocks:
            bidx = bdf.block.idx
            for n, sites in bdf.defs.items():
                self.def_sites[n].extend(Site(bidx, i) for i in sites)
            for n, sites in bdf.uses.items():
                self.use_sites[n].extend(Site(bidx, i) for i in sites)
        # owner[sub_block_idx] = Site of the op whose attr carries it —
        # how deep a sub-block use can see into its ancestors' pasts
        self.owner = {}
        for blk in program.blocks:
            for i, op in enumerate(blk.ops):
                for v in op.attrs.values():
                    if isinstance(v, framework.Block):
                        self.owner.setdefault(v.idx, Site(blk.idx, i))
        self.reachable_blocks = self._reachable()

    def _reachable(self):
        """Block idxs reachable from block 0 via op Block attrs — the
        set the executor can ever run (recurse_policy=False: even
        self-contained sub-blocks ARE executed, just not env-
        transparent)."""
        live = {0}
        stack = [self.program.blocks[0]]
        while stack:
            for op in stack.pop().ops:
                for v in op.attrs.values():
                    if isinstance(v, framework.Block) and \
                            v.idx not in live:
                        live.add(v.idx)
                        stack.append(self.program.blocks[v.idx])
        return live

    # -- cross-block resolution ------------------------------------------

    def ancestors(self, block_idx):
        """Block idx chain from block_idx to the global block
        (inclusive of block_idx)."""
        out = []
        b = self.program.blocks[block_idx]
        while b is not None:
            out.append(b.idx)
            b = b.parent_block
        return out

    def resolves(self, name, block_idx):
        """Whether `name` has a Variable declaration visible from
        block_idx (the executor's _find_var_recursive)."""
        return self.program.blocks[block_idx]._find_var_recursive(
            name) is not None

    def defs_visible_before(self, name, site):
        """Def sites of `name` that the executor guarantees can happen
        before a use at `site`:

        - top-level block: defs at a strictly earlier op index (ops run
          in list order)
        - the use's own sub-block: defs at ANY index (loop carries make
          later-in-body defs visible on the next iteration)
        - ancestor blocks, walking the owner-op chain: defs strictly
          before the op that carries the sub-block (the body only runs
          once control reaches that op)
        """
        frames = [(site.block_idx,
                   site.op_idx if site.block_idx == 0 else None)]
        b = site.block_idx
        while b != 0:
            owner = self.owner.get(b)
            if owner is None:
                break
            frames.append((owner.block_idx, owner.op_idx))
            b = owner.block_idx
        out = []
        for d in self.def_sites.get(name, ()):
            for bidx, limit in frames:
                if d.block_idx == bidx and (limit is None or
                                            d.op_idx < limit):
                    out.append(d)
                    break
        return out

    def is_external(self, name, block_idx=0):
        """Values the program legitimately reads without an in-program
        def: runtime feeds, declared feed vars (is_data, including the
        @SEQ_LEN lod companions), and persistable state initialized by
        the startup program / checkpoint restore."""
        if name in self.feed_names:
            return True
        v = self.program.blocks[block_idx]._find_var_recursive(name)
        return v is not None and (v.persistable or v.is_data)

    # -- liveness over the whole program ---------------------------------

    def live_interval(self, name, block_idx=0):
        return self.blocks[block_idx].live_interval(name)

    def dead_vars(self, block_idx=0, keep=()):
        """Vars defined in the block whose last use is behind them —
        per-name death points, the substrate for an eager-deletion
        pass (reference: eager_deletion_pass.cc)."""
        return self.blocks[block_idx].dead_after(keep=keep)

    def topo_order(self, block_idx=0):
        return self.blocks[block_idx].topo_order()


def build(program, feed_names=()):
    """Build the whole-program dataflow view (pure query)."""
    return ProgramDataflow(program, feed_names=feed_names)
