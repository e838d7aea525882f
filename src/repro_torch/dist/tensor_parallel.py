"""Tensor- and expert-parallel compute on the ``model`` blocks of the
parameters: what JAX's partitioner derives from the ``tp`` specs of
``repro.dist.sharding`` under ``jax.jit(in_shardings=...)``, written out
for the port's step on blocks (``repro_torch.dist.spmd``).

:func:`plan` works out, once, from the parameter specs and the config,
how each leaf is computed with, with its reason.  A leaf is one of three
kinds:

  * kept: a rank computes with its stored ``model`` block (gathered over
    ``data`` only), which holds whole units of a layer with a rule here;
  * taken (:class:`Take`): the stored block cuts across the layer's own
    units, so the leaf is gathered whole and the rank computes with its
    own slice of it (its units' ranges, and ranges every unit shares
    whole); each rank sends each ``model`` member only the ranges of its
    slice's grad that fall in that member's stored block, and the owner
    puts its block together (:meth:`Plan.fold`), so the rest of the step
    treats it as a kept leaf;
  * whole: gathered whole and computed with whole on every rank.

The rules:

  * GQA attention: whole query heads with whole KV groups (the query and
    KV head counts both divide by the ``model`` size); ``wq``/``wk``/
    ``wv`` are column blocks (this rank's heads), ``wo`` a row block
    whose partial output is summed over ``model``;
  * MQA-like attention (the query heads divide, the KV heads do not:
    recurrentgemma's one KV head): ``wq``/``wo`` on their head blocks,
    ``wk``/``wv`` whole, K and V computed whole on every rank and
    entering the rank's heads (their grads summed over ``model``);
  * MLA attention (DeepSeek-V3; its heads divide): ``wq_b``/``wkv_b``
    column blocks of whole heads, ``wo`` the row block; ``wq_a``/
    ``wkv_a`` (stored as column blocks of a latent, not of heads) whole,
    the normed latents and the shared rope key computed whole on every
    rank and entering the rank's heads (their grads summed over
    ``model``), as MQA's K and V;
  * Mamba2 (heads divide): ``a_log``/``dt_bias``/``d_skip`` and the
    norm's scale on their stored blocks of heads; ``in_proj``, ``conv_w``
    and ``out_proj`` taken: this rank's heads' z / x / dt columns with B
    and C whole, its x channels with B and C's whole, its heads' rows;
  * the RG-LRU (its width divides): ``wx``/``wgate``, the conv, ``lam``
    and the dense ``W x W`` gates ``wr``/``wi`` on their column blocks of
    this rank's channels (the gates read the conv output gathered over
    ``model``, :func:`gather`), ``wout`` taken: its channels' rows;
  * a SwiGLU MLP (dense layers, the RG-LRU blocks' MLPs, shared experts):
    ``wi``/``wg`` column blocks of ``d_ff``, ``wo`` a row block;
  * routed experts: whole experts (E over ``model``: expert parallelism);
  * the vocabulary: the embedding's rows and the head's columns;
  * the frontends' ``frontend_proj`` and the MTP head's ``mtp.proj``:
    column blocks of ``d_model``, their outputs gathered over ``model``
    into the replicated residual stream (:func:`join`); the MTP block's
    attention and MLP by the rules above.

Everything else is gathered whole: heads (or widths) that do not
divide, MLA's latent projections, the router (every rank routes every
token), norms outside these layers and conv kernels
(``dist.conv_parallel`` cuts them itself).

Inside :func:`model_axis` (the step enters it around its forward and
backward), a layer that finds a block where its config says whole units
(:func:`is_block`) computes its share with Megatron's two operators, in
``Mesh.psum``'s fixed order so that every ``model`` rank holds the same
bits: :func:`enter` (identity forward, psum of the grad backward) where
replicated activations meet the block, and :func:`leave` (psum forward,
identity backward) where the block's partial output rejoins them;
:func:`gather` (all-gather forward, the summed grad's own slice
backward) where a block's activations are read whole by other blocks;
and :func:`join` (all-gather forward, the grad's own slice backward,
no sum) where a column block's output joins the replicated activations,
whose grad is whole and the same on every rank already.  Every
``model`` rank computes the same loss from the same inputs, so a
replicated parameter's grad is whole on every rank and a kept leaf's is
its block.  :data:`COUNTS` counts the model psums, gathers and folds,
their bytes, and the bytes the step's grad sync sends and receives.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.dist.sharding import P, gather_tree, to_local
from repro_torch.launch.mesh import tally
from repro_torch.tree import tree_leaves, tree_unflatten

MODEL = "model"

#: the model collectives of this process: psums (``enter`` backward,
#: ``leave`` forward, ``pmax``, the backward of ``gather``), the bytes
#: they summed and the bytes they sent and received; ``gather`` and
#: ``join`` forward calls and the bytes of the blocks they gathered;
#: :meth:`Plan.fold`'s taken leaves and the bytes it sent and received;
#: and the bytes the train step's grad sync sent (``scatter_bytes``) and
#: received (``train_step._sync`` on blocks).  Sent and received bytes
#: are ``launch.mesh.WIRE``'s: what moves between ranks.
COUNTS = {"psums": 0, "psum_bytes": 0, "psum_sent": 0, "psum_received": 0,
          "gathers": 0, "gather_bytes": 0, "folds": 0, "fold_bytes": 0,
          "fold_received": 0, "scatter_bytes": 0, "scatter_received": 0}


@dataclasses.dataclass(frozen=True)
class Take:
    """The slice a rank computes with of a leaf gathered whole: along
    ``dim``, the leaf's ``parts`` in order, each ``(width, own)``; of an
    own part this rank's ``model`` block (its units), a shared part
    whole."""

    dim: int
    parts: tuple[tuple[int, bool], ...]

    def ranges(self, m: int, index: int) -> list[tuple[int, int, bool]]:
        """``(start, length, own)`` in the whole leaf of each range the
        slice holds, in order."""
        out, start = [], 0
        for width, own in self.parts:
            if own:
                out.append((start + index * (width // m), width // m, True))
            else:
                out.append((start, width, False))
            start += width
        return out

    def width(self, m: int) -> int:
        """The slice's size along ``dim``."""
        return sum(w // m if own else w for w, own in self.parts)

    def of(self, t: torch.Tensor, m: int, index: int) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t``."""
        if t.shape[self.dim] != sum(w for w, _ in self.parts):
            raise ValueError(f"a leaf of {t.shape[self.dim]} along dim "
                             f"{self.dim}, its parts {self.parts}")
        return torch.cat([t.narrow(self.dim, s, n)
                          for s, n, _ in self.ranges(m, index)], self.dim)

    def pieces(self, m: int, src: int, owner: int, block_dim: int,
               shape) -> list[tuple[tuple, tuple]]:
        """What rank ``src`` sends ``owner`` of its slice's grad (of
        ``shape``) when the whole leaf's stored ``model`` block ``owner``
        cuts dim ``block_dim``: each range ``src`` is the source of (its
        own ranges; at coordinate 0 the shared ones too: every rank
        holds the same bits of them) that falls in the block, as ``(slice region, block
        region)``, each region ``((dim, start, length), ...)``."""
        nd = len(shape)
        dim, block_dim = self.dim % nd, block_dim % nd
        width = sum(w for w, _ in self.parts) if dim == block_dim \
            else shape[block_dim]
        b = width // m
        lo_b, hi_b = owner * b, (owner + 1) * b
        out, at = [], 0
        for s, n, own in self.ranges(m, src):
            if own or src == 0:
                if dim == block_dim:
                    lo, hi = max(s, lo_b), min(s + n, hi_b)
                    if lo < hi:
                        out.append((((dim, at + lo - s, hi - lo),),
                                    ((dim, lo - lo_b, hi - lo),)))
                else:
                    out.append((((dim, at, n), (block_dim, lo_b, b)),
                                ((dim, s, n),)))
            at += n
        return out


def _region(t: torch.Tensor, region) -> torch.Tensor:
    for dim, start, length in region:
        t = t.narrow(dim, start, length)
    return t


def _model_dim(spec) -> int:
    """The dim a spec cuts over ``model``."""
    dims = [d for d, e in enumerate(spec) if e is not None
            and MODEL in (e if isinstance(e, tuple) else (e,))]
    if len(dims) != 1:
        raise ValueError(f"{spec} does not cut one dim over {MODEL}")
    return dims[0]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's compute: on a ``model`` block (``keep``: its
    stored one, or with ``take`` a slice of the leaf gathered whole) or
    whole, and why."""

    keep: bool
    why: str
    take: Take | None = None


def _names_model(spec) -> bool:
    return any(MODEL in (e if isinstance(e, tuple) else (e,))
               for e in spec)


def _drop_model(spec) -> P:
    """``spec`` without the ``model`` axis: the leaf gathered over the
    other axes only."""
    def drop(e):
        if isinstance(e, tuple):
            rest = tuple(a for a in e if a != MODEL)
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        return None if e == MODEL else e
    return P(*(drop(e) for e in spec))


#: a SwiGLU MLP's (or an expert stack's) weights.
_SWIGLU = ("wi", "wg", "wo")


def _ssm_rule(name: str, cfg, m: int) -> Leaf:
    """A Mamba2 leaf (``name`` under ``ssm``): on this rank's heads."""
    d, s = cfg.d_model, cfg.ssm_state
    di = cfg.ssm_expand * d
    h = di // cfg.ssm_head_dim
    if h % m or 2 * s % m or d % m:
        return Leaf(False, f"{h} Mamba2 heads (state {s}, d_model {d}) do "
                           f"not divide by model={m}")
    heads = f"heads, {h // m} of {h}"
    if name == "in_proj":
        return Leaf(True, f"{heads}: z, x and dt columns, B and C whole, "
                          f"taken from the leaf gathered whole (in_proj "
                          f"packs z/x/B/C/dt)",
                    Take(-1, ((di, True), (di, True), (s, False), (s, False),
                              (h, True))))
    if name == "conv_w":
        return Leaf(True, f"{heads}: x channels, B and C whole, taken from "
                          f"the leaf gathered whole (conv_w packs x/B/C)",
                    Take(-1, ((di, True), (s, False), (s, False))))
    if name == "out_proj":
        return Leaf(True, f"{heads}: rows, taken from the leaf gathered "
                          f"whole (stored: columns of d_model)",
                    Take(-2, ((di, True),)))
    return Leaf(True, heads)


def _rec_rule(name: str, cfg, m: int) -> Leaf:
    """An RG-LRU leaf (``name`` under ``rec``): on this rank's
    channels."""
    w = cfg.rglru_width or cfg.d_model
    if w % m or cfg.d_model % m:
        return Leaf(False, f"RG-LRU width {w} (d_model {cfg.d_model}) does "
                           f"not divide by model={m}")
    chans = f"channels, {w // m} of {w}"
    if name == "wout":
        return Leaf(True, f"{chans}: rows, taken from the leaf gathered "
                          f"whole (stored: columns of d_model)",
                    Take(-2, ((w, True),)))
    if name in ("wr", "wi"):
        return Leaf(True, f"{chans}: columns of the dense {w} x {w} gate, "
                          f"its rows read the conv output gathered over "
                          f"model")
    return Leaf(True, chans)


def _attn_rule(name: str, cfg, m: int) -> Leaf:
    h, hk = cfg.n_heads, cfg.n_kv_heads
    if h % m:
        return Leaf(False, f"{h} query heads and {hk} KV heads do not both "
                           f"divide by model={m}")
    if hk % m == 0:
        return Leaf(True, f"heads, {h // m} of {h} (KV {hk // m} of {hk})")
    if name in ("wk", "wv"):
        return Leaf(False, f"{hk} KV heads do not divide by model={m}: K "
                           f"and V computed whole, their grads summed over "
                           f"model")
    return Leaf(True, f"query heads, {h // m} of {h} (KV {hk} whole)")


def _mla_rule(name: str, cfg, m: int) -> Leaf:
    """An MLA leaf (``name`` under ``attn``): on this rank's heads."""
    h = cfg.n_heads
    if name in ("wq_a", "wkv_a"):
        return Leaf(False, "a latent's columns, not heads: the latent "
                           "computed whole, its grad summed over model")
    if h % m:
        return Leaf(False, f"{h} MLA heads do not divide by model={m}")
    return Leaf(True, f"heads, {h // m} of {h}")


def _columns(cfg, m: int, what: str) -> Leaf:
    d = cfg.d_model
    return Leaf(True, f"d_model columns, {d // m} of {d}: {what}'s output "
                      f"gathered over model")


def _rule(path: tuple[str, ...], ndim: int, cfg, m: int) -> Leaf:
    """The compute of a leaf whose spec cuts it over ``model``."""
    if not hasattr(cfg, "n_heads"):
        if ndim >= 4:
            return Leaf(False, "a conv kernel: the mesh-parallel conv "
                               "cuts it")
        return Leaf(False, "no rule of this slice: a model without "
                           "attention, MLP, experts or vocabulary")
    top = path[0]
    if top == "embed":
        return Leaf(True, f"vocabulary rows, {cfg.vocab // m} of "
                          f"{cfg.vocab}")
    if top == "lm_head":
        return Leaf(True, f"vocabulary columns, {cfg.vocab // m} of "
                          f"{cfg.vocab}")
    if top == "frontend_proj":
        return _columns(cfg, m, "the frontend")
    if path[:2] == ("mtp", "proj"):
        return _columns(cfg, m, "the MTP head")
    for layer, rule in (("ssm", _ssm_rule), ("rec", _rec_rule)):
        if layer in path:
            return rule(path[path.index(layer) + 1], cfg, m)
    unit, name = (path[-3], path[-2]) if len(path) >= 3 and \
        path[-1] == "w" else (None, None)
    if unit == "attn" and cfg.use_mla:
        return _mla_rule(name, cfg, m)
    if unit == "attn" and name in ("wq", "wk", "wv", "wo"):
        return _attn_rule(name, cfg, m)
    if unit == "moe" and name == "router":
        return Leaf(False, "the router: every rank routes every token")
    if unit == "moe" and name in _SWIGLU:
        return Leaf(True, f"experts, {cfg.n_experts // m} of "
                          f"{cfg.n_experts}")
    if unit in ("mlp", "shared") and name in _SWIGLU:
        f = cfg.moe_d_ff * cfg.n_shared_experts if unit == "shared" \
            else cfg.d_ff
        return Leaf(True, f"d_ff columns, {f // m} of {f}")
    return Leaf(False, "no rule of this slice reads its block")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Each parameter's compute under ``specs`` on ``mesh``
    (:func:`plan`): ``tree`` mirrors the specs with a :class:`Leaf` a
    parameter; ``vocab`` is the whole vocabulary where a rank holds its
    rows of it, else None."""

    tree: object
    specs: object
    mesh: object
    vocab: int | None

    @property
    def size(self) -> int:
        return dict(self.mesh.shape).get(MODEL, 1)

    @property
    def kept(self) -> list[bool]:
        """Per leaf, in ``tree_leaves`` order: on its ``model`` block."""
        return [leaf.keep for leaf in tree_leaves(self.tree)]

    @property
    def compute_specs(self):
        """The specs of the grads after :meth:`fold`, and of the blocks
        the step cuts them to: a kept leaf's without ``model``."""
        return tree_unflatten(self.specs, [
            _drop_model(s) if leaf.keep else s for s, leaf in
            zip(tree_leaves(self.specs), tree_leaves(self.tree))])

    @property
    def gather_specs(self):
        """The specs the step gathers by: a kept leaf's without
        ``model``, a taken leaf's whole."""
        return tree_unflatten(self.specs, [
            _drop_model(s) if leaf.keep and leaf.take is None else s
            for s, leaf in zip(tree_leaves(self.specs),
                               tree_leaves(self.tree))])

    def table(self) -> dict[str, tuple[bool, str]]:
        """``{"a.b.w": (keep, why)}``: the plan to print or compare."""
        out: dict = {}

        def walk(tree, path):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    walk(tree[k], path + (str(k),))
            elif isinstance(tree, (list, tuple)):
                for i, v in enumerate(tree):
                    walk(v, path + (str(i),))
            else:
                out[".".join(path)] = (tree.keep, tree.why)
        walk(self.tree, ())
        return out

    def held_bytes(self, params) -> int:
        """The bytes of ``params`` (whole, or ``meta`` tensors) that a
        rank computes with in a step: a kept leaf's ``model`` block, a
        taken leaf's slice, every other leaf whole."""
        total = 0
        for t, leaf in zip(tree_leaves(params), tree_leaves(self.tree)):
            n = t.numel() * t.element_size()
            if leaf.take is not None:
                n = n // t.shape[leaf.take.dim] * leaf.take.width(self.size)
            elif leaf.keep:
                n //= self.size
            total += n
        return total

    def gathered_bytes(self, params) -> int:
        """The bytes of ``params`` that a rank gathers in a step: a kept
        leaf's ``model`` block, every other leaf (a taken one too)
        whole."""
        return sum(t.numel() * t.element_size() // (
            self.size if leaf.keep and leaf.take is None else 1)
            for t, leaf in zip(tree_leaves(params), tree_leaves(self.tree)))

    def take(self, full):
        """``full`` (gathered by :attr:`gather_specs`) as the layers
        compute with it: each taken leaf's slice."""
        index = self.mesh.coordinate(MODEL) if self.size > 1 else 0
        return tree_unflatten(full, [
            t if leaf.take is None else leaf.take.of(t, self.size, index)
            for t, leaf in zip(tree_leaves(full), tree_leaves(self.tree))])

    def fold(self, grads):
        """The grads of :meth:`take`'s tree as those of the kept leaves:
        each taken leaf's grad cut to its stored ``model`` block.  Each
        rank sends each ``model`` member only the ranges of its slice's
        grad that fall in that member's block (:meth:`Take.pieces`, one
        ``all_to_all`` a dtype), and the owner copies them into place: a
        shared range's grad is whole on every rank (the layer summed it
        over ``model``) and comes from coordinate 0, an own range's from
        the rank that holds it, so the block is put together with no add,
        as a gather of the whole leaf would give it.  The rest as they
        are."""
        leaves = tree_leaves(grads)
        taken = [(i, leaf.take, _model_dim(s)) for i, (s, leaf) in
                 enumerate(zip(tree_leaves(self.specs),
                               tree_leaves(self.tree)))
                 if leaf.take is not None]
        if not taken:
            return grads
        m, me, mesh = self.size, self.mesh.coordinate(MODEL), self.mesh
        COUNTS["folds"] += len(taken)
        out = list(leaves)
        by_dtype: dict = {}
        for item in taken:
            by_dtype.setdefault(leaves[item[0]].dtype, []).append(item)
        with tally(COUNTS, "fold_bytes", "fold_received"):
            for items in by_dtype.values():
                blocks = {}
                for i, take, bdim in items:
                    g = leaves[i]
                    shape = list(g.shape)
                    d = take.dim % g.dim()
                    shape[d] = sum(w for w, _ in take.parts)
                    shape[bdim] //= m
                    blocks[i] = g.new_empty(shape)
                sends, sizes = [None] * m, [0] * m
                for k in range(m):
                    if k == me:
                        continue
                    mine = [_region(leaves[i], src).reshape(-1)
                            for i, take, bdim in items
                            for src, _ in take.pieces(m, me, k, bdim,
                                                      leaves[i].shape)]
                    sends[k] = torch.cat(mine) if mine else None
                    sizes[k] = sum(
                        _region(leaves[i], src).numel()
                        for i, take, bdim in items
                        for src, _ in take.pieces(m, k, me, bdim,
                                                  leaves[i].shape))
                got = mesh._all_to_all(sends, sizes, MODEL,
                                       leaves[items[0][0]])
                for k in range(m):
                    at = 0
                    for i, take, bdim in items:
                        g = leaves[i]
                        for src, dst in take.pieces(m, k, me, bdim, g.shape):
                            piece = _region(g, src)
                            if k != me:
                                n = piece.numel()
                                piece = got[k][at:at + n].view(piece.shape)
                                at += n
                            _region(blocks[i], dst).copy_(piece)
                for i in blocks:
                    out[i] = blocks[i]
        return tree_unflatten(grads, out)

    def axis(self):
        """The context the step's forward and backward run in: the
        ``model`` axis where a leaf is kept, else nothing."""
        if not any(self.kept):
            return contextlib.nullcontext()
        return model_axis(self.mesh, self.vocab)

    def widen(self, grads):
        """Each grad, its parameter's block (the step's sync leaves every
        grad so), put back together over the mesh."""
        return gather_tree(grads, self.specs, self.mesh)

    def narrow(self, grads):
        """:meth:`widen` undone: each grad's block, contiguous."""
        return tree_unflatten(grads, [
            g.contiguous() for g in tree_leaves(
                to_local(grads, self.specs, self.mesh))])


def plan(specs, cfg, mesh) -> Plan:
    """The compute of every parameter under ``specs`` (module
    docstring): a leaf whose spec cuts it over a ``model`` axis of size
    > 1 by the rule of its layer, every other leaf gathered whole."""
    m = dict(mesh.shape).get(MODEL, 1)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (str(i),))
                              for i, v in enumerate(tree))
        if m == 1:
            return Leaf(False, "the model axis has size 1")
        if not _names_model(tree):
            return Leaf(False, "its spec does not cut it over model")
        return _rule(path, len(tree), cfg, m)
    tree = walk(specs, ())
    vocab = None
    for top in ("embed", "lm_head"):
        if isinstance(tree, dict) and top in tree and tree[top]["w"].keep:
            vocab = cfg.vocab
    return Plan(tree, specs, mesh, vocab)


def global_norm(grads, plan: Plan) -> torch.Tensor:
    """The norm of the whole grads from this rank's blocks (each grad its
    parameter's block under ``plan.specs``): every element counted once
    over the mesh -- a block's squares added only on the ranks at
    coordinate 0 of every axis its spec does not cut, so a replica counts
    once -- and the squares summed over the mesh's axes in coordinate
    order (``Mesh.psum``)."""
    mesh = plan.mesh
    axes = tuple(a for a, n in mesh.shape.items() if n > 1)
    leaves = tree_leaves(grads)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g, spec in zip(leaves, tree_leaves(plan.specs)):
        named = {a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        if all(mesh.coordinate(a) == 0 for a in axes if a not in named):
            total = total + torch.sum(torch.square(g.float()))
    if axes:
        total = mesh.psum(total.reshape(1), axes)[0]
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# The model axis inside a step, and the layers' operators
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank on the ``model`` axis of ``mesh``: ``size`` blocks, its
    ``index``; ``vocab`` as in :class:`Plan`."""

    mesh: object
    size: int
    index: int
    vocab: int | None


_AXES: list[ModelAxis] = []


@contextlib.contextmanager
def model_axis(mesh, vocab: int | None = None):
    """Layers inside compute on the ``model`` blocks they are given."""
    _AXES.append(ModelAxis(mesh, mesh.shape[MODEL], mesh.coordinate(MODEL),
                           vocab))
    try:
        yield _AXES[-1]
    finally:
        _AXES.pop()


def active() -> ModelAxis | None:
    return _AXES[-1] if _AXES else None


def is_block(whole: int, have: int) -> bool:
    """Whether a layer that holds ``have`` of its ``whole`` units (heads,
    columns, experts, vocabulary rows) holds this rank's block of them;
    raises on any other count."""
    if have == whole:
        return False
    ax = active()
    if ax is None or have * ax.size != whole:
        raise RuntimeError(
            f"a layer holds {have} of {whole} units, not this rank's "
            f"block of a model axis ({ax})")
    return True


def first(have: int) -> int:
    """The index of this rank's first unit of a block of ``have``."""
    return active().index * have


def vocab_first(have: int) -> int | None:
    """The first vocabulary id of this rank's block where ``have`` logits
    (or rows) are a block of the vocabulary, else None."""
    ax = active()
    if ax is None or ax.vocab is None or not is_block(ax.vocab, have):
        return None
    return first(have)


def _psum(t: torch.Tensor, mesh) -> torch.Tensor:
    COUNTS["psums"] += 1
    COUNTS["psum_bytes"] += t.numel() * t.element_size()
    with tally(COUNTS, "psum_sent", "psum_received"):
        return mesh.psum(t, (MODEL,))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, index):
        ctx.mesh, ctx.start, ctx.n = mesh, index * x.shape[-1], x.shape[-1]
        COUNTS["gathers"] += 1
        COUNTS["gather_bytes"] += x.numel() * x.element_size()
        return mesh.all_gather(x, MODEL, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return (_psum(g, ctx.mesh).narrow(-1, ctx.start, ctx.n), None,
                None)


class _Join(_Gather):
    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.start, ctx.n), None, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every ``model`` rank) into a block's compute:
    the identity; its grad summed over ``model``."""
    return _Enter.apply(x, active().mesh)


def leave(x: torch.Tensor) -> torch.Tensor:
    """A block's partial ``x`` summed over ``model``; the grad passes
    unchanged to every rank's block."""
    return _Leave.apply(x, active().mesh)


def gather(x: torch.Tensor) -> torch.Tensor:
    """Every ``model`` rank's block ``x`` of the last dim, concatenated
    in coordinate order; the grad summed over ``model``, this rank's
    slice of it (a reduce-scatter)."""
    ax = active()
    return _Gather.apply(x, ax.mesh, ax.index)


def join(x: torch.Tensor) -> torch.Tensor:
    """Every ``model`` rank's block ``x`` of the last dim, concatenated
    in coordinate order, joining the replicated activations (a column
    block's output); the grad, whole and the same on every rank, cut to
    this rank's slice with no sum (Megatron's gather-from-region)."""
    ax = active()
    return _Join.apply(x, ax.mesh, ax.index)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The element-wise max over ``model`` (no grad)."""
    ax = active()
    COUNTS["psums"] += 1
    COUNTS["psum_bytes"] += x.numel() * x.element_size()
    with tally(COUNTS, "psum_sent", "psum_received"):
        return ax.mesh.pmax(x.detach(), (MODEL,))

