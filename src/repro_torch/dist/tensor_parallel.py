"""Tensor- and expert-parallel compute on the ``model`` blocks of the
parameters: what JAX's partitioner derives from the ``tp`` specs of
``repro.dist.sharding`` under ``jax.jit(in_shardings=...)``, written out
for the port's step on blocks (``repro_torch.dist.spmd``).

:func:`plan` works out, once, from the parameter specs and the config,
which leaves a rank computes with on its ``model`` block (gathered over
``data`` only) and which it gathers whole, each with its reason.  A leaf
keeps its block only where the block holds whole units of a layer that
has a rule here:

  * GQA attention: whole query heads with whole KV groups (the query and
    KV head counts both divide by the ``model`` size); ``wq``/``wk``/
    ``wv`` are column blocks (this rank's heads), ``wo`` a row block
    whose partial output is summed over ``model``;
  * a SwiGLU MLP (dense layers, the RG-LRU blocks' MLPs, shared experts):
    ``wi``/``wg`` column blocks of ``d_ff``, ``wo`` a row block;
  * routed experts: whole experts (E over ``model``: expert parallelism);
  * the vocabulary: the embedding's rows and the head's columns.

Everything else is gathered whole, as are MLA attention, Mamba2, the
RG-LRU, the frontends and the MTP head ("not ported"), the router (every
rank routes every token) and conv kernels (``dist.conv_parallel`` cuts
them itself).

Inside :func:`model_axis` (the step enters it around its forward and
backward), a layer that finds a block where its config says whole units
(:func:`is_block`) computes its share with Megatron's two operators, in
``Mesh.psum``'s fixed order so that every ``model`` rank holds the same
bits: :func:`enter` (identity forward, psum of the grad backward) where
replicated activations meet the block, and :func:`leave` (psum forward,
identity backward) where the block's partial output rejoins them.  Every
``model`` rank computes the same loss from the same inputs, so a
replicated parameter's grad is whole on every rank and a kept leaf's is
its block.  :data:`COUNTS` counts the model psums and their bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.dist.sharding import P, from_local, local_block
from repro_torch.tree import tree_leaves, tree_unflatten

MODEL = "model"

#: the model psums of this process: ``enter`` (backward), ``leave``
#: (forward) and ``pmax`` calls, and the bytes they summed.
COUNTS = {"psums": 0, "psum_bytes": 0}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's compute: on its ``model`` block (``keep``) or
    gathered whole, and why."""

    keep: bool
    why: str


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


def _only_model(spec) -> P:
    return P(*(MODEL if e is not None and MODEL in (
        e if isinstance(e, tuple) else (e,)) else None for e in spec))


#: a SwiGLU MLP's (or an expert stack's) weights.
_SWIGLU = ("wi", "wg", "wo")


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
        return Leaf(False, "not ported: the frontend")
    if top == "mtp":
        return Leaf(False, "not ported: the MTP head")
    if "ssm" in path:
        return Leaf(False, "not ported: Mamba2 (in_proj's z/x/B/C/dt "
                           "segments do not align with column blocks)")
    if "rec" in path:
        return Leaf(False, "not ported: the RG-LRU")
    unit, name = (path[-3], path[-2]) if len(path) >= 3 and \
        path[-1] == "w" else (None, None)
    if unit == "attn" and cfg.use_mla:
        return Leaf(False, "not ported: MLA attention")
    if unit == "attn" and name in ("wq", "wk", "wv", "wo"):
        h, hk = cfg.n_heads, cfg.n_kv_heads
        if h % m or hk % m:
            return Leaf(False, f"{h} query heads and {hk} KV heads do not "
                               f"both divide by model={m}")
        return Leaf(True, f"heads, {h // m} of {h} (KV {hk // m} of {hk})")
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
        """The specs the step gathers by: a kept leaf's without
        ``model``."""
        return tree_unflatten(self.specs, [
            _drop_model(s) if leaf.keep else s for s, leaf in
            zip(tree_leaves(self.specs), tree_leaves(self.tree))])

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
        rank computes with in a step: a kept leaf's ``model`` block, every
        other leaf whole."""
        return sum(t.numel() * t.element_size() // (self.size if k else 1)
                   for t, k in zip(tree_leaves(params), self.kept))

    def axis(self):
        """The context the step's forward and backward run in: the
        ``model`` axis where a leaf is kept, else nothing."""
        if not any(self.kept):
            return contextlib.nullcontext()
        return model_axis(self.mesh, self.vocab)

    def widen(self, grads):
        """Each kept leaf's block put back together over ``model``."""
        return tree_unflatten(grads, [
            from_local(g, _only_model(s), self.mesh) if k else g
            for g, s, k in zip(tree_leaves(grads),
                               tree_leaves(self.specs), self.kept)])

    def narrow(self, grads):
        """:meth:`widen` undone: each kept leaf's ``model`` block."""
        return tree_unflatten(grads, [
            local_block(g, _only_model(s), self.mesh).contiguous() if k
            else g for g, s, k in zip(tree_leaves(grads),
                                      tree_leaves(self.specs), self.kept)])


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
    """The norm of the whole grads from this rank's: each kept leaf's
    block once (its squares summed over ``model``), each replicated leaf
    once."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    blocks = sum((s for s, k in zip(sq, plan.kept) if k), zero)
    whole = sum((s for s, k in zip(sq, plan.kept) if not k), zero)
    blocks = plan.mesh.psum(blocks.reshape(1), (MODEL,))[0]
    return torch.sqrt(blocks + whole)


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


def enter(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every ``model`` rank) into a block's compute:
    the identity; its grad summed over ``model``."""
    return _Enter.apply(x, active().mesh)


def leave(x: torch.Tensor) -> torch.Tensor:
    """A block's partial ``x`` summed over ``model``; the grad passes
    unchanged to every rank's block."""
    return _Leave.apply(x, active().mesh)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The element-wise max over ``model`` (no grad)."""
    ax = active()
    COUNTS["psums"] += 1
    COUNTS["psum_bytes"] += x.numel() * x.element_size()
    return ax.mesh.pmax(x.detach(), (MODEL,))

