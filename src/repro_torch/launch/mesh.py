"""The device mesh of the port (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` carries the ordered axis names and sizes (``.shape``, the
mapping the planners read, as JAX's ``mesh.shape``).  A mesh made while a
``torch.distributed`` process group is up also carries the
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks, laid
out row-major (rank ``r`` sits at ``unravel(r, sizes)``): from it come
each axis's process group and this rank's coordinate, and the collectives
the mesh-parallel conv (``repro_torch.dist.conv_parallel``) runs over an
axis.  A mesh without one is abstract: it plans, and runs only where
every axis has size 1.

    make_production_mesh(multi_pod=False)   # (16, 16) ("data", "model")
    make_production_mesh(multi_pod=True)    # (2, 16, 16) ("pod", ...)
    make_host_mesh()                        # (world, 1) ("data", "model")

The production meshes have no devices: they are for the dry run
(``repro_torch.launch.dryrun``).  ``make_host_mesh`` is the process world,
``(1, 1)`` when no process group is up.

The backend follows from the layout (:func:`backend_for`): ``nccl`` when
each rank has a card of its own, ``gloo`` when ranks share a card or run
on the CPU.  Under ``gloo`` a CUDA tensor is copied to the host before a
collective and back after it (:meth:`Mesh.stage`, the one place that
does), so the kernels run on the card in every rank and only the
transport is on the host.

:meth:`Mesh.psum_scatter` is JAX's ``psum_scatter`` (the leading dim
cut into one block a member, tiled): each rank sends every other member of
the axis the block that member owns (one ``all_to_all``), and the owner
adds the parts in the axis's coordinate order, starting from part 0.
:meth:`Mesh.psum` is that followed by an ``all_gather`` of the blocks, so
every rank of an axis holds the same bits, whatever the backend's own
reduction order, and each element is the sum a gather of every rank's
whole tensor followed by an add in coordinate order gives, at about half
the bytes a rank receives (the tensor-parallel layers' sums over
``model`` too, ``repro_torch.dist.tensor_parallel``; :meth:`Mesh.pmax`
their max).  :meth:`Mesh.psum_scatter_flat` does so for a list of tensors
through one buffer a dtype, a chunk at a time, each tensor either cut to
this rank's block along a dim or summed whole (the train step's grads);
:meth:`Mesh.psum_flat` is its whole form over several axes.
:meth:`Mesh.broadcast` copies one rank's tensors along an axis, and
:meth:`Mesh.scatter` sends each member only its block of them.
:data:`WIRE` counts the bytes this process's collectives sent to and
received from other ranks, and :func:`tally` adds what a stretch of code
moved to a caller's counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import torch
import torch.distributed as dist

#: :meth:`Mesh.psum_flat` and :meth:`Mesh.psum_scatter_flat` sum their
#: buffers in chunks of this many bytes.
PSUM_CHUNK_BYTES = 1 << 28

#: the bytes this process's collectives sent to and received from other
#: ranks (a rank's own block, which no collective moves, is not counted;
#: a block one rank sends to several counts once a receiver).
WIRE = {"sent": 0, "received": 0}


def _wire(sent: int, received: int) -> None:
    WIRE["sent"] += sent
    WIRE["received"] += received


@contextlib.contextmanager
def tally(counts: dict, sent: str, received: str):
    """Add the bytes the collectives inside send and receive
    (:data:`WIRE`) to ``counts[sent]`` and ``counts[received]``."""
    s0, r0 = WIRE["sent"], WIRE["received"]
    try:
        yield
    finally:
        counts[sent] += WIRE["sent"] - s0
        counts[received] += WIRE["received"] - r0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ordered axes ``axis_names`` of sizes ``axis_sizes``; with a live
    process group, its ``device_mesh`` and the ``backend`` its collectives
    run on.  ``with mesh:`` makes it the mesh a ``conv_mesh`` without an
    explicit one lowers onto (JAX's ambient ``with mesh:``)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_mesh: object = None
    backend: str | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        """``"16x16"``: the report name of the dry run."""
        return "x".join(str(s) for s in self.axis_sizes)

    def __repr__(self) -> str:
        live = f", backend={self.backend}" if self.device_mesh else ""
        return f"Mesh({self.shape}{live})"

    def __enter__(self) -> "Mesh":
        from repro_torch.dist import constraints
        constraints._ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.dist import constraints
        constraints._ACTIVE.remove(self)

    # -- coordinates -------------------------------------------------------

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.shape[axis] == 1:
            return 0
        if self.device_mesh is None:
            raise RuntimeError(f"{self!r} is abstract: it plans, it does "
                               f"not run a sharded axis")
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank_at(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis``, this rank's
        coordinate on every other axis."""
        coord = [self.coordinate(a) for a in self.axis_names]
        coord[self.axis_names.index(axis)] = index
        rank = 0
        for c, s in zip(coord, self.axis_sizes):
            rank = rank * s + c
        return rank

    # -- collectives (host-staged under gloo) ------------------------------

    def _staging(self, device) -> torch.device:
        """Where a collective's buffers live: the host for a CUDA tensor
        under ``gloo``, which has no card transport here."""
        device = torch.device(device)
        if self.backend == "gloo" and device.type == "cuda":
            return torch.device("cpu")
        return device

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective sends: a CUDA tensor is copied to the
        host under ``gloo``."""
        t = t.contiguous()
        return t.to(self._staging(t.device))

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """The blocks of every rank along ``axis`` concatenated on
        ``dim`` in coordinate order."""
        j = self.coordinate(axis)
        parts = self._gather(t, axis)
        return torch.cat([t if i == j else p.to(t.device)
                          for i, p in enumerate(parts)], dim)

    def psum_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """JAX's ``psum_scatter(t, axis, scatter_dimension=0,
        tiled=True)``: ``t`` summed over the ranks of ``axis``, this rank's
        block of its leading dim (member ``j`` owns rows ``[j c, (j + 1)
        c)``, ``c`` the rows over the axis size rounded up; a length that
        does not divide is padded with zeros, and the padding cut off
        again).  The owner adds the parts in coordinate order, as
        :meth:`psum` does."""
        n = self.shape[axis]
        if n == 1:
            return t.clone()
        rows = t.shape[0]
        c = -(-rows // n)
        j = self.coordinate(axis)
        own = self._reduce_rows(_pad_rows(t, n * c).view(n, c, *t.shape[1:]),
                                axis)
        return own[:max(0, min(rows, (j + 1) * c) - j * c)]

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes`` (one axis after the
        other), added in coordinate order on ``t``'s device: along each
        axis, :meth:`psum_scatter` of the flat tensor, then an
        ``all_gather`` of the blocks, so every rank ends with the same
        bits."""
        for axis in axes:
            n = self.shape[axis]
            if n == 1 or t.numel() == 0:
                t = t.clone()
                continue
            flat = t.reshape(-1)
            c = -(-flat.numel() // n)
            own = self._reduce_rows(_pad_rows(flat, n * c).view(n, c), axis)
            t = self._gather_rows(own, axis).view(-1)[:flat.numel()] \
                .view(t.shape)
        return t

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The element-wise max of ``t`` over the ranks of ``axes``."""
        for axis in axes:
            t = torch.stack([p.to(t.device)
                             for p in self._gather(t, axis)]).amax(0)
        return t

    def _gather(self, t: torch.Tensor, axis: str) -> list[torch.Tensor]:
        st = self.stage(t)
        n = self.shape[axis]
        parts = [torch.empty_like(st) for _ in range(n)]
        dist.all_gather(parts, st, group=self.group(axis))
        nbytes = st.numel() * st.element_size()
        _wire((n - 1) * nbytes, (n - 1) * nbytes)
        return parts

    def _gather_rows(self, own: torch.Tensor, axis: str) -> torch.Tensor:
        """``(n, *own.shape)``: every member's ``own`` in coordinate order
        on ``own``'s device (this rank's from ``own`` itself)."""
        j = self.coordinate(axis)
        out = own.new_empty((self.shape[axis], *own.shape))
        for i, p in enumerate(self._gather(own, axis)):
            out[i].copy_(own if i == j else p)
        return out

    def _all_to_all(self, pieces, sizes, axis: str, like: torch.Tensor):
        """One ``all_to_all`` along ``axis``: ``pieces[i]`` (a tensor, or
        None for nothing) goes to member ``i``, and ``sizes[i]`` elements
        come from member ``i``; this rank's own slot is neither sent nor
        received.  Only what is sent is staged.  Returns the flat pieces
        received, on the staging device (None for this rank's slot)."""
        n, j = self.shape[axis], self.coordinate(axis)
        where = self._staging(like.device)
        send_sizes = [0 if i == j or p is None else p.numel()
                      for i, p in enumerate(pieces)]
        recv_sizes = [0 if i == j else int(k) for i, k in enumerate(sizes)]
        send = torch.empty(sum(send_sizes), dtype=like.dtype, device=where)
        at = 0
        for k, p in zip(send_sizes, pieces):
            if k:
                send[at:at + k].view(p.shape).copy_(p)
                at += k
        recv = torch.empty(sum(recv_sizes), dtype=like.dtype, device=where)
        dist.all_to_all_single(recv, send, recv_sizes, send_sizes,
                               group=self.group(axis))
        _wire(send.numel() * send.element_size(),
              recv.numel() * recv.element_size())
        out = list(torch.split(recv, recv_sizes))
        out[j] = None
        return out

    def _reduce_rows(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Row ``i`` of ``t`` (its leading dim the axis size) belongs to
        member ``i``: this rank's row summed over the members, the parts
        added in coordinate order from part 0 on ``t``'s device."""
        j = self.coordinate(axis)
        got = self._all_to_all(list(t), [t[0].numel()] * t.shape[0], axis,
                               t)
        parts = [t[j] if i == j else p.view(t.shape[1:])
                 for i, p in enumerate(got)]
        out = parts[0].to(t.device, copy=True)
        for p in parts[1:]:
            out.add_(p.to(t.device))
        return out

    def permute(self, sends, axis: str) -> list[torch.Tensor]:
        """One exchange along ``axis``: ``sends`` is a list of ``(tensor,
        offset)``; each rank ``j`` sends its tensor to ``j + offset`` and
        receives the one ``j - offset`` sent, or zeros where no rank
        sends (JAX's ``ppermute``).  Every send and receive of the list
        goes in one ``batch_isend_irecv``."""
        j, n = self.coordinate(axis), self.shape[axis]
        ops, recvs = [], []
        for tag, (t, off) in enumerate(sends):
            st = self.stage(t)
            buf = torch.zeros_like(st)
            if 0 <= j + off < n:
                ops.append(dist.P2POp(dist.isend, st,
                                      self.rank_at(axis, j + off), tag=tag))
            if 0 <= j - off < n:
                ops.append(dist.P2POp(dist.irecv, buf,
                                      self.rank_at(axis, j - off), tag=tag))
            recvs.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for b, (_, off) in zip(recvs, sends):
            nbytes = b.numel() * b.element_size()
            _wire(nbytes if 0 <= j + off < n else 0,
                  nbytes if 0 <= j - off < n else 0)
        return [b.to(t.device) for b, (t, _) in zip(recvs, sends)]

    def psum_flat(self, tensors: list[torch.Tensor],
                  axes) -> list[torch.Tensor]:
        """:meth:`psum` of every tensor of the list (one axis after the
        other), through one flat buffer per dtype, ``PSUM_CHUNK_BYTES``
        at a time (:meth:`psum_scatter_flat` with every tensor whole; the
        same sums, and no second whole buffer on the device): new
        tensors, in the list's order."""
        for axis in axes:
            tensors = self.psum_scatter_flat(tensors, axis,
                                             [None] * len(tensors))
        return list(tensors)

    def psum_scatter_flat(self, tensors: list[torch.Tensor], axis: str,
                          dims) -> list[torch.Tensor]:
        """Every tensor of the list summed over the ranks of ``axis``:
        where ``dims[i]`` is a dim, only this rank's block of it along
        that dim (JAX's ``psum_scatter`` on it, tiled; the dim must
        divide), where it is None the whole sum.  Per dtype, the cut
        tensors go in groups of about ``PSUM_CHUNK_BYTES``, each laid out
        by owner (row ``i`` every tensor's block ``i``), and the whole
        ones as one flat buffer padded to a multiple of the axis size,
        its row ``i`` member ``i``'s share, built a chunk at a time; each
        member receives only its own row of every rank's
        (:meth:`_reduce_rows`) and adds the parts in coordinate order,
        and the shares of the whole tensors are gathered back.  So no
        second whole copy of the tensors sits on the device.  New
        tensors, in the list's order, with :meth:`psum`'s bits."""
        n = self.shape[axis]
        if n == 1:
            return list(tensors)
        out: list = [None] * len(tensors)
        for idx in _by_dtype(tensors).values():
            cut = [i for i in idx if dims[i] is not None]
            whole = [i for i in idx if dims[i] is None]
            for group in _groups([tensors[i] for i in cut], cut):
                ts, ds = [tensors[i] for i in group], [dims[i] for i in group]
                own = self._reduce_chunks(_owner_rows(ts, ds, n), axis)
                for i, part in zip(group, _split(own, _block_shapes(ts, ds,
                                                                    n))):
                    out[i] = part
            if whole:
                ws = [tensors[i] for i in whole]
                c = -(-sum(t.numel() for t in ws) // n)
                # The sums' buffer holds this rank's share as it is reduced,
                # then every member's, gathered in place.
                sums = ws[0].new_empty((n, c))
                j = self.coordinate(axis)
                for a, b in _chunk_ranges(n, c, ws[0].element_size()):
                    rows = ws[0].new_zeros((n, b - a))
                    for r in range(n):
                        _copy_flat(ws, r * c + a, r * c + b, rows[r])
                    sums[j, a:b] = self._reduce_rows(rows, axis)
                    del rows
                for a, b in _chunk_ranges(n, c, ws[0].element_size()):
                    sums[:, a:b] = self._gather_rows(sums[j, a:b], axis)
                for i, part in zip(whole, _split(sums.view(-1),
                                                 [t.shape for t in ws])):
                    out[i] = part
        return out

    def _reduce_chunks(self, rows: torch.Tensor, axis: str) -> torch.Tensor:
        """:meth:`_reduce_rows` of ``rows`` (n, width), a chunk of columns
        at a time."""
        own = rows.new_empty(rows.shape[1])
        for a, b in _chunk_ranges(*rows.shape, rows.element_size()):
            own[a:b] = self._reduce_rows(rows[:, a:b], axis)
        return own

    def broadcast(self, tensors: list[torch.Tensor], axis: str,
                  index: int = 0) -> None:
        """Overwrite ``tensors`` in place with those of the rank at
        coordinate ``index`` along ``axis`` (this rank's coordinate on
        every other axis), one flat buffer per dtype."""
        root = self.rank_at(axis, index)
        me = self.coordinate(axis) == index
        n = self.shape[axis]
        for idx in _by_dtype(tensors).values():
            flat = self.stage(torch.cat([tensors[i].reshape(-1)
                                         for i in idx]))
            dist.broadcast(flat, src=root, group=self.group(axis))
            nbytes = flat.numel() * flat.element_size()
            _wire((n - 1) * nbytes if me else 0, 0 if me else nbytes)
            if not me:
                for i, part in zip(idx, _split(flat, [tensors[i].shape
                                                       for i in idx])):
                    tensors[i].copy_(part)

    def scatter(self, tensors: list[torch.Tensor], axis: str, dims,
                index: int = 0) -> list[torch.Tensor]:
        """This rank's block, along ``dims[i]``, of each tensor of the rank
        at coordinate ``index`` along ``axis``: the root sends each member
        only that member's blocks (one ``all_to_all`` per dtype), and
        keeps its own; in groups of about ``PSUM_CHUNK_BYTES``.  New
        tensors, in the list's order."""
        n, j = self.shape[axis], self.coordinate(axis)
        out: list = [None] * len(tensors)
        for idx in _by_dtype(tensors).values():
            for group in _groups([tensors[i] for i in idx], idx):
                ts, ds = [tensors[i] for i in group], [dims[i] for i in group]
                shapes = _block_shapes(ts, ds, n)
                if j == index:
                    rows = _owner_rows(ts, ds, n)
                    self._all_to_all(list(rows), [0] * n, axis, rows)
                    own = rows[j].clone()
                    del rows
                else:
                    width = sum(math.prod(s) for s in shapes)
                    got = self._all_to_all([None] * n, [
                        width if i == index else 0 for i in range(n)],
                        axis, ts[0])
                    own = got[index].to(ts[0].device)
                for i, part in zip(group, _split(own, shapes)):
                    out[i] = part
        return out

    def barrier(self) -> None:
        if self.device_mesh is not None:
            dist.barrier()


def _by_dtype(tensors) -> dict:
    """dtype -> the indices of ``tensors`` of that dtype, in order."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def _chunk_ranges(n: int, width: int, element_size: int):
    """``[a, b)`` column ranges of an ``(n, width)`` buffer, each about
    ``PSUM_CHUNK_BYTES``."""
    step = max(1, PSUM_CHUNK_BYTES // (n * element_size))
    return [(a, min(a + step, width)) for a in range(0, width, step)]


def _groups(tensors, keys) -> list[list]:
    """``keys`` (one a tensor) in order, cut into runs whose tensors hold
    about ``PSUM_CHUNK_BYTES`` together (a larger tensor alone)."""
    out, run, held = [], [], 0
    for t, k in zip(tensors, keys):
        nbytes = t.numel() * t.element_size()
        if run and held + nbytes > PSUM_CHUNK_BYTES:
            out.append(run)
            run, held = [], 0
        run.append(k)
        held += nbytes
    return out + [run] if run else out


def _copy_flat(tensors, start: int, stop: int, out: torch.Tensor) -> None:
    """Elements ``[start, stop)`` of the tensors flattened and laid end to
    end, copied into the front of ``out`` (past their end, ``out`` keeps
    what it holds)."""
    at = 0
    for t in tensors:
        k = t.numel()
        lo, hi = max(start, at), min(stop, at + k)
        if lo < hi:
            out[lo - start:hi - start].copy_(t.reshape(-1)[lo - at:hi - at])
        at += k


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows`` leading rows."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


def _block_shapes(tensors, dims, n: int) -> list[torch.Size]:
    """The shape of a block of each tensor cut into ``n`` along its dim."""
    shapes = []
    for t, d in zip(tensors, dims):
        d %= t.dim()
        if t.shape[d] % n:
            raise ValueError(f"a tensor of {t.shape[d]} along dim {d} "
                             f"does not cut into {n} blocks")
        shapes.append(t.shape[:d] + (t.shape[d] // n,) + t.shape[d + 1:])
    return shapes


def _owner_rows(tensors, dims, n: int) -> torch.Tensor:
    """``(n, width)``: row ``i`` every tensor's block ``i`` along its dim,
    flat and in the list's order."""
    shapes = _block_shapes(tensors, dims, n)
    rows = tensors[0].new_empty((n, sum(math.prod(s) for s in shapes)))
    at = 0
    for t, d, shape in zip(tensors, dims, shapes):
        d %= t.dim()
        k = math.prod(shape)
        src = t.unflatten(d, (n, t.shape[d] // n)).movedim(d, 0)
        rows[:, at:at + k].view(n, *src.shape[1:]).copy_(src)
        at += k
    return rows


def _split(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    """``flat`` cut into tensors of ``shapes``, in order."""
    out, start = [], 0
    for shape in shapes:
        k = math.prod(shape)
        out.append(flat[start:start + k].view(shape))
        start += k
    return out


def backend_for(device, local_world: int) -> str:
    """``nccl`` when each of the ``local_world`` ranks of this host has a
    card of its own, ``gloo`` when they share one or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def env_world() -> int:
    """The world size ``torch.distributed.run`` set, 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device, init_method: str = "env://", rank=None,
                     world_size=None, local_world=None) -> torch.device:
    """Start the process group (the environment of
    ``torch.distributed.run`` by default) on the backend the layout asks
    for, and return this rank's device: ``cuda:LOCAL_RANK`` under
    ``nccl``, ``device`` itself otherwise.  A group already up is kept."""
    dev = torch.device(device)
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = env_world() if world_size is None else world_size
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend_for(dev, local_world)
    if backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
        if rank == 0:
            print(f"[mesh] process group: {world_size} ranks on {backend} "
                  f"({dev.type}"
                  + (", host-staged" if backend == "gloo"
                     and dev.type == "cuda" else "") + ")", flush=True)
    return dev


def make_mesh(shape, axis_names) -> Mesh:
    """A mesh of ``shape`` over the process world (row-major ranks), or an
    abstract one when no process group is up."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if not dist.is_initialized():
        return Mesh(axis_names, shape)
    from torch.distributed.device_mesh import init_device_mesh
    backend = dist.get_backend()
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=axis_names)
    return Mesh(axis_names, shape, dm, backend)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16), 256 chips.  Multi-pod: (pod=2,
    data=16, model=16), the ``pod`` axis pure data parallelism.  Abstract:
    for planning."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """The process world as ``(world, 1)`` ``("data", "model")``; ``(1,
    1)`` when no process group is up."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n, 1), ("data", "model"))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """End the process group, when one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
