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

:meth:`Mesh.psum` sums in a fixed order (every member's block gathered,
then added in the axis's coordinate order), so every rank of an axis holds
the same bits, whatever the backend's own reduction order (the
tensor-parallel layers' sums over ``model`` too,
``repro_torch.dist.tensor_parallel``; :meth:`Mesh.pmax` their max);
:meth:`Mesh.psum_flat` does so for a list of tensors through one buffer a
dtype, a chunk at a time (the train step's grads), and
:meth:`Mesh.broadcast` copies one rank's tensors along an axis.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

#: :meth:`Mesh.psum_flat` sums its buffers in chunks of this many bytes.
PSUM_CHUNK_BYTES = 1 << 28


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

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective sends: a CUDA tensor is copied to the
        host under ``gloo``, which has no card transport here."""
        t = t.contiguous()
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu()
        return t

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """The blocks of every rank along ``axis`` concatenated on
        ``dim`` in coordinate order."""
        parts = self._gather(t, axis)
        return torch.cat([p.to(t.device) for p in parts], dim)

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes`` (one axis after the
        other), added in coordinate order on ``t``'s device: every rank
        ends with the same bits."""
        for axis in axes:
            parts = self._gather(t, axis)
            t = parts[0].to(t.device)
            for p in parts[1:]:
                t.add_(p.to(t.device))
        return t

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The element-wise max of ``t`` over the ranks of ``axes``."""
        for axis in axes:
            t = torch.stack([p.to(t.device)
                             for p in self._gather(t, axis)]).amax(0)
        return t

    def _gather(self, t: torch.Tensor, axis: str) -> list[torch.Tensor]:
        st = self.stage(t)
        parts = [torch.empty_like(st) for _ in range(self.shape[axis])]
        dist.all_gather(parts, st, group=self.group(axis))
        return parts

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
        return [b.to(t.device) for b, (t, _) in zip(recvs, sends)]

    def psum_flat(self, tensors: list[torch.Tensor],
                  axes) -> list[torch.Tensor]:
        """:meth:`psum` of every tensor of the list, through one flat
        buffer per dtype, summed ``PSUM_CHUNK_BYTES`` at a time in place
        (the same sums; no second whole buffer on the device): new
        tensors, in the list's order."""
        out: list = [None] * len(tensors)
        for idx in _by_dtype(tensors).values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            step = max(1, PSUM_CHUNK_BYTES // flat.element_size())
            for start in range(0, flat.numel(), step):
                chunk = flat[start:start + step]
                chunk.copy_(self.psum(chunk, axes))
            for i, part in zip(idx, _split(flat, [tensors[i] for i in idx])):
                out[i] = part
        return out

    def broadcast(self, tensors: list[torch.Tensor], axis: str,
                  index: int = 0) -> None:
        """Overwrite ``tensors`` in place with those of the rank at
        coordinate ``index`` along ``axis`` (this rank's coordinate on
        every other axis), one flat buffer per dtype."""
        root = self.rank_at(axis, index)
        for idx in _by_dtype(tensors).values():
            flat = self.stage(torch.cat([tensors[i].reshape(-1)
                                         for i in idx]))
            dist.broadcast(flat, src=root, group=self.group(axis))
            for i, part in zip(idx, _split(flat, [tensors[i] for i in idx])):
                tensors[i].copy_(part)

    def barrier(self) -> None:
        if self.device_mesh is not None:
            dist.barrier()


def _by_dtype(tensors) -> dict:
    """dtype -> the indices of ``tensors`` of that dtype, in order."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def _split(flat: torch.Tensor, like) -> list[torch.Tensor]:
    """``flat`` cut into tensors of the shapes of ``like``, in order."""
    out, start = [], 0
    for t in like:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
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
