"""Multi-process initialization, the port's device mesh and its collectives.

Counterpart of ``teaserpp_tpu/parallel/multihost.py``. A JAX mesh is a grid
of devices inside one or more processes; the port's :class:`Mesh` is a grid
of ``torch.distributed`` RANKS, one process per device, the PyTorch idiom: a
JAX single-process 8-device mesh corresponds to ``torchrun --nproc-per-node
8``. Ranks of one host are contiguous (torchrun's layout), so
:func:`make_mesh` puts the ``pairs`` axis inside a host and the ``batch``
axis across hosts, as JAX's puts ``pairs`` on a host's local devices.

The paths that run on a mesh (``parallel/batch.py::solve_batch_sharded``,
the ``mesh=`` branches of ``parallel/sharded.py`` and of ``features/``)
exchange data only through the collectives of :class:`Mesh`: all-reduce
(sum, max), all-gather along a dimension, broadcast. Each is taken over the
ranks of one axis line, through a process group made once, when the mesh is
built. Under gloo a CUDA tensor is copied to the host and back explicitly
(gloo takes host tensors only); the bytes so staged are counted in
:data:`STAGED_BYTES`. A mesh built without a process group is ``(1, 1)``
and its collectives are identities.

Two ranks may share one card only under gloo, which the caller names: NCCL
refuses that ("Duplicate GPU detected"), and :func:`initialize_distributed`
raises before it gets there. There is no silent switch of backend.
"""

from __future__ import annotations

import datetime
import socket
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Bytes that the gloo collectives copied from the card to the host and back.
STAGED_BYTES = {"to_host": 0, "to_device": 0}

# This process's place on its host, set by initialize_distributed:
# (local rank, ranks on the host).
_LOCAL: Dict[str, int] = {}

_STORE_PREFIX = "teaserpp_tpu_torch/"


def reset_staged_bytes() -> None:
    for k in STAGED_BYTES:
        STAGED_BYTES[k] = 0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join a ``torch.distributed`` world (a no-op for one process).

    ``coordinator_address`` is ``host:port`` of rank 0's store (any free port
    on a host every rank reaches); ``num_processes`` the world size;
    ``process_id`` this rank. ``backend`` is ``"nccl"`` unless named: every
    rank on a host then needs a CUDA card of its own, and this rank takes
    its local rank's card (``torch.cuda.set_device``). Ranks that share a
    card, or run on the CPU, name ``backend="gloo"``. Collectives time out
    after ``timeout_s`` seconds, so a rank that diverges fails instead of
    hanging.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a world of several processes needs coordinator_address and process_id")
    backend = "nccl" if backend is None else backend
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend nccl needs a CUDA card for every rank and this process "
            "sees none; name backend='gloo' to run on the CPU")
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout)
    name = socket.gethostname()
    store.set(f"{_STORE_PREFIX}host/{process_id}", name)
    hosts = [store.get(f"{_STORE_PREFIX}host/{r}").decode() for r in range(num_processes)]
    local = [r for r in range(num_processes) if hosts[r] == name]
    local_rank = local.index(process_id)
    if backend == "nccl":
        index = local_rank % torch.cuda.device_count()
        # a card's UUID names it across processes
        store.set(f"{_STORE_PREFIX}card/{process_id}",
                  str(torch.cuda.get_device_properties(index).uuid))
        cards = [(hosts[r], store.get(f"{_STORE_PREFIX}card/{r}").decode())
                 for r in range(num_processes)]
        store.set(f"{_STORE_PREFIX}read/{process_id}", "1")
        shared = [r for r in range(num_processes) if cards.count(cards[r]) > 1]
        if shared:  # every rank sees the same cards, so every rank raises
            if process_id == 0:  # the store lives here: up until every rank has read
                store.wait([f"{_STORE_PREFIX}read/{r}" for r in range(num_processes)])
            raise RuntimeError(
                f"ranks {shared} would share CUDA cards: NCCL refuses two ranks on "
                "one device ('Duplicate GPU detected'); give every rank a card of "
                "its own, or name backend='gloo' for ranks that share a card")
        torch.cuda.set_device(index)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _LOCAL.update(rank=local_rank, size=len(local))


def _ranks_per_host() -> int:
    """Ranks on this process's host, in a world joined here or elsewhere."""
    if _LOCAL:
        return _LOCAL["size"]
    world = dist.get_world_size()
    if world == 1:
        return 1
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return names.count(socket.gethostname())


def make_mesh(
    pairs_per_host: Optional[int] = None,
    axis_names: Tuple[str, str] = ("batch", "pairs"),
) -> "Mesh":
    """Global 2-D mesh of ranks, ``(world // pairs_per_host, pairs_per_host)``:
    ``pairs`` within each host's ranks, ``batch`` across the rest.

    ``pairs_per_host`` defaults to, and is capped at, the ranks on a host
    (JAX caps it at the local device count); it must divide the world.
    Without a process group the mesh is ``(1, 1)``, its collectives
    identities. Every rank of the world must call this, in the same order as
    any other collective.
    """
    if not dist.is_initialized():
        return Mesh(np.zeros((1, 1), np.int64), axis_names)
    world = dist.get_world_size()
    local = _ranks_per_host()
    pairs_per_host = local if pairs_per_host is None else min(pairs_per_host, local)
    if pairs_per_host < 1 or world % pairs_per_host:
        raise ValueError(
            f"pairs_per_host {pairs_per_host} does not divide the world of {world} ranks")
    return Mesh(np.arange(world).reshape(world // pairs_per_host, pairs_per_host),
                axis_names)


class Mesh:
    """A grid of ranks with named axes: the port's ``jax.sharding.Mesh``.

    ``devices`` is the numpy grid of global ranks; ``axis_names`` its axes;
    ``shape`` maps each axis name to its size (as JAX's ``mesh.shape``);
    ``coords`` maps each axis name to this rank's coordinate on it. The
    process group of this rank's line along each axis is made once, here,
    with ``new_group``: every rank of the world must build the same mesh, in
    the same order. Without a process group the grid must be ``(1, ...)``
    of rank 0 and every collective is an identity.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a {self.devices.ndim}-D grid needs as many axis names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        live = dist.is_initialized()
        self.rank = dist.get_rank() if live else 0
        world = dist.get_world_size() if live else 1
        if sorted(self.devices.ravel().tolist()) != list(range(world)):
            raise ValueError(
                f"the mesh must hold each of the world's {world} ranks once, got {self.devices}")
        where = np.argwhere(self.devices == self.rank)[0]
        self.coords = {a: int(c) for a, c in zip(self.axis_names, where)}
        self._lines: Dict[str, np.ndarray] = {}
        self._groups = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(-1, self.devices.shape[i])
            for line in lines:
                group = dist.new_group([int(r) for r in line]) if live else None
                if self.rank in line:
                    self._lines[axis] = line
                    self._groups[axis] = group

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords})"

    def _run(self, axis: str, t: torch.Tensor, op):
        """``op(host_or_card_tensor, group) -> tensor`` over ``axis``'s line,
        staging through the host under gloo."""
        group = self._groups[axis]
        backend = dist.get_backend(group)
        as_bool = t.dtype == torch.bool
        x = t.to(torch.uint8) if as_bool else t
        staged = backend == "gloo" and x.device.type != "cpu"
        if backend == "nccl" and x.device.type != "cuda":
            raise ValueError(f"an nccl collective takes CUDA tensors, got one on {x.device}")
        if staged:
            STAGED_BYTES["to_host"] += x.numel() * x.element_size()
            x = x.cpu()
        out = op(x.contiguous(), group)
        if staged:
            STAGED_BYTES["to_device"] += out.numel() * out.element_size()
            out = out.to(t.device)
        return out.bool() if as_bool else out

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Sum (``op="sum"``) or maximum (``"max"``) of ``t`` over ``axis``;
        a new tensor on ``t``'s device. Integer tensors reduce exactly."""
        if self._groups[axis] is None:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def run(x, group):
            x = x.clone()
            dist.all_reduce(x, op=red, group=group)
            return x
        return self._run(axis, t, run)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in
        coordinate order. ``sizes`` gives each coordinate's extent along
        ``dim`` where they differ (every rank knows them): the pieces are
        padded to the largest for the collective and cut after it."""
        if self._groups[axis] is None:
            return t
        p = self.shape[axis]
        sizes = [t.shape[dim]] * p if sizes is None else list(sizes)
        if len(sizes) != p or sizes[self.coords[axis]] != t.shape[dim]:
            raise ValueError(f"sizes {sizes} do not fit a piece of {t.shape[dim]} on {axis}")
        top = max(sizes)

        def run(x, group):
            if x.shape[dim] < top:
                pad = list(x.shape)
                pad[dim] = top - x.shape[dim]
                x = torch.cat([x, x.new_zeros(pad)], dim=dim)
            parts = [torch.empty_like(x) for _ in range(p)]
            dist.all_gather(parts, x, group=group)
            return torch.cat([q.narrow(dim, 0, s) for q, s in zip(parts, sizes)], dim=dim)
        return self._run(axis, t, run)

    def broadcast(self, t: torch.Tensor, axis: str, src: int = 0) -> torch.Tensor:
        """``t`` of the rank at coordinate ``src`` on ``axis``, on every rank
        of the line; the other ranks pass a tensor of the same shape and
        dtype (its values are ignored)."""
        if self._groups[axis] is None:
            return t
        root = int(self._lines[axis][src])

        def run(x, group):
            x = x.clone()
            dist.broadcast(x, src=root, group=group)
            return x
        return self._run(axis, t, run)


def require_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` if it is ``None`` or a port :class:`Mesh`, else ``TypeError``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a teaserpp_tpu_torch.parallel.multihost.Mesh (make_mesh), "
            f"got {type(mesh).__name__}")
    return mesh


def shard_range(total: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of share ``index`` of ``total`` items cut into ``parts``
    contiguous shares of ``ceil(total / parts)`` (the last ones may be short
    or empty): JAX's block layout of an axis sharded ``P(axis)``."""
    per = -(-total // parts)
    lo = min(index * per, total)
    return lo, min(lo + per, total)
