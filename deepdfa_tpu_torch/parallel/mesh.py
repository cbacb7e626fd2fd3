"""Device meshes over ``torch.distributed``.

The port of ``deepdfa_tpu/parallel/mesh.py``. Axes keep the JAX package's
names and order (``dp``, ``fsdp``, ``tp``, ``sp``), and devices fill the
mesh in the JAX package's order: device ``i`` of the list sits at the
row-major index ``i`` of the ``(dp, fsdp, tp, sp)`` shape, so the
fastest-varying axes (``tp``, ``sp``) hold neighbouring devices. A
:class:`Mesh` maps itself onto a process group (NCCL on CUDA, gloo on the
CPU and for ranks that share one card), each process holding the slots of
its own rank.

- ``dp`` alone: the GGNN's data parallelism (:mod:`.dp`) and replicated
  engine. A mesh without a group (:func:`local_mesh`) keeps every slot in
  this process: the engine's replicas, or several ``dp`` slots of the CPU
  in one process (the CPU may be named more than once, as the JAX
  package's tests name its host devices).
- ``fsdp``, ``tp``, ``sp`` shard the LLM (:mod:`deepdfa_tpu_torch.llm.
  llama`), one device per rank: the mesh then holds a process group per
  axis line through this rank (``groups``), made over the ranks of the
  mesh's group.

Nothing tells a process of a cluster: :func:`initialize_multihost` takes
the world size, the rank and a store or an address explicitly.
"""

from __future__ import annotations

import dataclasses
import logging
from datetime import timedelta

import numpy as np
import torch

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import MeshConfig
from deepdfa_tpu_torch.resilience import faults

AXES = ("dp", "fsdp", "tp", "sp")

__all__ = ["AXES", "DeviceLost", "Mesh", "build_mesh", "initialize_multihost",
           "local_mesh", "probed_devices"]

logger = logging.getLogger(__name__)

_WORLD = object()  # build_mesh's default group: the initialised world


class DeviceLost(RuntimeError):
    """This process's devices left the mesh (``mesh.device_lost``): the
    surviving ranks built a smaller one without it."""


@dataclasses.dataclass
class Mesh:
    """``devices`` fill the ``(dp, fsdp, tp, sp)`` shape in row-major order
    (with ``dp`` alone, ``devices[j]`` runs ``dp`` slot ``j``). ``group`` is
    the process group the slots are spread over (None: this process holds
    every slot); ``rank`` and ``world`` are this process's place in it.
    Rank ``r`` holds the slots ``local_slots``, an equal consecutive share.
    ``groups`` maps each axis longer than 1 to the process group of this
    rank's line along it (a mesh that shards the LLM, one device per
    rank)."""

    devices: tuple
    axes: dict
    group: object = None
    rank: int = 0
    world: int = 1
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_slots(self) -> range:
        per = len(self.devices) // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def device(self) -> torch.device:
        """The device of this process's first slot."""
        return self.devices[self.local_slots.start]

    @property
    def coords(self) -> dict[str, int]:
        """This process's first slot's place on each axis."""
        shape = tuple(self.axes[a] for a in AXES)
        return dict(zip(AXES, (int(i) for i in np.unravel_index(
            self.local_slots.start, shape))))

    @property
    def shards_llm(self) -> bool:
        """Whether an axis that shards the LLM (``fsdp``, ``tp``, ``sp``)
        is longer than 1."""
        return any(self.axes[a] > 1 for a in AXES[1:])

    def block(self, length: int, axis: str, what: str = "a dimension"
              ) -> slice:
        """This process's contiguous block of ``length`` split over
        ``axis``; ``ValueError`` when it does not split evenly."""
        n = self.axes[axis]
        if length % n:
            raise ValueError(f"{what} of {length} does not split over "
                             f"{axis}={n}")
        per = length // n
        i = self.coords[axis]
        return slice(i * per, (i + 1) * per)

    @property
    def replica_devices(self) -> tuple:
        """The first device of each ``dp`` slot: where a replicated model
        (the GGNN engine) runs, as the JAX package's shard-map over ``dp``
        places it."""
        return self.devices[:: len(self.devices) // self.axes["dp"]]


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank_devices(group) -> list[torch.device]:
    """One device per rank of ``group``: ``cuda:r`` (modulo the local
    cards) under NCCL, the CPU under gloo."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        n = torch.cuda.device_count()
        return [torch.device("cuda", r % n) for r in range(world)]
    return [torch.device("cpu")] * world


def build_mesh(cfg: MeshConfig, devices=None, group=_WORLD) -> Mesh:
    """The named mesh over ``devices`` (default: one per rank of the
    initialised process group, else every local card, else the CPU).

    ``group``: the process group the ``dp`` slots are spread over (default:
    the initialised world, if any); ``None`` keeps every slot in this
    process. The ``mesh.device_lost`` fault point halves the device list, a
    lost host: the surviving half builds the mesh (a ``dp=-1`` config
    absorbs the shrink) over a new group of the ranks that hold it, which
    every rank creates; a rank left outside raises :class:`DeviceLost`.
    The elastic resume (:mod:`deepdfa_tpu_torch.parallel.elastic`) carries
    a run across. A mesh whose ``fsdp``, ``tp`` or ``sp`` is longer than 1
    takes one device per rank of the whole world, and every rank makes the
    process groups of its axis lines (``Mesh.groups``), so every rank
    builds it."""
    import torch.distributed as dist

    if group is _WORLD:
        group = dist.group.WORLD if _initialized() else None
    if devices is None:
        if group is not None:
            devices = _rank_devices(group)
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    world = dist.get_world_size(group) if group is not None else 1
    if len(devices) % world:
        raise ValueError(f"{len(devices)} devices do not divide over "
                         f"{world} ranks")
    per = len(devices) // world
    if faults.fire("mesh.device_lost"):
        survivors = max(1, len(devices) // 2)
        logger.warning("injected mesh.device_lost: %d of %d devices survive",
                       survivors, len(devices))
        devices = devices[:survivors]
        if group is not None:
            ranks = sorted({j // per for j in range(survivors)})
            members = [dist.get_global_rank(group, r) for r in ranks]
            me = dist.get_rank(group)
            group = dist.new_group(members)
            if me not in ranks:
                raise DeviceLost(f"rank {me} lost its devices")
            world = len(ranks)
            if survivors % world:
                raise ValueError(f"{survivors} surviving devices do not "
                                 f"divide over {world} ranks")
    sizes = cfg.axis_sizes(len(devices))
    rank = dist.get_rank(group) if group is not None else 0
    groups = {}
    if group is not None and any(sizes[a] > 1 for a in AXES[1:]):
        if len(devices) != world:
            raise ValueError(f"a mesh that shards the LLM ({sizes}) takes "
                             f"one device per rank, not {len(devices)} "
                             f"devices over {world} ranks")
        if world != dist.get_world_size():
            raise ValueError("a mesh that shards the LLM is built over "
                             "every rank of the world (its axis groups are "
                             "made by all of them)")
        groups = _axis_groups(sizes, group, rank)
    elif group is not None and len(devices) == world and sizes["dp"] > 1:
        groups = {"dp": group}
    return Mesh(devices=tuple(devices), axes=sizes, group=group, rank=rank,
                world=world, groups=groups)


def _axis_groups(sizes: dict, group, rank: int) -> dict:
    """The process group of this rank's line along each axis longer than
    1. Every rank of ``group`` makes every line, in one order (a line's
    ranks ascend with its axis coordinate, so its group rank is that
    coordinate); a line of every rank is ``group`` itself."""
    import torch.distributed as dist

    shape = tuple(sizes[a] for a in AXES)
    index = np.arange(int(np.prod(shape))).reshape(shape)
    out = {}
    for ax, name in enumerate(AXES):
        if shape[ax] == 1:
            continue
        lines = np.moveaxis(index, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            members = tuple(dist.get_global_rank(group, int(r))
                            for r in line)
            grp = (group if len(members) == dist.get_world_size(group)
                   else dist.new_group(list(members)))
            if rank in line:
                out[name] = grp
    return out


def local_mesh(n_devices: int | None = None, device=None,
               **axis_sizes: int) -> Mesh:
    """A mesh in this process (no process group) over the first
    ``n_devices`` local cards, e.g. ``local_mesh(2)``; on the CPU
    (``device="cpu"``) over the CPU named ``n_devices`` times. Unnamed axes
    default to 1, except ``dp``, which absorbs the devices when not
    given."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        available = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        if n_devices is not None and n_devices > len(available):
            raise ValueError(f"requested {n_devices} devices, only "
                             f"{len(available)} available")
        devices = available[: n_devices or len(available)]
    else:
        devices = [dev] * (n_devices or 1)
    sizes = {a: axis_sizes.get(a, 1) for a in AXES}
    if "dp" not in axis_sizes:
        sizes["dp"] = -1
    return build_mesh(MeshConfig(**sizes), devices, group=None)


def probed_devices(deadline_s: float, on_timeout=None) -> list:
    """The local devices behind the hung-call watchdog: the first CUDA call
    initialises the driver, which on a wedged card blocks. Raises
    :class:`~deepdfa_tpu_torch.resilience.watchdog.WatchdogTimeout` after
    ``deadline_s`` instead."""
    from deepdfa_tpu_torch.resilience.watchdog import HangWatchdog

    def devices():
        if torch.cuda.is_available():
            torch.cuda.init()
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]

    return HangWatchdog(deadline_s, on_timeout=on_timeout).call(
        "device_init", devices)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None, store=None,
                         timeout_s: float = 300.0):
    """Join the process group: ``init_process_group`` with an explicit
    store and backend (NCCL when a card is present, else gloo). The store is
    ``store`` (a ``FileStore`` in tests) or a ``TCPStore`` at
    ``coordinator`` (``host:port`` or ``tcp://host:port``), served by
    process 0. ``num_processes=1`` without a coordinator or store skips, as
    the JAX package's does. Under NCCL each process takes the card
    ``process_id`` modulo the local cards. Returns the store, or None when
    skipped."""
    import torch.distributed as dist

    if num_processes == 1 and coordinator is None and store is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("pass num_processes and process_id: nothing tells "
                         "a process of a cluster")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = timedelta(seconds=timeout_s)
    if store is None:
        if coordinator is None:
            raise ValueError("pass a coordinator address or a store")
        host, _, port = coordinator.removeprefix("tcp://").rpartition(":")
        store = dist.TCPStore(host or "localhost", int(port), num_processes,
                              is_master=process_id == 0, timeout=timeout)
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout, **kw)
    return store
