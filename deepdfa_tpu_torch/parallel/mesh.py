"""Device meshes over ``torch.distributed``.

The port of ``deepdfa_tpu/parallel/mesh.py``. Axes keep the JAX package's
names (``dp``, ``fsdp``, ``tp``, ``sp``); only ``dp`` is ported: a
:class:`Mesh` lists one device per ``dp`` slot and maps the axis onto a
process group (NCCL on CUDA, gloo on the CPU), each process holding the
slots of its own rank. A mesh without a group (:func:`local_mesh`) keeps
every slot in this process: the engine's replicas, or several ``dp`` slots
of the CPU in one process (the CPU may be named more than once, as the JAX
package's tests name its host devices). ``fsdp``, ``tp`` and ``sp`` above
1 raise ``NotImplementedError``: they shard the LLM (ROADMAP A11b).

Nothing tells a process of a cluster: :func:`initialize_multihost` takes
the world size, the rank and a store or an address explicitly.
"""

from __future__ import annotations

import dataclasses
import logging
from datetime import timedelta

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
    """``devices[j]`` runs ``dp`` slot ``j``. ``group`` is the process group
    the slots are spread over (None: this process holds every slot);
    ``rank`` and ``world`` are this process's place in it. Rank ``r`` holds
    the slots ``local_slots``, an equal consecutive share."""

    devices: tuple
    axes: dict
    group: object = None
    rank: int = 0
    world: int = 1

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
    a run across."""
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
    later = {a: sizes[a] for a in ("fsdp", "tp", "sp") if sizes[a] > 1}
    if later:
        raise NotImplementedError(
            f"mesh axes {later} shard the LLM and are not ported yet: ROADMAP "
            "A11b (the sharded JointEngine, ring attention over sp)")
    rank = dist.get_rank(group) if group is not None else 0
    return Mesh(devices=tuple(devices), axes=sizes, group=group, rank=rank,
                world=world)


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
