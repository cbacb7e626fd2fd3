"""Mesh-elastic checkpoint restore: resume a ``dp=N`` run on a ``dp=M``
mesh.

The port of ``deepdfa_tpu/parallel/elastic.py``:

- every ``meta.json`` (and the run journal) records a :func:`mesh_block`:
  the device count, the platform (the card's CUDA device name on the
  card, ``cpu`` on the CPU) and the named axis sizes;
- on restore, :func:`mesh_changed` compares the recorded block with the
  current one; on a change :func:`reshard_tree` gathers every tensor to
  the host and places it on the current device. Parameters and optimizer
  state are replicated over ``dp``, so a copy is the right target and the
  values are bitwise the saved ones;
- :func:`stack_elastic` regroups the same flat batch sequence for the new
  mesh: ``dp=N`` consumes flat batch ``j`` at slot ``j``; ``dp=N/k`` with
  ``accum=k`` consumes flat batch ``j·k + i`` at slot ``j``, micro step
  ``i``, the stream index the dp step seeds its generator with
  (:mod:`deepdfa_tpu_torch.parallel.dp`). The global batch order is kept;
  the gradient sums reassociate.

The single-device trainer records ``axes=None``; a change of the device
count alone (a run moved to a host with fewer cards) still takes the
reshard path, then a plain host round trip.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["elastic_restore", "host_gather", "mesh_block", "mesh_changed",
           "reshard_tree", "stack_elastic"]


def _platform(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def mesh_block(mesh=None, device=None) -> dict:
    """JSON-serialisable topology record for ``meta.json``. Without a mesh
    (the single-device trainer on ``device``, default the card) the block
    pins the count of devices of that kind, so a resume on a host of
    another size is detected."""
    if mesh is None:
        dev = torch.device("cuda" if device is None else device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        return {"devices": int(n), "platform": _platform(dev), "axes": None}
    return {"devices": int(mesh.size), "platform": _platform(mesh.device),
            "axes": {name: int(s) for name, s in mesh.shape.items()}}


def mesh_changed(recorded: dict | None, current: dict) -> bool:
    """Does the recorded topology differ from the current one? A missing
    record (a checkpoint without one) restores as it is."""
    if not recorded:
        return False
    return (recorded.get("devices") != current.get("devices")
            or recorded.get("axes") != current.get("axes"))


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def host_gather(tree: Any) -> Any:
    """Every tensor of ``tree`` copied to the host (the first half of the
    reshard)."""
    return _map(tree, lambda t: t.detach().to("cpu", copy=True))


def reshard_tree(tree: Any, mesh=None, device=None) -> Any:
    """Host gather, then every tensor placed on the mesh's device (the
    replicated placement), or on ``device`` without a mesh. Values are
    untouched: the move is topological, bitwise."""
    target = torch.device(mesh.device if mesh is not None
                          else device or "cpu")
    return _map(host_gather(tree), lambda t: t.to(target))


def elastic_restore(ckpts, mesh=None, device=None, map_location=None
                    ) -> tuple[int, dict, Any, Any, bool]:
    """``restore_resume`` plus the reshard path: ``(step, meta, state, aux,
    resharded)``. When the checkpoint's recorded mesh block differs from
    the current topology (``mesh``, else the single-device trainer on
    ``device``), both payloads are gathered to the host and placed again;
    otherwise they come back as ``restore_resume`` loaded them."""
    step, meta, state, aux = ckpts.restore_resume(map_location=map_location)
    current = mesh_block(mesh, device)
    resharded = False
    if mesh_changed(meta.get("mesh"), current):
        state = reshard_tree(state, mesh, device)
        if aux is not None:
            aux = reshard_tree(aux, mesh, device)
        resharded = True
    return step, meta, state, aux, resharded


def stack_elastic(flat_batches: list, dp: int, accum: int = 1) -> list:
    """Regroup a flat same-bucket batch sequence for a ``dp``-way mesh with
    ``accum`` accumulation micro batches per slot.

    One global step consumes ``dp * accum`` consecutive flat batches; slot
    ``j`` takes ``[j*accum, (j+1)*accum)``, so flat batch ``k`` lands where
    the stream index is ``k``, the assignment ``dp*accum`` slots with
    ``accum=1`` would give. ``accum == 1`` returns ``[dp, ...]`` stacks,
    ``accum > 1`` ``[dp, accum, ...]`` stacks."""
    from deepdfa_tpu_torch.parallel.dp import stack_batches

    if dp < 1 or accum < 1:
        raise ValueError("dp and accum must be >= 1")
    per = dp * accum
    if len(flat_batches) % per:
        raise ValueError(
            f"{len(flat_batches)} batches do not divide into global steps of "
            f"dp*accum = {per}")
    out = []
    for g0 in range(0, len(flat_batches), per):
        group = flat_batches[g0: g0 + per]
        if accum == 1:
            out.append(stack_batches(group))
            continue
        out.append(stack_batches([
            stack_batches(group[j * accum: (j + 1) * accum])
            for j in range(dp)]))
    return out
