"""The distributed layer: device meshes over ``torch.distributed`` process
groups (NCCL on the card, gloo on the CPU), the data-parallel train and
eval steps, and the mesh-elastic checkpoint restore."""

from deepdfa_tpu_torch.parallel.mesh import build_mesh, local_mesh  # noqa: F401
