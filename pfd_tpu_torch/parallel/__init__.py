"""Batched serving over a list of devices, and the training step on one
device (the port of ``pfd_tpu/parallel``; its DP+TP mesh, ``mesh.py``,
``sharding.py`` and ``distributed.py``, is not ported)."""

from pfd_tpu_torch.parallel.serve import DataParallelServer  # noqa: F401
from pfd_tpu_torch.parallel.zoo_serve import ZooServer  # noqa: F401
