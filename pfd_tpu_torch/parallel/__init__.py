"""Batched serving over a list of devices (the port of ``pfd_tpu/parallel``'s
serving half; the training half is not ported)."""

from pfd_tpu_torch.parallel.serve import DataParallelServer  # noqa: F401
from pfd_tpu_torch.parallel.zoo_serve import ZooServer  # noqa: F401
