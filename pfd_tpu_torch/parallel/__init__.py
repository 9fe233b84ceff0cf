"""The multi-device path (the port of ``pfd_tpu/parallel``): the
('data'[, 'seq'], 'model') mesh over one process per device (``mesh.py``),
the Megatron sharding rules (``sharding.py``), the process group and the
explicit collectives (``distributed.py``), the training step on one device
or on a mesh (``train.py``), and batched serving over a list of devices
(``serve.py``, ``zoo_serve.py``; ``pfd_tpu``'s servers use the 'data' axis
only)."""

from pfd_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from pfd_tpu_torch.parallel.serve import DataParallelServer  # noqa: F401
from pfd_tpu_torch.parallel.zoo_serve import ZooServer  # noqa: F401
