"""The benchmark of the PyTorch / CUDA port (``pfd_tpu_torch``): one command
runs one cell once (``python3 -m pfdbench.run``); ``BENCHMARK.json`` at the
repository's root lists the cells, their configurations and metrics."""
