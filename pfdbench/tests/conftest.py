"""Registers the tiny widths of the configurations that ``tiny.py`` does not
hold (``tiny_vd.py``) into ``tiny.MODELS``, so that ``test_bench_cells.py``
runs every cell of ``BENCHMARK.json``."""

from pfdbench.tests import tiny, tiny_vd

tiny.MODELS.setdefault("vd_four_flow", tiny_vd.VD)
