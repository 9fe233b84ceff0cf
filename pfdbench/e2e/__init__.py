"""End-to-end metrics: one reader a file, ``read(window) -> float | None``,
found by the metric's name in ``BENCHMARK.json``. ``window``
(``run.Window``) holds the set-up's seconds, the window's start, each
request's (start, end, images) on the host clock."""
