"""The benchmark of the PyTorch and CUDA port (``flac_raster_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line.  Configurations, traffic mixes and per-layer metrics are files of
their own under ``configs/``, ``traffic/`` and ``metrics/``, found by the
names in ``BENCHMARK.json``; ``reference/`` holds the plain NumPy reader
and the raster generators that decide ``correct``.
"""
