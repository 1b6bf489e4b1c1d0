"""The benchmark of ``staticmapping_torch`` on one NVIDIA H100: drives of
synthetic LiDAR scans through the chunked ``MapBuilder``, one cell of
``BENCHMARK.json`` a run (``python3 -m mapbench.run``)."""
