"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``perfbench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything a
configuration, a traffic mix, a cell or a metric needs sits in a file of its
own under ``configs/``, ``traffic/``, ``workloads/`` and ``metrics/``; the
yardstick (the generator, the reference, the work counts and peaks, the
comparison that decides ``correct``) lives here and reads nothing of the
program but its entry points.
"""
