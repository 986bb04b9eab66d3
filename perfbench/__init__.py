"""The benchmark of ``ray_tpu_torch`` on NVIDIA GPUs.

``perfbench/run.py`` runs one cell of ``BENCHMARK.json``; see
``perfbench/README.md``. Everything here is the yardstick: traffic
generation, the reduction of traces and timings to metrics, the peaks,
the operation and byte counts, the plain reference and the comparison
that decides ``correct``. From the program it takes only the system
under test.
"""
