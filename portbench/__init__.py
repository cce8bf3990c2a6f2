"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the command; ``BENCHMARK.json`` at the root of the checkout
names the cells.  Everything that belongs to one configuration, traffic
mix or metric is a file of its own, found by name (``README.md``).
"""
