"""The benchmark of the PyTorch/CUDA port (``repro_torch``) of the MSF solver.

``python msfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` (at the root of the checkout) and
prints one JSON result line. Everything here is the yardstick: the input
generators, the plain reference, the byte arithmetic, the card's peaks,
the readers of the per-layer metrics and the comparison that decides
``correct``. None of it imports the JAX package.
"""
