"""PyTorch/CUDA port of the algebraic Awerbuch-Shiloach MSF solver.

Mirrors ``src/repro`` module by module (the JAX package is the reference
and stays untouched). Entry points run on the CUDA card unless the
caller asks for the CPU; the hot packed segment-min is a hand-written
CUDA kernel for Hopper (``repro_torch.kernels``).

    from repro_torch.graphs import rmat_graph
    from repro_torch.solve import SolveSpec, plan
    report = plan(rmat_graph(16, 8), SolveSpec()).solve()

This package imports torch, numpy and scipy only — never jax, and
nothing of ``repro``.
"""
