"""Input generators, found by the ``generator`` key of a configuration file.

Each module ``gen/<name>.py`` has ``base_edges(cfg, seed, index, device)``,
which returns one graph of the configuration as canonical undirected
edges (``edges.Edges``).
"""
