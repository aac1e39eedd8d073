"""Command-line entry points of the port (counterpart of ``repro.launch``):
``python -m repro_torch.launch.serve_graph`` replays an edge stream
through a stream plan or serves one over ``serve/v1`` TCP;
``python -m repro_torch.launch.loadgen`` drives either with open-loop
load; ``python -m repro_torch.launch.tune`` builds, verifies and checks
a tuning database. ``repro_torch.launch.mesh`` builds the rank grids of
the distributed plans (``make_mesh``, ``make_host_mesh``)."""
