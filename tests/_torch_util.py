"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Import only after ``pytest.importorskip("torch")``. Inputs are made with
numpy and handed to both packages; results are compared as numpy.
"""
import numpy as np
import torch

from repro_torch.graphs.structures import from_reference


def to_np(x) -> np.ndarray:
    """numpy view of a torch tensor, a jax array or anything array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cpu_graph(g):
    """The port's CPU ``Graph`` holding the same arrays as a JAX ``Graph``."""
    return from_reference(g, device="cpu")


def assert_same_msf(ref_report, port_report, *, exact_weight=True):
    """The slice's parity contract: eid sequence, parent, edge count and
    rounds identical; the weight exact (pack32 integer regime) or compared
    as float64 sums over the eid set (float weights)."""
    np.testing.assert_array_equal(to_np(port_report.msf_eids), to_np(ref_report.msf_eids))
    np.testing.assert_array_equal(to_np(port_report.parent), to_np(ref_report.parent))
    assert port_report.n_msf_edges == ref_report.n_msf_edges
    assert port_report.iterations == ref_report.iterations
    if exact_weight:
        assert port_report.weight == ref_report.weight


def float64_weight(g, eids) -> float:
    """Float64 sum of the weights of ``eids`` in a (JAX or port) graph."""
    valid = to_np(g.valid)
    by_eid = dict(zip(to_np(g.eid)[valid].tolist(), to_np(g.w)[valid].astype(np.float64)))
    return float(sum(by_eid[int(e)] for e in eids))
