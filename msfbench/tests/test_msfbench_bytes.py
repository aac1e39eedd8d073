"""The byte arithmetic of solve_roofline against a hand count, and the
readers of the per-layer metrics on hand-made inputs."""
from types import SimpleNamespace

import pytest

import _small  # noqa: F401
from msfbench import bytecount, devtrace, harness, peaks
from msfbench.harness import Reading


def test_round_bytes_by_hand():
    # a path 0-1-2-3: 3 undirected edges, 6 directed; n = 4
    # per directed edge: src 4 + dst 4 + w 4 + eid 4 + valid 1 = 17 bytes
    # per vertex: the parent read (4) and written (4)
    assert bytecount.round_bytes(4, 6) == 6 * 17 + 4 * 8 == 134
    assert bytecount.solve_bytes(4, 6, 3) == 3 * 134


def _read(metric, reading):
    return harness.metric_reader(metric)(reading)


def test_roofline_reader():
    prof = devtrace.Profile(window_s=1.0, busy_s=0.5, request_busy_s=[0.2, 0.3],
                            device_ops=[], idle_gaps=[],
                            n_device_events=10)
    reqs = [dict(profiled=True, bytes=3.35e11), dict(profiled=True, bytes=3.35e11),
            dict(profiled=False, bytes=1e15)]
    r = Reading(reqs, [], prof, peaks.H100_SXM)
    assert _read("solve_roofline.solve", r) == pytest.approx(100 * 0.2 / 0.5)
    assert _read("device_idle.solve", r) == pytest.approx(50.0)
    # no device events: nothing to read, and no 0 in its place
    r0 = Reading(reqs, [], prof._replace(n_device_events=0), peaks.H100_SXM)
    assert _read("solve_roofline.solve", r0) is None
    assert _read("device_idle.solve", r0) is None


def test_span_readers():
    ms = 1_000_000
    spans = [("plan.resolve", 0, 10 * ms, 1, None), ("msf.round", 20 * ms, 2 * ms, 1, None),
             ("msf.round", 40 * ms, 4 * ms, 1, None)]
    r = Reading([dict(plan_s=0.002, rounds=4), dict(plan_s=0.004, rounds=6)], spans, None,
                peaks.H100_SXM)
    assert _read("round_ms.solve", r) == pytest.approx(3.0)
    assert _read("plan_ms.solve", r) == pytest.approx(3.0)
    assert _read("rounds.solve", r) == pytest.approx(5.0)
    assert _read("round_ms.solve", r._replace(spans=[])) is None


def _ev(name, s, e, device=False, thread=1):
    kind = devtrace.torch.autograd.DeviceType.CUDA if device else devtrace.torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                           device_type=kind, thread=thread)


def test_profile_reduction():
    evs = [_ev("req", 0, 100), _ev("req", 100, 200),
           _ev("req", 1, 99, True), _ev("req", 101, 199, True),  # the ranges' device side
           _ev("aten::nonzero", 30, 99), _ev("aten::add", 120, 130),
           _ev("k1", 10, 30, True), _ev("k2", 20, 40, True), _ev("copy", 150, 190, True)]
    p = devtrace.reduce_events(evs, "req")
    assert p.window_s == pytest.approx(200e-6)
    assert p.busy_s == pytest.approx(70e-6)  # [10, 40] and [150, 190]
    assert p.request_busy_s == pytest.approx([30e-6, 40e-6])
    assert dict(p.device_ops) == pytest.approx({"copy": 40e-6, "k1": 20e-6, "k2": 20e-6})
    gaps = dict(p.idle_gaps)
    # [0, 10] and [190, 200] in req alone; [40, 150] has its middle in nonzero
    assert gaps == pytest.approx({"req": 20e-6, "aten::nonzero": 110e-6})
