"""The port's watchdog contract and SLO windows against the JAX package's.

``repro_torch.obs.health`` and ``repro_torch.obs.windows`` are host
copies of ``repro.obs.health`` / ``repro.obs.windows``: on the same
inputs the comparison helpers give the same verdicts (exact), the
helpers take tensors as well as arrays, ``HealthConfig.of`` reads the
same ``ServeConfig`` fields, and the windows report the same statistics
under the same injected clock (exact: both reduce the same float64
samples with numpy).  The engines' quarantine behaviour is held in
``tests/test_torch_serve_solver.py``.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.config.base import ServeConfig as JServeConfig
from repro.obs import health as jhealth
from repro.obs import windows as jwindows
from repro.serve.metrics import ServeTelemetry as JTelemetry
from repro_torch.config.base import ServeConfig
from repro_torch.obs import health, windows
from repro_torch.serve.metrics import ServeTelemetry


class FakeClock:
    """Deterministic injectable clock: 0.0, 0.5, 1.0, ..."""

    def __init__(self, step: float = 0.5):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        t, self.t = self.t, self.t + self.step
        return t


def _pairs():
    a = np.array([1.0, np.nan, np.inf, -np.inf, 0.0], np.float32)
    b = a.copy()
    b[0] = 1.0 + 1e-7
    c = a.copy()
    c[1] = 0.0
    d = a.copy()
    d[2] = -np.inf
    e = a.copy()
    e[0] = 2.0
    return {"same": (a, a.copy()), "close": (a, b), "nan_moved": (a, c),
            "inf_sign": (a, d), "far": (a, e), "dtype": (a, a.astype(
                np.float64)), "shape": (a, a[:3])}


@pytest.mark.parametrize("case", sorted(_pairs()))
def test_comparison_helpers_match_reference(case):
    a, b = _pairs()[case]
    assert health.bitwise_equal(a, b) == jhealth.bitwise_equal(a, b)
    assert health.allclose_or_both_nonfinite(a, b) == \
        jhealth.allclose_or_both_nonfinite(a, b)
    ref_raises = port_raises = None
    try:
        jhealth.assert_finite_close(a, b, context="x")
    except AssertionError as exc:
        ref_raises = str(exc)
    try:
        health.assert_finite_close(a, b, context="x")
    except AssertionError as exc:
        port_raises = str(exc)
    assert port_raises == ref_raises


def test_comparison_helpers_take_tensors():
    a = torch.tensor([1.0, float("nan"), float("inf")])
    assert health.bitwise_equal(a, a.clone())
    assert health.bitwise_equal(a, a.numpy().copy())
    assert not health.bitwise_equal(a, a.double())
    assert health.allclose_or_both_nonfinite(a, a + 1e-9)
    with pytest.raises(AssertionError, match="finite entries deviate"):
        health.assert_finite_close(a, a * 2, context="t")


def test_status_codes_and_config_match_reference():
    for name in ("STATUS_RUNNING", "STATUS_STOPPED", "STATUS_DIVERGED",
                 "STATUS_STALLED", "STATUS_LABELS"):
        assert getattr(health, name) == getattr(jhealth, name)
    assert health.HealthConfig.of(ServeConfig()) is None
    for kw in ({}, {"watchdog": True}, {"watchdog": True,
                                         "stall_patience": 7}):
        ref = jhealth.HealthConfig.of(JServeConfig(**kw))
        got = health.HealthConfig.of(ServeConfig(**kw))
        assert (got is None) == (ref is None)
        if got is not None:
            assert got.stall_window == ref.stall_window
            assert hash(got) == hash(health.HealthConfig(
                stall_window=ref.stall_window))
    f = health.SolveFailure(req_id=3, status="stalled", iters=4, stat=0.5)
    assert f.tick is None and f == health.SolveFailure(3, "stalled", 4, 0.5)


def test_serve_config_is_the_reference_field_for_field():
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(JServeConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert got == ref


@pytest.mark.parametrize("horizon", [1.0, 2.5])
def test_sliding_window_matches_reference(horizon):
    rng = np.random.default_rng(int(horizon * 10))
    ts = np.cumsum(rng.uniform(0.0, 0.4, 60))
    vs = rng.normal(size=60)
    jw = jwindows.SlidingWindow(horizon, maxlen=32)
    pw = windows.SlidingWindow(horizon, maxlen=32)
    for t, v in zip(ts, vs):
        jw.add(t, v)
        pw.add(t, v)
        assert pw.stats(t) == jw.stats(t)
    later = float(ts[-1]) + horizon
    assert pw.stats(later) == jw.stats(later)
    assert pw.stats(later)["p50"] is None and pw.stats(later)["count"] == 0


def test_sliding_window_rejects_bad_horizon():
    for bad in (0, -1.0):
        with pytest.raises(ValueError, match="horizon must be positive"):
            windows.SlidingWindow(bad)


def test_metric_windows_snapshot_matches_reference():
    jm, pm = jwindows.MetricWindows(3.0), windows.MetricWindows(3.0)
    for i in range(20):
        for m in (jm, pm):
            m.add("latency", 0.3 * i, float(i % 7))
            if i % 3 == 0:
                m.add("completions", 0.3 * i, 1.0)
    assert pm.snapshot(6.0) == jm.snapshot(6.0)
    assert set(pm.snapshot(6.0)) == {"window_s", "latency", "completions"}


def test_telemetry_windows_and_health_sections_match_reference():
    """The same lifecycle, quarantines and timeouts fed to both
    telemetries under the same fake clock give the same snapshot
    sections (windows, health, latencies)."""
    snaps = []
    for tele in (JTelemetry(clock=FakeClock(), window_s=2.0),
                 ServeTelemetry(clock=FakeClock(), window_s=2.0)):
        for i in range(6):
            tele.record_arrival(i, "lasso", "continuous")
            tele.record_admit(i)
        for i in range(6):
            tele.record_completion(i, iters=10 + i, converged=i % 2 == 0,
                                   status="ok" if i < 4 else "stalled")
        tele.record_quarantine("stalled")
        tele.record_quarantine("diverged")
        tele.record_timeout()
        tele.record_chunk(live=3, capacity=4, chunk_iters=8, wall_s=0.01)
        with pytest.raises(ValueError, match="unknown quarantine status"):
            tele.record_quarantine("bogus")
        snaps.append(tele.snapshot())
    ref, got = snaps
    for key in ("health", "windows", "latency_p50", "latency_p99",
                "queue_wait_p50", "completed", "converged", "iters_total"):
        assert got[key] == ref[key], key
    assert set(ref) <= set(got) | {"compile_cache"}
    for key in ("chunks", "row_iters", "live_iters", "occupancy_mean",
                "padding_waste", "migrations"):
        assert got["continuous"][key] == ref["continuous"][key], key


def test_deprecation_warns_once_per_process():
    from repro_torch import deprecation
    deprecation.reset_warnings()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        deprecation.warn_legacy("x.Engine", "FlexaClient()")
        deprecation.warn_legacy("x.Engine", "FlexaClient()")
        with deprecation.internal_use():
            deprecation.warn_legacy("y.Engine", "FlexaClient()")
    assert [str(w.message).split(" is ")[0] for w in seen] == ["x.Engine"]
    assert all(w.category is FutureWarning for w in seen)
    deprecation.reset_warnings()
