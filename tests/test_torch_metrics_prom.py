"""The port's metrics registry against the JAX package's, on the CPU.

The same observations (drawn from a seed) in both registries give
byte-equal Prometheus text (process gauges off: they read this process)
and equal quantiles, the histogram bucket bounds are the JAX ones, and the
content negotiation, the shared percentile and the process and build
gauges agree.
"""

import numpy as np
import pytest
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu.obs import metrics as jax_metrics
from eegnetreplication_tpu.obs import stats as jax_stats
from eegnetreplication_tpu_torch.obs import metrics, schema, stats

LABEL_VALUES = ["ok", "error", "a\"quoted\"", "back\\slash", "new\nline",
                "128", ""]


def _fill(registry, seed):
    """Counters, gauges and histograms with labeled series, one draw."""
    rng = np.random.RandomState(seed)
    for _ in range(60):
        kind = rng.randint(3)
        name = f"m{rng.randint(4)}_{('total', 'g', 'ms')[kind]}"
        labels = ({} if rng.rand() < 0.3 else
                  {"status": LABEL_VALUES[rng.randint(len(LABEL_VALUES))]})
        if rng.rand() < 0.2:
            labels["bucket"] = str(int(rng.choice([1, 8, 32, 128])))
        value = float(rng.choice([0.0, 1.0, rng.rand(), rng.rand() * 1e4,
                                  1e-3, 1e6, 7.5]))
        if kind == 0:
            registry.inc(name, value, **labels)
        elif kind == 1:
            registry.set(name, value - 3.0, **labels)
        else:
            registry.observe(name, value, **labels)
    for _ in range(40):
        registry.observe("request_latency_ms", float(rng.gamma(2.0, 3.0)))
        registry.inc("requests_total", status="ok")


def _pair(seed):
    port, ref = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _fill(port, seed)
    _fill(ref, seed)
    return port, ref


@pytest.mark.parametrize("seed", range(8))
def test_prometheus_text_is_byte_equal_to_the_jax_text(seed):
    port, ref = _pair(seed)
    got = metrics.to_prometheus_text(port.snapshot(), process_metrics=False)
    want = jax_metrics.to_prometheus_text(ref.snapshot(),
                                          process_metrics=False)
    assert got.encode() == want.encode()
    assert "# TYPE request_latency_ms histogram" in got
    assert 'request_latency_ms_bucket{le="+Inf"} 40' in got


@pytest.mark.parametrize("seed", range(4))
def test_snapshots_and_quantiles_equal_the_jax_ones(seed):
    port, ref = _pair(seed)
    a, b = port.snapshot(), ref.snapshot()
    for section in ("counters", "gauges", "histograms"):
        assert a[section] == b[section]
    schema.validate_metrics(a)
    for name, series in b["histograms"].items():
        for entry in series:
            labels = entry["labels"]
            for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
                assert port.quantile(name, q, **labels) == \
                    ref.quantile(name, q, **labels)
    assert port.quantile("absent", 0.5) is None


def test_the_bucket_bounds_are_the_jax_ones():
    assert metrics.DEFAULT_BUCKET_BOUNDS == jax_metrics.DEFAULT_BUCKET_BOUNDS


@pytest.mark.parametrize("seed", range(6))
def test_quantile_from_buckets_equals_the_jax_estimate(seed):
    rng = np.random.RandomState(seed)
    bounds = jax_metrics.DEFAULT_BUCKET_BOUNDS
    counts = [int(c) for c in rng.poisson(rng.rand() * 3,
                                          len(bounds) + 1)]
    lo, hi = sorted(rng.rand(2) * 100)
    for q in np.linspace(0, 1, 21):
        for kw in ({}, {"lo": lo, "hi": hi}):
            assert metrics.quantile_from_buckets(bounds, counts, q, **kw) \
                == jax_metrics.quantile_from_buckets(bounds, counts, q, **kw)


@pytest.mark.parametrize("accept", [
    None, "", "application/json", "text/plain", "text/plain;version=0.0.4",
    "application/openmetrics-text", "application/json, text/plain, */*",
    "*/*", "TEXT/PLAIN"])
def test_content_negotiation_equals_the_jax_rule(accept):
    assert metrics.wants_prometheus(accept) == \
        jax_metrics.wants_prometheus(accept)


def test_process_gauges_and_build_info_have_the_jax_keys():
    assert set(metrics.process_snapshot()) == \
        set(jax_metrics.process_snapshot())
    assert set(metrics.build_info()) == set(jax_metrics.build_info())
    text = metrics.to_prometheus_text(metrics.MetricsRegistry().snapshot())
    assert "# TYPE process_uptime_seconds gauge" in text
    assert "eegtpu_build_info{" in text and text.endswith(" 1\n")
    assert metrics.PROMETHEUS_CONTENT_TYPE == \
        jax_metrics.PROMETHEUS_CONTENT_TYPE


@pytest.mark.parametrize("seed", range(3))
def test_percentile_equals_the_jax_percentile(seed):
    values = np.random.RandomState(seed).randn(37).tolist()
    for q in (0.0, 0.25, 0.5, 0.95, 1.0):
        assert stats.percentile(values, q) == jax_stats.percentile(values, q)
    assert stats.percentile([], 0.5) == 0.0
