"""The port's serve launcher and metrics registry against the JAX package.

``repro_torch.launch.serve.run`` is the launcher's body: on the CPU it
serves the smoke config end to end, and ``--metrics`` writes the same
registry keys as ``repro.launch.serve``.  The registry copy gives the same
snapshot as ``repro.obs.metrics`` for the same observations.
"""
import json

import numpy as np
import pytest

from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch.launch.serve import run
from repro_torch.obs.metrics import MetricsRegistry


def test_registry_snapshot_matches_reference():
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.exponential(20.0, 50), [0.0, 1.0, 5e3]])
    snaps = []
    for reg in (JaxRegistry(), MetricsRegistry()):
        reg.counter("serve/tokens").inc(17)
        reg.counter("serve/tokens").inc(3)
        reg.gauge("serve/tok_per_s").set(12.5)
        h = reg.histogram("serve/completion_len")
        for v in values:
            h.observe(float(v))
        reg.histogram("serve/custom", buckets=(1.0, 10.0)).observe(4.0)
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]


def test_serve_run_on_cpu_writes_reference_metric_keys(tmp_path):
    path = tmp_path / "serve_metrics.json"
    out = run(["--smoke", "--device", "cpu", "--greedy", "--quiet",
               "--batch", "3", "--max-new", "6", "--metrics", str(path)])
    assert out["device"] == "cpu"
    assert out["tokens"] == sum(len(r.completion_ids) for r in out["rollouts"])
    assert out["decode_slot_steps"] == out["decode_steps"] * 3
    snap = json.loads(path.read_text())
    assert set(snap["counters"]) == {"serve/tokens", "serve/requests"}
    assert set(snap["gauges"]) == {"serve/tok_per_s", "serve/mean_len"}
    assert set(snap["histograms"]) == {"serve/completion_len"}
    assert snap["counters"]["serve/tokens"] == out["tokens"]
    assert snap["counters"]["serve/requests"] == 3
    assert snap["histograms"]["serve/completion_len"]["count"] == 3


@pytest.mark.parametrize("seed", [0, 3])
def test_serve_run_is_deterministic_per_seed(seed):
    argv = ["--smoke", "--device", "cpu", "--greedy", "--quiet",
            "--batch", "2", "--max-new", "5", "--seed", str(seed)]
    a, b = run(argv), run(argv)
    assert ([r.completion_ids for r in a["rollouts"]]
            == [r.completion_ids for r in b["rollouts"]])
