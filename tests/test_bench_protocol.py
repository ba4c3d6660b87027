"""bench.py measurement-protocol unit tests (no device): the spec round
slope must recover a planted t_round under realistic dispatch jitter and
must NEVER publish a garbage slope (VERDICT r4 weak #3: a negative slope
published 5.6e9 tok/s into the result JSON)."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench as benchmod  # noqa: E402


def _mk_run(t_round_s, overhead_s, jitter_s, seed=0, k=4, alpha=1.0):
    """Synthetic run(n_target, rep): geometric-acceptance rounds with a
    planted per-round time, fixed dispatch overhead, and one-sided
    lognormal-ish jitter (slow outliers)."""
    rng = np.random.default_rng(seed)

    def run(n_target, rep):
        toks, rounds = 0, 0
        while toks < n_target:
            acc = 0
            while acc < k and rng.uniform() < alpha:
                acc += 1
            toks += acc + 1
            rounds += 1
        wall = (overhead_s + rounds * t_round_s
                + abs(rng.normal(0, jitter_s)))
        return wall, {"rounds": rounds, "new_tokens": toks,
                      "mean_accepted": (toks - rounds) / rounds}

    return run


def test_slope_recovers_planted_round_time():
    run = _mk_run(0.055, 1.2, 0.05)
    row = benchmod.spec_slope_row(run, 4, 384, min_round_ms=12.0)
    assert not row.get("noisy_slope_walltime_fallback"), row
    assert 45 <= row["t_round_ms"] <= 66, row
    # tok/s from the slope must strip the 1.2 s dispatch overhead
    # (at 384 tokens the overhead is ~22% of the long run's wall)
    assert row["tok_s"] > 1.1 * row["walltime_tok_s"]


def test_negative_slope_never_publishes():
    """Massive jitter at short max_new (the r4 int8 garbage-row regime):
    the row must fall back to walltime, not publish absurd tok/s."""
    for seed in range(8):
        run = _mk_run(0.055, 1.2, 1.5, seed=seed)
        row = benchmod.spec_slope_row(run, 4, 96, min_round_ms=12.0)
        # either the gates caught it (fallback flag) or the slope is
        # physically plausible; NEVER a sub-physical or absurd number
        if not row.get("noisy_slope_walltime_fallback"):
            assert 12.0 <= row["t_round_ms"] <= 10_000, (seed, row)
        assert row["tok_s"] < 2000, (seed, row)
        assert row["t_round_ms"] > 0


def test_physical_bound_rejects_subdense_rounds():
    """A self-spec round contains a dense-cost verify; a slope below the
    caller's physical bound must be rejected even if self-consistent."""
    run = _mk_run(0.005, 0.5, 0.0)   # planted 5 ms round (impossible)
    row = benchmod.spec_slope_row(run, 4, 384, min_round_ms=12.0)
    assert row.get("noisy_slope_walltime_fallback"), row


def test_expected_tokens_per_round_geometric():
    f = benchmod.expected_tokens_per_round
    assert f(1.0, 4) == 5.0
    assert abs(f(0.7, 4) - sum(0.7 ** i for i in range(5))) < 1e-12
    assert f(0.0, 4) == 1.0


def test_study_alpha_reads_artifact(tmp_path, monkeypatch):
    study = {"basis": "test", "alpha_table": [
        {"keep": 0.5, "k": None, "alpha": 0.644},
        {"keep": 0.25, "k": 4, "alpha": 0.48},
    ]}
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "acceptance_study.json").write_text(json.dumps(study))
    monkeypatch.setattr(benchmod, "__file__", str(tmp_path / "bench.py"))
    assert benchmod._study_alpha(0.5, 4) == (0.644, "test")
    assert benchmod._study_alpha(0.25, 4) == (0.48, "test")
    assert benchmod._study_alpha(0.25, 6) is None
    assert benchmod._study_alpha(0.75, 4) is None


def test_accuracy_map_builds_and_renders():
    from teal_jax.eval.accuracy_map import (build_accuracy_map,
                                            elementwise_equiv, to_markdown)
    assert abs(elementwise_equiv(0.5) - 0.835) < 1e-9
    assert abs(elementwise_equiv(0.4) - 0.785) < 1e-9
    assert elementwise_equiv(0.0) == 0.0 and elementwise_equiv(1.0) == 1.0
    m = build_accuracy_map()
    pts = {p["group_sparsity"]: p for p in m["operating_points"]}
    assert set(pts) == {0.25, 0.40, 0.50}
    # no on-card bench record given: speed renders as not measured
    assert all(p["measured_speedup"] is None for p in pts.values())
    md = to_markdown(m)
    assert "group sparsity" in md and "0.50" in md
    assert "not measured" in md
    # bench delegation: one source of truth for the curve
    assert benchmod._elementwise_equiv(0.5) == elementwise_equiv(0.5)
