"""CLI surface smoke tests (the reference exposes everything through
CLIs — generate.py:528-558, ppl_test.py:32-37 etc.; ours must too)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax import cli
from teal_jax.config import get_model_config
from teal_jax.models import llama
from teal_jax.utils import checkpoint


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    path = str(tmp_path_factory.mktemp("ck") / "native")
    checkpoint.save_params(params, path)
    return path


def test_cli_generate_with_metrics_and_profile(tiny_ckpt, tmp_path, capsys):
    metrics = str(tmp_path / "metrics.jsonl")
    profile = str(tmp_path / "trace")
    cli.main([
        "generate", "--model", "tiny", "--checkpoint", tiny_ckpt,
        "--prompt", "hi", "--max-new-tokens", "4", "--num-samples", "2",
        "--max-seq", "64", "--temperature", "0",
        "--metrics", metrics, "--profile", profile,
    ])
    out = capsys.readouterr()
    assert "tok/s" in out.err
    lines = [json.loads(l) for l in open(metrics)]
    assert len(lines) == 2
    assert lines[0]["new_tokens"] == 4
    assert "tokens_per_s" in lines[0]
    # jax.profiler wrote a trace directory
    assert os.path.isdir(profile) and os.listdir(profile)


def test_cli_generate_speculative(tiny_ckpt, capsys):
    cli.main([
        "generate", "--model", "tiny", "--checkpoint", tiny_ckpt,
        "--draft-checkpoint", tiny_ckpt, "--speculate-k", "3",
        "--prompt", "hi", "--max-new-tokens", "6", "--max-seq", "64",
        "--temperature", "0.5",
    ])
    out = capsys.readouterr()
    assert "speculative k=3" in out.err
    assert "mean accepted" in out.err


def test_cli_eval_task_file(tiny_ckpt, tmp_path, capsys):
    task_file = str(tmp_path / "task.json")
    with open(task_file, "w") as f:
        json.dump({
            "name": "toy",
            "type": "multiple_choice",
            "docs": [{"query": "ab", "choices": ["c", "d"], "gold": 0}],
        }, f)
    cli.main([
        "eval", "--model", "tiny", "--checkpoint", tiny_ckpt,
        "--task-file", task_file, "--max-seq", "64",
    ])
    out = capsys.readouterr()
    results = json.loads(out.out)
    assert "toy" in results and "acc" in results["toy"]


def test_cli_ppl_group_mode(tiny_ckpt, tmp_path, capsys):
    # calibrate first (group histograms at the model's effective sizes)
    calib = str(tmp_path / "calib")
    cli.main([
        "calibrate", "--model", "tiny", "--checkpoint", tiny_ckpt,
        "--output-path", calib, "--batch", "1", "--seq-len", "64",
        "--no-layer-inputs", "--group-sizes", "16,32",
    ])
    hist = os.path.join(calib, "histograms")
    cli.main([
        "ppl", "--model", "tiny", "--checkpoint", tiny_ckpt,
        "--num-tokens", "512", "--context-size", "64",
        "--window-size", "32", "--sparsity", "0.5", "--hist-path", hist,
        "--mode", "group", "--block-size", "16", "--group-thresholds",
    ])
    out = capsys.readouterr()
    assert "dense ppl" in out.out
    assert "mode=group" in out.out


def test_cli_ppl_permute(tiny_ckpt, capsys):
    cli.main([
        "ppl", "--model", "tiny", "--checkpoint", tiny_ckpt,
        "--num-tokens", "256", "--context-size", "64",
        "--window-size", "32", "--permute",
    ])
    out = capsys.readouterr()
    assert "dense ppl" in out.out


def test_cli_ppl_group_thresholds_require_group_consumer(tiny_ckpt,
                                                         tmp_path):
    """--group-thresholds with the default elementwise mode (and a
    non-block kernel) must error loudly: group-score thresholds through
    the |x| > t rule silently over-sparsify."""
    calib = str(tmp_path / "calib")
    cli.main([
        "calibrate", "--model", "tiny", "--checkpoint", tiny_ckpt,
        "--output-path", calib, "--batch", "1", "--seq-len", "64",
        "--no-layer-inputs", "--group-sizes", "16,32",
    ])
    hist = os.path.join(calib, "histograms")
    with pytest.raises(SystemExit):
        cli.main([
            "ppl", "--model", "tiny", "--checkpoint", tiny_ckpt,
            "--num-tokens", "256", "--context-size", "64",
            "--window-size", "32", "--sparsity", "0.5",
            "--hist-path", hist, "--block-size", "16",
            "--group-thresholds",   # no --mode group / --kernel block
        ])
