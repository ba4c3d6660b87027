"""Multi-process (simulated multi-host) execution: the jax.distributed
handshake + global-mesh programs across 2 processes
(experiments/multihost_dryrun.py). Validates the code paths the
single-process virtual-device dryrun cannot: cross-process device
enumeration, process-local placement, collectives over the process
boundary.

Legs (VERDICT r4 #7 — one 2-process run each):
  gspmd     — GSPMD decode step, dp=2 x tp=4
  pp        — pp=2 x tp=4 GPipe prefill (ppermute IS the process hop)
  serving   — continuous-batching engine on a tp=8 global mesh with
              chunked admission (SPMD host loop on both processes)
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_leg(leg: str):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    out = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "experiments", "multihost_dryrun.py"),
         "--leg", leg],
        env=env, capture_output=True, text=True, timeout=560,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


def test_two_process_decode_step():
    out = _run_leg("gspmd")
    assert out.count("multihost step ok=True") >= 1, out


@pytest.mark.slow
def test_two_process_pipeline_parallel():
    out = _run_leg("pp")
    assert out.count("multihost pp ok=True") >= 1, out


@pytest.mark.slow
def test_two_process_serving_engine():
    out = _run_leg("serving")
    assert out.count("multihost serving ok=True") >= 1, out
