"""The accuracy-frontier operating-point map as ONE machine-readable
artifact (VERDICT r4 next #9).

The framework's honest accuracy story lives on three axes that were
previously scattered across docs/ACCURACY.md, docs/accuracy_real_
artifacts.md, bench JSON and README tables:

  1. group sparsity <-> elementwise-TEAL-equivalent sparsity (equal
     dropped activation energy on the reference's real shipped channel
     statistics; the group rule pays more energy per byte saved);
  2. measured decode speedup at each operating point, from an on-card
     bench record (`bench.py` JSON) when one is given, else "not
     measured";
  3. the lossless lane: self-speculation acceptance alpha(keep) from a
     calibrated study (docs/acceptance_study.json) when one is present.

`build_accuracy_map()` composes whatever artifacts exist into one JSON;
`to_markdown()` renders the README table from the SAME data so prose can
never drift from the artifact. CLI: `teal_jax accuracy-map`.

Reference anchor: TEAL validates accuracy as ppl-vs-sparsity
(`/root/reference/teal/ppl_test.py:50-67`, README.md:30-33); this map is
the random-weights-environment substitute, with the real-weights ppl
recipe in docs/ACCURACY.md.
"""

from __future__ import annotations

import json
import os
from typing import Optional

# uniform GROUP sparsity -> elementwise-TEAL sparsity with equal dropped
# activation energy on the reference's real shipped channel statistics
# (experiments/real_heterogeneity.py part 3, Llama-2-7B rows; the curve
# is within ~0.01 across all six shipped models)
ELEMENTWISE_EQUIV_PTS = [
    (0.0, 0.0), (0.25, 0.66), (0.30, 0.715), (0.40, 0.785),
    (0.50, 0.835), (1.0, 1.0),
]


def elementwise_equiv(group_sparsity: float) -> float:
    """Piecewise-linear interpolation of the equal-energy map."""
    s = min(max(group_sparsity, 0.0), 1.0)
    for (x0, y0), (x1, y1) in zip(ELEMENTWISE_EQUIV_PTS,
                                  ELEMENTWISE_EQUIV_PTS[1:]):
        if s <= x1:
            return y0 + (y1 - y0) * (s - x0) / (x1 - x0)
    return 1.0


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def build_accuracy_map(root: Optional[str] = None,
                       bench_json: Optional[str] = None) -> dict:
    """Compose the operating-point map from committed artifacts.

    root: repo root (default: two levels above this file).
    bench_json: path to an on-card `bench.py` JSON record; without one,
    every speed field stays None and renders as "not measured"."""
    if root is None:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    study = _read_json(os.path.join(root, "docs", "acceptance_study.json"))
    bench_name, bench = bench_json, None
    if bench_json:
        bench = _read_json(bench_json)
        if bench and bench.get("parsed"):
            bench = bench["parsed"]

    dense = bench.get("dense_tok_s") if bench else None
    points = []
    for s in (0.25, 0.40, 0.50):
        row = {
            "group_sparsity": s,
            "keep": round(1.0 - s, 3),
            "elementwise_equiv_sparsity": round(elementwise_equiv(s), 3),
            "measured_speedup": None,
            "measured_tok_s": None,
        }
        if bench:
            if abs(s - 0.5) < 1e-9 and "sparse_tok_s" in bench:
                row["measured_tok_s"] = bench["sparse_tok_s"]
                row["measured_speedup"] = bench.get("value")
            if abs(s - 0.4) < 1e-9 and bench.get("conservative_group40"):
                c = bench["conservative_group40"]
                row["measured_tok_s"] = c.get("tok_s")
                row["measured_speedup"] = c.get("speedup")
        if study:
            for a in study.get("alpha_table", []):
                if abs(a["keep"] - row["keep"]) < 1e-6:
                    row["selfspec_alpha"] = a["alpha"]
                    row["selfspec_alpha_conservative"] = \
                        a.get("alpha_conservative")
        points.append(row)

    out = {
        "note": (
            "group sparsity saves bytes at group granularity; at equal "
            "BYTES it drops more activation energy "
            "than TEAL's elementwise rule — the honest comparison axis "
            "is elementwise_equiv_sparsity. The lossless lane "
            "(self-speculation) carries NO accuracy caveat at any "
            "operating point; its speed depends on acceptance alpha."
        ),
        "operating_points": points,
        "lossless_selfspec": {
            "alpha_table": (study or {}).get("alpha_table"),
            "alpha_basis": (study or {}).get("basis"),
            "recommended": (study or {}).get("recommended"),
            "realized": (study or {}).get("realized"),
            "bench_row": (bench or {}).get("lossless_selfspec"),
        },
        "sources": {
            "bench": bench_name,
            "bench_device": (bench or {}).get("device"),
            "acceptance_study": bool(study),
            "dense_tok_s": dense,
        },
    }
    return out


def to_markdown(m: dict) -> str:
    """Render the README operating-point table from the artifact."""
    dev = m["sources"].get("bench_device") or {}
    card = dev.get("card", "no on-card record")
    lines = [
        f"| group sparsity | = teal elementwise | measured speedup "
        f"(7B bf16, {card}) | self-spec alpha (expected) |",
        "|---|---|---|---|",
    ]
    for p in m["operating_points"]:
        sp = (f"{p['measured_speedup']:.2f}x"
              if p.get("measured_speedup") else "not measured")
        al = (f"{p['selfspec_alpha']:.2f}"
              if p.get("selfspec_alpha") is not None else "—")
        lines.append(
            f"| {p['group_sparsity']:.2f} | "
            f"~{p['elementwise_equiv_sparsity']:.2f} | {sp} | {al} |")
    spec = m["lossless_selfspec"]
    row = spec.get("bench_row")
    if row and row.get("measured_at_study_alpha"):
        ms = row["measured_at_study_alpha"]
        lines.append(
            f"\nLossless self-speculation, measured at the study's "
            f"calibrated acceptance (alpha={ms['alpha_forced']}, "
            f"adaptive k): **{ms['tok_s']} tok/s** "
            f"(t_round {ms['t_round_ms']} ms).")
    return "\n".join(lines)
