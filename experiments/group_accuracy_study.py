#!/usr/bin/env python
"""Group-vs-elementwise sparsity accuracy study (synthetic, structured).

The environment has no model weights (zero egress), so the ppl cost of the
block kernel's group-granular selection cannot be measured on a real
checkpoint here. This study isolates the quantity that *differs* between
the shipped fast path and TEAL's elementwise rule — the selection
structure — and measures its cost on activations with realistic channel
statistics, mimicking what is known about LLM hidden states:

  - aggregate value distributions are zero-mean unimodal (h1 ~ Gaussian-
    like, h2 ~ Laplacian-like; reference notebooks/distributions.ipynb,
    reproduced from the real shipped histograms by
    `teal_jax/calibration/analysis.py`);
  - per-channel magnitudes are strongly heterogeneous (massive-activation
    channels). Channel scale sigma_c ~ lognormal(0, s); s sweeps from 0
    (homogeneous) to 1.2 (heavy heterogeneity).

For each selection rule the study reports, at 40%/50% target sparsity:
achieved sparsity, dropped energy fraction, and relative output error
through a random projection — side by side for TEAL's elementwise rule,
group top-k, calibrated group thresholds, and both group modes after the
magnitude-sorted channel permutation (`calibration/permute.py`), at the
exact G=32/64 group sizes the bench kernel uses.

Output: markdown table (stdout) consumed by docs/ACCURACY.md.
"""

import argparse

import numpy as np

PROFILES = {
    # (noise, channel-heterogeneity s): h1-like and h2-like synthetic cases
    "h1-gauss": ("gauss",),
    "h2-laplace": ("laplace",),
}


def synth_acts(rng, P, K, noise, s_hetero, sigma=None):
    if sigma is None:
        sigma = np.exp(rng.normal(0.0, s_hetero, K))
    if noise == "gauss":
        eps = rng.normal(size=(P, K))
    else:
        eps = rng.laplace(size=(P, K))
    return eps * sigma[None, :], sigma


def group_scores(x, G):
    P, K = x.shape
    return np.abs(x).reshape(P, K // G, G).max(-1)


def apply_rule(x, rule, s, G, perm=None, x_cal=None):
    """Mask x under a selection rule at target sparsity s.

    Thresholds are calibrated on a held-out sample (x_cal), exactly as the
    pipeline calibrates on a corpus then applies at inference.
    """
    if perm is not None:
        x = x[:, perm]
        x_cal = x_cal[:, perm]
    P, K = x.shape
    if rule == "teal":
        t = np.quantile(np.abs(x_cal), s)
        mask = np.abs(x) > t
    elif rule == "group-topk":
        sc = group_scores(x, G)
        nb = K // G
        k = max(1, int(round(nb * (1 - s))))
        kth = np.sort(sc, axis=1)[:, nb - k][:, None]
        mask = np.repeat(sc >= kth, G, axis=1)
    elif rule == "group-thresh":
        sc_cal = group_scores(x_cal, G)
        t = np.quantile(sc_cal, s)
        sc = group_scores(x, G)
        nb = K // G
        cap = max(1, int(round(nb * (1 - s) * 1.25)))
        surv = sc > t
        # first-cap-by-index (the kernel's unified rule)
        over = np.cumsum(surv, axis=1) > cap
        mask = np.repeat(surv & ~over, G, axis=1)
    else:
        raise ValueError(rule)
    xm = np.where(mask, x, 0.0)
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        xm = xm[:, inv]
        mask = mask[:, inv]
    return xm, mask


def measure(x, xm, mask, W):
    y = x @ W
    ys = xm @ W
    denom = np.linalg.norm(y) + 1e-30
    return {
        "sparsity": 1.0 - mask.mean(),
        "energy_dropped": 1.0 - (xm ** 2).sum() / ((x ** 2).sum() + 1e-30),
        "rel_err": np.linalg.norm(ys - y) / denom,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=4096)
    ap.add_argument("--positions", type=int, default=2048)
    ap.add_argument("--out-dim", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    K, P, N = args.channels, args.positions, args.out_dim
    W = rng.normal(size=(K, N)) / np.sqrt(K)

    rows = []
    for prof, (noise,) in PROFILES.items():
        for s_het in (0.0, 0.6, 1.2):
            x_cal, sigma = synth_acts(rng, P, K, noise, s_het)
            # held-out eval draw with the SAME channel profile
            x, _ = synth_acts(rng, P, K, noise, s_het, sigma=sigma)
            perm = np.argsort(-np.abs(x_cal).mean(0), kind="stable")
            for s in (0.4, 0.5):
                for G in (32, 64, 128):
                    for rule, use_perm in (
                        ("teal", False),
                        ("group-topk", False),
                        ("group-thresh", False),
                        ("group-topk", True),
                        ("group-thresh", True),
                    ):
                        if rule == "teal" and G != 32:
                            continue  # G-independent
                        xm, mask = apply_rule(
                            x, rule, s, G,
                            perm=perm if use_perm else None, x_cal=x_cal,
                        )
                        m = measure(x, xm, mask, W)
                        rows.append({
                            "profile": prof, "hetero": s_het,
                            "target_s": s, "G": "-" if rule == "teal" else G,
                            "rule": rule + ("+perm" if use_perm else ""),
                            **m,
                        })

    print("| profile | channel het. | target s | rule | G | achieved s "
          "| energy dropped | rel. output err |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['profile']} | {r['hetero']} | {r['target_s']} "
              f"| {r['rule']} | {r['G']} | {r['sparsity']:.3f} "
              f"| {r['energy_dropped']:.4f} | {r['rel_err']:.4f} |")


if __name__ == "__main__":
    main()
