"""Paired system comparison (pt.Experiment parity).

The reference evaluates every trained model against a baseline with paired
significance (eval.py:26 ``pt.Experiment(..., baseline=0)``). This is the
same: mean metrics per system plus two-sided paired t-test p-values vs the
baseline system over the shared query set.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from pacednegatives_tpu_torch.eval.metrics import Qrels, Run, evaluate_run


def _paired_t(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sided paired t-test p-value (scipy-free fallback inside)."""
    try:
        from scipy.stats import ttest_rel

        return float(ttest_rel(a, b).pvalue)
    except Exception:
        d = a - b
        n = len(d)
        if n < 2 or np.allclose(d, 0):
            return 1.0
        t = d.mean() / (d.std(ddof=1) / np.sqrt(n))
        # normal approximation
        from math import erf, sqrt

        return 2 * (1 - 0.5 * (1 + erf(abs(t) / sqrt(2))))


def experiment(
    runs: Mapping[str, Run],
    qrels: Qrels,
    metrics: Sequence[str] = ("map", "ndcg_cut_10", "recip_rank"),
    baseline: str | None = None,
) -> list[dict]:
    """Rows of {name, <metric>..., <metric>_pvalue...} like pt.Experiment."""
    per_system = {
        name: evaluate_run(run, qrels, metrics) for name, run in runs.items()
    }
    if baseline is None:
        baseline = next(iter(runs))

    # common qids per metric (paired comparison needs alignment)
    rows = []
    for name, vals in per_system.items():
        row: dict = {"name": name}
        for m in metrics:
            qids = sorted(vals[m])
            row[m] = float(np.mean([vals[m][q] for q in qids])) if qids else 0.0
            if name != baseline:
                base_vals = per_system[baseline][m]
                shared = sorted(set(qids) & set(base_vals))
                if shared:
                    a = np.array([vals[m][q] for q in shared])
                    b = np.array([base_vals[q] for q in shared])
                    row[f"{m}_pvalue"] = _paired_t(a, b)
        rows.append(row)
    return rows
