"""Evaluation metrics for OGB parity runs: ROC-AUC (ogbg-molhiv) and AP
(ogbg-molpcba), dependency-free.

The port's own copy of ``flowgnn_tpu.bench.metrics`` (whose package imports
jax): the same arithmetic on the same inputs, held equal to it by
``tests/test_torch_ogb_metrics.py``. The reference has no accuracy harness
(its hosts only dump predictions to HLS_output.txt); ``cli accuracy``
scores a labelled dataset with these.
"""

from __future__ import annotations

import numpy as np


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC-AUC via the rank statistic, tied scores given their
    average rank; NaN where either class is absent."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    pos = labels == 1
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, scores.size + 1)
    sorted_scores = scores[order]
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """AP (area under precision-recall, step interpolation), the molpcba
    metric. NaN labels (molpcba's missing task entries) are ignored; NaN
    where no positive label is left."""
    labels = np.asarray(labels, np.float64).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    keep = ~np.isnan(labels)
    labels, scores = labels[keep], scores[keep]
    n_pos = int((labels == 1).sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    tp = np.cumsum(labels[order] == 1)
    precision = tp / np.arange(1, labels.size + 1)
    return float((precision * (labels[order] == 1)).sum() / n_pos)
