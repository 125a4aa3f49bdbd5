"""Contrastive-pretraining evaluation metrics (a copy of
`madrigal_tpu/eval/cl_metrics.py`, numpy and scipy; umap and matplotlib
are imported only inside the plotting helpers).

Port of the reference CL eval utilities
(reference: madrigal/evaluate/eval_utils.py:148-243): uniformity and
alignment losses, stacked instance-discrimination top-k retrieval accuracy,
FOSCTTM (fraction of samples closer than the true match), and a kNN
classifier over embeddings.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _normalize(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def uniform_loss(x: np.ndarray, t: float = 2.0) -> float:
    """log mean exp(-t * ||xi - xj||^2) over pairs (eval_utils.py:148-150)."""
    x = _normalize(np.asarray(x))
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    iu = np.triu_indices(len(x), k=1)
    return float(np.log(np.mean(np.exp(-t * d2[iu]))))


def alignment_loss(x1, x2, alpha: float = 2.0) -> float:
    x1, x2 = _normalize(np.asarray(x1)), _normalize(np.asarray(x2))
    return float(np.mean(np.linalg.norm(x1 - x2, axis=1) ** alpha))


def retrieval_topk_accuracy(
    emb_a: np.ndarray, emb_b: np.ndarray, topk: Sequence[int] = (1, 5, 20)
) -> Tuple[float, ...]:
    """Cross-modal retrieval: for each row of emb_a, rank rows of emb_b by
    cosine similarity; correct = the same index (eval_utils.py:158-174)."""
    a, b = _normalize(emb_a), _normalize(emb_b)
    sim = a @ b.T
    order = np.argsort(-sim, axis=1)
    target = np.arange(len(a))[:, None]
    res = []
    for k in topk:
        res.append(float(np.mean((order[:, :k] == target).any(axis=1))))
    return tuple(res)


def foscttm(R: np.ndarray, E: np.ndarray) -> Tuple[float, float]:
    """Fraction of samples closer than the true match
    (eval_utils.py:232-243): for each i, the fraction of rows of R closer
    to E[i] than R[i] is. Returns (mean, std)."""
    R, E = np.asarray(R), np.asarray(E)
    out = np.empty(E.shape[0])
    for i in range(E.shape[0]):
        dist = np.linalg.norm(R - E[i], axis=-1)
        out[i] = np.sum(dist < dist[i]) / dist.shape[0]
    return float(out.mean()), float(out.std(ddof=1))


def knn_classifier(
    train_features, train_labels, test_features, test_labels,
    metric: str = "cosine", k: int = 5, T: float = 1.0, num_classes: int = 2,
) -> float:
    """DINO-style weighted kNN top-1 accuracy (eval_utils.py:177-229)."""
    train_features = np.asarray(train_features)
    test_features = np.asarray(test_features)
    train_labels = np.asarray(train_labels)
    test_labels = np.asarray(test_labels)

    if metric == "cosine":
        sim = _normalize(test_features) @ _normalize(train_features).T
        idx = np.argsort(-sim, axis=1)[:, :k]
        d = np.take_along_axis(sim, idx, axis=1)
    elif metric == "euclidean":
        from scipy.spatial import distance_matrix

        dm = distance_matrix(test_features, train_features)
        idx = np.argsort(dm, axis=1)[:, :k]
        d = np.take_along_axis(dm, idx, axis=1)
    else:
        raise ValueError(metric)

    neighbors = train_labels[idx]  # [N_test, k]
    onehot = np.zeros((len(test_labels), k, num_classes))
    np.put_along_axis(onehot, neighbors[..., None], 1.0, axis=2)
    w = np.exp(d / T)[..., None]
    probs = np.sum(onehot * w, axis=1)
    pred = np.argmax(probs, axis=1)
    return float(np.mean(pred == test_labels))


def embedding_plot_coords(embeds, method: str = "auto", seed: int = 42):
    """2-D coordinates for embedding scatter plots (the reference draws
    UMAP plots per modality -- eval_utils.py:389-597 draw_umap_plot).
    Uses umap-learn when installed, else a PCA fallback."""
    x = np.asarray(embeds, np.float64)
    if method in ("auto", "umap"):
        try:
            from umap import UMAP

            return UMAP(random_state=seed).fit_transform(x), "umap"
        except ImportError:
            if method == "umap":
                raise
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    return xc @ vt[:2].T, "pca"


def plot_embeddings(
    embeds_by_group, out_path: str, title: str = "embeddings",
    method: str = "auto", seed: int = 42,
):
    """Scatter plot of 2-D-projected embeddings colored by group (the
    reference's draw_umap_plot role, eval_utils.py:389-597; matplotlib
    instead of plotly, UMAP when installed else PCA)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = list(embeds_by_group)
    all_x = np.concatenate([np.asarray(embeds_by_group[g]) for g in groups])
    coords, used = embedding_plot_coords(all_x, method=method, seed=seed)
    fig, ax = plt.subplots(figsize=(6, 5))
    off = 0
    for g in groups:
        n = len(embeds_by_group[g])
        ax.scatter(coords[off:off + n, 0], coords[off:off + n, 1],
                   s=8, alpha=0.7, label=str(g))
        off += n
    ax.legend(fontsize=7)
    ax.set_title(f"{title} ({used})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
