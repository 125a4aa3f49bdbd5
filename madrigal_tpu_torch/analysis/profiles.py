"""Drug-name matching, organ-grouped score tables, and DDI-profile
similarity studies (port of `madrigal_tpu/analysis/profiles.py`: a copy;
numpy and scipy on the host).

The computational core of the reference's discussion notebooks
(reference: notebooks/discussions/discussions_combomatch.ipynb — match
trial drug names against the metadata's synonym sets, group adverse DDI
classes by organ via notebooks/drugbank_ddi_organs.csv, and tabulate
per-combo per-class scores for the strip plot;
notebooks/discussions/discussions_proteomics_analysis.ipynb — wide
binary DDI profiles per drug, Jaccard similarity matrices, binned
similarity comparisons with Mann-Whitney U, and the high-embedding-
similarity contrast of proteome-fingerprint correlations). The paper's
external datasets (ComboMATCH arms, Mitchell 2023 proteome
fingerprints) are inputs here, not baked in — a user supplies their own
names/pairs/fingerprints and gets the same statistics.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Name matching (discussions_combomatch.ipynb cells 0/4: lowercase
# node_name + cmap_name synonym sets; discussions_proteomics cell 16
# additionally squashes '-', '_', ' ' out of names before matching).


def normalize_name(name: str, squash: bool = False) -> str:
    """Lowercase (and optionally strip '-', '_', ' ' — the proteomics
    notebook's compound_name_plain convention)."""
    s = str(name).lower()
    if squash:
        for ch in "-_ ":
            s = s.replace(ch, "")
    return s


def match_drug_names(
    names: Sequence[str],
    name_sets: Sequence[Sequence[str]],
    squash: bool = False,
) -> Dict[str, Optional[int]]:
    """Map query names to drug indices via per-drug synonym sets.

    `name_sets[i]` holds every known name of drug i (the notebooks build
    these from node_name + cmap_name). Returns {query: index or None};
    like the notebook's `matched_indices[...][0]`, the first matching
    drug wins when several share a synonym. Matching is exact after
    normalize_name on both sides.
    """
    lut: Dict[str, int] = {}
    for i, syns in enumerate(name_sets):
        for s in syns:
            lut.setdefault(normalize_name(s, squash), i)
    return {q: lut.get(normalize_name(q, squash)) for q in names}


# ---------------------------------------------------------------------------
# Organ grouping of DDI classes (combomatch cells 2/5; the reference
# ships notebooks/drugbank_ddi_organs.csv: "ddi_class\torgan", organ a
# comma-separated list).


def load_organ_map(path: str) -> Dict[str, List[str]]:
    """Parse a ddi_class -> [organs] TSV (drugbank_ddi_organs.csv
    layout: tab-separated, header row, organs comma-joined)."""
    out: Dict[str, List[str]] = {}
    with open(path) as f:
        header = f.readline()
        if "\t" not in header:
            raise ValueError(f"{path}: expected tab-separated header")
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            cls, organs = line.split("\t", 1)
            out[cls] = [o.strip() for o in organs.split(",") if o.strip()]
    return out


def organ_class_groups(
    class_names: Sequence[str],
    organ_map: Dict[str, Sequence[str]],
    exclude: Sequence[str] = (),
) -> Dict[str, List[int]]:
    """organ -> label indices, skipping excluded class names (the
    notebook drops the 'decrease'-direction classes, cell 2). A class
    annotated with several organs lands in each group, matching the
    notebook's specific_organs_mapping loop (cell 5)."""
    drop = set(exclude)
    groups: Dict[str, List[int]] = {}
    for i, name in enumerate(class_names):
        if name in drop:
            continue
        for organ in organ_map.get(name, ()):
            groups.setdefault(organ, []).append(i)
    return groups


def combo_class_table(
    tensor,
    pairs: Sequence[Tuple[int, int]],
    pair_names: Sequence[str],
    class_names: Sequence[str],
    organ_map: Optional[Dict[str, Sequence[str]]] = None,
    exclude: Sequence[str] = (),
) -> Dict[str, np.ndarray]:
    """Long-format strip-plot table: one row per (combo, class[, organ])
    with the [L, N, N] tensor's value (combomatch cells 5-6). Returns
    {'pair': [R] str, 'ddi_class': [R] str, 'value': [R] f64,
    'organ': [R] str} ('organ' only when organ_map given; classes with
    no organ annotation are dropped then, like the notebook's
    organ-specific strip plot)."""
    if len(pairs) != len(pair_names):
        raise ValueError(f"{len(pairs)} pairs vs {len(pair_names)} names")
    from .ddi_queries import pair_values

    drop = set(exclude)
    if organ_map is None:
        rows = [(i, None) for i, n in enumerate(class_names)
                if n not in drop]
    else:
        groups = organ_class_groups(class_names, organ_map, exclude)
        rows = sorted((i, organ) for organ, idxs in groups.items()
                      for i in idxs)
    if not rows:
        raise ValueError("no classes left after exclusion")
    labels = sorted({i for i, _ in rows})
    vals = pair_values(tensor, pairs, labels)  # [L', P]
    pos = {l: k for k, l in enumerate(labels)}
    pair_col, cls_col, val_col, organ_col = [], [], [], []
    for i, organ in rows:
        for p, name in enumerate(pair_names):
            pair_col.append(name)
            cls_col.append(class_names[i])
            val_col.append(vals[pos[i], p])
            organ_col.append(organ)
    out = {
        "pair": np.asarray(pair_col),
        "ddi_class": np.asarray(cls_col),
        "value": np.asarray(val_col, np.float64),
    }
    if organ_map is not None:
        out["organ"] = np.asarray(organ_col)
    return out


# ---------------------------------------------------------------------------
# DDI-profile similarity (discussions_proteomics cells 2-4, 24).


def ddi_profile_matrix(
    pairs: Sequence[Tuple[int, int]],
    n_drugs: int,
    labels: Optional[Sequence[int]] = None,
    kind: str = "partner",
) -> np.ndarray:
    """Wide binary interaction profile per drug from an undirected pair
    list. kind='partner': [N, N] partner-only (cell 2's
    drugs_ddis_wide); 'label': [N, L] outcome-only (cell 3);
    'partner_label': [N, N*L] joint (cell 4). Pairs are symmetrized
    (each side gets the other as partner)."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    a, b = pairs[:, 0], pairs[:, 1]
    if kind == "partner":
        out = np.zeros((n_drugs, n_drugs), bool)
        out[a, b] = True
        out[b, a] = True
        return out
    if labels is None:
        raise ValueError(f"kind={kind!r} needs labels")
    lab = np.asarray(labels, np.int64)
    n_lab = int(lab.max()) + 1 if lab.size else 0
    if kind == "label":
        out = np.zeros((n_drugs, n_lab), bool)
        out[a, lab] = True
        out[b, lab] = True
        return out
    if kind == "partner_label":
        out = np.zeros((n_drugs, n_drugs * n_lab), bool)
        out[a, b * n_lab + lab] = True
        out[b, a * n_lab + lab] = True
        return out
    raise ValueError(kind)


def jaccard_similarity(profiles: np.ndarray) -> np.ndarray:
    """[N, N] Jaccard similarity of binary profile rows (cell 24's
    'jaccard similarity between ddi profiles'). Rows with empty
    profiles get similarity 0 (and 1 on the diagonal)."""
    p = np.asarray(profiles, bool).astype(np.float64)
    inter = p @ p.T
    sizes = p.sum(axis=1)
    union = sizes[:, None] + sizes[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        sim = np.where(union > 0, inter / np.maximum(union, 1e-300), 0.0)
    np.fill_diagonal(sim, 1.0)
    return sim


def lower_triangle_pairs(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Strict-lower-triangle index pair (rows, cols) — the notebook's
    np.tril_indices_from(sim, k=-1) sampling of unordered pairs."""
    return np.tril_indices(n, k=-1)


def binned_similarity_compare(
    x: np.ndarray,
    y: np.ndarray,
    n_bins: int = 3,
    negative_bucket: bool = True,
) -> Dict[str, object]:
    """Bin paired samples by x (e.g. proteome-profile similarity) and
    compare y (e.g. DDI-profile similarity) across bins (proteomics
    cells 25-29): equal-width bins over [0, 1), an optional '<0' bucket
    for negative correlations, per-bin mean/count, and the notebook's
    Mann-Whitney U of the bottom bin vs the top bin (alternative
    'less'). Returns {'bin_labels', 'bin_of', 'means', 'counts',
    'statistic', 'pvalue'}."""
    from scipy.stats import mannwhitneyu

    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError(f"{x.shape} x vs {y.shape} y")
    keep = np.isfinite(x) & np.isfinite(y)
    x, y = x[keep], y[keep]
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    labels = [f"[{lo:.2f}, {hi:.2f})" for lo, hi in zip(edges[:-1],
                                                        edges[1:])]
    bin_of = np.clip(np.digitize(x, edges[1:-1]), 0, n_bins - 1)
    if negative_bucket:
        labels = ["<0"] + labels
        bin_of = np.where(x < 0, 0, bin_of + 1)
    means = np.array([y[bin_of == b].mean() if (bin_of == b).any()
                      else np.nan for b in range(len(labels))])
    counts = np.array([(bin_of == b).sum() for b in range(len(labels))])
    lo_b, hi_b = (1, len(labels) - 1) if negative_bucket else \
        (0, len(labels) - 1)
    lo_y, hi_y = y[bin_of == lo_b], y[bin_of == hi_b]
    if lo_y.size and hi_y.size:
        res = mannwhitneyu(lo_y, hi_y, alternative="less")
        stat, pval = float(res.statistic), float(res.pvalue)
    else:
        stat, pval = float("nan"), float("nan")
    return {"bin_labels": labels, "bin_of": bin_of, "means": means,
            "counts": counts, "statistic": stat, "pvalue": pval}


def high_similarity_contrast(
    embed_sim: np.ndarray,
    target_overlap: np.ndarray,
    values: np.ndarray,
    threshold: float = 0.95,
    n_background: int = 10000,
    seed: int = 42,
) -> Dict[str, object]:
    """The proteomics notebook's final contrast (cell 35): among drug
    pairs, split the high-embedding-similarity ones (> threshold) by
    whether they share an annotated target (overlap > 0), sample a
    random background, and compare each group's external values (the
    proteome-fingerprint correlations) with Mann-Whitney U vs the
    background. Inputs are flat per-pair arrays. Returns the three
    groups' values plus {'shared_pvalue', 'unshared_pvalue'} (each
    'greater' vs background)."""
    from scipy.stats import mannwhitneyu

    embed_sim = np.asarray(embed_sim, np.float64).ravel()
    target_overlap = np.asarray(target_overlap, np.float64).ravel()
    values = np.asarray(values, np.float64).ravel()
    if not (embed_sim.shape == target_overlap.shape == values.shape):
        raise ValueError("per-pair arrays must be the same length")
    hi = embed_sim > threshold
    shared = values[hi & (target_overlap > 0)]
    unshared = values[hi & (target_overlap == 0)]
    rng = np.random.RandomState(seed)
    n_background = min(n_background, values.size)
    background = rng.choice(values, n_background, replace=False)

    def _p(grp):
        if grp.size == 0:
            return float("nan")
        return float(mannwhitneyu(grp, background,
                                  alternative="greater").pvalue)

    return {"shared_target": shared, "no_shared_target": unshared,
            "background": background, "shared_pvalue": _p(shared),
            "unshared_pvalue": _p(unshared)}
