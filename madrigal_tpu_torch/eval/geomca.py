"""Geometric Component Analysis (GeomCA) for embedding-space diagnostics
(a copy of `madrigal_tpu/eval/geomca.py`, numpy and scipy).

Pure numpy/scipy re-implementation of the reference's vendored gudhi/
networkx GeomCA (reference: madrigal/evaluate/GeomCA.py:34-474; Poklukar
et al. 2022 definitions):

  * epsilon graph on R (reference set) union E (evaluated set): edge iff
    pairwise distance <= epsilon (Vietoris-Rips 1-skeleton; here via
    scipy.spatial.cKDTree sparse distance matrix)
  * component consistency (Def 2.2): 1 - ||R_i| - |E_i|| / (|R_i| + |E_i|)
  * component quality (Def 2.3): heterogeneous-edge fraction --
    (|edges(RE)| - |edges(R)| - |edges(E)|) / |edges(RE)|
  * network precision/recall (Def 2.5): fraction of E (resp. R) points in
    components passing both thresholds
  * epsilon estimated from a percentile of R's pairwise distances scaled
    by `gamma` (GeomCA.py:250-282 estimate_distance semantics)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


@dataclasses.dataclass
class GeomCAResult:
    epsilon: float
    network_consistency: float
    network_quality: float
    precision: float
    recall: float
    num_components: int
    components: Dict[int, dict]


def estimate_epsilon(R: np.ndarray, percentile: float = 5.0,
                     gamma: float = 1.0, max_pairs: int = 200_000,
                     seed: int = 0) -> float:
    """gamma * percentile of R's pairwise distances (subsampled)."""
    rng = np.random.RandomState(seed)
    n = len(R)
    n_pairs = min(max_pairs, n * (n - 1) // 2)
    i = rng.randint(0, n, n_pairs)
    j = rng.randint(0, n, n_pairs)
    keep = i != j
    d = np.linalg.norm(R[i[keep]] - R[j[keep]], axis=1)
    return float(gamma * np.percentile(d, percentile))


def _epsilon_edges(points: np.ndarray, epsilon: float):
    tree = cKDTree(points)
    coo = tree.sparse_distance_matrix(tree, epsilon, output_type="coo_matrix")
    mask = coo.row < coo.col  # unique undirected edges, no self loops
    return coo.row[mask], coo.col[mask]


def geomca(
    R: np.ndarray,
    E: np.ndarray,
    epsilon: Optional[float] = None,
    gamma: float = 1.0,
    percentile: float = 5.0,
    comp_consistency_threshold: float = 0.75,
    comp_quality_threshold: float = 0.45,
) -> GeomCAResult:
    R = np.asarray(R, np.float64)
    E = np.asarray(E, np.float64)
    nR, nE = len(R), len(E)
    if epsilon is None:
        epsilon = estimate_epsilon(R, percentile, gamma)

    pts = np.concatenate([R, E])
    src, dst = _epsilon_edges(pts, epsilon)

    n = nR + nE
    adj = csr_matrix(
        (np.ones(len(src) * 2),
         (np.concatenate([src, dst]), np.concatenate([dst, src]))),
        shape=(n, n),
    )
    n_comp, labels = connected_components(adj, directed=False)

    is_R_edge = (src < nR) & (dst < nR)
    is_E_edge = (src >= nR) & (dst >= nR)
    edge_comp = labels[src]  # both endpoints share a component

    comps: Dict[int, dict] = {}
    in_quality_R = 0
    in_quality_E = 0
    # order components by size descending like the reference
    sizes = np.bincount(labels, minlength=n_comp)
    order = np.argsort(-sizes)
    for rank, c in enumerate(order):
        nodes = np.nonzero(labels == c)[0]
        r_nodes = nodes[nodes < nR]
        e_nodes = nodes[nodes >= nR] - nR
        denom = len(r_nodes) + len(e_nodes)
        consistency = (
            1.0 - abs(len(r_nodes) - len(e_nodes)) / denom if denom else 0.0
        )
        sel = edge_comp == c
        total_edges = int(sel.sum())
        homo = int((sel & (is_R_edge | is_E_edge)).sum())
        quality = (total_edges - homo) / total_edges if total_edges else 0.0
        comps[rank] = {
            "Ridx": r_nodes,
            "Eidx": e_nodes,
            "comp_consistency": consistency,
            "comp_quality": quality,
        }
        if (consistency > comp_consistency_threshold
                and quality > comp_quality_threshold):
            in_quality_R += len(r_nodes)
            in_quality_E += len(e_nodes)

    network_consistency = 1.0 - abs(nR - nE) / (nR + nE)
    total_edges = len(src)
    homo_edges = int(is_R_edge.sum() + is_E_edge.sum())
    network_quality = (
        (total_edges - homo_edges) / total_edges if total_edges else 0.0
    )
    return GeomCAResult(
        epsilon=float(epsilon),
        network_consistency=network_consistency,
        network_quality=network_quality,
        precision=in_quality_E / nE if nE else 0.0,
        recall=in_quality_R / nR if nR else 0.0,
        num_components=n_comp,
        components=comps,
    )


def sparsify_point_set(points: np.ndarray, min_dist: float) -> np.ndarray:
    """Geometric sparsification (GeomCA Def 3.1; the reference calls
    gudhi.subsampling.sparsify_point_set, GeomCA.py:333-352): greedy scan
    keeping each point only if it lies >= min_dist from every kept point.
    cKDTree lookup keeps this O(n log n)-ish instead of O(n^2)."""
    pts = np.asarray(points, np.float64).reshape(len(points), -1)
    kept: list = []
    tree = None
    rebuild_every = 256
    for i, p in enumerate(pts):
        if not kept:
            kept.append(i)
            tree = None
            continue
        if tree is None or len(kept) % rebuild_every == 0:
            tree = cKDTree(pts[kept])
            n_tree = len(kept)
        d, _ = tree.query(p, k=1)
        ok = d >= min_dist
        if ok and n_tree < len(kept):  # check points added since rebuild
            tail = pts[kept[n_tree:]]
            ok = np.linalg.norm(tail - p, axis=1).min() >= min_dist
        if ok:
            kept.append(i)
    return pts[kept]


def reduce_points(points: np.ndarray, mode: str = "sparsify",
                  min_dist: float = 0.0, n_samples: Optional[int] = None,
                  seed: int = 0) -> np.ndarray:
    """Point reduction before analysis (reference sparsify_points,
    GeomCA.py:284-331): 'sparsify' = geometric min-distance filtering,
    'subsample' = random subsampling (with replacement, matching the
    reference's np.random.choice default)."""
    pts = np.asarray(points, np.float64).reshape(len(points), -1)
    if mode == "sparsify":
        return sparsify_point_set(pts, min_dist)
    if mode == "subsample":
        rng = np.random.RandomState(seed)
        return pts[rng.choice(len(pts), n_samples)]
    raise ValueError(mode)


def geomca_logged(
    R: np.ndarray,
    E: np.ndarray,
    log_dir: str,
    prefix: str = "",
    reduce: Optional[str] = None,
    min_dist: float = 0.0,
    n_samples: Optional[int] = None,
    seed: int = 0,
    **geomca_kwargs,
) -> GeomCAResult:
    """geomca + the reference's component-evolution logging artifacts
    (GeomCA.py:197-248 log_components_stat / log_network_parameters /
    log_network_stats / log_to_txt; JSON instead of pickle): writes
    `<prefix>network_parameters.json`, `<prefix>network_stats.json`,
    `<prefix>components_stats.json` (per-component size/consistency/
    quality ordered largest-first) and a human-readable
    `<prefix>geomca.txt`. `reduce` optionally sparsifies/subsamples both
    point sets first (reduced sizes are logged)."""
    import json
    import os

    os.makedirs(log_dir, exist_ok=True)
    nR0, nE0 = len(R), len(E)
    if reduce:
        R = reduce_points(R, reduce, min_dist, n_samples, seed)
        E = reduce_points(E, reduce, min_dist, n_samples, seed + 1)
    res = geomca(R, E, **geomca_kwargs)

    def dump(name, obj):
        with open(os.path.join(log_dir, prefix + name), "w") as f:
            json.dump(obj, f, indent=1)

    dump("network_parameters.json", {
        "epsilon": res.epsilon,
        "reduce": reduce, "min_dist": min_dist, "n_samples": n_samples,
        "num_R": len(R), "num_E": len(E),
        "num_R_original": nR0, "num_E_original": nE0,
        **{k: v for k, v in geomca_kwargs.items()
           if isinstance(v, (int, float, str, bool, type(None)))},
    })
    dump("network_stats.json", {
        "precision": res.precision, "recall": res.recall,
        "network_consistency": res.network_consistency,
        "network_quality": res.network_quality,
        "num_components": res.num_components,
    })
    dump("components_stats.json", [
        {"rank": rank, "num_R": len(c["Ridx"]), "num_E": len(c["Eidx"]),
         "comp_consistency": c["comp_consistency"],
         "comp_quality": c["comp_quality"]}
        for rank, c in res.components.items()
    ])
    with open(os.path.join(log_dir, prefix + "geomca.txt"), "w") as f:
        f.write(
            f"epsilon: {res.epsilon:.6f}\n"
            f"precision: {res.precision:.4f}\nrecall: {res.recall:.4f}\n"
            f"network_consistency: {res.network_consistency:.4f}\n"
            f"network_quality: {res.network_quality:.4f}\n"
            f"num_components: {res.num_components}\n\n")
        for rank, c in res.components.items():
            f.write(f"component {rank}: |R|={len(c['Ridx'])} "
                    f"|E|={len(c['Eidx'])} "
                    f"consistency={c['comp_consistency']:.4f} "
                    f"quality={c['comp_quality']:.4f}\n")
    return res
