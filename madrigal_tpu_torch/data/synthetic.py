"""Synthetic miniature Madrigal dataset generator.

The reference repo ships no data (its metadata pkl / KG / signature CSVs
live on external storage -- reference README.md setup section). This module
fabricates a structurally-faithful miniature dataset so tests, benches and
the end-to-end training loops exercise every code path: per-drug molecules,
a small heterogeneous KG, cv/tx signature tables, modality-availability
masks, and a directed long-format DDI table with fixed negatives
(reference formats: madrigal/data/data.py:556-612, 759-974).

Port note: the DDI edge table is an `EdgeTable` (a small numpy column
container with the reference DataFrame's column names), so nothing here
needs pandas. For the same seed every array and column equals the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..constants import (
    BOND_DIM,
    CELL_LINES,
    CV_INPUT_DIM,
    MOL_DIM,
    NON_TX_MODALITIES,
    NUM_CELL_LINES,
    NUM_MODALITIES,
    NUM_NON_TX_MODALITIES,
    TX_INPUT_DIM,
)


class EdgeTable:
    """Column container for the long-format DDI table: the columns of the
    reference's DataFrame (`head`, `tail`, `label_indexed`, `neg_head`,
    `neg_tail`, ...) as equal-length 1-D numpy arrays."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self._cols = {k: np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {lengths}")

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def take(self, rows) -> "EdgeTable":
        """The rows at the given positions (or boolean mask), in that
        order: the reference's `df.iloc[rows].reset_index(drop=True)`."""
        return EdgeTable({k: v[rows] for k, v in self._cols.items()})

    def replace(self, drop=(), **columns) -> "EdgeTable":
        """A copy without the `drop` columns and with `columns` set."""
        cols = {k: v for k, v in self._cols.items() if k not in drop}
        cols.update(columns)
        return EdgeTable(cols)


@dataclasses.dataclass
class SyntheticDataset:
    num_drugs: int
    num_labels: int
    molecules: List[dict]  # per-drug graph dicts (molgraph.pack_molecules fmt)
    mod_avail: np.ndarray  # [num_drugs, NUM_MODALITIES] 1=available
    cv_table: np.ndarray  # [num_drugs, CV_INPUT_DIM]
    tx_table: np.ndarray  # [NUM_CELL_LINES, num_drugs, TX_INPUT_DIM]
    tx_dosages: np.ndarray  # [NUM_CELL_LINES, num_drugs]
    kg_node_feats: Dict[str, np.ndarray]
    kg_edge_indices: Dict[tuple, np.ndarray]
    kg_drug_ids: np.ndarray  # global drug id per KG drug-node row
    edge_df: "EdgeTable"  # head, tail, label_indexed, neg_head, neg_tail
    extra_tabular: dict = dataclasses.field(default_factory=dict)
    # extra non-tx tabular modality tables ({'bs': [num_drugs, dim], ...};
    # active when NON_TX_MODALITIES env includes them -- utils.py:30-37)

    @property
    def masks(self) -> np.ndarray:
        """Key-padding convention: True = missing (reference data.py:944)."""
        return self.mod_avail == 0


def random_molecule(rng: np.random.RandomState, n_atoms: int) -> dict:
    node_feats = (rng.rand(n_atoms, MOL_DIM) < 0.15).astype(np.float32)
    edges, feats = [], []
    for i in range(1, n_atoms):
        j = int(rng.randint(0, i))
        f = (rng.rand(BOND_DIM) < 0.3).astype(np.float32)
        edges += [(i, j), (j, i)]
        feats += [f, f]
    # a few extra ring-closure bonds
    for _ in range(max(0, n_atoms // 4)):
        i, j = rng.randint(0, n_atoms, 2)
        if i == j:
            continue
        f = (rng.rand(BOND_DIM) < 0.3).astype(np.float32)
        edges += [(i, j), (j, i)]
        feats += [f, f]
    return {
        "node_feats": node_feats,
        "edge_index": np.asarray(edges, np.int32).reshape(-1, 2),
        "edge_feats": np.asarray(feats, np.float32).reshape(-1, BOND_DIM),
    }


# PrimeKG-like scale spec (~122.5k nodes, 17 edge types, ~8.3M directed
# edges -- reference kg_pretraining_prep.ipynb's graph): the canonical
# node/edge counts used by every reference-scale bench (scripts/
# hgt_scale_bench.py, train_scale_bench.py, stage1_scale_bench.py) and by
# make_reference_scale_dataset below.
PRIMEKG_NODE_TYPES = {
    "drug": 8000, "protein": 27000, "disease": 17000, "pathway": 2500,
    "bioprocess": 28000, "molfunc": 11000, "cellcomp": 4000,
    "anatomy": 25000,
}
PRIMEKG_EDGE_SPEC = [
    ("drug", "targets", "protein", 300_000),
    ("protein", "rev_targets", "drug", 300_000),
    ("drug", "indication", "disease", 50_000),
    ("disease", "rev_indication", "drug", 50_000),
    ("drug", "interacts", "drug", 600_000),
    ("protein", "ppi", "protein", 1_200_000),
    ("protein", "in_pathway", "pathway", 200_000),
    ("pathway", "rev_in_pathway", "protein", 200_000),
    ("protein", "bp", "bioprocess", 1_100_000),
    ("bioprocess", "rev_bp", "protein", 1_100_000),
    ("protein", "mf", "molfunc", 600_000),
    ("molfunc", "rev_mf", "protein", 600_000),
    ("protein", "cc", "cellcomp", 400_000),
    ("cellcomp", "rev_cc", "protein", 400_000),
    ("disease", "anat", "anatomy", 600_000),
    ("anatomy", "rev_anat", "disease", 600_000),
    ("disease", "dd", "disease", 300_000),
]


def reference_scale_kg_sizes(num_drugs: int = 6843, kg_scale: int = 1):
    """(node count per node type, edge count per edge type) of the KG that
    make_reference_scale_dataset builds for these arguments."""
    nodes = {nt: (max(2, int(num_drugs * 0.8)) if nt == "drug"
                  else max(n // kg_scale, 8))
             for nt, n in PRIMEKG_NODE_TYPES.items()}
    edges = {(src, rel, dst): max(e // kg_scale, 16)
             for src, rel, dst, e in PRIMEKG_EDGE_SPEC}
    return nodes, edges


def _vectorized_ddi_table(num_drugs: int, num_labels: int, num_rows: int,
                          rng: np.random.RandomState):
    """Directed (head, tail, label) rows with per-row fixed negatives --
    the reference long-format table (data.py:556-612) built with array
    ops instead of make_dataset's per-row Python loop (which is O(minutes)
    at the 175k-row reference scale)."""
    def key(l, h, t):
        return (l.astype(np.int64) * num_drugs + h) * num_drugs + t

    h = np.empty(0, np.int64)
    t = np.empty(0, np.int64)
    l = np.empty(0, np.int64)
    while len(h) < num_rows:
        need = int((num_rows - len(h)) * 1.3) + 16
        ch = rng.randint(0, num_drugs, need)
        ct = rng.randint(0, num_drugs, need)
        cl = rng.randint(0, num_labels, need)
        ok = ch != ct
        ch, ct, cl = ch[ok], ct[ok], cl[ok]
        h = np.concatenate([h, ch])
        t = np.concatenate([t, ct])
        l = np.concatenate([l, cl])
        # directedness invariant: (l, h, t) present => (l, t, h) absent
        canon = key(l, np.minimum(h, t), np.maximum(h, t))
        _, first = np.unique(canon, return_index=True)
        keep = np.sort(first)
        h, t, l = h[keep], t[keep], l[keep]
    h, t, l = h[:num_rows], t[:num_rows], l[:num_rows]

    pos_keys = np.sort(np.concatenate([key(l, h, t), key(l, t, h)]))

    def in_pos(k):
        i = np.searchsorted(pos_keys, k)
        i = np.minimum(i, len(pos_keys) - 1)
        return pos_keys[i] == k

    def sample_neg():
        """cand invalid iff it forms a known positive with either end or
        equals either end (make_dataset.sample_neg semantics)."""
        out = np.full(num_rows, -1, np.int64)
        pending = np.arange(num_rows)
        while len(pending):
            cand = rng.randint(0, num_drugs, len(pending))
            lp, hp, tp = l[pending], h[pending], t[pending]
            bad = (in_pos(key(lp, hp, cand)) | in_pos(key(lp, cand, tp))
                   | (cand == hp) | (cand == tp))
            out[pending[~bad]] = cand[~bad]
            pending = pending[bad]
        return out

    return EdgeTable({
        "head": h, "tail": t, "label_indexed": l,
        "neg_head": sample_neg(), "neg_tail": sample_neg(),
    })


def make_reference_scale_dataset(
    num_drugs: int = 6843,
    num_labels: int = 960,
    num_rows: int = 174_763,  # x6 under the train collator (undirect +
    seed: int = 0,            # 2x2 negatives) ~= 1M triples
    kg_scale: int = 1,
    kg_feat_dim: int = 128,
) -> SyntheticDataset:
    """Reference-scale synthetic dataset: 6,843 drugs (data.py:708), 960
    outcomes, the PrimeKG-scale KG (PRIMEKG_NODE_TYPES/EDGE_SPEC at 128-d
    node features), full cv/tx tables -- the CLI-runnable counterpart of
    scripts/train_scale_bench.build_scale_data, for end-to-end wall-clock
    work with the host collator in the loop (--synthetic_scale)."""
    rng = np.random.RandomState(seed)
    molecules = [
        random_molecule(rng, int(rng.randint(8, 40)))
        for _ in range(num_drugs)
    ]

    num_kg_drugs = max(2, int(num_drugs * 0.8))
    kg_drug_ids = np.sort(
        rng.choice(num_drugs, size=num_kg_drugs, replace=False))
    mod_avail = np.zeros((num_drugs, NUM_MODALITIES), dtype=np.int64)
    mod_avail[:, 0] = 1
    mod_avail[kg_drug_ids, 1] = 1
    mod_avail[:, 2] = rng.rand(num_drugs) < 0.6
    extra_tabular = {}
    for j, mod in enumerate(NON_TX_MODALITIES[3:], start=3):
        mod_avail[:, j] = rng.rand(num_drugs) < 0.5
        tab = rng.randn(num_drugs, 64).astype(np.float32)
        tab[mod_avail[:, j] == 0] = 0.0
        extra_tabular[mod] = tab
    for c in range(NUM_CELL_LINES):
        mod_avail[:, NUM_NON_TX_MODALITIES + c] = rng.rand(num_drugs) < 0.3

    cv_table = rng.randn(num_drugs, CV_INPUT_DIM).astype(np.float32)
    cv_table[mod_avail[:, 2] == 0] = 0.0
    tx_table = rng.randn(NUM_CELL_LINES, num_drugs, TX_INPUT_DIM).astype(
        np.float32)
    for c in range(NUM_CELL_LINES):
        tx_table[c, mod_avail[:, NUM_NON_TX_MODALITIES + c] == 0] = 0.0
    tx_dosages = (
        rng.rand(NUM_CELL_LINES, num_drugs).astype(np.float32) * 10.0)
    tx_dosages[tx_table.sum(-1) == 0] = 0.0

    node_counts, edge_counts = reference_scale_kg_sizes(num_drugs, kg_scale)
    kg_node_feats = {
        nt: rng.randn(n, kg_feat_dim).astype(np.float32)
        for nt, n in node_counts.items()
    }
    kg_edge_indices = {}
    for (src, rel, dst), e in edge_counts.items():
        kg_edge_indices[(src, rel, dst)] = np.stack([
            rng.randint(0, kg_node_feats[src].shape[0], e),
            rng.randint(0, kg_node_feats[dst].shape[0], e),
        ]).astype(np.int32)

    edge_df = _vectorized_ddi_table(num_drugs, num_labels, num_rows, rng)
    return SyntheticDataset(
        num_drugs=num_drugs,
        num_labels=num_labels,
        molecules=molecules,
        mod_avail=mod_avail,
        cv_table=cv_table,
        tx_table=tx_table,
        tx_dosages=tx_dosages,
        kg_node_feats=kg_node_feats,
        kg_edge_indices=kg_edge_indices,
        kg_drug_ids=kg_drug_ids,
        edge_df=edge_df,
        extra_tabular=extra_tabular,
    )


def make_dataset(
    num_drugs: int = 32,
    num_labels: int = 12,
    num_edges: int = 120,
    num_proteins: int = 40,
    num_diseases: int = 20,
    kg_feat_dim: int = 24,
    kg_drug_fraction: float = 0.8,
    seed: int = 0,
    extra_tabular_dims: dict = None,
) -> SyntheticDataset:
    rng = np.random.RandomState(seed)
    molecules = [
        random_molecule(rng, int(rng.randint(4, 24))) for _ in range(num_drugs)
    ]

    # modality availability: str always available; kg only for drugs in KG;
    # cv/tx random; every drug has >= 1 modality (str)
    num_kg_drugs = max(2, int(num_drugs * kg_drug_fraction))
    kg_drug_ids = np.sort(
        rng.choice(num_drugs, size=num_kg_drugs, replace=False)
    )
    mod_avail = np.zeros((num_drugs, NUM_MODALITIES), dtype=np.int64)
    mod_avail[:, 0] = 1
    mod_avail[kg_drug_ids, 1] = 1
    mod_avail[:, 2] = rng.rand(num_drugs) < 0.6
    extra_tabular = {}
    for j, mod in enumerate(NON_TX_MODALITIES[3:], start=3):
        mod_avail[:, j] = rng.rand(num_drugs) < 0.5
        dim = (extra_tabular_dims or {}).get(mod, 64)
        tab = rng.randn(num_drugs, dim).astype(np.float32)
        tab[mod_avail[:, j] == 0] = 0.0
        extra_tabular[mod] = tab
    for c in range(NUM_CELL_LINES):
        mod_avail[:, NUM_NON_TX_MODALITIES + c] = rng.rand(num_drugs) < 0.3

    cv_table = rng.randn(num_drugs, CV_INPUT_DIM).astype(np.float32)
    cv_table[mod_avail[:, 2] == 0] = 0.0
    tx_table = rng.randn(NUM_CELL_LINES, num_drugs, TX_INPUT_DIM).astype(
        np.float32
    )
    for c in range(NUM_CELL_LINES):
        tx_table[c, mod_avail[:, NUM_NON_TX_MODALITIES + c] == 0] = 0.0
    tx_dosages = (
        rng.rand(NUM_CELL_LINES, num_drugs).astype(np.float32) * 10.0
    )
    tx_dosages[tx_table.sum(-1) == 0] = 0.0

    # small PrimeKG-like heterogeneous graph
    kg_node_feats = {
        "drug": rng.randn(num_kg_drugs, kg_feat_dim).astype(np.float32),
        "protein": rng.randn(num_proteins, kg_feat_dim).astype(np.float32),
        "disease": rng.randn(num_diseases, kg_feat_dim).astype(np.float32),
    }

    def rand_edges(ns, nd, e):
        return np.stack([rng.randint(0, ns, e), rng.randint(0, nd, e)])

    kg_edge_indices = {
        ("drug", "targets", "protein"): rand_edges(num_kg_drugs, num_proteins, 80),
        ("protein", "rev_targets", "drug"): rand_edges(num_proteins, num_kg_drugs, 80),
        ("protein", "ppi", "protein"): rand_edges(num_proteins, num_proteins, 120),
        ("drug", "indication", "disease"): rand_edges(num_kg_drugs, num_diseases, 40),
        ("disease", "rev_indication", "drug"): rand_edges(num_diseases, num_kg_drugs, 40),
        ("protein", "assoc", "disease"): rand_edges(num_proteins, num_diseases, 60),
        ("disease", "rev_assoc", "protein"): rand_edges(num_diseases, num_proteins, 60),
    }

    # directed long-format DDI table with fixed negatives
    # (reference data.py:556-612: head, tail, label_indexed, neg_head, neg_tail)
    seen = set()
    rows = []
    while len(rows) < num_edges:
        h, t = rng.randint(0, num_drugs, 2)
        l = int(rng.randint(0, num_labels))
        if h == t or (l, h, t) in seen or (l, t, h) in seen:
            continue
        seen.add((l, h, t))
        rows.append((h, t, l))
    heads, tails, labels = map(np.asarray, zip(*rows))

    def sample_neg(exclude_pairs, n):
        out = np.empty(n, dtype=np.int64)
        for i in range(n):
            while True:
                cand = int(rng.randint(0, num_drugs))
                if (labels[i], heads[i], cand) not in seen and (
                    labels[i], cand, tails[i]
                ) not in seen and cand != heads[i] and cand != tails[i]:
                    out[i] = cand
                    break
        return out

    neg_heads = sample_neg(seen, num_edges)
    neg_tails = sample_neg(seen, num_edges)

    edge_df = EdgeTable(
        {
            "head": heads,
            "tail": tails,
            "label_indexed": labels,
            "neg_head": neg_heads,
            "neg_tail": neg_tails,
        }
    )

    return SyntheticDataset(
        num_drugs=num_drugs,
        num_labels=num_labels,
        molecules=molecules,
        mod_avail=mod_avail,
        cv_table=cv_table,
        tx_table=tx_table,
        tx_dosages=tx_dosages,
        kg_node_feats=kg_node_feats,
        kg_edge_indices=kg_edge_indices,
        kg_drug_ids=kg_drug_ids,
        edge_df=edge_df,
        extra_tabular=extra_tabular,
    )


def make_split_dataset(
    num_drugs: int = 32,
    num_labels: int = 12,
    num_edges: int = 160,
    split_method: str = "split_by_triplets",
    val_frac: float = 0.15,
    test_frac: float = 0.15,
    seed: int = 0,
):
    """Dataset + split edge tables mirroring the reference's split families
    (reference: madrigal/data/data.py:556-612 split semantics):

    * split_by_triplets / split_by_pairs: random row split; every split has
      neg_head/neg_tail columns.
    * split_by_drugs_*: drugs partition into train/eval sets; 'between'
      edges (eval-head -> train-tail) carry neg_tail_1/neg_tail_2 fixed
      negatives (data.py:584-589); 'within' edges connect eval drugs.

    Returns (SyntheticDataset-with-train-edges, {split_name: EdgeTable}),
    equal for the same seed to the JAX package's DataFrames.
    """
    rng = np.random.RandomState(seed)
    ds = make_dataset(num_drugs, num_labels, num_edges * 2, seed=seed)
    df = ds.edge_df

    if split_method in ("split_by_triplets", "split_by_pairs"):
        perm = rng.permutation(len(df))
        n_val = int(len(df) * val_frac)
        n_test = int(len(df) * test_frac)
        splits = {"train": df.take(perm[n_val + n_test:]),
                  "val": df.take(perm[:n_val]),
                  "test": df.take(perm[n_val:n_val + n_test])}
    elif split_method.startswith("split_by_drugs"):
        drugs = rng.permutation(num_drugs)
        n_eval = max(2, int(num_drugs * (val_frac + test_frac)))
        eval_drugs = set(drugs[:n_eval].tolist())
        half = len(eval_drugs) // 2
        val_drugs = set(list(eval_drugs)[:half])

        def classify(h, t):
            h_in, t_in = h in eval_drugs, t in eval_drugs
            if not h_in and not t_in:
                return "train"
            which = "val" if (h in val_drugs or t in val_drugs) else "test"
            return f"{which}_within" if h_in and t_in else f"{which}_between"

        names = np.asarray([classify(int(h), int(t))
                            for h, t in zip(df["head"], df["tail"])])
        splits = {}
        for name in sorted(set(names.tolist())):  # groupby order
            sub = df.take(names == name)
            if name.endswith("_between"):
                # between-split fixed negatives corrupt only the train-side
                # tail (data.py:584-589)
                train_side = sorted(set(range(num_drugs)) - eval_drugs)
                sub = sub.replace(
                    drop=("neg_head", "neg_tail"),
                    neg_tail_1=rng.choice(train_side, len(sub)),
                    neg_tail_2=rng.choice(train_side, len(sub)))
            splits[name] = sub
        splits.setdefault("train", df.take(names == "train"))
    else:
        raise ValueError(split_method)

    ds.edge_df = splits["train"]
    return ds, splits
