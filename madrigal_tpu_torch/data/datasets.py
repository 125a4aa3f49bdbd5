"""Reference-format dataset loading without pandas (port of
`madrigal_tpu/data/datasets.py`).

Reads the on-disk layout the reference consumes
(reference: madrigal/data/data.py:377-444 get_train_data):
  <root>/views_features_new/combined_metadata_ddi.{pkl,csv}
      -- per-drug metadata: canonical_smiles, view_str/view_kg/view_cv/
         view_tx_<cell> availability columns, <mod>_sig_id columns,
         <cell>_max_dose_averaged_sig_id, <cell>_pert_dose
  <root>/views_features_new/cv/cv.csv            -- [sig_dim x sigs] table
  <root>/views_features_new/tx/tx.csv            -- LINCS signatures
  <root>/views_features_new/kg/kg_edges.npz      -- per-edge-type indices
  <root>/polypharmacy_new/<source>/<split_method>/<split>_df.csv
      -- long-format DDI tables (head, tail, label_indexed, neg_*)

Everything loads into the same `SyntheticDataset` (with an `EdgeTable`)
the collators consume, and the arrays equal the JAX package's loader's.
The csv files are read with the csv module and numpy (of a signature
table, the columns some drug's id names), keeping the
pandas semantics the JAX loader relies on: `read_csv(index_col=0)`,
quoted fields, pandas' missing-value spellings, `fillna(0)` on the
`view_*` and `<cell>_pert_dose` columns, signature ids looked up as
column names (as strings, even where an id looks numeric), values parsed
to float64 and then cast to float32, int64 edge columns. A `.pkl`
metadata table is a pickled DataFrame and is read only through pandas,
imported when it is needed.
"""
from __future__ import annotations

import collections
import csv
import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import (
    CELL_LINES,
    CV_INPUT_DIM,
    NUM_CELL_LINES,
    NUM_NON_TX_MODALITIES,
    TX_INPUT_DIM,
)
from .featurize import featurize_many
from .synthetic import EdgeTable, SyntheticDataset

# pandas.read_csv's default missing-value spellings
_NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _header_names(fields: Sequence[str]) -> List[str]:
    """pandas' column names for a header row: an empty name becomes
    'Unnamed: <position>', and a repeated name 'name.1', 'name.2', ..."""
    out, seen = [], set()
    for i, name in enumerate(fields):
        name = name or f"Unnamed: {i}"
        base, k = name, 0
        while name in seen:
            k += 1
            name = f"{base}.{k}"
        seen.add(name)
        out.append(name)
    return out


class _Table:
    """A csv table's columns as lists of raw cells (None: missing), with
    the conversions the loader needs, each with pandas' result."""

    def __init__(self, columns: Dict[str, list]):
        self.columns = columns
        self.num_rows = len(next(iter(columns.values()))) if columns else 0

    @classmethod
    def read_csv(cls, path: str, index_col: bool) -> "_Table":
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]
        names = _header_names(rows[0])
        if index_col:
            names = names[1:]
        first = 1 if index_col else 0
        width = len(rows[0])
        cols = {n: [] for n in names}
        for r in rows[1:]:
            r = (r + [""] * width)[:width]
            for n, v in zip(names, r[first:]):
                cols[n].append(None if v in _NA_VALUES else v)
        return cls(cols)

    @classmethod
    def from_frame(cls, df) -> "_Table":
        """A pandas DataFrame's columns, as the strings a csv holds."""
        import pandas as pd

        return cls({str(c): [None if pd.isna(v) else str(v)
                             for v in df[c].tolist()] for c in df.columns})

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def _col(self, name: str) -> list:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"no column {name!r}") from None

    def numbers(self, name: str) -> np.ndarray:
        """float64 values, missing cells 0 (`fillna(0)`); True/False read
        as 1/0."""
        out = np.zeros(self.num_rows, np.float64)
        for i, v in enumerate(self._col(name)):
            if v is None:
                continue
            out[i] = 1.0 if v in _TRUE else 0.0 if v in _FALSE else float(v)
        return out

    def ints(self, name: str) -> np.ndarray:
        """`fillna(0).astype(np.int64)`: truncated toward zero."""
        return self.numbers(name).astype(np.int64)

    def strings(self, name: str) -> List[str]:
        """`astype(str)`: a missing cell is 'nan'."""
        return ["nan" if v is None else v for v in self._col(name)]

    def ids(self, name: str, rows: np.ndarray) -> List[Optional[str]]:
        col = self._col(name)
        return [col[i] for i in np.flatnonzero(rows)]


def _read_metadata(root: str) -> _Table:
    """combined_metadata_ddi.pkl if it is there, else the .csv (the JAX
    loader's order). A .pkl needs pandas: without it the error names the
    file and asks for the .csv, which is not read in its place, since the
    two may differ."""
    vf = os.path.join(root, "views_features_new")
    pkl = os.path.join(vf, "combined_metadata_ddi.pkl")
    if os.path.exists(pkl):
        try:
            import pandas as pd
        except ImportError:
            raise RuntimeError(
                f"{pkl} is a pickled pandas DataFrame and pandas is not "
                "installed: write the table as combined_metadata_ddi.csv "
                "(DataFrame.to_csv) and move the .pkl away") from None
        return _Table.from_frame(pd.read_pickle(pkl))
    path = os.path.join(vf, "combined_metadata_ddi.csv")
    if os.path.exists(path):
        return _Table.read_csv(path, index_col=True)
    raise FileNotFoundError(
        f"no combined_metadata_ddi.(pkl|csv) under {root}/views_features_new")


def read_signature_table(path: str, columns: Optional[Sequence[str]] = None):
    """(column names, float32 values [rows, len(names)]) of a signature
    table written by `DataFrame.to_csv` (cv.csv, tx.csv): the first
    column is the index. `columns` names the columns to read, in that
    order (default: every one); a name the table lacks raises KeyError.
    Values parse as float64 and are cast to float32; an empty cell is
    NaN. numpy's C parser reads the rows; a table with empty cells, which
    it refuses, is read again one row at a time."""
    with open(path, newline="") as f:
        names = _header_names(next(csv.reader(f)))[1:]
    if columns is None:
        columns = names
    index = {n: j + 1 for j, n in enumerate(names)}
    missing = [c for c in columns if c not in index]
    if missing:
        raise KeyError(f"{path} has no column for ids {missing[:5]}")
    fields = [index[c] for c in columns]
    if not fields:  # only the row count
        with open(path, newline="") as f:
            rows = sum(1 for r in csv.reader(f) if r) - 1
        return [], np.zeros((rows, 0), np.float32)
    try:
        values = np.loadtxt(path, delimiter=",", quotechar='"', skiprows=1,
                            usecols=fields, dtype=np.float64, ndmin=2,
                            encoding="utf-8")
    except ValueError:
        rows = []
        with open(path, newline="") as f:
            reader = csv.reader(f)
            next(reader)
            for r in reader:
                if not r:
                    continue
                cells = np.array(r, dtype=object)[fields]
                cells[np.isin(cells, list(_NA_VALUES))] = "nan"
                rows.append(cells.astype(np.float64))
        values = np.stack(rows) if rows else np.zeros((0, len(fields)))
    return list(columns), values.astype(np.float32)


def _signature_rows(path: str, id_lists) -> list:
    """For each list of signature ids, the [len(ids), rows] float32 rows
    of the table's columns so named (`df[ids].values.T`). The table is
    read once, and only the columns some list names."""
    wanted = list(dict.fromkeys(i for ids in id_lists for i in ids))
    names, values = read_signature_table(path, wanted)
    pos = {n: j for j, n in enumerate(names)}
    return [values[:, [pos[i] for i in ids]].T for ids in id_lists]


def load_kg_npz(path: str):
    """kg_edges.npz layout: 'node_types' (list), per node type
    'x__<type>' feature matrices, per edge type
    'edge__<src>__<rel>__<dst>' [2, E] arrays, 'drug_ids' global drug id
    per KG drug-node row."""
    data = np.load(path, allow_pickle=True)
    node_feats = {}
    edges = {}
    for k in data.files:
        if k.startswith("x__"):
            node_feats[k[3:]] = data[k].astype(np.float32)
        elif k.startswith("edge__"):
            _, src, rel, dst = k.split("__")
            edges[(src, rel, dst)] = data[k].astype(np.int64)
    return node_feats, edges, data["drug_ids"].astype(np.int64)


def convert_pyg_kg(pt_path: str, out_path: str, drug_ids=None):
    """One-time export: PyG HeteroData .pt -> kg_edges.npz (run in an
    environment with torch_geometric; reference KG format
    data_utils.py:296-337)."""
    import torch

    g = torch.load(pt_path, map_location="cpu", weights_only=False)
    arrays = {}
    for nt in g.node_types:
        arrays[f"x__{nt}"] = g[nt].x.numpy()
    for et in g.edge_types:
        src, rel, dst = et
        arrays[f"edge__{src}__{rel}__{dst}"] = g[et].edge_index.numpy()
    n_drug = arrays["x__drug"].shape[0]
    arrays["drug_ids"] = (
        np.asarray(drug_ids) if drug_ids is not None else np.arange(n_drug)
    )
    np.savez_compressed(out_path, **arrays)


def _typed_column(cells: list) -> np.ndarray:
    """pandas' dtype for a csv column: int64 when every cell is an
    integer, bool for True/False, float64 when every cell is a number or
    missing (NaN), else object (strings, NaN where missing)."""
    if all(v is not None for v in cells):
        try:
            return np.array([int(v) for v in cells], np.int64)
        except ValueError:
            pass
        if all(v in _TRUE or v in _FALSE for v in cells):
            return np.array([v in _TRUE for v in cells])
    try:
        return np.array([np.nan if v is None else float(v) for v in cells],
                        np.float64)
    except ValueError:
        return np.array([np.nan if v is None else v for v in cells],
                        dtype=object)


def read_edge_table(path: str) -> EdgeTable:
    """A long-format DDI table (`pd.read_csv(path)`), as an EdgeTable."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    t = _Table.read_csv(path, index_col=False)
    return EdgeTable({n: _typed_column(c) for n, c in t.columns.items()})


def check_directed(table: EdgeTable) -> None:
    """The directedness invariant (reference data.py:594-596): no row
    repeats, and no row's (tail, head, label) is another row or itself."""
    tmp = np.stack([table["head"], table["tail"], table["label_indexed"]], 1)
    both = np.concatenate([tmp, tmp[:, [1, 0, 2]]])
    assert len(np.unique(both, axis=0)) == 2 * len(tmp), \
        "DDI edge table must be strictly directed"


def load_edge_table(root: str, data_source: str = "TWOSIDES",
                    split_method: str = "split_by_triplets",
                    split: str = "train",
                    repeat: Optional[str] = None) -> EdgeTable:
    """One split's DDI edge table, held to the directedness invariant.
    FileNotFoundError when the split has no table."""
    parts = [root, "polypharmacy_new", data_source, split_method]
    if repeat:
        parts.append(repeat)
    table = read_edge_table(os.path.join(*parts, f"{split}_df.csv"))
    check_directed(table)
    return table


def load_reference_dataset(
    root: str,
    data_source: str = "TWOSIDES",
    split_method: str = "split_by_triplets",
    split: str = "train",
    repeat: Optional[str] = None,
    featurizer_backend: Optional[str] = None,
) -> SyntheticDataset:
    meta = _read_metadata(root)
    n = meta.num_rows

    # molecules from SMILES
    mols = featurize_many(meta.strings("canonical_smiles"),
                          backend=featurizer_backend)
    empty = {
        "node_feats": np.zeros((1, 67), np.float32),
        "edge_index": np.zeros((0, 2), np.int32),
        "edge_feats": np.zeros((0, 18), np.float32),
    }
    mols = [m if m is not None else empty for m in mols]

    # availability mask matrix
    view_cols = (
        ["view_str", "view_kg", "view_cv"]
        + (["view_bs"] if NUM_NON_TX_MODALITIES >= 4 else [])
        + [f"view_tx_{c}" for c in CELL_LINES]
    )
    mod_avail = np.stack([meta.ints(c) for c in view_cols], 1) if n else (
        np.zeros((0, len(view_cols)), np.int64))

    # cv table: columns are sig ids; gather per-drug rows by cv_sig_id
    cv_path = os.path.join(root, "views_features_new", "cv", "cv.csv")
    cv_table = np.zeros((n, CV_INPUT_DIM), np.float32)
    if os.path.exists(cv_path):
        avail = mod_avail[:, 2] == 1
        cv_table[avail] = _signature_rows(
            cv_path, [meta.ids("cv_sig_id", avail)])[0]

    # tx signatures per cell line
    tx_path = os.path.join(root, "views_features_new", "tx", "tx.csv")
    tx_table = np.zeros((NUM_CELL_LINES, n, TX_INPUT_DIM), np.float32)
    tx_dosages = np.zeros((NUM_CELL_LINES, n), np.float32)
    if os.path.exists(tx_path):
        avail = [meta.ints(f"view_tx_{cell}") == 1 for cell in CELL_LINES]
        rows = _signature_rows(tx_path, [
            meta.ids(f"{cell}_max_dose_averaged_sig_id", a)
            for cell, a in zip(CELL_LINES, avail)])
        for ci, cell in enumerate(CELL_LINES):
            tx_table[ci, avail[ci]] = rows[ci]
            dose_col = f"{cell}_pert_dose"
            if dose_col in meta:
                tx_dosages[ci] = meta.numbers(dose_col)

    # KG
    kg_npz = os.path.join(root, "views_features_new", "kg", "kg_edges.npz")
    if os.path.exists(kg_npz):
        kg_node_feats, kg_edges, kg_drug_ids = load_kg_npz(kg_npz)
    else:
        kg_drug_ids = np.where(mod_avail[:, 1] == 1)[0]
        kg_node_feats = {
            "drug": np.zeros((max(len(kg_drug_ids), 1), 1), np.float32)
        }
        kg_edges = {}

    edge_df = load_edge_table(root, data_source, split_method, split, repeat)
    num_labels = int(edge_df["label_indexed"].max()) + 1

    return SyntheticDataset(
        num_drugs=n,
        num_labels=num_labels,
        molecules=mols,
        mod_avail=mod_avail,
        cv_table=cv_table,
        tx_table=tx_table,
        tx_dosages=tx_dosages,
        kg_node_feats=kg_node_feats,
        kg_edge_indices=kg_edges,
        kg_drug_ids=kg_drug_ids,
        edge_df=edge_df,
    )


# -------------------------------------------------------------- writing
def _float_text(values: np.ndarray) -> np.ndarray:
    """[..., 16] uint8: each float32 value as '+d.dddddddde+xx,' (9
    significant digits, which a float64 parse and a cast back to float32
    return exactly), formatted with array operations. Values must be
    finite."""
    x = values.astype(np.float64).ravel()
    out = np.empty((x.size, 16), np.uint8)
    out[:, 0] = np.where(np.signbit(x), ord("-"), ord("+"))
    ax = np.abs(x)
    nz = ax > 0
    e = np.floor(np.log10(np.where(nz, ax, 1.0))).astype(np.int64)
    m = np.rint(ax * 10.0 ** (8 - e))
    # log10's rounding can leave the digits one place off
    for fix in (m >= 1e9, nz & (m < 1e8)):
        e[fix] += np.where(m[fix] >= 1e9, 1, -1)
        m[fix] = np.rint(ax[fix] * 10.0 ** (8 - e[fix]))
    m = m.astype(np.uint32)  # 9 digits; uint32 division is the quick one
    for k in range(9):
        q = m // 10
        out[:, 10 - k if k < 8 else 1] = m - q * 10 + ord("0")
        m = q
    out[:, 2] = ord(".")
    out[:, 11] = ord("e")
    out[:, 12] = np.where(e < 0, ord("-"), ord("+"))
    ae = np.abs(e)
    out[:, 13] = ae // 10 + ord("0")
    out[:, 14] = ae % 10 + ord("0")
    out[:, 15] = ord(",")
    return out.reshape(values.shape + (16,))


def _write_signature_table(path: str, names: Sequence[str],
                           columns: np.ndarray) -> None:
    """A [rows, len(names)] float32 table as `DataFrame.to_csv` lays it
    out: a header of the names, then each row under its integer index."""
    if not np.isfinite(columns).all():
        raise ValueError(f"{path}: the table holds non-finite values")
    with open(path, "w", newline="") as f:
        csv.writer(f).writerow([""] + list(names))
    step = max(1, (1 << 22) // max(columns.shape[1], 1))
    starts = iter(range(0, columns.shape[0], step))

    def block(start: int):
        text = _float_text(columns[start:start + step])
        text[:, -1, -1] = ord("\n")
        return start, text

    # blocks of rows formatted on threads (numpy's array operations release
    # the GIL), at most one a thread ahead of the writer, written in order
    threads = min(8, os.cpu_count() or 1)
    with open(path, "ab") as f, ThreadPoolExecutor(threads) as pool:
        ahead = collections.deque(
            pool.submit(block, s) for s in itertools.islice(starts, threads))
        while ahead:
            start, text = ahead.popleft().result()
            nxt = next(starts, None)
            if nxt is not None:
                ahead.append(pool.submit(block, nxt))
            for i, row in enumerate(text):
                f.write(f"{start + i},".encode())
                f.write(row.tobytes())


def write_edge_table(table: EdgeTable, path: str) -> None:
    """A DDI edge table as `DataFrame.to_csv(index=False)` writes it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cols = table.columns
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        w.writerows(zip(*[table[c].tolist() for c in cols]))


def export_synthetic_as_reference_layout(ds: SyntheticDataset, root: str,
                                         data_source: str = "TWOSIDES",
                                         split_method: str = "split_by_triplets"):
    """Write a SyntheticDataset to disk in the reference's layout, as the
    JAX package's exporter does (every drug's cv and tx column; alkane
    SMILES in the molecules' place; the edge table as `train_df.csv`).
    Both packages' loaders read it back equal; float32 values are written
    with 9 significant digits, and the KG npz is not compressed."""
    vf = os.path.join(root, "views_features_new")
    for sub in ("cv", "tx", "kg"):
        os.makedirs(os.path.join(vf, sub), exist_ok=True)

    n = ds.num_drugs
    view_cols = (["view_str", "view_kg", "view_cv"]
                 + [f"view_tx_{c}" for c in CELL_LINES])
    header = [""] + ["canonical_smiles"] + view_cols + ["cv_sig_id"]
    for cell in CELL_LINES:
        header += [f"{cell}_max_dose_averaged_sig_id", f"{cell}_pert_dose"]
    with open(os.path.join(vf, "combined_metadata_ddi.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in range(n):
            # synthetic drugs have no real SMILES: simple alkanes sized by
            # atom count, so featurization round-trips structurally
            atoms = ds.molecules[i]["node_feats"].shape[0]
            row = [i, "C" * max(2, min(atoms, 20))]
            row += [int(v) for v in ds.mod_avail[i, :len(view_cols)]]
            row.append(f"cv_{i}")
            for ci, cell in enumerate(CELL_LINES):
                row += [f"tx_{cell}_{i}", repr(float(ds.tx_dosages[ci, i]))]
            w.writerow(row)

    _write_signature_table(os.path.join(vf, "cv", "cv.csv"),
                           [f"cv_{i}" for i in range(n)], ds.cv_table.T)
    _write_signature_table(
        os.path.join(vf, "tx", "tx.csv"),
        [f"tx_{cell}_{i}" for cell in CELL_LINES for i in range(n)],
        ds.tx_table.reshape(NUM_CELL_LINES * n, -1).T)

    arrays = {}
    for nt, x in ds.kg_node_feats.items():
        arrays[f"x__{nt}"] = x
    for (src, rel, dst), ei in ds.kg_edge_indices.items():
        arrays[f"edge__{src}__{rel}__{dst}"] = ei
    arrays["drug_ids"] = ds.kg_drug_ids
    np.savez(os.path.join(vf, "kg", "kg_edges.npz"), **arrays)

    write_edge_table(ds.edge_df, os.path.join(
        root, "polypharmacy_new", data_source, split_method, "train_df.csv"))


def union_edge_tables(tables) -> EdgeTable:
    """Concatenate split edge tables for all-train scoring runs
    (reference LongDDIDatasetAllTrain, data.py:654-694: train+val+test of
    split_by_pairs, whose negative-sampling scheme matches train); tables
    without every one of the five columns are left out."""
    keep_cols = ["head", "tail", "label_indexed", "neg_head", "neg_tail"]
    frames = [t for t in tables if all(c in t.columns for c in keep_cols)]
    return EdgeTable({c: np.concatenate([t[c] for t in frames])
                      for c in keep_cols})


def load_reference_all_train(root: str, data_source: str = "TWOSIDES",
                             **kw) -> SyntheticDataset:
    """All-train dataset: union of train/val/test edges over
    split_by_pairs (the reference's all-train entry uses exactly this
    layout, train_ddi_batch_all_train.py)."""
    ds = load_reference_dataset(root, data_source,
                                split_method="split_by_pairs",
                                split="train", **kw)
    tables = [ds.edge_df]
    base = os.path.join(root, "polypharmacy_new", data_source,
                        "split_by_pairs")
    for split in ("val", "test"):
        p = os.path.join(base, f"{split}_df.csv")
        if os.path.exists(p):
            tables.append(read_edge_table(p))
    ds.edge_df = union_edge_tables(tables)
    return ds
