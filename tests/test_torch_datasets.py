"""The port's reference-format data loading against the JAX package.

  * `data/smiles.py` and `data/featurize.py` (copies) give the originals'
    parses and features, exactly, on a varied SMILES set.
  * The native binding (built into build/native/) gives the JAX
    binding's `featurize_batch_native` / `featurize_pack_native` output.
  * The loader, both ways and exactly: a directory written by the JAX
    exporter read by both loaders; one written by the port's exporter
    read by the JAX loader and the port's, and equal to the dataset
    written; a hand-written metadata csv with empty cells, quoted commas
    and numeric-looking ids; a .pkl metadata table (read through pandas
    where it is installed, refused where it is not); the directedness
    check; and --all_train's union of the split_by_pairs tables.
"""
import csv
import os
import sys

import numpy as np
import pandas as pd
import pytest

from madrigal_tpu.data import datasets as j_ds
from madrigal_tpu.data import featurize as j_feat
from madrigal_tpu.data import native_featurizer as j_native
from madrigal_tpu.data import smiles as j_smiles
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu_torch.data import datasets as t_ds
from madrigal_tpu_torch.data import featurize as t_feat
from madrigal_tpu_torch.data import native_featurizer as t_native
from madrigal_tpu_torch.data import smiles as t_smiles
from madrigal_tpu_torch.data import synthetic as t_syn

SMILES = [
    "CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "C[C@H](N)C(=O)O",
    "[NH4+].[Cl-]", "O=C([O-])c1ccccc1", "C1CC2CCC1C2", "c1ccc2[nH]ccc2c1",
    "F/C=C/F", "CC(C)(C)Br", "C%10CCCCC%10", "[Se]1C=CC=C1", "N#N",
    "CS(=O)(=O)O", "not a smiles", "C1CC", "",
]
DATA = dict(num_drugs=18, num_labels=5, num_edges=40, seed=4)


def test_smiles_and_featurize_copies_match_jax():
    for s in SMILES:
        try:
            want = j_smiles.parse_smiles(s)
        except (j_smiles.SmilesError, ValueError, IndexError) as e:
            with pytest.raises(Exception) as got:  # each package's class
                t_smiles.parse_smiles(s)
            assert type(got.value).__name__ == type(e).__name__
            assert str(got.value) == str(e)
            continue
        got = t_smiles.parse_smiles(s)
        assert repr(got) == repr(want), s
    for j_graph, t_graph in zip(j_feat.featurize_many(SMILES, "builtin"),
                                t_feat.featurize_many(SMILES, "builtin")):
        assert (j_graph is None) == (t_graph is None)
        if j_graph is not None:
            assert_graphs_equal(t_graph, j_graph)


def assert_graphs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_binding_matches_jax():
    path = t_native.build_native()
    assert path.endswith(os.path.join("build", "native",
                                      "libmadrigal_native.so"))
    for j_graph, t_graph in zip(j_native.featurize_batch_native(SMILES),
                                t_native.featurize_batch_native(SMILES)):
        assert (j_graph is None) == (t_graph is None)
        if j_graph is not None:
            assert_graphs_equal(t_graph, j_graph)
    assert_graphs_equal(t_native.featurize_smiles_native("c1ccccc1O"),
                        j_native.featurize_smiles_native("c1ccccc1O"))
    assert t_feat.featurize_smiles("CCO", "native") is not None
    want = j_native.featurize_pack_native(SMILES)
    got = t_native.featurize_pack_native(SMILES, device="cpu")
    assert got.num_graphs == want.num_graphs == len(SMILES)
    for name in ("node_feats", "node_mask", "node_graph", "edge_src",
                 "edge_dst", "edge_feats", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    with pytest.raises(ValueError, match="budgets"):
        t_native.featurize_pack_native(SMILES, node_budget=8, device="cpu")


def assert_datasets_equal(got, want, molecules=True):
    """Every array of two loaded datasets, exactly (dtypes included); the
    edge table column for column."""
    assert (got.num_drugs, got.num_labels) == (want.num_drugs,
                                               want.num_labels)
    for name in ("mod_avail", "cv_table", "tx_table", "tx_dosages",
                 "kg_drug_ids"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for a, b in ((got.kg_node_feats, want.kg_node_feats),
                 (got.kg_edge_indices, want.kg_edge_indices)):
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    assert_tables_equal(got.edge_df, want.edge_df)
    if molecules:
        assert len(got.molecules) == len(want.molecules)
        for g, w in zip(got.molecules, want.molecules):
            assert_graphs_equal(g, w)


def assert_tables_equal(got, want):
    """A port EdgeTable against a pandas DataFrame, row for row."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, (c, got[c].dtype, w.dtype)
        if w.dtype == object:  # strings, NaN where missing
            assert [None if pd.isna(v) else v for v in got[c]] == [
                None if pd.isna(v) else v for v in w], c
        else:
            np.testing.assert_array_equal(got[c], w, err_msg=c)


def test_loader_reads_the_jax_export(tmp_path):
    ds = j_syn.make_dataset(**DATA)
    j_ds.export_synthetic_as_reference_layout(ds, str(tmp_path))
    assert_datasets_equal(t_ds.load_reference_dataset(str(tmp_path)),
                          j_ds.load_reference_dataset(str(tmp_path)))


def test_port_export_reads_back_in_both_loaders(tmp_path):
    """The port's exporter (9-digit floats, an uncompressed npz) read by
    the JAX loader equals the port's loader's result, and every array but
    the molecules equals the dataset written."""
    ds = t_syn.make_dataset(**DATA)
    t_ds.export_synthetic_as_reference_layout(ds, str(tmp_path))
    got = t_ds.load_reference_dataset(str(tmp_path))
    assert_datasets_equal(got, j_ds.load_reference_dataset(str(tmp_path)))
    for name in ("mod_avail", "cv_table", "tx_table", "tx_dosages",
                 "kg_drug_ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ds, name))
    for k, ei in ds.kg_edge_indices.items():
        np.testing.assert_array_equal(got.kg_edge_indices[k], ei)
    for c in ds.edge_df.columns:
        np.testing.assert_array_equal(got.edge_df[c], ds.edge_df[c])
    # extreme float32 values survive the 9-digit text exactly
    vals = np.array([[0.0, -0.0, 1e-45, 1.1754944e-38, 3.4028235e38,
                      -0.1, 9.999999e-5, 123456.79]], np.float32)
    path = str(tmp_path / "t.csv")
    t_ds._write_signature_table(path, [f"s{i}" for i in range(8)], vals)
    names, back = t_ds.read_signature_table(path)
    assert names == [f"s{i}" for i in range(8)]
    np.testing.assert_array_equal(back, vals)
    # a subset of the columns, in the order asked for
    names, back = t_ds.read_signature_table(path, ["s6", "s0", "s6"])
    assert names == ["s6", "s0", "s6"]
    np.testing.assert_array_equal(back, vals[:, [6, 0, 6]])
    with pytest.raises(KeyError, match="s9"):
        t_ds.read_signature_table(path, ["s9"])
    np.testing.assert_array_equal(
        pd.read_csv(path, index_col=0).to_numpy().astype(np.float32), vals)


def write_rows(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)


def hand_written(root, n=5):
    """A metadata csv with empty cells in the view and dose columns, a
    quoted field holding commas, and signature ids that look numeric in
    columns pandas keeps as strings; cv/tx tables with a quoted header
    and an empty cell in a column no drug reads; a KG-less layout."""
    from madrigal_tpu.constants import CELL_LINES, CV_INPUT_DIM, TX_INPUT_DIM

    rng = np.random.RandomState(0)
    vf = os.path.join(root, "views_features_new")
    header = ["", "canonical_smiles", "drug_name", "view_str", "view_kg",
              "view_cv"] + [f"view_tx_{c}" for c in CELL_LINES] + [
        "cv_sig_id"]
    for c in CELL_LINES:
        header += [f"{c}_max_dose_averaged_sig_id", f"{c}_pert_dose"]
    cv_ids = ["7", "cv,b", "0031", "x", ""]

    def tx_id(i, c):
        if (i + c) % 3:
            return ""
        return "0042" if (i, c) == (0, 0) else f"s{i}_{c}"

    rows = [header]
    for i in range(n):
        row = [f"d{i}", ["CCO", "c1ccccc1", "C1CC", "CC(=O)O", "N"][i],
               f"drug {i}, salt", 1, ["1", "", "0", "1.0", "1"][i],
               ["1", "1", "1", "1.0", "0"][i]]
        row += ["1" if (i + c) % 3 == 0 else ("" if c == 1 else "0")
                for c in range(len(CELL_LINES))]
        row.append(cv_ids[i])
        for c in range(len(CELL_LINES)):
            row += [tx_id(i, c), "" if c == 2 else f"{0.5 * i + c:.3f}"]
        rows.append(row)
    write_rows(os.path.join(vf, "combined_metadata_ddi.csv"), rows)
    cv_cols = ["7", "cv,b", "0031", "x", "unused"]
    cv = rng.randn(CV_INPUT_DIM, len(cv_cols)).astype(np.float32)
    cv_rows = [[""] + cv_cols] + [
        [str(g)] + [repr(float(v)) for v in r] for g, r in enumerate(cv)]
    cv_rows[3][-1] = ""  # empty cell in the column no drug reads
    write_rows(os.path.join(vf, "cv", "cv.csv"), cv_rows)
    tx_cols = sorted({tx_id(i, c) for i in range(n)
                      for c in range(len(CELL_LINES))} - {""})
    tx = rng.randn(TX_INPUT_DIM, len(tx_cols))
    write_rows(os.path.join(vf, "tx", "tx.csv"),
               [[""] + tx_cols] + [[f"g{g}"] + [f"{v:.6f}" for v in r]
                                  for g, r in enumerate(tx)])
    edges = [["head", "tail", "label_indexed", "neg_head", "neg_tail",
              "note"],
             [0, 1, 0, 2, 3, "a, b"], [1, 2, 1, 0, 4, ""],
             [3, 4, 2, 1, 0, "c"], [4, 3, 1, 2, 2, "d"]]
    write_rows(os.path.join(root, "polypharmacy_new", "TWOSIDES",
                            "split_by_triplets", "train_df.csv"), edges)


def test_loader_reads_a_hand_written_csv(tmp_path):
    hand_written(str(tmp_path))
    want = j_ds.load_reference_dataset(str(tmp_path))
    got = t_ds.load_reference_dataset(str(tmp_path))
    assert_datasets_equal(got, want)
    assert got.kg_edge_indices == {} and got.num_drugs == 5
    assert got.mod_avail[1, 1] == 0 and got.mod_avail[3, 1] == 1
    assert got.cv_table[2].any() and not got.cv_table[4].any()
    assert np.isnan(t_ds.read_signature_table(
        str(tmp_path / "views_features_new" / "cv" / "cv.csv"))[1]).any()


def test_metadata_pkl(tmp_path, monkeypatch):
    """A .pkl metadata table wins over the .csv. With pandas it is read as
    the JAX loader reads it; without pandas the loader refuses it, naming
    the file, rather than read the .csv in its place."""
    ds = t_syn.make_dataset(**DATA)
    t_ds.export_synthetic_as_reference_layout(ds, str(tmp_path))
    vf = tmp_path / "views_features_new"
    meta = pd.read_csv(vf / "combined_metadata_ddi.csv", index_col=0)
    meta["view_cv"] = 0
    meta.to_pickle(vf / "combined_metadata_ddi.pkl")
    got = t_ds.load_reference_dataset(str(tmp_path))
    assert_datasets_equal(got, j_ds.load_reference_dataset(str(tmp_path)))
    assert not got.mod_avail[:, 2].any() and not got.cv_table.any()
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(RuntimeError, match="combined_metadata_ddi.pkl"):
        t_ds.load_reference_dataset(str(tmp_path))


def test_directedness_check(tmp_path):
    ds = t_syn.make_dataset(**DATA)
    t = ds.edge_df
    ds.edge_df = t.take(np.concatenate([np.arange(len(t)), [0]]))
    ds.edge_df = ds.edge_df.replace(
        head=np.concatenate([t["head"], t["tail"][:1]]),
        tail=np.concatenate([t["tail"], t["head"][:1]]))
    t_ds.export_synthetic_as_reference_layout(ds, str(tmp_path))
    for load in (j_ds.load_reference_dataset, t_ds.load_reference_dataset):
        with pytest.raises(AssertionError, match="strictly directed"):
            load(str(tmp_path))


def test_all_train_union(tmp_path):
    """load_reference_all_train: the split_by_pairs train table, then val
    and test, as the JAX package concatenates them (with a split that has
    fewer columns left out)."""
    ds, splits = t_syn.make_split_dataset(num_drugs=18, num_labels=5,
                                          num_edges=40,
                                          split_method="split_by_pairs",
                                          seed=4)
    t_ds.export_synthetic_as_reference_layout(
        ds, str(tmp_path), split_method="split_by_pairs")
    base = tmp_path / "polypharmacy_new" / "TWOSIDES" / "split_by_pairs"
    t_ds.write_edge_table(splits["val"], str(base / "val_df.csv"))
    t_ds.write_edge_table(splits["test"].replace(drop=("neg_head",)),
                          str(base / "test_df.csv"))
    got = t_ds.load_reference_all_train(str(tmp_path))
    want = j_ds.load_reference_all_train(str(tmp_path))
    assert_datasets_equal(got, want, molecules=False)
    assert len(got.edge_df) == len(splits["train"]) + len(splits["val"])
    t_ds.write_edge_table(splits["test"], str(base / "test_df.csv"))
    got = t_ds.load_reference_all_train(str(tmp_path))
    assert_tables_equal(got.edge_df,
                        j_ds.load_reference_all_train(str(tmp_path)).edge_df)
    assert len(got.edge_df) == sum(map(len, splits.values()))
