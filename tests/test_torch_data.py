"""The port's data plane equals the JAX package's: the copied synthetic
generator and negative sampler (array for array, edge-table column for
column), and the collator's drug batches, KG batch (against the JAX
package's destination-sorted `sort_edges=True` batch) and collated DDI
batches."""
import dataclasses

import numpy as np
import pytest
import torch

from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import negative_sampling as j_ns
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import negative_sampling as t_ns
from madrigal_tpu_torch.data import synthetic as t_syn

EDGE_COLUMNS = ["head", "tail", "label_indexed", "neg_head", "neg_tail"]


# the molecule batch's K2 layouts, which only the port's batch carries
# (tests/test_torch_sorted_layouts.py checks them)
PORT_ONLY = {"edge_dst_order", "edge_dst_starts", "edge_src_order",
             "edge_src_starts", "node_graph_starts"}


def assert_same(j, t, where="batch"):
    """Recursively compare a JAX-package value with the port's."""
    if dataclasses.is_dataclass(t):
        for f in dataclasses.fields(t):
            if f.name in PORT_ONLY and not hasattr(j, f.name):
                continue
            assert_same(getattr(j, f.name), getattr(t, f.name),
                        f"{where}.{f.name}")
    elif isinstance(t, dict):
        assert set(j) == set(t), where
        for k in t:
            assert_same(j[k], t[k], f"{where}[{k}]")
    elif isinstance(t, torch.Tensor):
        jn = np.asarray(j)
        tn = t.cpu().numpy()
        assert jn.dtype == tn.dtype, (where, jn.dtype, tn.dtype)
        np.testing.assert_array_equal(jn, tn, err_msg=where)
    else:
        assert j == t, (where, j, t)


def assert_same_dataset(dj, dt):
    assert (dj.num_drugs, dj.num_labels) == (dt.num_drugs, dt.num_labels)
    assert len(dj.molecules) == len(dt.molecules)
    for mj, mt in zip(dj.molecules, dt.molecules):
        for k in mj:
            np.testing.assert_array_equal(mj[k], mt[k])
    for name in ("mod_avail", "cv_table", "tx_table", "tx_dosages",
                 "kg_drug_ids", "masks"):
        np.testing.assert_array_equal(getattr(dj, name), getattr(dt, name),
                                      err_msg=name)
    for name in ("kg_node_feats", "kg_edge_indices", "extra_tabular"):
        a, b = getattr(dj, name), getattr(dt, name)
        assert set(a) == set(b), name
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}{k}")
    assert list(dj.edge_df.columns) == dt.edge_df.columns == EDGE_COLUMNS
    for col in EDGE_COLUMNS:
        np.testing.assert_array_equal(dj.edge_df[col].values,
                                      dt.edge_df[col], err_msg=col)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_dataset_equal(seed):
    kw = dict(num_drugs=20, num_labels=5, num_edges=40, seed=seed)
    assert_same_dataset(j_syn.make_dataset(**kw), t_syn.make_dataset(**kw))


def test_reference_scale_dataset_equal():
    kw = dict(num_drugs=48, num_labels=8, num_rows=150, seed=3,
              kg_scale=400)
    ds = t_syn.make_reference_scale_dataset(**kw)
    assert_same_dataset(j_syn.make_reference_scale_dataset(**kw), ds)
    # the sizes the smoke run checks kernel K2 at are the dataset's
    nodes, edges = t_syn.reference_scale_kg_sizes(48, 400)
    assert nodes == {nt: f.shape[0] for nt, f in ds.kg_node_feats.items()}
    assert edges == {et: e.shape[1] for et, e in ds.kg_edge_indices.items()}


def test_negative_sampling_equal():
    rng = np.random.RandomState(0)
    ei = rng.randint(0, 30, (2, 50))
    lb = rng.randint(0, 4, 50)
    gt = rng.randint(0, 30, (2, 20))
    gl = rng.randint(0, 4, 20)
    out = [m.structured_negative_sampling_multilabel(
        ei, lb, other_ground_truth_edge_index=gt, other_ground_truth_label=gl,
        num_nodes=30, rng=np.random.RandomState(1)) for m in (j_ns, t_ns)]
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_drugs=18, num_labels=6, num_edges=30, seed=5)
    return j_syn.make_dataset(**kw), t_syn.make_dataset(**kw)


def test_drug_and_kg_batches_equal(datasets):
    dj, dt = datasets
    cj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                               kg_src_sort=False)
    ct = t_collate.DDICollator(dt, split="train", device="cpu")
    ids = np.array([3, 0, 17, 5, 5, 11])
    assert_same(cj.drug_batch(ids), ct.drug_batch(ids), "drug_batch")
    # the port's KG batch is sorted by destination, as the JAX package's
    # sort_edges sorts it
    kj, kt = cj.kg_batch(sort_edges=True), ct.kg_batch()
    for name in ("node_feats", "edge_src", "edge_dst", "edge_mask",
                 "drug_index_map"):
        assert_same(getattr(kj, name), getattr(kt, name), name)
    assert kj.metadata.node_types == kt.metadata.node_types
    assert kj.metadata.edge_types == kt.metadata.edge_types


@pytest.mark.parametrize("split,num_neg", [("train", None), ("val", None),
                                           ("train", 1)])
def test_collated_batch_equal(datasets, split, num_neg):
    dj, dt = datasets
    cj = j_collate.DDICollator(dj, split=split, seed=4,
                               num_negative_samples_per_pair=num_neg)
    ct = t_collate.DDICollator(dt, split=split, seed=4,
                               num_negative_samples_per_pair=num_neg,
                               device="cpu")
    (bj, _), (bt, kg) = cj(build_kg=False), ct(build_kg=False)
    assert kg is None
    assert_same(bj, bt, "DDIBatch")


@pytest.mark.parametrize("method", ["split_by_triplets",
                                    "split_by_drugs_random"])
def test_make_split_dataset_equal(method):
    kw = dict(num_drugs=20, num_labels=5, num_edges=40, split_method=method,
              seed=6)
    (dj, sj), (dt, st) = (j_syn.make_split_dataset(**kw),
                          t_syn.make_split_dataset(**kw))
    assert list(sj) == list(st)
    for name in st:
        assert list(sj[name].columns) == st[name].columns, name
        for col in st[name].columns:
            np.testing.assert_array_equal(sj[name][col].values,
                                          st[name][col], err_msg=name + col)
    assert_same_dataset(dj, dt)


def test_train_collator_full_table_src_sort_and_between_equal():
    """The training collator's options (the full drug table, the shared
    drug-batch cache, the source-sorted KG layout) and the between-split
    negatives give the JAX package's batches."""
    kw = dict(num_drugs=20, num_labels=5, num_edges=40,
              split_method="split_by_drugs_random", seed=6)
    (dj, sj), (dt, st) = (j_syn.make_split_dataset(**kw),
                          t_syn.make_split_dataset(**kw))
    cj = j_collate.DDICollator(dj, split="train", seed=2, kg_edge_chunk=0,
                               kg_src_sort=True, full_drug_table=True)
    ct = t_collate.DDICollator(dt, split="train", seed=2, device="cpu",
                               kg_src_sort=True, full_drug_table=True)
    (bj, _), (bt, kt) = cj(build_kg=False), ct()
    kj = cj.kg_batch(sort_edges=True)
    assert_same(bj, bt, "DDIBatch")
    assert bt.head is bt.tail  # one cached full-table drug batch
    for name in ("edge_src_order", "edge_src_starts", "edge_src",
                 "edge_mask"):
        assert_same(getattr(kj, name), getattr(kt, name), name)
    between = [n for n in st if n.endswith("_between")]
    assert between
    for name in between:
        bj = j_collate.DDICollator(dj, split=name, seed=2)(
            sj[name], build_kg=False)[0]
        bt = t_collate.DDICollator(dt, split=name, seed=2, device="cpu")(
            st[name], build_kg=False)[0]
        assert_same(bj, bt, name)
