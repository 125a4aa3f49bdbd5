"""The sorted layouts that put every encoder sum of the port on kernel K2,
against the JAX package and against the port's unsorted path.

  * The port's KG batch (sorted by destination, its default) equals the
    JAX package's `build_kg_batch(sort_edges=True)` array for array, its
    destination boundary tables are `searchsorted` of the sorted
    destinations, and its per-destination-type orders group the
    concatenated edge types stably.
  * `ops/segment_sorted.sorted_sum` (K2's plain version on the CPU, over
    rows in input order or under a permutation) gives `index_add_`'s sums
    and its gradient, exactly: the stable layout adds each segment's rows
    in their input order, as `index_add_` does on the CPU.
  * On the same weights (seeded in the port, carried to flax by
    `to_flax`, so no JAX init compiles) and sorted batches, the HGT
    (per_edge_type with each group aggregate, global, remat), GIN, GAT,
    HAN and RGCN outputs within atol = rtol = 1e-5 of the JAX modules,
    and every parameter's gradient of sum(out^2) within rtol 1e-5 and
    atol 1e-5 of the largest entry of each tensor (float32, matmul
    precision highest as tests/conftest.py sets it; the JAX side one
    compiled program a module). The bf16 HGT is held to the JAX module on
    the sorted batch in tests/test_torch_bf16.py.
  * The guard: with the unsorted `index_add_` branch of `ops/segment.py`
    made to raise, the flagship model and each alternative encoder's run
    forward and backward, and the edge-sharded HGT on two gloo ranks
    does; the backward graph of every KG and molecule encoder holds no
    node whose backward scatters with accumulation (the HGT's message
    weighting has no `repeat_interleave`).
"""
import copy
import json
import sys

import jax
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.data.kg import build_kg_batch as j_build
from madrigal_tpu.models import gat as j_gat
from madrigal_tpu.models import gin as j_gin
from madrigal_tpu.models import hgt as j_hgt
from madrigal_tpu.models import kg_alt as j_kg_alt
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import build_kg_batch, edge_key, kg_schema
from madrigal_tpu_torch.interop.from_flax import load_flax_weights
from madrigal_tpu_torch.models import gat as t_gat
from madrigal_tpu_torch.models import gin as t_gin
from madrigal_tpu_torch.models import hgt as t_hgt
from madrigal_tpu_torch.models import kg_alt as t_kg_alt
from madrigal_tpu_torch.ops import segment as t_segment
from madrigal_tpu_torch.ops.segment_sorted import sorted_sum
from madrigal_tpu_torch.parallel import dryrun as D
from tests.test_torch_alt_encoders import alt_cfg, port_model
from tests.test_torch_stage1 import to_flax
from test_torch_train import one_thread  # noqa: F401  (fixture)

DATASET = dict(num_drugs=14, num_labels=4, num_edges=24, seed=8)
TOL = dict(atol=1e-5, rtol=1e-5)
# autograd nodes whose backward adds rows with an accumulating scatter
SCATTERING = {"IndexBackward0", "IndexSelectBackward0", "IndexAddBackward0",
              "IndexPutBackward0", "ScatterAddBackward0", "GatherBackward0",
              "EmbeddingBackward0", "RepeatInterleaveBackward0"}


@pytest.fixture(scope="module")
def data():
    dj, dt = j_syn.make_dataset(**DATASET), t_syn.make_dataset(**DATASET)
    kj = j_build(dj.kg_node_feats, dj.kg_edge_indices, dj.kg_drug_ids,
                 sort_edges=True, src_sort=True)
    kt = build_kg_batch(dt.kg_node_feats, dt.kg_edge_indices,
                        dt.kg_drug_ids, device="cpu", src_sort=True)
    ids = np.arange(dt.num_drugs)
    mj = j_collate.DDICollator(dj, kg_edge_chunk=0).drug_batch(ids).mols
    mt = t_collate.DDICollator(dt, device="cpu").drug_batch(ids).mols
    return dt, kj, kt, mj, mt


def test_sorted_kg_batch_matches_jax(data):
    dt, kj, kt, _, _ = data
    assert kj.metadata.edges_sorted
    assert kt.metadata.edge_types == kj.metadata.edge_types
    for name in ("node_feats", "edge_src", "edge_dst", "edge_mask",
                 "edge_src_order", "edge_src_starts"):
        j, t = getattr(kj, name), getattr(kt, name)
        assert set(j) == set(t), name
        for k in j:
            assert t[k].numpy().dtype == np.asarray(j[k]).dtype
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                          err_msg=f"{name}[{k}]")
    np.testing.assert_array_equal(kt.drug_index_map.numpy(),
                                  np.asarray(kj.drug_index_map))
    n = {nt: f.shape[0] for nt, f in dt.kg_node_feats.items()}
    for et in kj.metadata.edge_types:
        k = edge_key(et)
        msk = np.asarray(kj.edge_mask[k])
        dst = np.asarray(kj.edge_dst[k])[msk]
        want = np.searchsorted(dst, np.arange(n[et[2]] + 1))
        assert kt.edge_dst_starts[k].dtype == torch.int32
        np.testing.assert_array_equal(kt.edge_dst_starts[k].numpy(), want)
    # one destination type's order: a stable grouping of its edge types'
    # concatenated rows, real rows first
    assert set(kt.dst_type_order) == {et[2] for et in kt.metadata.edge_types}
    for nt, order in kt.dst_type_order.items():
        keys = [edge_key(et) for et in kt.metadata.edge_types
                if et[2] == nt]
        dst = torch.cat([kt.edge_dst[k] for k in keys]).numpy()
        msk = torch.cat([kt.edge_mask[k] for k in keys]).numpy()
        o = order.numpy()
        real = int(msk.sum())
        assert msk[o[:real]].all() and not msk[o[real:]].any()
        key = dst[o[:real]].astype(np.int64) * len(o) + o[:real]
        assert (np.diff(key) > 0).all()
        np.testing.assert_array_equal(
            kt.dst_type_starts[nt].numpy(),
            np.searchsorted(dst[o[:real]], np.arange(n[nt] + 1)))
    unsorted = build_kg_batch(dt.kg_node_feats, dt.kg_edge_indices,
                              dt.kg_drug_ids, device="cpu", sort_edges=False)
    assert not unsorted.edge_dst_starts and not unsorted.dst_type_order


@pytest.mark.parametrize("permuted", [False, True])
def test_sorted_sum_equals_index_add(permuted):
    """Forward and gradient of the autograd K2 sum equal index_add_'s and
    its autograd's (an index_select), bit for bit."""
    rng = np.random.RandomState(3)
    e, n = 300, 23
    ids = rng.randint(0, n + 2, e)  # ids n and n + 1 belong to no segment
    if not permuted:
        ids = np.sort(ids)
    data = torch.from_numpy(rng.randn(e, 3, 5).astype(np.float32))
    cot = torch.from_numpy(rng.randn(n, 3, 5).astype(np.float32))
    key = np.where(ids < n, ids, n)
    order = np.argsort(key, kind="stable").astype(np.int32)
    starts = np.searchsorted(key[order], np.arange(n + 1)).astype(np.int32)
    x = data.clone().requires_grad_(True)
    got = sorted_sum(x, torch.from_numpy(starts),
                     torch.from_numpy(order) if permuted else None)
    (got * cot).sum().backward()
    y = data.clone().requires_grad_(True)
    safe = torch.from_numpy(np.where(ids < n, ids, n))
    want = torch.zeros((n + 1, 3, 5)).index_add_(0, safe, y)[:n]
    (want * cot).sum().backward()
    assert torch.equal(got, want)
    assert torch.equal(x.grad, y.grad)


def _square_sum(out):
    if isinstance(out, dict):
        return sum(_square_sum(o) for o in out.values())
    if isinstance(out, (tuple, list)):
        return sum(_square_sum(o) for o in out)
    return (out ** 2).sum()


def _seeded(tm, seed=0):
    """`tm` in eval mode with normal(0, 0.3) weights from `seed`, and the
    same variables as a flax tree (no JAX init is compiled)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0.0, 0.3, generator=gen)
    params, stats = to_flax(tm.eval())
    return tm, {"params": params, "batch_stats": stats}


def _jax_value_grads(jm, v, *args):
    """sum(out^2) of the JAX module, its outputs and its parameter
    gradients, in one compiled program (float32: within 1e-6 of op-by-op
    dispatch)."""
    def loss(p):
        out = jm.apply({**v, "params": p}, *args, train=False)
        return _square_sum(out), out

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])


def _matches_jax(tm, v, t_args, jax_result):
    """The port's outputs, sum(out^2) and every parameter's gradient of it
    against the JAX module's (jax_result), the gradients carried through
    the same weight converter."""
    (j_val, j_out), j_grads = jax_result
    out = tm(*t_args)
    flat_t = out.values() if isinstance(out, dict) else out
    flat_j = j_out.values() if isinstance(j_out, dict) else j_out
    for t, j in zip(flat_t, flat_j):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)
    loss = _square_sum(out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    ref = load_flax_weights(copy.deepcopy(tm), {**v, "params": j_grads})
    want = dict(ref.named_parameters())
    for name, p in tm.named_parameters():
        r = want[name].detach().numpy()
        g = np.zeros_like(r) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


# two layers for the sum group (a gradient through a layer's input), one
# for the other aggregates and the global scope, which act in each layer
HGT_CASES = {"sum": dict(num_layers=2), "mean": dict(group="mean"),
             "max": dict(group="max"), "global": dict(softmax_scope="global")}


@pytest.mark.parametrize("case", list(HGT_CASES))
def test_hgt_matches_jax_on_sorted_batches(data, case):
    """Each case's JAX module once; the sum case also holds the port's
    edge-type remat (which recomputes the same ops) to it."""
    dt, kj, kt, _, _ = data
    kw = dict(hidden_dim=16, num_layers=1, att_heads=4)
    kw.update(HGT_CASES[case])
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    tm, v = _seeded(t_hgt.HGTEncoder(t_config.HGTConfig(**kw), 8, *schema))
    jm = j_hgt.HGTEncoder(cfg=j_config.HGTConfig(**kw), embed_dim=8)
    want = _jax_value_grads(jm, v, kj)
    _matches_jax(tm, v, (kt,), want)
    if case == "sum":
        remat = t_hgt.HGTEncoder(t_config.HGTConfig(
            remat_edge_types=True, **kw), 8, *schema)
        remat.load_state_dict(tm.state_dict())
        _matches_jax(remat.eval(), v, (kt,), want)


@pytest.mark.parametrize("name", ["gin", "gat"])
def test_molecule_encoders_match_jax(data, name):
    """GIN and GAT on the molecule batch's layouts; the JAX batch is the
    same arrays without them."""
    _, _, _, mj, mt = data
    assert mt.edge_dst_starts is not None
    if name == "gin":
        kw = dict(hidden_dims=(16, 16, 8), num_mlp_layer=2)
        jm, tm = j_gin.GINEncoder(**kw), t_gin.GINEncoder(**kw)
    else:
        kw = dict(hidden_dims=(16, 8), num_head=2, batch_norm=True)
        jm, tm = j_gat.GATEncoder(**kw), t_gat.GATEncoder(**kw)
    tm, v = _seeded(tm)
    _matches_jax(tm, v, (mt,), _jax_value_grads(jm, v, mj))


@pytest.mark.parametrize("name", ["han", "rgcn"])
def test_kg_alt_encoders_match_jax(data, name):
    dt, kj, kt, _, _ = data
    if name == "han":
        cfg = dict(hidden_dim=8, num_layers=2, att_heads=2, dropout=0.0)
        jm = j_kg_alt.HANEncoder(cfg=j_config.HANConfig(**cfg), embed_dim=6)
        tm = t_kg_alt.HANEncoder(t_config.HANConfig(**cfg), 6,
                                 *kg_schema(dt.kg_node_feats,
                                            dt.kg_edge_indices))
    else:
        kw = dict(num_layers=2, num_bases=3, aggr="mean")
        jm = j_kg_alt.RGCNEncoder(hidden_dim=8, embed_dim=6, **kw)
        width = {f.shape[1] for f in dt.kg_node_feats.values()}.pop()
        tm = t_kg_alt.RGCNEncoder(width, len(dt.kg_edge_indices), 8, 6, **kw)
    tm, v = _seeded(tm)
    _matches_jax(tm, v, (kt,), _jax_value_grads(jm, v, kj))


def _raise(*args, **kwargs):
    raise AssertionError("the unsorted index_add_ branch was reached")


def _graph_ops(tensors) -> set:
    """Names of every autograd node behind `tensors`."""
    seen, stack, names = set(), [t.grad_fn for t in tensors], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("str_enc,kg_enc", [("gin", "hgt"), ("gat", "hgt"),
                                            ("gin", "han"), ("gin", "rgcn")])
def test_guard_no_encoder_reaches_index_add(data, monkeypatch, str_enc,
                                            kg_enc):
    """The whole model (gin/hgt is the flagship's pair) forward and
    backward on the collator's batches, with the unsorted branch raising;
    the KG and molecule encoders' graphs hold no scattering node."""
    dt = data[0]
    monkeypatch.setattr(t_segment, "_index_add_sum", _raise)
    cfg = alt_cfg(t_config, str_enc, kg_enc)
    model, _ = port_model(cfg, kg_schema(dt.kg_node_feats,
                                         dt.kg_edge_indices), seed=2)
    model.train()
    batch, kg = t_collate.DDICollator(dt, split="train", device="cpu",
                                      kg_src_sort=True)()
    enc = model.encoder
    kg_out = enc.kg_drug_table(kg)
    str_out = enc.str_encoder(batch.head.mols)
    for nodes in (_graph_ops([kg_out]), _graph_ops(str_out)):
        assert not nodes & SCATTERING, nodes & SCATTERING
    scores = model.score_triples(batch.head, batch.tail, kg, batch.head_idx,
                                 batch.tail_idx, batch.labels)
    (scores.square().sum() + kg_out.sum() + str_out[0].sum()).backward()
    assert sum(p.grad is not None for p in enc.kg_encoder.parameters()) > 4


SHARDED_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from madrigal_tpu_torch import config as C
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.synthetic import make_dataset
from madrigal_tpu_torch.models.hgt import HGTEncoder
from madrigal_tpu_torch.ops import segment
from madrigal_tpu_torch.parallel import kg_shard
from madrigal_tpu_torch.parallel.mesh import make_mesh
from madrigal_tpu_torch.parallel.multihost import initialize, shutdown


def refuse(*args, **kwargs):
    raise AssertionError("the unsorted index_add_ branch was reached")


segment._index_add_sum = refuse
initialize(device="cpu")
ds = make_dataset(**json.loads(sys.argv[1]))
kg = DDICollator(ds, device="cpu", kg_src_sort=True).kg_batch()
torch.manual_seed(0)
hgt = HGTEncoder(C.HGTConfig(hidden_dim=8, num_layers=2, att_heads=2,
                             shard_axis="dp"), 6,
                 *kg_schema(ds.kg_node_feats, ds.kg_edge_indices))
for p in hgt.parameters():
    torch.nn.init.normal_(p, 0.0, 0.3)
share = kg_shard.device_put_kg_sharded(kg, make_mesh(("dp",)), "dp")
out = hgt(share)["drug"]
out.square().sum().backward()
print(json.dumps({"layouts": len(share.edge_src_order),
                  "edge_types": len(share.edge_src),
                  "grads": sum(p.grad is not None
                               for p in hgt.parameters())}))
shutdown()
"""


def test_guard_sharded_hgt_reaches_no_index_add():
    """The edge-sharded HGT on two gloo ranks, each share with its own
    layouts, forward and backward with the unsorted branch raising."""
    res = D.launch([sys.executable, "-c", SHARDED_WORKER,
                    json.dumps(DATASET)], 2, env={"OMP_NUM_THREADS": "1"},
                   timeout=120)
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
        got = json.loads(r.stdout.strip().splitlines()[-1])
        assert got["layouts"] == got["edge_types"] > 0 and got["grads"] > 4
