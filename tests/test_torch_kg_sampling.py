"""The port's KG subgraph sampler and VAE against the JAX package.

  * `data/kg_sampling.sample_kg_subgraph` (a copy of the JAX function,
    building the port's KG batch) on the same rng as the JAX one: the
    subgraph's node features, real edges (mask True), drug_index_map and
    drug_row_map equal, exactly; also through
    `DDICollator.kg_batch(kg_sampling_num_neighbors=...)`, drawn from the
    collator's rng, twice in a row. Only the padding may differ: the port
    pads each edge type to a multiple of 512 rows, the JAX call to 256.
  * An HGT forward over the sampled subgraph, from the same weights,
    within the HGT tolerance of `tests/test_torch_models.py` (1e-4: its
    segment softmax sums exponentials in another order).
  * `models/vae.VAE` at train=False against the JAX VAE (atol = rtol =
    1e-5), its loss, and the train-mode draws taken from the generator.
"""
import numpy as np
import pytest
import torch

from madrigal_tpu.config import HGTConfig as JHGTConfig
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import kg_sampling as j_sampling
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.models import hgt as j_hgt
from madrigal_tpu.models import vae as j_vae
from madrigal_tpu_torch.config import HGTConfig
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import kg_sampling as t_sampling
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import edge_key, kg_schema
from madrigal_tpu_torch.models import hgt as t_hgt
from madrigal_tpu_torch.models import vae as t_vae
from tests.test_torch_alt_encoders import applied, carried
from tests.test_torch_models import close
from test_torch_train import one_thread  # noqa: F401  (fixture)

DATASET = dict(num_drugs=30, num_labels=4, num_edges=40, seed=5)


@pytest.fixture(scope="module")
def datasets():
    return j_syn.make_dataset(**DATASET), t_syn.make_dataset(**DATASET)


def assert_same_subgraph(t_kg, j_kg):
    assert t_kg.metadata.node_types == j_kg.metadata.node_types
    assert t_kg.metadata.edge_types == j_kg.metadata.edge_types
    for nt in j_kg.node_feats:
        np.testing.assert_array_equal(t_kg.node_feats[nt].numpy(),
                                      np.asarray(j_kg.node_feats[nt]))
    np.testing.assert_array_equal(t_kg.drug_index_map.numpy(),
                                  np.asarray(j_kg.drug_index_map))
    for et in j_kg.metadata.edge_types:
        k = edge_key(et)
        tm, jm = t_kg.edge_mask[k].numpy(), np.asarray(j_kg.edge_mask[k])
        assert tm.sum() == jm.sum()
        # the port's subgraph is sorted by destination: the JAX package's
        # edges in the order its build_kg_batch(sort_edges=True) gives
        order = np.argsort(np.asarray(j_kg.edge_dst[k])[jm], kind="stable")
        for attr in ("edge_src", "edge_dst"):
            np.testing.assert_array_equal(
                getattr(t_kg, attr)[k].numpy()[tm],
                np.asarray(getattr(j_kg, attr)[k])[jm][order])
        assert k in t_kg.edge_dst_starts


@pytest.mark.parametrize("num_neighbors,num_layers,seeds", [
    (2, 2, [0, 3, 7]), (4, 1, [1, 2]), (3, 3, [5])])
def test_sampler_copy_matches_jax(datasets, num_neighbors, num_layers,
                                  seeds):
    dj, dt = datasets
    j_kg, j_map = j_sampling.sample_kg_subgraph(
        dj.kg_node_feats, dj.kg_edge_indices, dj.kg_drug_ids, seeds,
        num_neighbors, num_layers, rng=np.random.RandomState(3))
    t_kg, t_map = t_sampling.sample_kg_subgraph(
        dt.kg_node_feats, dt.kg_edge_indices, dt.kg_drug_ids, seeds,
        num_neighbors, num_layers, rng=np.random.RandomState(3),
        device="cpu", src_sort=True)
    np.testing.assert_array_equal(t_map, j_map)
    assert_same_subgraph(t_kg, j_kg)
    assert set(t_kg.edge_src_order) == set(t_kg.edge_src)
    # fewer real edges than the whole KG: the sampler did cut
    assert sum(int(m.sum()) for m in t_kg.edge_mask.values()) < sum(
        e.shape[1] for e in dt.kg_edge_indices.values())


def test_collator_kg_batch_samples_as_jax(datasets):
    dj, dt = datasets
    cj = j_collate.DDICollator(dj, split="train", seed=4, kg_edge_chunk=0)
    ct = t_collate.DDICollator(dt, split="train", seed=4, device="cpu")
    for seeds in ([0, 4, 9], None):
        j_kg = cj.kg_batch(seeds, kg_sampling_num_neighbors=2,
                           kg_sampling_num_layers=2)
        t_kg = ct.kg_batch(seeds, kg_sampling_num_neighbors=2,
                           kg_sampling_num_layers=2)
        assert_same_subgraph(t_kg, j_kg)


def test_hgt_over_sampled_subgraph(datasets):
    dj, dt = datasets
    j_kg, _ = j_sampling.sample_kg_subgraph(
        dj.kg_node_feats, dj.kg_edge_indices, dj.kg_drug_ids, [0, 2, 6], 3,
        2, rng=np.random.RandomState(8))
    t_kg, _ = t_sampling.sample_kg_subgraph(
        dt.kg_node_feats, dt.kg_edge_indices, dt.kg_drug_ids, [0, 2, 6], 3,
        2, rng=np.random.RandomState(8), device="cpu")
    kw = dict(hidden_dim=16, num_layers=2, att_heads=4)
    jm = j_hgt.HGTEncoder(cfg=JHGTConfig(**kw), embed_dim=8)
    schema = kg_schema({nt: f.numpy() for nt, f in t_kg.node_feats.items()},
                       t_kg.metadata.edge_types)
    tm = t_hgt.HGTEncoder(HGTConfig(**kw), 8, *schema)
    v, tm = carried(jm, tm, j_kg, train=False)
    with torch.no_grad():
        got = tm(t_kg)["drug"]
    want = applied(jm, v, j_kg, train=False)["drug"]
    assert got.shape == (t_kg.num_nodes("drug"), 8)
    close(got, want, atol=1e-4, rtol=1e-4)


def test_vae_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(6, 20).astype(np.float32)
    kw = dict(hidden_dims=(32, 16), hidden_dim=16, latent_dim=8,
              dropout=0.3)
    jm = j_vae.VAE(input_dim=20, **kw)
    v, tm = carried(jm, t_vae.VAE(20, **kw), x, train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = applied(jm, v, x, train=False)
    for g, w in zip(got, want):
        close(g, w)
    got_loss = t_vae.vae_loss(torch.from_numpy(x), *got[1:], beta=0.5)
    want_loss = j_vae.vae_loss(x, *want[1:], beta=0.5)
    for g, w in zip(got_loss, want_loss):
        close(g, w)
    # train mode: the reparametrization draws from the generator given
    tm.train()
    with torch.no_grad():
        torch.manual_seed(0)  # dropout's draws
        a = tm(torch.from_numpy(x), torch.Generator().manual_seed(1))
        torch.manual_seed(0)
        b = tm(torch.from_numpy(x), torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], a[2])
    with pytest.raises(ValueError, match="Generator"):
        tm(torch.from_numpy(x))
