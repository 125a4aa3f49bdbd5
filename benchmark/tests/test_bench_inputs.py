"""The inputs made from the seed: the benchmark's generator draws what
the port's generator draws, a mix's `data` keys take the place of the
configuration's, and the Zipf KG option gives hub nodes."""
import numpy as np

import inputs
import tiny


def test_generator_is_the_ports():
    from madrigal_tpu_torch.data.synthetic import (
        make_reference_scale_dataset,
    )

    ours = inputs.dataset(tiny.TINY_DATA, {}, 7)
    port = make_reference_scale_dataset(seed=7, **tiny.TINY_DATA)
    assert ours.kg_edge_indices.keys() == port.kg_edge_indices.keys()
    for k, v in ours.kg_edge_indices.items():
        np.testing.assert_array_equal(v, port.kg_edge_indices[k])
    for col in ours.edge_df.columns:
        np.testing.assert_array_equal(ours.edge_df[col], port.edge_df[col])
    np.testing.assert_array_equal(ours.tx_table, port.tx_table)
    np.testing.assert_array_equal(ours.mod_avail, port.mod_avail)


def test_mix_data_takes_the_configurations_place():
    ds = inputs.dataset(tiny.TINY_DATA, {"data": {"num_rows": 40}}, 7)
    assert len(ds.edge_df) == 40
    assert len(inputs.dataset(tiny.TINY_DATA, {}, 7).edge_df) == 80


def test_zipf_kg_has_hubs():
    data = dict(tiny.TINY_DATA, kg_scale=40)
    uni = inputs.dataset(data, {}, 7)
    zipf = inputs.dataset(data, {"data": {"kg_degrees": "zipf"}}, 7)
    for k, ei in zipf.kg_edge_indices.items():
        assert ei.shape == uni.kg_edge_indices[k].shape
        n_dst = zipf.kg_node_feats[k[2]].shape[0]
        assert 0 <= ei.min() and ei[1].max() < n_dst
    ppi = ("protein", "ppi", "protein")
    top = lambda ds: np.bincount(ds.kg_edge_indices[ppi][1]).max()
    assert top(zipf) > 10 * top(uni)
