"""The reference's own (upstream Madrigal) checkpoints into the port.

  * The copies `interop/{torch_convert,convert_checkpoint}.py` against the
    JAX package's originals: equal trees, array for array, on one
    reference-format state_dict holding every converter's modules.
  * Reference-format finetune and CL state_dicts, built as
    `tests/test_convert_checkpoint.py` builds them (torch fixtures of the
    cv MLP, the fusion stack, the adaptors, tokens, positional encoding
    and the parametrized decoder weight), with the HGT of
    `tests/pyg_hgt_replicas.py` in both PyG layouts, each with its
    softmax scope:
    - `state_dict_from_reference` loads into the port's model with
      `strict=False`, nothing unexpected, the modules it lacks (GIN,
      chemCPA) keeping their fresh values; the scores within 1e-5 of the
      JAX model given `convert_reference_finetune_checkpoint`'s tree
      (merged into the same fresh init), and the drug table, cv encoder
      and fusion within 1e-5 of the torch replicas' outputs;
    - `stage2_checkpoint_from_reference` and the warm start of
      `cli.train_ddi --checkpoint` (`warm_start_encoder`) give exactly
      the parameters of JAX's `convert_reference_cl_checkpoint` +
      `merge_params`, with and without the pretrained adaptor;
  * a layout whose softmax scope does not match the config raises.
"""
import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.interop import convert_checkpoint as j_conv
from madrigal_tpu.models import encoder as j_enc
from madrigal_tpu.train.checkpoint import merge_params as j_merge
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.interop import convert_checkpoint as t_conv
from madrigal_tpu_torch.interop.from_flax import (
    flax_to_state_dict,
    load_flax_weights,
    stage2_checkpoint_from_reference,
    state_dict_from_reference,
)
from madrigal_tpu_torch.models.encoder import MadrigalMultilabel
from madrigal_tpu_torch.train.checkpoint import (
    load_checkpoint,
    warm_start_encoder,
)
from tests.pyg_hgt_replicas import (
    HGTConvPyG22,
    HGTConvPyG23,
    HGTPyGReplica,
)
from tests.test_convert_checkpoint import build_reference_style_state_dict
from tests.test_torch_alt_encoders import applied, port_model
from test_torch_train import one_thread  # noqa: F401  (fixture)

DATASET = dict(num_drugs=12, num_labels=5, num_edges=20, seed=3)
LAYOUTS = {"pyg23": (HGTConvPyG23, "global"),
           "pyg22": (HGTConvPyG22, "per_edge_type")}


def ref_cfg(c, scope):
    """test_convert_checkpoint's encoder config with the layout's scope."""
    return c.EncoderConfig(
        feature_dim=32,
        gin=c.GINConfig(hidden_dims=(32,), num_mlp_layer=3),
        hgt=c.HGTConfig(hidden_dim=16, num_layers=2, att_heads=4,
                        softmax_scope=scope),
        cv=c.MLPEncoderConfig(hidden_dims=(64, 32), dropout=0.0, norm=None),
        chemcpa=c.ChemCPAConfig(dim=32, autoencoder_width=32,
                                autoencoder_depth=1),
        transformer=c.FusionConfig(num_layers=1, att_heads=2, head_dim=16,
                                   ffn_dim=64, dropout=0.0, norm_first=True,
                                   agg="x-attn", num_tx_bottlenecks=2),
        proj=c.ProjectorConfig(hidden_dims=(64, 64), dropout=0.0, norm="ln"),
        pos_emb_type="learnable", pos_emb_dropout=0.0)


def gin_and_chemcpa_keys(rng):
    """Random GIN (torchdrug layout) and chemCPA (chemCPA's layout)
    entries at ref_cfg's widths, under `encoder.`."""
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    sd = {}
    dims = [67, 32, 32]
    for i in range(2):
        p = f"encoder.str_encoder.layers.{i}."
        sd[p + "eps"] = t(1)
        sd[p + "edge_linear.weight"], sd[p + "edge_linear.bias"] = (
            t(dims[i], 18), t(dims[i]))
        for j, (a, b) in enumerate(((dims[i], dims[i + 1]),
                                    (dims[i + 1], dims[i + 1]),
                                    (dims[i + 1], dims[i + 1]))):
            sd[p + f"mlp.layers.{j}.weight"] = t(b, a)
            sd[p + f"mlp.layers.{j}.bias"] = t(b)
        for k in ("weight", "bias", "running_mean"):
            sd[p + f"batch_norm.{k}"] = t(dims[i + 1])
        sd[p + "batch_norm.running_var"] = torch.rand(dims[i + 1]) + 0.5
    for name, sizes in (("encoder", (978, 32, 32)),
                        ("decoder", (32, 32, 978 * 2))):
        p = f"encoder.tx_encoder.{name}.network."
        sd[p + "0.weight"], sd[p + "0.bias"] = t(sizes[1], sizes[0]), t(
            sizes[1])
        for k in ("weight", "bias", "running_mean"):
            sd[p + f"1.{k}"] = t(sizes[1])
        sd[p + "1.running_var"] = torch.rand(sizes[1]) + 0.5
        sd[p + "3.weight"], sd[p + "3.bias"] = t(sizes[2], sizes[1]), t(
            sizes[2])
    sd["encoder.tx_encoder.covariates_embeddings.0.weight"] = t(16, 32)
    return sd


@pytest.fixture(scope="module")
def data():
    dj, dt = j_syn.make_dataset(**DATASET), t_syn.make_dataset(**DATASET)
    bj, kj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                                   kg_src_sort=False)()
    bt, kt = t_collate.DDICollator(dt, split="train", device="cpu")()
    return dt, bj, kj, bt, kt


@pytest.fixture(scope="module")
def references(data):
    """Per layout: the reference-format state_dict and its torch
    fixtures."""
    dt, _, _, _, kt = data
    meta = kt.metadata
    out = {}
    for name, (conv_cls, _) in LAYOUTS.items():
        sd, cv_mod, fus_mod = build_reference_style_state_dict()
        torch.manual_seed(4)
        replica = HGTPyGReplica(24, 16, 32, 2, 4, (list(meta.node_types),
                                                   list(meta.edge_types)),
                                conv_cls)
        for k, v in replica.state_dict().items():
            sd[f"encoder.kg_encoder.{k}"] = v
        out[name] = (sd, cv_mod, fus_mod, replica)
    return out


def assert_same_tree(a, b, path=""):
    if isinstance(a, tuple):  # (params, batch_stats)
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
        return
    assert isinstance(a, dict) == isinstance(b, dict), path
    if not isinstance(a, dict):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        return
    assert set(a) == set(b), path
    for k in a:
        assert_same_tree(a[k], b[k], f"{path}/{k}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_converter_copies_match_originals(data, references, layout):
    meta = data[4].metadata
    sd = dict(references[layout][0])
    sd.update(gin_and_chemcpa_keys(np.random.RandomState(5)))
    scope = LAYOUTS[layout][1]
    got = t_conv.convert_reference_finetune_checkpoint(
        sd, ref_cfg(t_config, scope), meta, strict_kg=True)
    want = j_conv.convert_reference_finetune_checkpoint(
        sd, ref_cfg(j_config, scope), meta, strict_kg=True)
    assert_same_tree(got, want)
    assert {"str_encoder", "tx_encoder", "kg_encoder"} <= set(
        got[0]["encoder"])
    cl = {"base_encoder." + k[len("encoder."):]: v for k, v in sd.items()
          if k.startswith("encoder.")}
    for adaptor in (False, True):
        assert_same_tree(
            t_conv.convert_reference_cl_checkpoint(
                cl, ref_cfg(t_config, scope), meta, adaptor),
            j_conv.convert_reference_cl_checkpoint(
                cl, ref_cfg(j_config, scope), meta, adaptor))


@pytest.fixture(scope="module")
def jax_fresh(data):
    """Per scope, the JAX model and fresh variables (the port's initial
    weights as a flax tree)."""
    dt = data[0]
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    return {scope: (j_enc.MadrigalMultilabel(enc_cfg=ref_cfg(j_config, scope),
                                             prediction_dim=5),
                    port_model(ref_cfg(t_config, scope), schema, seed=0,
                               prediction_dim=5)[1])
            for scope in ("global", "per_edge_type")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_finetune_checkpoint_serves_as_jax(data, references, jax_fresh,
                                           layout):
    dt, bj, kj, bt, kt = data
    sd, cv_mod, fus_mod, replica = references[layout]
    scope = LAYOUTS[layout][1]
    jm, fresh = jax_fresh[scope]
    params, stats = j_conv.convert_reference_finetune_checkpoint(
        sd, ref_cfg(j_config, scope), kj.metadata)
    want = np.asarray(applied(
        jm, {"params": j_merge(fresh["params"], params),
             "batch_stats": j_merge(fresh["batch_stats"], stats)},
        bj.head, bj.tail, kj, train=False))

    model = MadrigalMultilabel(ref_cfg(t_config, scope), 5,
                               *kg_schema(dt.kg_node_feats,
                                          dt.kg_edge_indices))
    load_flax_weights(model, fresh)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    converted = state_dict_from_reference(sd, ref_cfg(t_config, scope),
                                          kt.metadata)
    missing, unexpected = model.load_state_dict(converted, strict=False)
    assert not unexpected
    assert {k.split(".")[1] for k in missing} == {"str_encoder",
                                                  "tx_encoder"}
    for k in missing:
        assert torch.equal(model.state_dict()[k], before[k])
    model.eval()
    with torch.no_grad():
        got = model(bt.head, bt.tail, kt).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        # the torch replicas' own outputs
        x = {nt: kt.node_feats[nt] for nt in kt.metadata.node_types}
        np.testing.assert_allclose(
            model.encoder.kg_drug_table(kt).numpy(),
            replica(x, dt.kg_edge_indices)["drug"].numpy(), atol=1e-5,
            rtol=1e-5)
        cv = bt.head.cv
        np.testing.assert_allclose(model.encoder.cv_encoder(cv).numpy(),
                                   cv_mod(cv).numpy(), atol=1e-5, rtol=1e-5)
        rng = np.random.RandomState(7)
        seq = torch.from_numpy(rng.randn(4, 21, 32).astype(np.float32))
        fmask = torch.from_numpy(rng.rand(4, 21) < 0.3)
        fmask[:, 3:5] = False
        src = model.encoder.src_mask
        np.testing.assert_allclose(
            model.encoder.transformer(seq, fmask, src).numpy(),
            fus_mod(seq, fmask, src).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout,adaptor", [("pyg23", False),
                                            ("pyg22", True)])
def test_stage2_warm_start_matches_jax(data, references, jax_fresh,
                                       tmp_path, layout, adaptor):
    dt, _, kj, _, kt = data
    scope = LAYOUTS[layout][1]
    sd = references[layout][0]
    cl = {"base_encoder." + k[len("encoder."):]: v for k, v in sd.items()
          if k.startswith("encoder.")}
    jm, fresh = jax_fresh[scope]
    params, _ = j_conv.convert_reference_cl_checkpoint(
        cl, ref_cfg(j_config, scope), kj.metadata, adaptor)
    want = flax_to_state_dict({"params": {
        "encoder": j_merge(fresh["params"]["encoder"], params)}})

    cfg = t_config.PretrainConfig(encoder=ref_cfg(t_config, scope))
    path = str(tmp_path / "stage2.pt")
    stage2_checkpoint_from_reference(cl, path, cfg, kt.metadata, adaptor)
    stage2, saved_cfg = load_checkpoint(path)
    assert saved_cfg == cfg
    model = MadrigalMultilabel(ref_cfg(t_config, scope), 5,
                               *kg_schema(dt.kg_node_feats,
                                          dt.kg_edge_indices))
    load_flax_weights(model, fresh)
    kept = warm_start_encoder(model, stage2, adaptor)
    assert any(k.startswith("uni_projector.") for k in kept) == adaptor
    assert {k.split(".")[0] for k in kept} >= {"kg_encoder", "cv_encoder",
                                               "uni_fuser"}
    got = dict(model.named_parameters())
    for k, p in got.items():
        if k.startswith("encoder."):
            assert torch.equal(p.detach(), want[k]), k


def test_layout_scope_mismatch_raises(data, references):
    meta = data[4].metadata
    for layout, wrong in (("pyg23", "per_edge_type"), ("pyg22", "global")):
        with pytest.raises(ValueError, match="softmax_scope"):
            state_dict_from_reference(references[layout][0],
                                      ref_cfg(t_config, wrong), meta)
    bad = {k: v for k, v in references["pyg23"][0].items()
           if ".kqv_lin." not in k}
    with pytest.raises(KeyError, match="layout mismatch"):
        state_dict_from_reference(bad, ref_cfg(t_config, "global"), meta)
