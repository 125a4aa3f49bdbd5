"""The port's bfloat16 modes against the JAX package's.

`hgt.compute_dtype='bfloat16'` (the HGT's edge pipeline) and
`transformer.compute_dtype='bfloat16'` (the fusion's projections and
feed-forward matmuls) held to the JAX modules in the same mode, from the
same weights, at train=False:

  * the HGT encoder in both softmax scopes, the fusion transformer, and
    the whole model's scores with both modes on.

The JAX reference is applied op by op (not under `jax.jit`): then every
bf16 operation rounds its result, as the port's do. Under jit XLA keeps
some fused intermediates in float32, and its scores move by about as much
as bf16 moves them from float32. Tolerance: atol = 2^-8 * max|JAX|, one
unit roundoff of bf16 at the largest value (the port and JAX round at the
same points, so only float32 sums taken in another order differ).

Each test also shows that the mode is on: the port's bf16 result differs
from its float32 result by more than the float32 tolerance (1e-5); and the
HGT's backward hands K2 (its plain version, on the CPU) bf16 rows. The
float32 paths are unchanged (`tests/test_torch_golden.py`,
`tests/test_torch_models.py`).
"""
import dataclasses

import numpy as np
import pytest
import torch

from madrigal_tpu import config as j_config
from madrigal_tpu.constants import (
    NUM_CELL_LINES,
    NUM_MODALITIES,
    NUM_NON_TX_MODALITIES,
)
from madrigal_tpu.models import encoder as j_enc
from madrigal_tpu.models import fusion as j_fusion
from madrigal_tpu.models import hgt as j_hgt
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.models import fusion as t_fusion
from madrigal_tpu_torch.models import hgt as t_hgt
from madrigal_tpu_torch.models.encoder import MadrigalMultilabel
from madrigal_tpu_torch.ops import gather as t_gather
from madrigal_tpu_torch.ops.segment_sorted import sorted_segment_sum
from tests.test_torch_alt_encoders import (  # noqa: F401
    alt_cfg,
    carried,
    data,
    port_model,
)
from test_torch_train import one_thread  # noqa: F401  (fixture)

BF16_UNIT_ROUNDOFF = 2.0 ** -8
F32_TOL = 1e-5


def bf16_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(
        got, want, rtol=0, atol=BF16_UNIT_ROUNDOFF * np.abs(want).max())


def mode_on(bf16: np.ndarray, f32: np.ndarray) -> None:
    assert np.abs(bf16 - f32).max() > F32_TOL * np.abs(f32).max()


def hgt_kw(scope, compute_dtype="bfloat16", **kw):
    return dict(hidden_dim=64, num_layers=2, att_heads=4,
                softmax_scope=scope, compute_dtype=compute_dtype, **kw)


@pytest.mark.parametrize("scope", ["per_edge_type", "global"])
def test_hgt_bf16(data, scope):
    """On the destination-sorted KG batch of both packages (the port's
    default, the JAX package's sort_edges)."""
    from madrigal_tpu.data.kg import build_kg_batch as j_build

    dt, _, _, _, kt = data
    kj = j_build(dt.kg_node_feats, dt.kg_edge_indices, dt.kg_drug_ids,
                 sort_edges=True)
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    jm = j_hgt.HGTEncoder(cfg=j_config.HGTConfig(**hgt_kw(scope)),
                          embed_dim=8)
    tm = t_hgt.HGTEncoder(t_config.HGTConfig(**hgt_kw(scope)), 8, *schema)
    v, tm = carried(jm, tm, kj, train=False)
    t32 = t_hgt.HGTEncoder(t_config.HGTConfig(**hgt_kw(scope, "float32")),
                           8, *schema)
    t32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got, f32 = tm(kt)["drug"], t32.eval()(kt)["drug"]
    assert got.dtype == torch.float32
    want = np.asarray(jm.apply(v, kj, train=False)["drug"])
    bf16_close(got.numpy(), want)
    mode_on(got.numpy(), f32.numpy())


def test_hgt_bf16_backward_hands_k2_bf16_rows(data, monkeypatch):
    """With the source-sorted layout the fused k|v gather's backward
    reduces bf16 cotangent rows, once per (layer, edge type) reaching the
    drug table; the edge-type remat gives the same gradients (within
    1e-6 of each tensor's largest: the recompute repeats the same ops, and
    CPU sums are threaded)."""
    dt = data[0]
    kt = t_collate.DDICollator(dt, split="train", device="cpu",
                               kg_src_sort=True).kg_batch()
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    seen = []

    def counted(rows, *args):
        seen.append((rows.dtype, rows.shape[1]))
        return sorted_segment_sum(rows, *args)

    monkeypatch.setattr(t_gather, "sorted_segment_sum", counted)
    grads = {}
    for remat in (False, True):
        cfg = t_config.HGTConfig(**hgt_kw("per_edge_type",
                                          remat_edge_types=remat))
        torch.manual_seed(0)
        tm = t_hgt.HGTEncoder(cfg, 8, *schema)
        for p in tm.parameters():
            torch.nn.init.normal_(p, 0.0, 0.2)
        tm(kt)["drug"].square().sum().backward()
        grads[remat] = {k: p.grad for k, p in tm.named_parameters()}
    # the fused k|v table's transposes (128 wide) and the destination
    # gathers' (64) reduce bf16 rows; the softmax denominators' (4) f32
    assert [s for s in seen if s[1] == 128] == [(torch.bfloat16, 128)] * (
        2 * (2 + 7))
    assert set(seen) == {(torch.bfloat16, 128), (torch.bfloat16, 64),
                         (torch.float32, 4)}
    reached = {k for k, g in grads[False].items() if g is not None}
    assert reached == {k for k, g in grads[True].items() if g is not None}
    for k in reached:
        g = grads[False][k]
        torch.testing.assert_close(grads[True][k], g, rtol=0,
                                   atol=1e-6 * float(g.abs().max()))


@pytest.mark.parametrize("agg,norm_first,actn", [
    ("x-attn", True, "gelu"), ("x-attn", False, "relu"),
    ("mean", True, "gelu")])
def test_fusion_bf16(agg, norm_first, actn):
    num_bt = 2 if agg == "x-attn" else 0
    kw = dict(num_layers=2, att_heads=2, head_dim=8, ffn_dim=24, dropout=0.0,
              norm_first=norm_first, agg=agg, num_tx_bottlenecks=num_bt,
              actn=actn)
    S = NUM_MODALITIES + num_bt
    rng = np.random.RandomState(6)
    seq = rng.randn(5, S, 12).astype(np.float32)
    fmask = rng.rand(5, S) < 0.4
    fmask[:, NUM_NON_TX_MODALITIES:NUM_NON_TX_MODALITIES + num_bt] = False
    src = (j_fusion.build_bottleneck_masks(NUM_NON_TX_MODALITIES, num_bt,
                                           NUM_CELL_LINES, False)
           if num_bt else None)
    jm = j_fusion.TransformerFusion(
        cfg=j_config.FusionConfig(compute_dtype="bfloat16", **kw),
        embed_dim=12, num_kv_tokens=S, num_non_tx=NUM_NON_TX_MODALITIES)
    tm = t_fusion.TransformerFusion(
        t_config.FusionConfig(compute_dtype="bfloat16", **kw), 12, S,
        NUM_NON_TX_MODALITIES)
    v, tm = carried(jm, tm, seq, fmask, src)
    t32 = t_fusion.TransformerFusion(t_config.FusionConfig(**kw), 12, S,
                                     NUM_NON_TX_MODALITIES)
    t32.load_state_dict(tm.state_dict())
    args = (torch.from_numpy(seq), torch.from_numpy(fmask),
            None if src is None else torch.from_numpy(src))
    with torch.no_grad():
        got, f32 = tm(*args), t32.eval()(*args)
    assert got.dtype == torch.float32
    bf16_close(got.numpy(), np.asarray(jm.apply(v, seq, fmask, src)))
    mode_on(got.numpy(), f32.numpy())


def bf16_cfg(c, compute_dtype="bfloat16"):
    enc = alt_cfg(c)
    return dataclasses.replace(
        enc, hgt=dataclasses.replace(enc.hgt, hidden_dim=64, att_heads=4,
                                     compute_dtype=compute_dtype),
        transformer=dataclasses.replace(enc.transformer, actn="gelu",
                                        compute_dtype=compute_dtype))


def test_whole_model_bf16(data):
    dt, bj, kj, bt, kt = data
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    model, v = port_model(bf16_cfg(t_config), schema, seed=1)
    jm = j_enc.MadrigalMultilabel(enc_cfg=bf16_cfg(j_config),
                                  prediction_dim=4)
    want = np.asarray(jm.apply(v, bj.head, bj.tail, kj, train=False))
    f32 = MadrigalMultilabel(bf16_cfg(t_config, "float32"), 4, *schema)
    f32.load_state_dict(model.state_dict())
    got = {}
    for cd, m in (("bfloat16", model), ("float32", f32.eval())):
        with torch.no_grad():
            got[cd] = m(bt.head, bt.tail, kt).numpy()
    bf16_close(got["bfloat16"], want)
    mode_on(got["bfloat16"], got["float32"])
