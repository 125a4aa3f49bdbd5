"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 with f32 compute and output within 1e-4 of max|plain|
(the same f32 products, summed in another order); with bf16 anywhere,
1e-2 (a bf16 rounding of z_head . W_l or of the score can land on the
other side of its boundary). K2 within 1e-5 of max|plain| (the same f32
sums in another order; bf16 and f16 rows widen to f32 exactly).
Ranks on the card equal the port's CPU ranks of the same scores exactly
(the same stable order, the same float32 arithmetic); the sigmoid-mean
ensemble of K1 scores is within 1e-5 of the CPU path's.
"""
import copy

import numpy as np
import pytest
import torch

from madrigal_tpu_torch.eval import predict as tp
from madrigal_tpu_torch.eval import ranks as tr
from madrigal_tpu_torch.models.decoder import BilinearDDIScorer
from madrigal_tpu_torch.ops import bilinear as tb
from madrigal_tpu_torch.ops import segment_sorted as ts
from madrigal_tpu_torch.ops.gather import gather_rows_sorted

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 300, 1000), (2, 1, 7), (3, 64, 64),
                                   (3, 129, 257), (1, 1, 6843),
                                   (2, 256, 1024), (1, 65, 6843),
                                   (3, 100, 1002), (5, 129, 1024),
                                   (6, 1, 6843), (5, 63, 999)])
@pytest.mark.parametrize("compute,out", [("f32", "f32"), ("bf16", "bf16"),
                                         ("bf16", "f32"), ("f32", "bf16")])
def test_bilinear_kernel_matches_plain(cuda, shape, compute, out):
    """Shapes inside one tile, across the f32 path's 128x128 tile edges
    (129, 257), one row against the serving width (N % 4 != 0: one-value
    stores) and whole tiles with N % 4 == 0 (16-byte stores). For the bf16
    path's outcome groups and row-wise stores: L not a multiple of the
    group (1, 3, 5, 6), M not a multiple of 64, N odd, N % 8 == 2 and
    N % 8 == 0 (rows at every 2-byte offset, and aligned rows), and small
    M against large N (the z_tail sweep split). Each call counts one
    launch, though f32 compute runs two CUDA kernels (z_head @ W_l, then
    the scores)."""
    L, M, N = shape
    rng = np.random.RandomState(0)
    zh = torch.from_numpy(rng.randn(M, 128).astype(np.float32)).to(cuda)
    zt = torch.from_numpy(rng.randn(N, 128).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(L, 128, 128) / np.sqrt(128))
                         .astype(np.float32)).to(cuda)
    cdt, odt = DTYPES[compute], DTYPES[out]
    before = tb.bilinear_scores.launches
    got = tb.bilinear_scores(zh, zt, w, out_dtype=odt, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert tb.bilinear_scores.launches == before + 1
    assert got.shape == (L, M, N) and got.dtype == odt
    ref = tb.bilinear_scores_plain(zh, zt, w, out_dtype=odt,
                                   compute_dtype=cdt)
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-4 if compute == out == "f32" else 1e-2
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
def test_bilinear_kernel_refuses_what_it_does_not_take(cuda):
    zh = torch.randn(4, 64, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        tb.bilinear_scores(zh, zh, torch.randn(1, 64, 64, device=cuda))
    zh = torch.randn(4, 128, device=cuda)
    with pytest.raises(ValueError, match="compute_dtype"):
        tb.bilinear_scores(zh, zh, torch.randn(1, 128, 128, device=cuda),
                           compute_dtype=torch.float16)


def _sorted_rows(cuda, e, n, w, real, seed):
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.randint(0, n, real))
    ids[ids == n // 2] = n // 2 + 1  # an empty segment
    data = torch.from_numpy(rng.randn(e, w).astype(np.float32)).to(cuda)
    starts = torch.from_numpy(ts.segment_starts_np(ids, n, real)).to(cuda)
    return data, starts


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,w,real", [(1000, 37, 256, 900),
                                        (4096, 1001, 128, 4000),
                                        (300, 5, 384, 300), (0, 3, 256, 0),
                                        (500, 21, 96, 480), (200, 9, 37, 200),
                                        (64, 4, 1, 60)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("aligned", [True, False])
def test_segment_sum_kernel_matches_plain(cuda, e, n, w, real, dtype,
                                          aligned):
    """Widths taking each of the kernel's vector paths (8, 4 and 1 values
    a lane), and rows that start off the vector alignment (the scalar
    path)."""
    data, starts = _sorted_rows(cuda, e, n, w, real, seed=e + n)
    data = data.to(DTYPES[dtype])
    if not aligned:  # the same rows one element into a larger buffer
        buf = torch.empty(e * w + 1, dtype=data.dtype, device=cuda)
        buf[1:] = data.reshape(-1)
        data = buf[1:].view(e, w)
    before = ts.sorted_segment_sum.launches
    got = ts.sorted_segment_sum(data, starts, n)
    again = ts.sorted_segment_sum(data, starts, n)
    torch.cuda.synchronize()
    assert ts.sorted_segment_sum.launches == before + 2
    assert got.shape == (n, w) and got.dtype == torch.float32
    assert torch.equal(got, again)  # no atomics: the same bits every run
    ref = ts.sorted_segment_sum_plain(data, starts, n)
    err = (got - ref).abs().max().item() if n else 0.0
    assert err <= 1e-5 * max(ref.abs().max().item(), 1.0)


@pytest.mark.cuda
def test_sorted_gather_backward_launches_k2(cuda):
    from madrigal_tpu_torch.data.kg import _src_sort_layout

    rng = np.random.RandomState(1)
    n, e, w = 50, 600, 256
    idx = rng.randint(0, n, e).astype(np.int32)
    order, starts = _src_sort_layout(idx, np.ones(e, bool), n)
    table = torch.randn(n, w, device=cuda, requires_grad=True)
    cot = torch.randn(e, w, device=cuda)
    args = [torch.from_numpy(a).to(cuda) for a in (idx, order, starts)]
    before = ts.sorted_segment_sum.launches
    (gather_rows_sorted(table, *args) * cot).sum().backward()
    torch.cuda.synchronize()
    assert ts.sorted_segment_sum.launches == before + 1
    ref = torch.zeros_like(table).index_add_(0, args[0].long(), cot)
    assert (table.grad - ref).abs().max().item() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_segment_sum_kernel_refuses_what_it_does_not_take(cuda):
    data, starts = _sorted_rows(cuda, 64, 4, 128, 64, seed=2)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ts.sorted_segment_sum(data.double(), starts, 4)
    with pytest.raises(ValueError, match="int32"):
        ts.sorted_segment_sum(data, starts.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ts.sorted_segment_sum(data.t().contiguous().t(), starts, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 300, 6000])
@pytest.mark.parametrize("stable,compact,ties", [
    (True, None, False), (True, True, False), (False, None, False),
    (True, None, True), (True, True, True)])
def test_ranks_on_card_equal_cpu_ranks(cuda, n, stable, compact, ties):
    """At n = 6000, m = n(n-1)/2 passes 2^24: the float32 rounding of the
    ranks is checked there too. Ties only under stable sorts (an unstable
    sort may order equal scores either way)."""
    rng = np.random.RandomState(n)
    if ties:
        s = np.round(rng.randn(n, n) * 2).astype(np.float32) / 2
    else:  # n^2 distinct floats: distinct bit patterns from 1.0 up
        s = (np.int32(0x3F800000) + rng.permutation(n * n).astype(np.int32)
             ).view(np.float32).reshape(n, n)
    got = tr.normalized_rank_matrix(torch.from_numpy(s).to(cuda),
                                    stable=stable, compact=compact)
    want = tr.normalized_rank_matrix(torch.from_numpy(s), stable=stable,
                                     compact=compact)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_rank_tensor_on_card_runs_k1_and_equals_cpu_ranks(cuda):
    rng = np.random.RandomState(1)
    n, L = 700, 5
    z = rng.randn(n, 128).astype(np.float32)
    w = (rng.randn(L, 128, 128) / np.sqrt(128)).astype(np.float32)
    w = np.triu(w) + np.transpose(np.triu(w, 1), (0, 2, 1))
    before = tb.bilinear_scores.launches
    got = tr.rank_tensor(z, w, chunk=2, device=cuda)
    assert tb.bilinear_scores.launches == before + 3  # ceil(5 / 2) chunks
    zc, wc = torch.from_numpy(z).to(cuda), torch.from_numpy(w).to(cuda)
    for l in range(L):
        scores = tb.bilinear_scores(zc, zc, wc[l:l + 1], torch.float32,
                                    torch.float32)[0].cpu()
        want = tr.normalized_rank_matrix(scores)
        assert torch.equal(torch.from_numpy(got[l]), want)


class _Decoder(torch.nn.Module):
    """What ensemble_sigmoid_scores_all_pairs reads of a model."""

    def __init__(self, w):
        super().__init__()
        self.decoder = BilinearDDIScorer(*w.shape)
        with torch.no_grad():
            self.decoder.weight.copy_(torch.from_numpy(w))


@pytest.mark.cuda
def test_ensemble_sigmoid_scores_on_card_match_cpu(cuda):
    rng = np.random.RandomState(2)
    n, L = 300, 7
    seeds = [(rng.randn(L, 128, 128) / np.sqrt(128)).astype(np.float32)
             for _ in range(3)]
    zs = [rng.randn(n, 128).astype(np.float32) for _ in range(3)]
    want = tp.ensemble_sigmoid_scores_all_pairs(
        [(_Decoder(w), z) for w, z in zip(seeds, zs)], label_chunk=3)
    before = tb.bilinear_scores.launches
    got = tp.ensemble_sigmoid_scores_all_pairs(
        [(_Decoder(w).to(cuda), z) for w, z in zip(seeds, zs)],
        label_chunk=3)
    assert tb.bilinear_scores.launches == before + 3 * 3  # seeds x chunks
    assert got.shape == (L, n, n)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.cuda
def test_prefetcher_batches_equal_serial_ones(cuda):
    """Pinned host memory, a side-stream copy and an event: each batch the
    consumer reads (and computes on at once) equals the serial copy bit
    for bit, in order."""
    from madrigal_tpu_torch.data.collate import DDICollator
    from madrigal_tpu_torch.data.pipeline import (
        map_tensors,
        prefetch_epochs,
        to_device,
    )
    from madrigal_tpu_torch.data.synthetic import make_dataset

    coll = DDICollator(make_dataset(num_drugs=40, seed=1), device="cpu")
    rng = np.random.RandomState(0)
    hosts = [(coll.drug_batch(rng.choice(40, 16, replace=False)),
              rng.randn(512, 256).astype(np.float32),
              {"m": rng.rand(16, 19) < 0.5}) for _ in range(6)]
    got = []
    for batch in prefetch_epochs(lambda s: hosts[s], 6, buffer_size=2,
                                 device=cuda):
        got.append((batch, float(batch[1].double().sum())))
    for (batch, total), host in zip(got, hosts):
        want = to_device(host, cuda)
        assert total == float(want[1].double().sum())
        flat_got, flat_want = [], []
        map_tensors(flat_got.append, batch)
        map_tensors(flat_want.append, want)
        assert len(flat_got) == len(flat_want) > 8
        for a, b in zip(flat_got, flat_want):
            assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
def test_stage2_step_on_card_matches_cpu(cuda):
    """One stage-2 step (device-table path, dropout 0) from the same
    weights: the loss within 1e-5 relative and every parameter within
    1e-5 of the CPU step's, plus 2 * lr * steps on the entries whose
    step-1 gradient is at most 1e-6 of the model's largest (a bias ahead
    of a BatchNorm has a true gradient of 0 and carries rounding noise
    only, which Adam's first step turns into a move of up to lr either
    way; `tests/test_torch_stage1.py` allows the same); the HGT backward
    launches K2."""
    from madrigal_tpu_torch import config as C
    from madrigal_tpu_torch.data.collate import DDICollator
    from madrigal_tpu_torch.data.kg import kg_schema
    from madrigal_tpu_torch.data.synthetic import make_dataset
    from madrigal_tpu_torch.models.encoder import init_weights
    from madrigal_tpu_torch.train.pretrain_cl import (
        CLPretrainer,
        build_simclr_model,
    )

    ds = make_dataset(num_drugs=24, seed=3)
    enc = C.EncoderConfig(
        feature_dim=16, gin=C.GINConfig(hidden_dims=(16, 16),
                                        num_mlp_layer=2),
        hgt=C.HGTConfig(hidden_dim=64, num_layers=2, att_heads=2),
        cv=C.MLPEncoderConfig(hidden_dims=(32, 16), dropout=0.0),
        chemcpa=C.ChemCPAConfig(dim=16, autoencoder_width=32,
                                autoencoder_depth=1),
        transformer=C.FusionConfig(num_layers=1, att_heads=2, head_dim=8,
                                   ffn_dim=32, dropout=0.0),
        proj=C.ProjectorConfig(hidden_dims=(32, 32), dropout=0.0),
        pos_emb_dropout=0.0)
    cfg = C.PretrainConfig(encoder=enc, pretrain_batch_size=16,
                           warmup_epochs=0, pretrain_lr=1e-3,
                           raw_encoder_output=True)
    model = init_weights(build_simclr_model(
        cfg, *kg_schema(ds.kg_node_feats, ds.kg_edge_indices)),
        torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda):
        coll = DDICollator(ds, device=dev, kg_src_sort=True)
        tr = CLPretrainer(cfg, coll, coll.kg_batch(),
                          copy.deepcopy(model).to(dev))
        before = ts.sorted_segment_sum.launches
        loss = tr.train_step()
        runs[str(dev)] = (loss, ts.sorted_segment_sum.launches - before,
                          {k: v.cpu() for k, v in
                           tr.model.state_dict().items()},
                          {k: p.grad.cpu() for k, p in
                           tr.model.named_parameters()
                           if p.grad is not None})
    (lc, kc, sc, grads), (lg, kg_, sg, _) = runs["cpu"], runs["cuda"]
    assert kc == 0 and kg_ > 0
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    top = max(float(g.abs().max()) for g in grads.values())
    allowance = 2 * cfg.pretrain_lr * 1  # 2 * lr * steps
    for k, v in sc.items():
        atol = np.full(v.shape, 1e-5)
        if k in grads:
            atol[(grads[k].abs() <= 1e-6 * top).numpy()] += allowance
        err = np.abs(sg[k].numpy() - v.numpy())
        assert (err <= atol).all(), (k, float(err.max()))


@pytest.mark.cuda
def test_bf16_hgt_step_k2_on_bf16_rows_matches_plain(cuda, monkeypatch):
    """The HGT with compute_dtype='bfloat16' on the card: its source
    gathers' backward hands K2 bf16 rows, once per (layer, edge type)
    reaching the drug table (its destination gathers' too, and the
    denominators' gathers f32 rows), and every gradient is within 2^-8 (bf16's unit roundoff) of
    its tensor's largest of the same step through K2's plain version (the
    same f32 sums in another order, each rounded to bf16)."""
    from madrigal_tpu_torch import config as C
    from madrigal_tpu_torch.data.collate import DDICollator
    from madrigal_tpu_torch.data.kg import kg_schema
    from madrigal_tpu_torch.data.synthetic import make_dataset
    from madrigal_tpu_torch.models.hgt import HGTEncoder
    from madrigal_tpu_torch.ops import gather as tg

    ds = make_dataset(num_drugs=24, seed=3)
    kg = DDICollator(ds, device=cuda, kg_src_sort=True).kg_batch()
    cfg = C.HGTConfig(hidden_dim=128, num_layers=2, att_heads=4,
                      compute_dtype="bfloat16")
    torch.manual_seed(0)
    model = HGTEncoder(cfg, 16, *kg_schema(ds.kg_node_feats,
                                           ds.kg_edge_indices)).to(cuda)
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1)
    seen, grads = [], {}
    # the forward's sums (2 a layer and edge type) run on K2 in both runs;
    # the gathers' transposes (3 a live edge type: source, destination,
    # denominators) on K2 or on its plain version
    forward = 2 * cfg.num_layers * len(ds.kg_edge_indices)
    for name, reduce in (("k2", ts.sorted_segment_sum),
                         ("plain", ts.sorted_segment_sum_plain)):
        def counted(rows, *args, reduce=reduce):
            seen.append((rows.dtype, rows.shape[1]))
            return reduce(rows, *args)

        monkeypatch.setattr(tg, "sorted_segment_sum", counted)
        model.zero_grad(set_to_none=True)
        before = ts.sorted_segment_sum.launches
        model(kg)["drug"].square().sum().backward()
        torch.cuda.synchronize()
        assert ts.sorted_segment_sum.launches - before == forward + (
            3 * 9 if name == "k2" else 0)
        grads[name] = {k: p.grad.float().cpu()
                       for k, p in model.named_parameters()
                       if p.grad is not None}
    assert [s for s in seen if s[1] == 256] == [(torch.bfloat16, 256)] * 18
    assert sorted(set(seen), key=str) == sorted(
        {(torch.bfloat16, 256), (torch.bfloat16, 128), (torch.float32, 4)},
        key=str)
    assert grads["k2"].keys() == grads["plain"].keys()
    for k, ref in grads["plain"].items():
        torch.testing.assert_close(grads["k2"][k], ref, rtol=0,
                                   atol=2.0 ** -8 * float(ref.abs().max()))


TWO_RANKS = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.synthetic import make_dataset
from madrigal_tpu_torch.eval.ranks import rank_tensor
from madrigal_tpu_torch.ops import segment_sorted
from madrigal_tpu_torch.parallel import dryrun as D
from madrigal_tpu_torch.parallel.allpairs import sharded_rank_tensor
from madrigal_tpu_torch.parallel.mesh import make_mesh
from madrigal_tpu_torch.parallel.multihost import initialize, shutdown
from madrigal_tpu_torch.parallel.train_step import make_train_mesh

dev = initialize(device="cuda", backend="gloo")
rng = np.random.RandomState(0)
z = rng.randn(300, 128).astype(np.float32)
w = rng.randn(6, 128, 128).astype(np.float32) / 128
w = (w + w.transpose(0, 2, 1)) / 2
got = sharded_rank_tensor(make_mesh(("label",)), z, w, chunk_per_device=2)
out = {}
if got is not None:
    out["ranks_equal"] = bool(np.array_equal(
        got, rank_tensor(z, w, chunk=3, device="cuda")))
ds = make_dataset(num_drugs=12, num_labels=8, num_edges=24, seed=0)
batch, kg = DDICollator(ds, split="train", device=dev, kg_src_sort=True)()
cfg = D.three_way_config()
ref, _ = D.finetune_step(cfg, batch, kg, ds, dev)
segment_sorted.sorted_segment_sum.launches = 0
for label in (1, 2):
    for axis in (None, "dp"):
        got, _ = D.finetune_step(cfg, batch, kg, ds, dev,
                                 make_train_mesh(label_dim=label), axis)
        out[f"{label}_{axis}"] = max(abs(got[k] - ref[k]) / abs(ref[k])
                                     for k in ref)
out["k2"] = segment_sorted.sorted_segment_sum.launches
if dist.get_rank() == 0:
    json.dump(out, open(sys.argv[1], "w"))
shutdown()
"""


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_match_one_card(cuda, tmp_path):
    """Two ranks sharing the card (gloo: NCCL refuses a shared card): the
    label-sharded ranks equal rank_tensor's on the card exactly, and a
    narrow three-forward finetune step on meshes 2 x 1 and 1 x 2, the KG
    replicated and edge-sharded, has the one-card step's losses within
    1e-4 relative; K2 carries the encoders' sums on every path."""
    import json
    import sys

    from madrigal_tpu_torch.parallel.dryrun import launch, require_ok

    path = tmp_path / "out.json"
    require_ok(launch([sys.executable, "-c", TWO_RANKS, str(path)], 2,
                      timeout=600))
    out = json.loads(path.read_text())
    assert out["ranks_equal"]
    for key in ("1_None", "1_dp", "2_None", "2_dp"):
        assert out[key] <= 1e-4, (key, out)
    assert out["k2"] > 0


# ---------------------------------------------------- reproducibility
# Every sum the encoders make runs on K2 over sorted layouts (the KG
# batch sorted by destination, the molecule batches' layouts), so a pass
# gives the same bits on every run.

@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["uniform", "hub", "zipf"])
@pytest.mark.parametrize("w", [4, 128, 256])
def test_segment_sum_kernel_skewed_and_narrow(cuda, draw, w):
    """K2 at the widths of its new uses (4: the softmax denominators, one
    column a head; 128: the messages; 256: the fused k|v table) on rows
    grouped uniformly, with one hub segment holding a quarter of them,
    and by a Zipf-like draw. The rows hold small integers, so every f32
    sum is exact in any order: K2 equals its plain version exactly."""
    g = torch.Generator(device=cuda).manual_seed(w)
    e, n = 200_000, 5_000
    if draw == "zipf":
        weights = torch.arange(1, n + 1, device=cuda,
                               dtype=torch.float64) ** -1.1
        ids = torch.multinomial(weights, e, replacement=True, generator=g)
    else:
        ids = torch.randint(0, n, (e,), generator=g, device=cuda)
        if draw == "hub":
            ids[:e // 4] = n // 3
    ids = ids.sort()[0]
    starts = torch.searchsorted(
        ids, torch.arange(n + 1, device=cuda)).to(torch.int32)
    data = torch.randint(-8, 9, (e + 100, w), generator=g,
                         device=cuda).float()
    got = ts.sorted_segment_sum(data, starts, n)
    assert torch.equal(got, ts.sorted_segment_sum(data, starts, n))
    assert torch.equal(got, ts.sorted_segment_sum_plain(data, starts, n))


@pytest.mark.cuda
def test_molecule_layout_sums_match_plain(cuda):
    """K2 over the molecule batch's layouts (the GIN's and GAT's message
    sums and denominators, the readout) against its plain version."""
    from madrigal_tpu_torch.data.molgraph import pack_molecules
    from madrigal_tpu_torch.data.synthetic import make_dataset

    mols = pack_molecules(make_dataset(num_drugs=64, seed=5).molecules,
                          device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    for n_rows, w, starts, n in (
            (mols.num_edges_padded, 128, mols.edge_dst_starts,
             mols.num_nodes_padded),
            (mols.num_edges_padded, 4, mols.edge_dst_starts,
             mols.num_nodes_padded),
            (mols.num_nodes_padded, 128, mols.node_graph_starts,
             mols.num_graphs)):
        data = torch.randn(n_rows, w, generator=g, device=cuda)
        got = ts.sorted_segment_sum(data, starts, n)
        ref = ts.sorted_segment_sum_plain(data, starts, n)
        assert (got - ref).abs().max().item() <= 1e-5 * max(
            ref.abs().max().item(), 1.0)


def _flagship(num_labels, remat=False):
    """The flagship configuration of chip_smoke.py, dropout 0, its
    triples scored in label chunks as the training runs score them."""
    import dataclasses

    from chip_smoke import LABEL_CHUNK, flagship_config

    cfg = flagship_config(num_labels, dropout=False)
    enc = cfg.model.encoder
    return dataclasses.replace(
        cfg, label_chunk_triples=LABEL_CHUNK,
        model=dataclasses.replace(cfg.model, encoder=dataclasses.replace(
            enc, hgt=dataclasses.replace(enc.hgt,
                                         remat_edge_types=remat))))


def _scaled(shrink):
    from madrigal_tpu_torch.cli.common import reference_scale_kwargs
    from madrigal_tpu_torch.data.synthetic import (
        make_reference_scale_dataset)

    return make_reference_scale_dataset(seed=0,
                                        **reference_scale_kwargs(shrink))


def _scaled_data(cuda, ds, src_sort=True, sorted_layouts=True):
    """`ds`'s training batch (chip_smoke.py's 80% split) and its KG batch
    on the card. Without sorted_layouts, the KG in its input order and the
    molecule batches without their layouts: the sums the port ran before
    K2 carried them (index_add_)."""
    import dataclasses

    from chip_smoke import split_rows
    from madrigal_tpu_torch.data.collate import DDICollator
    from madrigal_tpu_torch.data.kg import build_kg_batch

    batch, _ = DDICollator(ds, split="train", device=cuda)(
        split_rows(ds)["train"], build_kg=False)
    kg = build_kg_batch(ds.kg_node_feats, ds.kg_edge_indices,
                        ds.kg_drug_ids, device=cuda, src_sort=src_sort,
                        sort_edges=sorted_layouts)
    if not sorted_layouts:
        plain = {k: None for k in ("edge_dst_order", "edge_dst_starts",
                                   "edge_src_order", "edge_src_starts",
                                   "node_graph_starts")}
        head = dataclasses.replace(batch.head, mols=dataclasses.replace(
            batch.head.mols, **plain))
        tail = (head if batch.tail is batch.head else dataclasses.replace(
            batch.tail, mols=dataclasses.replace(batch.tail.mols, **plain)))
        batch = dataclasses.replace(batch, head=head, tail=tail)
    return batch, kg


@pytest.mark.cuda
def test_serving_forward_twice_bit_identical(cuda):
    """The flagship's KG pass and drug encodings (embed_all_drugs) twice,
    at the reference scale / 8: the same bits."""
    from madrigal_tpu_torch.data.collate import DDICollator

    ds = _scaled(8)
    batch, kg = _scaled_data(cuda, ds, src_sort=False)
    model = _trainer(cuda, ds, batch, kg,
                     _flagship(ds.num_labels)).model.eval()
    coll = DDICollator(ds, device=cuda)
    first = tp.embed_all_drugs(model, coll, kg)
    assert np.isfinite(first).all()
    assert np.array_equal(first, tp.embed_all_drugs(model, coll, kg))


def _trainer(cuda, ds, batch, kg, cfg):
    from madrigal_tpu_torch.data.kg import kg_schema
    from madrigal_tpu_torch.models.encoder import build_model, init_weights
    from madrigal_tpu_torch.train.finetune import (
        FinetuneTrainer,
        training_model_config,
    )

    model = build_model(training_model_config(cfg),
                        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices),
                        device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return FinetuneTrainer(cfg, batch, kg, model.to(cuda))


@pytest.mark.cuda
def test_training_step_twice_bit_identical(cuda):
    """One flagship training step (the reference scale / 8) run twice
    from the same weights, optimizer state, mask sampler and generator
    states: the same loss, parameters, buffers and optimizer state."""
    from chip_smoke import repeat_step

    ds = _scaled(8)
    batch, kg = _scaled_data(cuda, ds)
    trainer = _trainer(cuda, ds, batch, kg, _flagship(ds.num_labels))
    trainer.train_epoch()  # the optimizer's state is not empty
    assert repeat_step(trainer)["tensors"] > 0


@pytest.mark.cuda
def test_training_step_runs_no_nondeterministic_op(cuda):
    """A flagship training step (the reference scale / 64) and a serving
    pass under torch.use_deterministic_algorithms(True, warn_only=True):
    PyTorch warns on no operation that lacks a deterministic form, but
    two. cuBLAS's warning about CUBLAS_WORKSPACE_CONFIG concerns work
    spread over several streams, and the step runs on one. The segment
    maximum of the softmax (`scatter_reduce_` amax, `ops/segment.py`)
    takes a maximum, which no order changes, and carries no gradient."""
    import warnings

    from madrigal_tpu_torch.data.collate import DDICollator

    ds = _scaled(64)
    batch, kg = _scaled_data(cuda, ds)
    trainer = _trainer(cuda, ds, batch, kg, _flagship(ds.num_labels))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_epoch()
            tp.embed_all_drugs(trainer.model.eval(),
                               DDICollator(ds, device=cuda), kg)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    found = sorted({str(w.message).split("\n")[0] for w in caught
                    if "deterministic" in str(w.message)
                    and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)
                    and "scatter_reduce" not in str(w.message)})
    assert not found, found


@pytest.mark.cuda
def test_f1_cost_kg_pass_and_step(cuda, monkeypatch):
    """The cost of the repair at full scale (prints one JSON line; run it
    with -s): the flagship's full-KG pass (`kg_drug_table`, no gradient)
    and one training step with the HGT remat, their device memory peaks,
    on the sorted layouts (K2), on the input-order batches (the sums on
    index_add_, as before), and on those under
    torch.use_deterministic_algorithms(True) (index_add_'s deterministic
    form; warn_only, its warnings counted)."""
    import json
    import time
    import warnings

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    out = {"card": torch.cuda.get_device_name(0)}
    ds = _scaled(1)
    for mode in ("sorted", "index_add", "deterministic"):
        batch, kg = _scaled_data(cuda, ds, sorted_layouts=mode == "sorted")
        trainer = _trainer(cuda, ds, batch, kg,
                           _flagship(ds.num_labels, remat=True))
        torch.cuda.empty_cache()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if mode == "deterministic":
                torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                row = {}
                with torch.no_grad():
                    trainer.model.encoder.kg_drug_table(kg)  # warm-up
                    times = []
                    for _ in range(3):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        trainer.model.encoder.kg_drug_table(kg)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                row["kg_pass_s"] = times
                torch.cuda.reset_peak_memory_stats()
                trainer.train_epoch()  # warm-up
                times = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_epoch()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                row["step_s"] = times
                row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            finally:
                torch.use_deterministic_algorithms(False)
        row["warnings"] = sorted({str(w.message).split("\n")[0][:160]
                                  for w in caught
                                  if "determinis" in str(w.message)})
        out[mode] = row
        del trainer, batch, kg
        torch.cuda.empty_cache()
    print(json.dumps({"f1_cost": out}), flush=True)
    assert all(np.isfinite(out[m]["step_s"]).all() for m in
               ("sorted", "index_add", "deterministic"))
