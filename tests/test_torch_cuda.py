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
    """The HGT with compute_dtype='bfloat16' on the card: its backward
    hands K2 bf16 rows, once per (layer, edge type) reaching the drug
    table, and every gradient is within 2^-8 (bf16's unit roundoff) of
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
        assert ts.sorted_segment_sum.launches - before == (
            9 if name == "k2" else 0)
        grads[name] = {k: p.grad.float().cpu()
                       for k, p in model.named_parameters()
                       if p.grad is not None}
    assert seen == [(torch.bfloat16, 256)] * 18
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
    1e-4 relative; K2 runs in the replicated KG's backward only."""
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
