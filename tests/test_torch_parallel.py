"""The port's sharded paths (`madrigal_tpu_torch/parallel/`) against the
JAX package and against the port on one device.

Real separate processes: two gloo ranks on the CPU, and four for the
2 x 2 mesh and dp = 4, started as `python -c` so that they import no JAX
(`tests/conftest.py` does). They all start when the module's fixture does
and run beside the JAX references computed here. Each writes its results
to `tmp_path`; the pytest process compares them. Every check is at the
JAX package's narrow test widths.

  * Ranks: `sharded_rank_tensor` (2 ranks on 'label'; and the 2 x 2 mesh,
    whose 'dp' rows are replicas) equals JAX's `sharded_rank_tensor` on
    the 8-virtual-device mesh and the port's `rank_tensor`, exactly.
  * `sharded_score_chunk` within 1e-5 of JAX's; `embed_all_drugs_sharded`
    within 1e-5 of JAX's serial `embed_all_drugs` from the same weights.
  * Graph-parallel KG (edges over 'dp'): the drug table (both softmax
    scopes) and every parameter's gradient of sum(tanh(table)^2) (also
    with each edge type recomputed in the backward) within 1e-5 of JAX's
    unsharded ones, as tests/test_kg_shard.py does.
  * The finetune step (three forwards with str-str) on meshes 2 x 1,
    1 x 2 and 2 x 2, each with the KG replicated and edge-sharded over
    'dp', and 2 x 1 with the label-chunked view: each forward's loss
    within 1e-4 of JAX's single-device forward from the same weights and
    masks; every gradient within 1e-5 of the unsharded port's, and every
    parameter after the AdamW step too, except entries whose unsharded
    gradient is rounding noise (Adam's first step moves those by up to
    the learning rate either way). LARS with the decoder label-sharded
    (its trust ratio from the whole weight's norms): parameters within
    1e-5 of the unsharded port's.
  * Stage 2 on 2 ranks, host-collate with the KG edge-sharded and device
    table: the loss within 1e-4 of JAX's forward on the same draws and
    weights, gradients and parameters as above.
  * The divisibility errors keep the JAX package's messages;
    `pad_kg_edges_to_multiple` keeps the mask budget; `cli.predict
    --sharded` under torchrun on 2 ranks writes the unsharded export.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from madrigal_tpu import config as j_config
from madrigal_tpu.data import collate as j_collate
from madrigal_tpu.data import synthetic as j_syn
from madrigal_tpu.eval.predict import embed_all_drugs as j_embed_all
from madrigal_tpu.models.encoder import MadrigalMultilabel as JMultilabel
from madrigal_tpu.models.simclr import SimCLRModel as JSimCLR
from madrigal_tpu.parallel.allpairs import sharded_rank_tensor as j_sharded
from madrigal_tpu.parallel.allpairs import sharded_score_chunk as j_scores
from madrigal_tpu.train.losses import masked_bce as j_bce
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.cli import predict as t_predict
from madrigal_tpu_torch.data import collate as t_collate
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.eval.ranks import rank_tensor
from madrigal_tpu_torch.interop.from_flax import flax_to_state_dict
from madrigal_tpu_torch.parallel import dryrun as D
from madrigal_tpu_torch.parallel.kg_shard import pad_kg_edges_to_multiple
from madrigal_tpu_torch.train.checkpoint import save_checkpoint
from madrigal_tpu_torch.train.masking import FinetuneMasker
from madrigal_tpu_torch.train.pretrain_cl import CLPretrainer
from madrigal_tpu_torch.constants import NON_TX_MODALITIES

from test_torch_stage1 import to_flax
from test_torch_train import one_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(num_drugs=12, num_labels=8, num_edges=24, seed=0)
CL_BATCH = 8
TOL = dict(atol=1e-5, rtol=1e-5)
# (mesh dp x label, kg_shard_axis, label_chunk) of the finetune runs
FT_RUNS_2 = [((2, 1), None, 0), ((2, 1), "dp", 0), ((1, 2), None, 0),
             ((1, 2), "dp", 0), ((2, 1), None, 8)]
FT_RUNS_4 = [((2, 2), None, 0), ((2, 2), "dp", 0)]
ENV = {"OMP_NUM_THREADS": "1"}


def finetune_cfg(label_chunk=0, optimizer="adamw", remat=False,
                 scope="per_edge_type"):
    """The narrow three-forward configuration (parallel/dryrun.py's path
    5) with no warmup, so that the first step moves the weights."""
    cfg = D.three_way_config(label_chunk=label_chunk)
    hgt = dataclasses.replace(cfg.model.encoder.hgt, remat_edge_types=remat,
                              softmax_scope=scope)
    enc = dataclasses.replace(cfg.model.encoder, hgt=hgt)
    return dataclasses.replace(
        cfg, warmup_epochs=0,
        model=dataclasses.replace(cfg.model, encoder=enc),
        optim=dataclasses.replace(cfg.optim, optimizer=optimizer))


WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from madrigal_tpu_torch import config as C
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.synthetic import make_dataset
from madrigal_tpu_torch.models.encoder import build_model
from madrigal_tpu_torch.parallel import allpairs, kg_shard
from madrigal_tpu_torch.parallel.collectives import (
    all_gather_tensor, all_reduce_grads)
from madrigal_tpu_torch.parallel.mesh import axis_group, make_mesh
from madrigal_tpu_torch.parallel.multihost import initialize, shutdown
from madrigal_tpu_torch.parallel.train_step import (
    gather_decoder_weight, make_train_mesh, shard_cl_pretrainer,
    shard_finetune_trainer)
from madrigal_tpu_torch.train.finetune import (
    FinetuneTrainer, training_model_config)
from madrigal_tpu_torch.train.pretrain_cl import (
    CLPretrainer, build_simclr_model)

root = sys.argv[1]
spec = json.load(open(root + "/spec.json"))
initialize(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
ds = make_dataset(**spec["data"])
coll = DDICollator(ds, split="train", device="cpu", kg_src_sort=True)
batch, kg = coll()
schema = kg_schema(ds.kg_node_feats, ds.kg_edge_indices)
out = {}


def model_of(cfg_dict):
    cfg = C.from_dict(C.TrainConfig, cfg_dict)
    model = build_model(training_model_config(cfg), *schema, device="cpu")
    model.load_state_dict(torch.load(root + "/finetune_init.pt"))
    return cfg, model


def finetune(cfg_dict, mesh=None, kg_axis=None, data=(batch, kg)):
    cfg, model = model_of(cfg_dict)
    t = FinetuneTrainer(cfg, data[0], data[1], model)
    if mesh is not None:
        mesh = make_train_mesh(label_dim=mesh[1])
        shard_finetune_trainer(t, mesh, kg_shard_axis=kg_axis)
    losses = t.train_epoch()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    if mesh is not None:
        grads["decoder.weight"] = all_gather_tensor(
            model.decoder.weight.grad, axis_group("label", mesh))
        params["decoder.weight"] = gather_decoder_weight(t)
    return dict(losses=losses, grads=grads, params=params,
                triples=int(t.train_batch.labels.shape[0]))


def cl(device_table, mesh=None, kg_axis=None):
    pcfg = C.from_dict(C.PretrainConfig, spec["pretrain_cfg"])
    model = build_simclr_model(pcfg, *schema)
    model.load_state_dict(torch.load(root + "/cl_init.pt"))
    c = DDICollator(ds, split="train", device="cpu", kg_src_sort=True)
    t = CLPretrainer(pcfg, c, c.kg_batch(), model, device_table=device_table)
    if mesh is not None:
        shard_cl_pretrainer(t, make_mesh(("dp",)), kg_shard_axis=kg_axis)
    loss = t.train_step()
    return dict(loss=loss,
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def error_of(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


if world == 2:
    z, w = np.load(root + "/z.npy"), np.load(root + "/w.npy")
    label_mesh = make_mesh(("label",))
    out["ranks"] = allpairs.sharded_rank_tensor(label_mesh, z, w,
                                                chunk_per_device=2)
    zh, zt = (torch.from_numpy(np.load(root + f"/{k}.npy")) for k in "ht")
    out["scores"] = allpairs.sharded_score_chunk(
        label_mesh, zh, zt, torch.from_numpy(w))
    out["scores_rank"] = rank
    # embedding and the graph-parallel KG from the finetune weights
    _, model = model_of(spec["ft_cfg"])
    model.eval()
    dp_mesh = make_mesh(("dp",))
    with torch.no_grad():
        table = model.encoder.kg_drug_table(kg)
    ids = np.arange(ds.num_drugs)
    batches = [coll.drug_batch(ids[s:s + 5]) for s in range(0, len(ids), 5)]
    out["embed"] = allpairs.embed_all_drugs_sharded(
        dp_mesh, lambda b: model.encoder.encode(b, kg_drug_table=table),
        batches)
    for name in ("per_edge_type", "global", "remat"):
        _, model = model_of(spec["kg_cfgs"][name])
        kg_sh = kg_shard.device_put_kg_sharded(kg, dp_mesh, "dp")
        fn = kg_shard.make_sharded_kg_table_fn(model, dp_mesh, "dp")
        t_sh = fn(kg_sh)
        # every rank computes the whole loss from the replicated table, so
        # each backpropagates its share of it (collectives.py's rule)
        ((torch.tanh(t_sh) ** 2).sum() / world).backward()
        all_reduce_grads(list(model.parameters()), dist.group.WORLD)
        out["kg_" + name] = dict(
            table=t_sh.detach(), src_layouts=len(kg_sh.edge_src_order),
            edges={k: int(v.shape[0]) for k, v in kg_sh.edge_src.items()},
            grads={n: p.grad.clone() for n, p in model.named_parameters()})
    out["ft_ref"] = finetune(spec["ft_cfg"])
    for shape, axis, lc in spec["ft_runs"]:
        out[f"ft_{shape[0]}x{shape[1]}_{axis}_{lc}"] = finetune(
            spec["ft_cfgs"][str(lc)], tuple(shape), axis)
    out["lars_ref"] = finetune(spec["lars_cfg"])
    out["lars"] = finetune(spec["lars_cfg"], (1, 2))
    for table_path, axis in ((False, "dp"), (True, None)):
        key = "cl_table" if table_path else "cl_host"
        out[key + "_ref"] = cl(table_path)
        out[key] = cl(table_path, True, axis)
    bad_cfg = dict(spec["ft_cfg"])
    bad_cfg["model"] = dict(bad_cfg["model"], prediction_dim=7)

    def bad_labels():
        cfg = C.from_dict(C.TrainConfig, bad_cfg)
        m = build_model(training_model_config(cfg), *schema, device="cpu")
        shard_finetune_trainer(FinetuneTrainer(cfg, batch, kg, m),
                               make_train_mesh(label_dim=2))

    out["err_labels"] = error_of(bad_labels)
    bad_cl = dict(spec["pretrain_cfg"], pretrain_batch_size=5)

    def bad_batch():
        pcfg = C.from_dict(C.PretrainConfig, bad_cl)
        c = DDICollator(ds, split="train", device="cpu")
        t = CLPretrainer(pcfg, c, c.kg_batch(),
                         build_simclr_model(pcfg, *schema))
        shard_cl_pretrainer(t, make_mesh(("dp",)))

    out["err_cl_batch"] = error_of(bad_batch)
else:
    z, w = np.load(root + "/z.npy"), np.load(root + "/w.npy")
    mesh = make_train_mesh(label_dim=2)
    out["ranks_2x2"] = allpairs.sharded_rank_tensor(mesh, z, w,
                                                    chunk_per_device=2)
    for shape, axis, lc in spec["ft_runs_4"]:
        out[f"ft_{shape[0]}x{shape[1]}_{axis}_{lc}"] = finetune(
            spec["ft_cfgs"][str(lc)], tuple(shape), axis)
    odd = make_dataset(**dict(spec["data"], num_edges=21))
    odd_data = DDICollator(odd, split="train", device="cpu")()
    out["err_dp"] = error_of(lambda: finetune(
        spec["ft_cfg"], (4, 1), None, odd_data))
    # one label-chunk of 8192 triples for each of 5 labels: 5 chunks

    def bad_chunks():
        five = make_dataset(**dict(spec["data"], num_labels=5))
        cfg = C.from_dict(C.TrainConfig, spec["ft_cfgs"]["8192"])
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, prediction_dim=5))
        m = build_model(training_model_config(cfg),
                        *kg_schema(five.kg_node_feats, five.kg_edge_indices),
                        device="cpu")
        b, k = DDICollator(five, split="train", device="cpu")()
        shard_finetune_trainer(FinetuneTrainer(cfg, b, k, m),
                               make_train_mesh(label_dim=1))

    out["err_chunk"] = error_of(bad_chunks)
if rank == 0:
    torch.save(out, root + f"/world{world}.pt")
shutdown()
"""


# ------------------------------------------------------------ fixture
def t_cfg_dict(cfg):
    return t_config.to_dict(cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 2- and 4-rank workers and the torchrun CLI on 2 ranks,
    builds the JAX references while they run, and returns (port results
    by world size, references, the CLI's export paths)."""
    root = tmp_path_factory.mktemp("parallel")
    dt = t_syn.make_dataset(**DATA)
    schema = kg_schema(dt.kg_node_feats, dt.kg_edge_indices)
    ft = finetune_cfg()
    model = D.finetune_model(ft, dt, "cpu", seed=0)
    torch.save(model.state_dict(), root / "finetune_init.pt")
    pcfg = D.pretrain_config(batch=CL_BATCH)
    cl_model = D.simclr_model(pcfg, dt, "cpu", seed=1)
    torch.save(cl_model.state_dict(), root / "cl_init.pt")
    rng = np.random.RandomState(1)
    z = rng.randn(20, 16).astype(np.float32)
    w = rng.randn(8, 16, 16).astype(np.float32)
    w = (w + w.transpose(0, 2, 1)) / 2
    np.save(root / "z.npy", z)
    np.save(root / "w.npy", w)
    np.save(root / "h.npy", rng.randn(6, 16).astype(np.float32))
    np.save(root / "t.npy", rng.randn(9, 16).astype(np.float32))
    spec = {
        "data": DATA, "ft_cfg": t_cfg_dict(ft),
        "ft_cfgs": {str(lc): t_cfg_dict(finetune_cfg(label_chunk=lc))
                    for lc in (0, 8, 8192)},
        "kg_cfgs": {"per_edge_type": t_cfg_dict(ft),
                    "global": t_cfg_dict(finetune_cfg(scope="global")),
                    "remat": t_cfg_dict(finetune_cfg(remat=True))},
        "lars_cfg": t_cfg_dict(finetune_cfg(optimizer="lars")),
        "pretrain_cfg": t_cfg_dict(pcfg),
        "ft_runs": FT_RUNS_2, "ft_runs_4": FT_RUNS_4}
    (root / "spec.json").write_text(json.dumps(spec))
    # the CLI's checkpoint and its unsharded export
    ckpt = str(root / "model.pt")
    save_checkpoint(ckpt, model, ft)
    cli = ["--platform", "cpu", "--checkpoint", ckpt, "--synthetic",
           "--synthetic_drugs", "12", "--synthetic_labels", "8",
           "--label_chunk", "3"]
    procs = {}
    for world in (2, 4):
        procs[world] = _start(root, world)
    env = dict(os.environ, **ENV)
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(D.free_port()), "-m",
         "madrigal_tpu_torch.cli.predict", "--sharded", *cli,
         "--export_ranks", str(root / "sharded.npy")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    refs = jax_references(dt, model, cl_model, pcfg, z, w, root)
    t_predict.main(cli + ["--export_ranks", str(root / "plain.npy")])
    got = {}
    for world, launched in procs.items():
        D.require_ok(launched())
        got[world] = torch.load(root / f"world{world}.pt",
                                weights_only=False)
    _, err = torchrun.communicate(timeout=300)
    assert torchrun.returncode == 0, err[-3000:]
    return got, refs, (root / "plain.npy", root / "sharded.npy")


def _start(root, world):
    """Start `world` worker ranks; returns a function that waits for
    them (dryrun.launch's kill-on-failure, in a thread)."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    fut = pool.submit(D.launch, [sys.executable, "-c", WORKER, str(root)],
                      world, env=ENV, timeout=400, cwd=ROOT)
    pool.shutdown(wait=False)
    return fut.result


# ---------------------------------------------------- JAX references
def jax_references(dt, model, cl_model, pcfg, z, w, root):
    dj = j_syn.make_dataset(**DATA)
    cj = j_collate.DDICollator(dj, split="train", kg_edge_chunk=0,
                               kg_src_sort=True)
    bj, kj = cj()
    ft = finetune_cfg()
    jcfg = j_config.from_dict(j_config.TrainConfig, t_config.to_dict(ft))
    params, stats = to_flax(model)
    variables = {"params": params, "batch_stats": stats}
    jm = JMultilabel(enc_cfg=jcfg.model.encoder,
                     prediction_dim=jcfg.model.prediction_dim)
    refs = {}
    # ranks and scores on the 8-virtual-device mesh (label = 8)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                ("dp", "label"))
    refs["ranks"] = j_sharded(mesh, z, w, chunk_per_device=2)
    zh, zt = np.load(root / "h.npy"), np.load(root / "t.npy")
    refs["scores"] = np.asarray(j_scores(mesh, jnp.asarray(zh),
                                         jnp.asarray(zt), jnp.asarray(w)))
    # embeddings and the KG table (+ gradients) of the finetune weights
    refs["embed"] = j_embed_all(jm, variables, cj, kj)

    def table_fn(p, m):
        return m.apply({"params": p}, kj, method=lambda mm, k:
                       mm.encoder.kg_drug_table(k, train=False))

    refs["kg_table"] = np.asarray(jax.jit(lambda p: table_fn(p, jm))(params))
    gm = JMultilabel(enc_cfg=dataclasses.replace(
        jcfg.model.encoder, hgt=dataclasses.replace(
            jcfg.model.encoder.hgt, softmax_scope="global")),
        prediction_dim=jcfg.model.prediction_dim)
    refs["kg_table_global"] = np.asarray(
        jax.jit(lambda p: table_fn(p, gm))(params))
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(jnp.tanh(table_fn(p, jm)) ** 2)))(params)
    refs["kg_grads"] = flax_to_state_dict({"params": grads})
    # the finetune forwards' losses on the trainer's first masks
    masker = FinetuneMasker(ft.finetune_mode, np.asarray(dt.masks),
                            list(NON_TX_MODALITIES),
                            train_with_str_str=True, seed=ft.seed)
    mh, mt = masker.sample_epoch()
    head_g = np.asarray(bj.head.drugs)[np.asarray(bj.head_idx)]
    tail_g = np.asarray(bj.tail.drugs)[np.asarray(bj.tail_idx)]
    w_dir = np.asarray(bj.mask) & (head_g < tail_g)
    w_all = np.asarray(bj.mask)

    @jax.jit
    def fwd(v, a, b, wt):
        out, _ = jm.apply(
            v, dataclasses.replace(bj.head, masks=a),
            dataclasses.replace(bj.tail, masks=b), kj, bj.head_idx,
            bj.tail_idx, bj.labels, train=True, mutable=["batch_stats"],
            method=JMultilabel.score_triples,
            rngs={"dropout": jax.random.PRNGKey(0)})
        return j_bce(out, bj.pos_neg, wt, "mean")

    refs["ft_losses"] = {
        name: float(fwd(variables, jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(wt)))
        for name, a, b, wt in (("str_str", mh, mh, w_dir),
                               ("X_X", mt, mt, w_dir),
                               ("str_X", mh, mt, w_all))}
    # the stage-2 forward's loss on each path's first draws
    jp = j_config.from_dict(j_config.PretrainConfig, t_config.to_dict(pcfg))
    jcl = JSimCLR(enc_cfg=jp.encoder, mlp_dim=jp.moco_mlp_dim,
                  temperature=jp.moco_t, shared_predictor=jp.shared_predictor,
                  raw_encoder_output=jp.raw_encoder_output)
    cp, cs = to_flax(cl_model)
    cvars = {"params": cp, "batch_stats": cs}
    cjc = j_collate.DDICollator(dj, split="train")
    full = cjc.drug_batch(np.arange(dj.num_drugs))
    ct = t_collate.DDICollator(dt, split="train", device="cpu")
    # the first step's draws (the same on both paths): the port's, which
    # equal the JAX trainer's (tests/test_torch_pretrain.py)
    ids, m1, m2 = CLPretrainer(pcfg, ct, None, cl_model)._host_batch()
    m1, m2 = jnp.asarray(m1), jnp.asarray(m2)
    apply = jax.jit(lambda v, b, m1, m2, kw: jcl.apply(
        v, b, kj, m1, m2, train=True, mutable=["batch_stats"], **kw)[0])
    for key, b, kw in (("cl_table", full, {"ids": jnp.asarray(ids)}),
                       ("cl_host", cjc.drug_batch(ids), {})):
        refs[key] = float(apply(cvars, b, m1, m2, kw)[2][2])
    return refs


# -------------------------------------------------------------- tests
def test_sharded_ranks_equal_jax_and_unsharded(runs):
    got, refs, _ = runs
    z, w = _zw()
    plain = rank_tensor(z, w, chunk=3, device="cpu")
    np.testing.assert_array_equal(plain, refs["ranks"])
    np.testing.assert_array_equal(got[2]["ranks"], refs["ranks"])
    # 2 x 2: the label axis shards, the dp rows are replicas
    np.testing.assert_array_equal(got[4]["ranks_2x2"], refs["ranks"])


def _zw():
    rng = np.random.RandomState(1)
    z = rng.randn(20, 16).astype(np.float32)
    w = rng.randn(8, 16, 16).astype(np.float32)
    return z, (w + w.transpose(0, 2, 1)) / 2


def test_sharded_score_chunk_matches_jax(runs):
    got, refs, _ = runs
    np.testing.assert_allclose(got[2]["scores"].numpy(), refs["scores"],
                               **TOL)


def test_embed_all_drugs_sharded_matches_jax_serial(runs):
    got, refs, _ = runs
    np.testing.assert_allclose(got[2]["embed"], refs["embed"], **TOL)


@pytest.mark.parametrize("name", ["per_edge_type", "global", "remat"])
def test_graph_parallel_kg_table_matches_jax(runs, name):
    got, refs, _ = runs
    run = got[2]["kg_" + name]
    # each share carries its own K2 layouts, the source-sorted ones too
    assert run["src_layouts"] == len(run["edges"])
    ref = refs["kg_table_global" if name == "global" else "kg_table"]
    np.testing.assert_allclose(run["table"].numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["per_edge_type", "remat"])
def test_graph_parallel_kg_gradients_match_jax(runs, name):
    got, refs, _ = runs
    grads = got[2]["kg_" + name]["grads"]
    want = refs["kg_grads"]
    assert set(grads) == set(want)
    nonzero = 0
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **TOL)
        nonzero += "kg_encoder" in k and bool(want[k].abs().max() > 0)
    assert nonzero > 10  # every HGT weight gets a gradient through it


def _noise_mask(g_ref, top):
    return g_ref.abs() <= 1e-6 * top


def assert_step_matches(run, ref, lr):
    """Gradients within 1e-5 of the unsharded step's, and parameters after
    it, but for the entries whose gradient is rounding noise, which AdamW's
    first step moves by up to lr either way."""
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(run["grads"][k].numpy(), g.numpy(),
                                   err_msg=k, **TOL)
        noise = _noise_mask(g, top)
        diff = (run["params"][k] - ref["params"][k]).abs()
        assert _largest(diff[~noise]) <= 1e-5, k
        assert _largest(diff[noise]) <= 2 * lr, k


def _largest(t):
    return float(t.max()) if t.numel() else 0.0


def ft_keys():
    return ([f"ft_{s[0]}x{s[1]}_{a}_{lc}" for s, a, lc in FT_RUNS_2]
            + [f"ft_{s[0]}x{s[1]}_{a}_{lc}" for s, a, lc in FT_RUNS_4])


@pytest.mark.parametrize("key", ft_keys())
def test_finetune_step_matches_jax_and_unsharded(runs, key):
    got, refs, _ = runs
    world = 4 if key.startswith("ft_2x2") else 2
    run, ref = got[world][key], got[2]["ft_ref"]
    for name, want in refs["ft_losses"].items():
        assert abs(run["losses"][name] - want) <= 1e-4, (name, run, want)
    assert abs(run["losses"]["total"] - ref["losses"]["total"]) <= 1e-5
    # this rank held a strict share of the triples
    assert 0 < run["triples"] < (8192 if key.endswith("_8") else 144)
    assert_step_matches(run, ref, lr=finetune_cfg().optim.decoder_lr)


def test_lars_label_sharded_matches_unsharded(runs):
    got, _, _ = runs
    run, ref = got[2]["lars"], got[2]["lars_ref"]
    for k, p in ref["params"].items():
        np.testing.assert_allclose(run["params"][k].numpy(), p.numpy(),
                                   err_msg=k, **TOL)
    moved = max(float((p - got[2]["ft_ref"]["params"][k]).abs().max())
                for k, p in ref["params"].items() if k == "decoder.weight")
    assert moved > 0


@pytest.mark.parametrize("key", ["cl_host", "cl_table"])
def test_stage2_step_matches_jax_and_unsharded(runs, key):
    got, refs, _ = runs
    run, ref = got[2][key], got[2][key + "_ref"]
    assert abs(run["loss"] - refs[key]) <= 1e-4
    assert abs(ref["loss"] - refs[key]) <= 1e-4
    assert set(run["grads"]) == set(ref["grads"])
    assert_step_matches(run, ref, lr=1e-3 * CL_BATCH / 512)


def test_divisibility_errors_keep_jax_messages(runs):
    got, _, _ = runs
    assert got[2]["err_labels"] == "label count 7 must divide label=2"
    assert got[2]["err_cl_batch"] == "pretrain batch 5 must divide dp=2"
    assert got[4]["err_dp"] == (
        "triple count 126 must divide dp=4; collate with a pair_budget "
        "rounded to a dp multiple")
    assert got[4]["err_chunk"] == (
        "label-chunked triple count 40960 / chunk 8192 must divide dp=4 "
        "(chunk-aligned shards)")


def test_pad_kg_edges_keeps_mask_budget():
    dt = t_syn.make_dataset(**DATA)
    kg = t_collate.DDICollator(dt, split="train", device="cpu",
                               kg_src_sort=True).kg_batch()
    padded = pad_kg_edges_to_multiple(kg, 7)
    assert not padded.edge_src_order and not padded.edge_src_starts
    assert not padded.edge_dst_starts and not padded.dst_type_order
    for k, src in padded.edge_src.items():
        e = kg.edge_src[k].shape[0]
        assert src.shape[0] % 7 == 0 and src.shape[0] - e < 7
        assert not padded.edge_mask[k][e:].any()
        assert torch.equal(padded.edge_src[k][:e], kg.edge_src[k])
        assert torch.equal(padded.edge_mask[k][:e], kg.edge_mask[k])


def test_sharded_predict_cli_equals_unsharded(runs):
    _, _, (plain, sharded) = runs
    a, b = np.load(plain), np.load(sharded)
    assert a.shape == (8, 12, 12)
    np.testing.assert_array_equal(b, a)


def test_graph_parallel_refuses_a_kg_encoder_other_than_hgt():
    """The HAN (and the RGCN, by the same check) would aggregate each
    rank's partial graph: refused, as in the JAX package."""
    from madrigal_tpu_torch.parallel.kg_shard import (
        make_sharded_kg_table_fn)

    dt = t_syn.make_dataset(**DATA)
    cfg = finetune_cfg()
    enc = dataclasses.replace(cfg.model.encoder, kg_encoder="han")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=enc))
    model = D.finetune_model(cfg, dt, "cpu")
    with pytest.raises(ValueError, match="requires kg_encoder='hgt'"):
        make_sharded_kg_table_fn(model, None, "dp")


def test_hgt_shard_axis_builds_and_needs_a_mesh():
    """hgt.shard_axis no longer raises at build time; the conv looks its
    group up in the current mesh when it runs."""
    from madrigal_tpu_torch.parallel import mesh as mesh_lib

    dt = t_syn.make_dataset(**DATA)
    cfg = finetune_cfg()
    hgt = dataclasses.replace(cfg.model.encoder.hgt, shard_axis="dp")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder=dataclasses.replace(cfg.model.encoder, hgt=hgt)))
    model = D.finetune_model(cfg, dt, "cpu")
    assert model.encoder.kg_encoder.conv_0.shard_axis == "dp"
    kg = t_collate.DDICollator(dt, split="train", device="cpu").kg_batch()
    saved, mesh_lib._current = mesh_lib._current, None
    try:
        with pytest.raises(RuntimeError, match="no device mesh"):
            model.encoder.kg_drug_table(kg)
    finally:
        mesh_lib._current = saved
