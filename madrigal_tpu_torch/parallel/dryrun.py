"""The seven sharded paths against one device (port of
`__graft_entry__.dryrun_multichip`).

    python -m madrigal_tpu_torch.parallel.dryrun --nproc 2 \\
        --device cuda --backend gloo

spawns `--nproc` ranks (one process each, on `localhost`) and checks, on
a ('dp', 'label') mesh of them, each path against the same work done
unsharded by every rank, with the JAX dryrun's tolerances:

  1. one flagship-width finetune step (dropout 0.2, fusion remat) on the
     default train mesh, the KG replicated: losses within 1e-4;
  2. the label-sharded normalized-rank tensor (K1) against
     `eval.ranks.rank_tensor`: equal;
  3. the dp-sharded drug embedding against `eval.predict.embed_all_drugs`:
     within 1e-5;
  4. the edge-sharded KG drug table against the full-graph one: 1e-5;
  5. a three-way-loss mode (str_str + random_sample with str-str, the
     label-chunked view) at narrow widths, dp over every rank with the KG
     edge-sharded over 'dp': losses within 1e-4;
  6. the stage-2 step on the host-collate path, dp over every rank, the
     KG edge-sharded: loss within 1e-4;
  7. the stage-2 step on the device-table path: loss within 1e-4.

Two ranks sharing one card run gloo (NCCL refuses a shared card); NCCL
runs one rank a card. Rank 0 prints one JSON line: each path's error
against its tolerance, seconds, and each rank's K1 and K2 launches (the
counts set to 0 just before the sharded run of the path, read just
after), and each rank's peak device memory. Any failed check raises, and
the launcher exits non-zero.

`launch` starts any command as N ranks with torchrun's environment
(the tests use it with `python -c`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
# path 2's outcomes and outcomes a rank ranks a K1 launch
NUM_LABELS, RANK_CHUNK_PER_DEVICE = 8, 2


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str


def launch(cmd: Sequence[str], nproc: int, env: Optional[dict] = None,
           timeout: float = 900.0, cwd=None) -> List[RankResult]:
    """Run `cmd` as `nproc` ranks on this host with torchrun's variables
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); `env` adds to them (LOCAL_WORLD_SIZE=2 makes hosts of
    2 ranks). When one rank fails, the others are killed (they would
    wait on it in a collective); so they are at the time limit. Returns
    every rank's exit code and output."""
    port = free_port()
    procs, files = [], []
    env = dict(env or {})
    local = int(env.get("LOCAL_WORLD_SIZE", nproc))
    for r in range(nproc):
        out = tempfile.TemporaryFile("w+")
        err = tempfile.TemporaryFile("w+")
        files.append((out, err))
        e = dict(os.environ, **env)
        e.update(RANK=str(r), WORLD_SIZE=str(nproc),
                 LOCAL_RANK=str(r % local), LOCAL_WORLD_SIZE=str(local),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(list(cmd), env=e, stdout=out,
                                      stderr=err, cwd=cwd or ROOT))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)
    res = []
    for r, (p, (out, err)) in enumerate(zip(procs, files)):
        p.wait()
        out.seek(0)
        err.seek(0)
        res.append(RankResult(r, p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return res


def require_ok(results: List[RankResult]) -> None:
    """Raise with the failing ranks' standard error unless every rank
    exited with 0."""
    bad = [r for r in results if r.returncode != 0]
    if bad:
        raise RuntimeError("\n".join(
            f"rank {r.rank} exited {r.returncode}:\n{r.stderr[-4000:]}"
            for r in bad))


# ------------------------------------------------------------ configs
def flagship_train_config(num_labels: int = NUM_LABELS):
    """The JAX dryrun's flagship finetune configuration (its
    `_flagship_cfg`): full widths, dropout 0.2, the fusion layers
    recomputed in the backward."""
    from .. import config as C

    enc = C.EncoderConfig(
        feature_dim=128,
        gin=C.GINConfig(hidden_dims=(128, 128, 128), num_mlp_layer=3),
        hgt=C.HGTConfig(hidden_dim=128, num_layers=2, att_heads=4),
        chemcpa=C.ChemCPAConfig(dim=128, autoencoder_width=512,
                                autoencoder_depth=2, use_drugs=False),
        transformer=C.FusionConfig(
            num_layers=2, att_heads=8, head_dim=256, ffn_dim=1024,
            dropout=0.2, actn="gelu", norm_first=True, agg="x-attn",
            num_tx_bottlenecks=2, remat=True),
        pos_emb_type="sinusoidal", fusion="transformer_uni_proj")
    return C.TrainConfig(
        model=C.ModelConfig(encoder=enc, prediction_dim=num_labels),
        optim=C.OptimizerConfig(), finetune_mode="str_random_sample",
        num_epochs=10, warmup_epochs=2, seed=0)


def small_encoder_config(dropout: float = 0.0):
    """The JAX dryrun's narrow encoder (`small_enc`), every dropout rate
    `dropout`."""
    from .. import config as C

    return C.EncoderConfig(
        feature_dim=16,
        gin=C.GINConfig(hidden_dims=(16, 16), num_mlp_layer=2),
        hgt=C.HGTConfig(hidden_dim=8, num_layers=2, att_heads=2),
        cv=C.MLPEncoderConfig(hidden_dims=(32, 16), dropout=dropout),
        chemcpa=C.ChemCPAConfig(dim=16, autoencoder_width=32,
                                autoencoder_depth=1),
        transformer=C.FusionConfig(num_layers=1, att_heads=2, head_dim=8,
                                   ffn_dim=32, dropout=dropout,
                                   norm_first=True, agg="x-attn",
                                   num_tx_bottlenecks=2),
        proj=C.ProjectorConfig(hidden_dims=(32, 32), dropout=dropout),
        pos_emb_type="sinusoidal", pos_emb_dropout=dropout,
        fusion="transformer_uni_proj")


def three_way_config(num_labels: int = NUM_LABELS, label_chunk: int = 8):
    """Path 5's configuration: the narrow encoder, the three forwards and
    str-str, the label-chunked triple view."""
    from .. import config as C

    return C.TrainConfig(
        model=C.ModelConfig(encoder=small_encoder_config(),
                            prediction_dim=num_labels),
        optim=C.OptimizerConfig(), finetune_mode="str_str+random_sample",
        train_with_str_str=True, label_chunk_triples=label_chunk,
        num_epochs=10, warmup_epochs=2, seed=0)


def pretrain_config(batch: int, optimizer: str = "adamw"):
    """Paths 6-7's stage-2 configuration (the JAX dryrun's, dropout 0)."""
    from .. import config as C

    return C.PretrainConfig(
        encoder=small_encoder_config(), pretrain_mode="str_center_uni",
        pretrain_unbalanced=True, raw_encoder_output=True,
        pretrain_batch_size=batch, pretrain_num_epochs=10,
        warmup_epochs=1, pretrain_lr=1e-3, seed=3,
        pretrain_optimizer=optimizer)


def finetune_model(cfg, ds, device, seed: int = 0):
    """The stage-3 model of `cfg` for `ds`'s KG, weights from `seed`."""
    from ..data.kg import kg_schema
    from ..models.encoder import build_model, init_weights
    from ..train.finetune import training_model_config

    model = build_model(training_model_config(cfg),
                        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices),
                        device="cpu")
    return init_weights(model, torch.Generator().manual_seed(seed)).to(device)


def simclr_model(pcfg, ds, device, seed: int = 0):
    from ..data.kg import kg_schema
    from ..models.encoder import init_weights
    from ..train.pretrain_cl import build_simclr_model

    model = build_simclr_model(pcfg, *kg_schema(ds.kg_node_feats,
                                                ds.kg_edge_indices))
    return init_weights(model, torch.Generator().manual_seed(seed)).to(device)


# --------------------------------------------------------- the checks
def reset_launches() -> None:
    from ..ops import bilinear, segment_sorted

    bilinear.bilinear_scores.launches = 0
    segment_sorted.sorted_segment_sum.launches = 0


def read_launches() -> dict:
    from ..ops import bilinear, segment_sorted

    return {"bilinear_scores": bilinear.bilinear_scores.launches,
            "sorted_segment_sum": segment_sorted.sorted_segment_sum.launches}


def finetune_step(cfg, batch, kg, ds, device, mesh=None, kg_shard_axis=None,
                  seed: int = 0):
    """(losses, trainer) of one finetune step from the weights of `seed`,
    sharded on `mesh` when given; the torch generator is seeded first, so
    the replicated encoder's dropout draws are the unsharded run's."""
    from ..train.finetune import FinetuneTrainer
    from .train_step import shard_finetune_trainer

    trainer = FinetuneTrainer(cfg, batch, kg,
                              finetune_model(cfg, ds, device, seed))
    if mesh is not None:
        shard_finetune_trainer(trainer, mesh, kg_shard_axis=kg_shard_axis)
    torch.manual_seed(seed)
    return trainer.train_epoch(), trainer


def cl_step(pcfg, ds, device, device_table: bool, mesh=None,
            kg_shard_axis=None, seed: int = 0, steps: int = 1):
    """(losses, trainer) of `steps` stage-2 steps from the weights of
    `seed`, sharded on `mesh` when given."""
    from ..data.collate import DDICollator
    from ..train.pretrain_cl import CLPretrainer
    from .train_step import shard_cl_pretrainer

    coll = DDICollator(ds, split="train", device=device, kg_src_sort=True)
    trainer = CLPretrainer(pcfg, coll, coll.kg_batch(),
                           simclr_model(pcfg, ds, device, seed),
                           device_table=device_table)
    if mesh is not None:
        shard_cl_pretrainer(trainer, mesh, kg_shard_axis=kg_shard_axis)
    torch.manual_seed(seed)
    return [trainer.train_step() for _ in range(steps)], trainer


def _loss_err(ref: dict, got: dict) -> float:
    if set(ref) != set(got):
        raise AssertionError(f"loss keys {sorted(ref)} != {sorted(got)}")
    return max(abs(ref[k] - got[k]) for k in ref)


def run_paths(device: torch.device, num_drugs: int = 12,
              num_edges: int = 24) -> dict:
    """The seven paths on this rank (every rank calls it together);
    returns {path: {"err", "tol", "s", "launches", ...}}. A failed check
    raises."""
    import torch.distributed as dist

    from ..data.collate import DDICollator
    from ..data.synthetic import make_dataset
    from ..eval.predict import embed_all_drugs
    from ..eval.ranks import rank_tensor
    from .allpairs import embed_all_drugs_sharded, sharded_rank_tensor
    from .kg_shard import sharded_kg_drug_table
    from .mesh import axis_size, make_mesh
    from .train_step import make_train_mesh

    n = dist.get_world_size()
    out = {}

    def record(name, err, tol, t0, launches, **extra):
        s = time.perf_counter() - t0
        if not err <= tol:
            raise AssertionError(f"path {name}: error {err} > {tol}")
        out[name] = dict(err=float(err), tol=tol, s=s, launches=launches,
                         **extra)

    ds = make_dataset(num_drugs=num_drugs, num_labels=NUM_LABELS,
                      num_edges=num_edges, seed=0)
    coll = DDICollator(ds, split="train", device=device, kg_src_sort=True)
    batch, kg = coll()

    # 1. flagship finetune step, dp x label, the KG replicated
    cfg = flagship_train_config()
    ref, ref_trainer = finetune_step(cfg, batch, kg, ds, device)
    mesh = make_train_mesh()
    reset_launches()
    t0 = time.perf_counter()
    got, _ = finetune_step(cfg, batch, kg, ds, device, mesh)
    record("1_finetune", _loss_err(ref, got), 1e-4, t0, read_launches(),
           mesh=[axis_size(mesh, "dp"), axis_size(mesh, "label")],
           loss=got["total"])

    # 2. label-sharded ranks
    rng = np.random.RandomState(0)
    z = rng.randn(24, 128).astype(np.float32)
    w = rng.randn(NUM_LABELS, 128, 128).astype(np.float32)
    w_sym = (w + w.transpose(0, 2, 1)) / 2
    ranks_ref = rank_tensor(z, w_sym, chunk=3, device=device)
    reset_launches()
    t0 = time.perf_counter()
    ranks = sharded_rank_tensor(mesh, z, w_sym,
                                chunk_per_device=RANK_CHUNK_PER_DEVICE)
    launches = read_launches()
    err = (float(np.abs(ranks - ranks_ref).max()) if ranks is not None
           else 0.0)
    record("2_ranks", err, 0.0, t0, launches)

    # 3. dp-sharded embedding
    model = ref_trainer.model.eval()
    with torch.no_grad():
        z_serial = embed_all_drugs(model, coll, kg)
        table = model.encoder.kg_drug_table(kg)
    dp_mesh = make_mesh(("dp",))
    per = -(-ds.num_drugs // n)
    ids = np.arange(ds.num_drugs)
    batches = [coll.drug_batch(ids[i * per:(i + 1) * per])
               for i in range(n) if i * per < ds.num_drugs]
    reset_launches()
    t0 = time.perf_counter()
    z_sh = embed_all_drugs_sharded(
        dp_mesh, lambda b: model.encoder.encode(b, kg_drug_table=table),
        batches)
    record("3_embed", float(np.abs(z_sh - z_serial).max()), 1e-5, t0,
           read_launches())

    # 4. graph-parallel KG drug table
    reset_launches()
    t0 = time.perf_counter()
    table_sh = sharded_kg_drug_table(dp_mesh, model, kg, axis="dp")
    record("4_kg_table", float(np.abs(table_sh - table.cpu().numpy()).max()),
           1e-5, t0, read_launches())

    # 5. three-way-loss mode, label-chunked, dp with the KG edge-sharded
    cfg5 = three_way_config()
    dpl = make_train_mesh(label_dim=1)
    ref5, _ = finetune_step(cfg5, batch, kg, ds, device)
    reset_launches()
    t0 = time.perf_counter()
    got5, _ = finetune_step(cfg5, batch, kg, ds, device, dpl,
                            kg_shard_axis="dp")
    record("5_three_way", _loss_err(ref5, got5), 1e-4, t0, read_launches(),
           loss=got5["total"])

    # 6-7. stage 2, dp over every rank: host-collate (KG edge-sharded),
    # device-table (KG replicated)
    # up to 4 drugs a rank, whole batches a rank (every drug here has
    # two modalities or more)
    pcfg = pretrain_config(batch=n * min(4, max(1, num_drugs // n)))
    for name, table_path, axis in (("6_cl_host_collate", False, "dp"),
                                   ("7_cl_device_table", True, None)):
        ref_cl, _ = cl_step(pcfg, ds, device, table_path)
        reset_launches()
        t0 = time.perf_counter()
        got_cl, _ = cl_step(pcfg, ds, device, table_path, dp_mesh,
                            kg_shard_axis=axis)
        record(name, abs(ref_cl[0] - got_cl[0]), 1e-4, t0, read_launches(),
               loss=got_cl[0])
    return out


def prewarm_optimizer_import() -> None:
    """Import torch._dynamo on a thread: a process's first torch.optim
    optimizer imports it (about 7 s on the H100's host), and a rank's
    set-up before its first trainer can overlap it."""
    import threading

    def load():
        import torch._dynamo  # noqa: F401

    threading.Thread(target=load, daemon=True).start()


def worker(args) -> None:
    import torch.distributed as dist

    from .collectives import all_gather_object
    from .multihost import initialize, shutdown

    prewarm_optimizer_import()
    device = initialize(device=args.device, backend=args.backend)
    t0 = time.perf_counter()
    paths = run_paths(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    every = all_gather_object({"paths": paths, "peak_bytes": peak}, None)
    if dist.get_rank() == 0:
        merged = {}
        for name in paths:
            merged[name] = dict(paths[name])
            merged[name]["launches"] = [r["paths"][name]["launches"]
                                        for r in every]
        print(json.dumps({"dryrun": "ok", "nproc": dist.get_world_size(),
                          "device": str(device), "backend": args.backend,
                          "seconds": time.perf_counter() - t0,
                          "peak_bytes": [r["peak_bytes"] for r in every],
                          "paths": merged}), flush=True)
    shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    if args.worker:
        worker(args)
        return 0
    res = launch([sys.executable, "-m", "madrigal_tpu_torch.parallel.dryrun",
                  "--worker", "--device", args.device, "--backend",
                  args.backend], args.nproc, timeout=args.timeout)
    for r in res:
        sys.stderr.write(r.stderr[-2000:] if r.returncode else "")
    require_ok(res)
    line = [l for l in res[0].stdout.splitlines() if l.startswith("{")][-1]
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
