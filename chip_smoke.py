"""Smoke run of the PyTorch port (`madrigal_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `madrigal_tpu_torch/csrc/` into
`build/kernels/`, holds each against its plain PyTorch version on the
card, times it, and then drives the two ported paths of the flagship DDI
model (TWOSIDES `sweep_config_hardy_sweep_321`: 128-d embeddings, GIN
128x3+128, 2-layer 4-head HGT, chemCPA 128 with a 512x2 autoencoder,
2-layer 8x256 norm-first x-attn fusion with 2 tx bottlenecks) with random
weights from a seed: serving at 6,843 drugs, 960 outcomes and the
PrimeKG-scale synthetic KG through `madrigal_tpu_torch.cli.predict` and
`madrigal_tpu_torch.eval.predict.score_all_pairs`, and stage-3 training
through `madrigal_tpu_torch.cli.train_ddi` on the same data (divided by
TRAIN_SHRINK) with the memory flags TRAIN_MEMORY_FLAGS.

Phases, in order; any failure ends the script with a non-zero exit:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: kernels K1 (`csrc/bilinear.cu`) and K2 (`csrc/segment_sum.cu`)
     with nvcc for sm_90a, the two compiles started together;
  3. kernels: K1 and K2 against their plain versions at ragged shapes
     and at the shapes the two paths give them (K2: every edge type the
     training run reduces), timed with CUDA events
     beside the plain version, one PyTorch call computing the same
     function (`library_ms`, timed only here) and the card's bound;
  4. small: the serving path on a small dataset on the card against the
     same model on the CPU;
  5. serving: the serving path at full width, with every kernel's launch
     count set to 0 just before it and read just after;
  6. train_small: 3 training steps at flagship widths (dropout 0) on a
     small dataset, on the card against the CPU from the same weights and
     masks, and the card's HGT gradients through K2 against those through
     the plain `index_add_` backward (`--no_src_mxu`);
  7. training: the training CLI at the flagship configuration for 3
     epochs, with every kernel's launch count set to 0 just before it and
     read just after.

Standard output: one JSON line per phase, the `{"kernels": [...]}` line,
the nvidia-smi line, and last `{"ok": true, "device": {...}}`. The script
writes only under `build/` in the checkout and imports no JAX.

    python3 chip_smoke.py --train_memory

instead runs 2 epochs of the training run under each choice of memory
flags (MEMORY_CHOICES), each in a process of its own, and prints one
line per choice with its epoch times and peak device memory, or its
out-of-memory error. It prints no ok line.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import madrigal_tpu_torch
from madrigal_tpu_torch import config as C
from madrigal_tpu_torch.cli import predict as cli_predict
from madrigal_tpu_torch.cli import train_ddi as cli_train_ddi
from madrigal_tpu_torch.cli.common import reference_scale_kwargs
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.kg import PAD_MULTIPLE, build_kg_batch, kg_schema
from madrigal_tpu_torch.data.synthetic import (
    make_dataset,
    make_reference_scale_dataset,
    make_split_dataset,
    reference_scale_kg_sizes,
)
from madrigal_tpu_torch.device import resolve_device
from madrigal_tpu_torch.eval import predict as P
from madrigal_tpu_torch.models.encoder import build_model, init_weights
from madrigal_tpu_torch.ops import _build, bilinear, segment_sorted
from madrigal_tpu_torch.train.checkpoint import save_checkpoint
from madrigal_tpu_torch.train.finetune import FinetuneTrainer

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
D = 128

# NVIDIA H100 SXM data sheet: HBM rate, dense tensor-core bf16 rate, and
# the float32 rate outside the tensor cores (float32 work here uses no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "f32",
              torch.float16: "f16"}

# the serving run: outcomes scored per K1 launch, and head drugs scored
NUM_DRUGS, NUM_LABELS, LABEL_CHUNK, SERVE_HEADS = 6843, 960, 64, 128
TRIPLES = ["0:1:2", "5:10:20"]

# the training run: the reference scale divided by TRAIN_SHRINK (chosen on
# the card: the smallest of 1, 2, 4 whose peak memory fits in 80 GB), the
# epochs, and the memory flags: the fastest of MEMORY_CHOICES that fits
# (`--train_memory`; with none a full-scale step asks for more than
# 80 GB), which recomputes each HGT edge type's messages in the backward
TRAIN_SHRINK, TRAIN_EPOCHS = 1, 3
TRAIN_MEMORY_FLAGS = ["--set", "model.encoder.hgt.remat_edge_types=true"]
# K2 reduces the fused k|v table of the 128-wide HGT; timed at the
# smallest edge type it reduces on the training path and at the largest
K2_WIDTH = 256
K2_TIMED = (("drug", "indication", "disease"), ("protein", "ppi", "protein"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def flagship_config(num_labels: int, dropout: bool = True
                    ) -> C.TrainConfig:
    """The flagship configuration (upstream configs/ddi_finetune/TWOSIDES/
    sweep_config_hardy_sweep_321.yaml), at full width. dropout=False turns
    off every dropout that trains, so that two training runs draw no
    random numbers and can be compared."""
    p = 0.2 if dropout else 0.0  # the flagship's rate and the defaults'
    enc = C.EncoderConfig(
        feature_dim=128,
        gin=C.GINConfig(hidden_dims=(128, 128, 128), num_mlp_layer=3),
        hgt=C.HGTConfig(hidden_dim=128, num_layers=2, att_heads=4),
        cv=C.MLPEncoderConfig(dropout=p),
        chemcpa=C.ChemCPAConfig(dim=128, autoencoder_width=512,
                                autoencoder_depth=2, use_drugs=False),
        transformer=C.FusionConfig(
            num_layers=2, att_heads=8, head_dim=256, ffn_dim=1024,
            dropout=p, actn="gelu", norm_first=True, agg="x-attn",
            num_tx_bottlenecks=2),
        proj=C.ProjectorConfig(dropout=p),
        pos_emb_type="sinusoidal",
        pos_emb_dropout=p,
        fusion="transformer_uni_proj",
    )
    return C.TrainConfig(
        model=C.ModelConfig(encoder=enc, prediction_dim=num_labels),
        optim=C.OptimizerConfig(), finetune_mode="str_random_sample",
        num_epochs=10, warmup_epochs=2, seed=0)


def random_model(cfg: C.TrainConfig, ds, seed: int) -> torch.nn.Module:
    """The model for `ds`'s KG schema on the CPU, weights from `seed`."""
    model = build_model(cfg.model,
                        *kg_schema(ds.kg_node_feats, ds.kg_edge_indices),
                        device="cpu")
    return init_weights(model, torch.Generator().manual_seed(seed))


# ------------------------------------------------------------------ K1
def k1_bound(L: int, M: int, N: int, compute: torch.dtype,
             out: torch.dtype):
    """(least time in ms, what bounds it) for one K1 call on the card:
    each input read once and each score written once, against the two
    products' operations at the compute type's peak rate."""
    cs = torch.finfo(compute).bits // 8
    os_ = torch.finfo(out).bits // 8
    nbytes = (M * D + N * D + L * D * D) * cs + L * M * N * os_
    ops = 2 * L * M * D * D + 2 * L * M * N * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[compute] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int) -> float:
    """Median device time of one call of `fn` in ms over `iters` calls,
    each between two CUDA events, after a warm-up call."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def max_err(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, max |ref|), one outcome at a time."""
    err = scale = 0.0
    for g, r in zip(got, ref):
        r = r.float()
        err = max(err, (g.float() - r).abs().max().item())
        scale = max(scale, r.abs().max().item())
    return err, scale


def k1_inputs(L: int, M: int, N: int, dtype: torch.dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    zh = torch.randn(M, D, generator=g, device="cuda")
    zt = torch.randn(N, D, generator=g, device="cuda")
    w = torch.randn(L, D, D, generator=g, device="cuda") / D ** 0.5
    return zh.to(dtype), zt.to(dtype), w.to(dtype)


def k1_check(L, M, N, compute, out, seed=0, iters=0):
    """K1 against its plain version on the card: f32 compute and output
    within 1e-4 of max|plain| (the same f32 products, summed in another
    order), otherwise within 1e-2 (a bf16 rounding of ZW or of the score
    can land on the other side of its boundary). With iters, also time
    the kernel, the plain version and the one-call PyTorch yardstick."""
    zh, zt, w = k1_inputs(L, M, N, compute, seed)
    got = bilinear.bilinear_scores(zh, zt, w, out, compute)
    ref = bilinear.bilinear_scores_plain(zh, zt, w, out, compute)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    del got, ref
    tol = 1e-4 if compute == out == torch.float32 else 1e-2
    row = {"L": L, "M": M, "N": N, "compute": DTYPE_NAME[compute],
           "out": DTYPE_NAME[out], "iters": iters, "max_abs_err": err,
           "max_abs_plain": scale, "tol": tol * scale}
    require(np.isfinite(err) and err <= tol * scale,
            f"K1 disagrees with its plain version: {row}")
    if iters:
        row["ms"] = cuda_ms(
            lambda: bilinear.bilinear_scores(zh, zt, w, out, compute), iters)
        row["plain_ms"] = cuda_ms(
            lambda: bilinear.bilinear_scores_plain(zh, zt, w, out, compute),
            iters)
        # the yardstick: one PyTorch call chain over the same inputs, in
        # the compute type (the port never calls it)
        row["library_ms"] = cuda_ms(
            lambda: torch.matmul(torch.matmul(zh, w), zt.T), iters)
        row["bound_ms"], row["bound_by"] = k1_bound(L, M, N, compute, out)
    torch.cuda.empty_cache()
    return row


def phase_kernels():
    f32, bf16 = torch.float32, torch.bfloat16
    checks = [k1_check(5, 300, 1000, c, o, seed=1)
              for c in (f32, bf16) for o in (f32, bf16)]
    # the shape score_all_pairs gives K1 in the serving phase, and the
    # all-pairs export at one 64-outcome chunk
    checks.append(k1_check(LABEL_CHUNK, SERVE_HEADS, NUM_DRUGS, f32, f32,
                           seed=2, iters=50))
    checks.append(k1_check(LABEL_CHUNK, NUM_DRUGS, NUM_DRUGS, f32, f32,
                           seed=3, iters=11))
    checks.append(k1_check(LABEL_CHUNK, NUM_DRUGS, NUM_DRUGS, bf16, bf16,
                           seed=3, iters=21))
    for row in checks:
        emit({"phase": "kernels", "kernel": "bilinear_scores", **row})
    return checks


# ------------------------------------------------------------------ K2
def k2_bound(e_real: int, n: int, w: int, dtype: torch.dtype):
    """(least time in ms, what bounds it) for one K2 call on the card: the
    real rows read once, the f32 output and the boundary table written or
    read once, against one f32 add per input value."""
    nbytes = e_real * w * (torch.finfo(dtype).bits // 8) + n * w * 4 + (
        n + 1) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_real * w / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_inputs(e_real: int, e_pad: int, n: int, dtype: torch.dtype,
              seed: int):
    """[e_pad, K2_WIDTH] rows grouped by a uniform random segment id, as
    the synthetic KG's sources are, rows past e_real trailing padding."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, n, (e_real,), generator=g, device="cuda").sort()[0]
    ids[ids == n // 2] = n // 2 + 1  # one empty segment
    starts = torch.searchsorted(
        ids, torch.arange(n + 1, device="cuda")).to(torch.int32)
    data = torch.randn(e_pad, K2_WIDTH, generator=g, device="cuda")
    return data.to(dtype), starts


def k2_check(e_real, e_pad, n, dtype, seed=0, iters=0):
    """K2 against its plain version on the card, within 1e-5 of
    max|plain| (the same f32 sums in another order; bf16 rows widen to f32
    exactly); two launches give the same bits. With iters, also time the
    kernel, the plain version and the one-call PyTorch yardstick."""
    data, starts = k2_inputs(e_real, e_pad, n, dtype, seed)
    got = segment_sorted.sorted_segment_sum(data, starts, n)
    again = segment_sorted.sorted_segment_sum(data, starts, n)
    ref = segment_sorted.sorted_segment_sum_plain(data, starts, n)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    row = {"E": e_pad, "E_real": e_real, "N": n, "W": K2_WIDTH,
           "in": DTYPE_NAME[dtype], "iters": iters, "max_abs_err": err,
           "max_abs_plain": scale, "tol": 1e-5 * scale,
           "repeatable": bool(torch.equal(got, again))}
    require(np.isfinite(err) and err <= 1e-5 * scale and row["repeatable"],
            f"K2 disagrees with its plain version: {row}")
    del got, again, ref
    if iters:
        row["ms"] = cuda_ms(
            lambda: segment_sorted.sorted_segment_sum(data, starts, n), iters)
        row["plain_ms"] = cuda_ms(
            lambda: segment_sorted.sorted_segment_sum_plain(data, starts, n),
            iters)
        # the yardstick: one PyTorch call over the same rows (the port
        # never calls it)
        offsets = starts.long()
        row["library_ms"] = cuda_ms(
            lambda: torch.segment_reduce(data, "sum", offsets=offsets),
            iters)
        row["bound_ms"], row["bound_by"] = k2_bound(e_real, n, K2_WIDTH,
                                                    dtype)
    torch.cuda.empty_cache()
    return row


def k2_shapes(shrink: int) -> dict:
    """{edge type: (real rows, padded rows, source nodes)} of every K2
    launch in the training run at --synthetic_scale_shrink `shrink`: the
    edge types whose backward reaches the drug table (k2_live_edge_types),
    sized as the CLI's dataset builder sizes them, each padded to a
    multiple of 512 rows as the KG batch pads it."""
    kw = reference_scale_kwargs(shrink)
    nodes, edges = reference_scale_kg_sizes(kw.get("num_drugs", NUM_DRUGS),
                                            kw.get("kg_scale", 1))
    hgt = flagship_config(NUM_LABELS).model.encoder.hgt
    live = {et for layer in k2_live_edge_types(list(edges), hgt.num_layers)
            for et in layer}
    return {et: (edges[et], -(-edges[et] // PAD_MULTIPLE) * PAD_MULTIPLE,
                 nodes[et[0]]) for et in edges if et in live}


def phase_k2_kernels():
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # ragged: empty segments, trailing padding rows, N not a multiple of a
    # block's 8 segments; f32, bf16 and f16 rows
    checks = [k2_check(e_real, e_pad, n, dt, seed=4)
              for e_real, e_pad, n in ((900, 1000, 37), (4000, 4096, 1001))
              for dt in (f32, bf16, f16)]
    # every edge type the training run reduces, at the shape the run gives
    # it; the smallest and the largest timed (the kernels line reports the
    # last timed row, the largest)
    for et, shape in k2_shapes(TRAIN_SHRINK).items():
        checks.append({"edge_type": "__".join(et), "shrink": TRAIN_SHRINK,
                       **k2_check(*shape, f32, seed=6,
                                  iters=50 if et in K2_TIMED else 0)})
    timed = [r for r in checks if "ms" in r]
    require(timed[-1]["edge_type"] == "__".join(K2_TIMED[-1]),
            "the last timed K2 row is not the training run's largest")
    for row in checks:
        emit({"phase": "kernels", "kernel": "sorted_segment_sum", **row})
    return checks


# ------------------------------------------------------------- serving
class PhaseTimes(logging.Handler):
    """Collects the `phase` / `seconds` that eval.predict logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = {}

    def emit(self, record):
        if hasattr(record, "phase"):
            self.seconds[record.phase] = record.seconds


def phase_small():
    """The serving path on the card against the same model on the CPU, on
    a small dataset: within 1e-4 of max|cpu| (the same f32 math without
    TF32, summed in another order)."""
    ds = make_dataset(seed=3)
    cpu_model = random_model(flagship_config(ds.num_labels), ds, seed=1)
    triples = [(0, 1, 2), (5, 3, 4), (11, 30, 7)]
    res = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(cpu_model).to(dev)
        coll = DDICollator(ds, split="train", seed=0, device=dev)
        z = P.embed_all_drugs(model, coll, coll.kg_batch())
        res[dev] = (z, P.score_all_pairs(model, z),
                    P.score_triples_for_pairs(model, z, triples))
    errs = {}
    for name, got, ref in zip(("z", "scores", "triples"), res["cuda"],
                              res["cpu"]):
        require(got.shape == ref.shape and np.isfinite(got).all(),
                f"small serving run: {name} has shape {got.shape} or is "
                "not finite")
        errs[name] = float(np.abs(got - ref).max())
        require(errs[name] <= 1e-4 * np.abs(ref).max(),
                f"small serving run: {name} differs from the CPU run by "
                f"{errs[name]} (max|cpu| {np.abs(ref).max()})")
    emit({"phase": "small", "drugs": ds.num_drugs, "outcomes": ds.num_labels,
          "max_abs_err_vs_cpu": errs})


def phase_serving(seed: int = 0):
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    ckpt, emb = str(WORK / "flagship.pt"), str(WORK / "z.npy")
    t0 = time.perf_counter()
    ds = make_reference_scale_dataset(seed=seed)
    require((ds.num_drugs, ds.num_labels) == (NUM_DRUGS, NUM_LABELS),
            "the reference-scale dataset changed size")
    kg_edges = int(sum(e.shape[1] for e in ds.kg_edge_indices.values()))
    t_data = time.perf_counter() - t0
    # what the source-sorted layout of the training backward adds to the
    # KG batch build (host argsorts, and the copies to the card)
    t_kg = {}
    for layout, src_sort in (("plain", False), ("src_sort", True)):
        t0 = time.perf_counter()
        build_kg_batch(ds.kg_node_feats, ds.kg_edge_indices, ds.kg_drug_ids,
                       device="cuda", src_sort=src_sort)
        torch.cuda.synchronize()
        t_kg[layout] = time.perf_counter() - t0
    save_checkpoint(ckpt, random_model(flagship_config(NUM_LABELS), ds, seed),
                    flagship_config(NUM_LABELS))
    del ds

    times = PhaseTimes()
    logging.getLogger("madrigal_tpu_torch").addHandler(times)
    logging.getLogger("madrigal_tpu_torch").setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    triple_scores = cli_predict.main([
        "--checkpoint", ckpt, "--synthetic_scale", "--seed", str(seed),
        "--platform", "cuda", "--export_embeddings", emb,
        "--label_chunk", str(LABEL_CHUNK), "--triples", *TRIPLES])
    t_cli = time.perf_counter() - t0
    z = np.load(emb)
    model, _ = P.model_from_checkpoint(ckpt, device="cuda")
    scores = P.score_all_pairs(model, z[:SERVE_HEADS], z,
                               label_chunk=LABEL_CHUNK)
    counts = read_launches()  # counts end here
    launches = counts["bilinear_scores"]
    t_main = time.perf_counter() - t0
    logging.getLogger("madrigal_tpu_torch").removeHandler(times)

    require(z.shape == (NUM_DRUGS, D) and np.isfinite(z).all(),
            f"embeddings: shape {z.shape} or not finite")
    require(scores.shape == (NUM_LABELS, SERVE_HEADS, NUM_DRUGS)
            and np.isfinite(scores).all(),
            f"scores: shape {scores.shape} or not finite")
    n_chunks = -(-NUM_LABELS // LABEL_CHUNK)
    require(launches == n_chunks,
            f"K1 launched {launches} times in the serving run, "
            f"expected {n_chunks}")
    # first and last chunk against K1's plain version on the same inputs
    w_sym = P.decoder_weight(model)
    zh = torch.from_numpy(z[:SERVE_HEADS]).cuda()
    zt = torch.from_numpy(z).cuda()
    chunk_err = 0.0
    for s in (0, NUM_LABELS - LABEL_CHUNK):
        ref = bilinear.bilinear_scores_plain(
            zh, zt, w_sym[s:s + LABEL_CHUNK], torch.float32,
            torch.float32).cpu().numpy()
        err = float(np.abs(scores[s:s + LABEL_CHUNK] - ref).max())
        require(err <= 1e-4 * np.abs(ref).max(),
                f"score chunk at outcome {s} differs from the plain "
                f"version by {err}")
        chunk_err = max(chunk_err, err)
    # the CLI's triple answers (plain per-triple path) against K1's scores
    want = [scores[l, a, b] for l, a, b in
            (map(int, t.split(":")) for t in TRIPLES)]
    triple_err = float(np.abs(np.asarray(triple_scores) - want).max())
    require(triple_err <= 1e-4 * np.abs(scores).max(),
            f"triple answers differ from the score tensor by {triple_err}")
    emit({"phase": "serving", "drugs": NUM_DRUGS, "outcomes": NUM_LABELS,
          "kg_edges": kg_edges, "label_chunk": LABEL_CHUNK,
          "head_drugs": SERVE_HEADS, "launches": counts,
          "chunk_max_abs_err": chunk_err, "triple_max_abs_err": triple_err,
          "data_build_s": t_data, "kg_build_s": t_kg, "cli_s": t_cli,
          "main_path_s": t_main,
          "phase_s": times.seconds,
          "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    shutil.rmtree(WORK)
    return counts


# ------------------------------------------------------------ training
def reset_launches() -> None:
    bilinear.bilinear_scores.launches = 0
    segment_sorted.sorted_segment_sum.launches = 0


def read_launches() -> dict:
    return {"bilinear_scores": bilinear.bilinear_scores.launches,
            "sorted_segment_sum": segment_sorted.sorted_segment_sum.launches}


def k2_live_edge_types(edge_types, num_layers: int) -> list:
    """The edge types whose backward runs in one training step, one list
    per HGT layer from the last: those whose messages reach the drug table
    the model reads. In the last layer only the edge types into drugs
    count, in the layer before also those into their source types."""
    need, out = {"drug"}, []
    for _ in range(num_layers):
        live = [et for et in edge_types if et[2] in need]
        out.append(live)
        need |= {et[0] for et in live}
    return out


def k2_launches_per_step(edge_types, num_layers: int) -> int:
    """K2's launches in one training step: one per (HGT layer, live edge
    type); autograd runs no backward for the others."""
    return sum(map(len, k2_live_edge_types(edge_types, num_layers)))


def config_overrides(cfg) -> list:
    """`--set KEY=VALUE` for every field of a config (the card has no
    YAML loader)."""
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out += [a if a == "--set" else f"{f.name}.{a}"
                    for a in config_overrides(v)]
        else:
            out += ["--set", f"{f.name}={json.dumps(C.to_dict(v))}"]
    return out


def phase_train_small():
    """3 training steps at flagship widths, dropout 0, on a small dataset:
    on the card against the CPU from the same weights and masks (every
    loss within 1e-4 relative: the same f32 math summed in another order,
    moved through 3 Adam steps), and the card's step-1 HGT gradients
    through K2 against those through the plain backward (within 1e-4 of
    each tensor's largest: K2 and index_add_ sum the same rows in another
    order)."""
    ds, _ = make_split_dataset(seed=3)
    cfg = flagship_config(ds.num_labels, dropout=False)
    model = random_model(cfg, ds, seed=1)
    runs = {"cpu": ("cpu", True, 3), "cuda": ("cuda", True, 3),
            "cuda_plain_bwd": ("cuda", False, 1)}
    losses, grads, launches = {}, {}, {}
    for name, (dev, src_sort, steps) in runs.items():
        batch, kg = DDICollator(ds, split="train", seed=0, device=dev,
                                kg_src_sort=src_sort)()
        trainer = FinetuneTrainer(cfg, batch, kg,
                                  copy.deepcopy(model).to(dev))
        reset_launches()
        losses[name] = []
        for step in range(steps):
            losses[name].append(trainer.train_epoch())
            if step == 0:
                grads[name] = {k: p.grad.detach().cpu()
                               for k, p in trainer.model.named_parameters()
                               if "kg_encoder" in k}
        launches[name] = read_launches()
    n_types = len(ds.kg_edge_indices)
    per_step = k2_launches_per_step(list(ds.kg_edge_indices),
                                    cfg.model.encoder.hgt.num_layers)
    require(launches["cuda"]["sorted_segment_sum"] == 3 * per_step
            and launches["cuda_plain_bwd"]["sorted_segment_sum"] == 0,
            f"train_small: K2 launches {launches}, expected {per_step} "
            "per step")
    loss_err = 0.0
    for lc, lg in zip(losses["cpu"], losses["cuda"]):
        for k in lc:
            rel = abs(lg[k] - lc[k]) / abs(lc[k])
            require(np.isfinite(lg[k]) and rel <= 1e-4,
                    f"train_small: loss {k} on the card {lg[k]} against "
                    f"{lc[k]} on the CPU")
            loss_err = max(loss_err, rel)
    grad_err = 0.0
    for k, g in grads["cuda"].items():
        ref = grads["cuda_plain_bwd"][k]
        err = (g - ref).abs().max().item()
        require(err <= 1e-4 * ref.abs().max().item(),
                f"train_small: HGT gradient {k} through K2 differs from "
                f"the plain backward by {err}")
        grad_err = max(grad_err, err / max(ref.abs().max().item(), 1e-30))
    emit({"phase": "train_small", "drugs": ds.num_drugs,
          "outcomes": ds.num_labels, "kg_edge_types": n_types,
          "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
          "max_rel_loss_err_vs_cpu": loss_err,
          "max_rel_hgt_grad_err_k2_vs_plain": grad_err,
          "launches": launches})


def train_argv(memory_flags, epochs: int, save_dir: Path,
               seed: int = 0) -> list:
    """The training CLI's arguments at the flagship configuration on the
    reference scale divided by TRAIN_SHRINK."""
    return config_overrides(flagship_config(NUM_LABELS)) + [
        *memory_flags, "--platform", "cuda", "--synthetic_scale",
        "--synthetic_scale_shrink", str(TRAIN_SHRINK),
        "--finetune_mode", "str_random_sample", "--label_chunk", "64",
        "--num_epochs", str(epochs), "--evaluate_interval", "0",
        "--seed", str(seed), "--save_dir", str(save_dir)]


def phase_training():
    """The training CLI at the flagship configuration on the reference
    scale divided by TRAIN_SHRINK, with TRAIN_MEMORY_FLAGS."""
    save_dir = WORK / "train"
    if save_dir.exists():
        shutil.rmtree(save_dir)
    argv = train_argv(TRAIN_MEMORY_FLAGS, TRAIN_EPOCHS, save_dir)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # counts start here
    t0 = time.perf_counter()
    res = cli_train_ddi.main(argv)
    t_cli = time.perf_counter() - t0
    counts = read_launches()  # counts end here
    peak = torch.cuda.max_memory_allocated() / 1e9

    hgt = flagship_config(NUM_LABELS).model.encoder.hgt
    want = k2_launches_per_step(list(reference_scale_kg_sizes()[1]),
                                hgt.num_layers) * TRAIN_EPOCHS
    require(counts["sorted_segment_sum"] == want,
            f"K2 launched {counts['sorted_segment_sum']} times in the "
            f"training run, expected {want}")
    require(len(res["losses"]) == TRAIN_EPOCHS
            and all(np.isfinite(v) for l in res["losses"]
                    for v in l.values()),
            f"training losses: {res['losses']}")
    model, cfg = P.model_from_checkpoint(res["checkpoint"], device="cuda")
    require(cfg.num_epochs == TRAIN_EPOCHS and all(
        torch.isfinite(t).all() for t in model.state_dict().values()),
            "the last_model checkpoint does not load as trained")
    emit({"phase": "training", "shrink": TRAIN_SHRINK,
          "memory_flags": TRAIN_MEMORY_FLAGS,
          "drugs": NUM_DRUGS // TRAIN_SHRINK,
          "outcomes": model.decoder.weight.shape[0],
          "epochs": TRAIN_EPOCHS, "launches": counts,
          "losses": res["losses"], "epoch_s": res["epoch_seconds"],
          "data_build_s": res["data_seconds"], "cli_s": t_cli,
          "peak_device_mem_gb": peak})
    shutil.rmtree(save_dir)
    return counts


# --train_memory: each choice of memory flags for the training run
MEMORY_CHOICES = [
    [],
    TRAIN_MEMORY_FLAGS,
    ["--fusion_remat"],
    ["--fusion_remat", *TRAIN_MEMORY_FLAGS],
    ["--fusion_remat", "--fusion_remat_policy", "none", *TRAIN_MEMORY_FLAGS],
]


def memory_choice(flags) -> dict:
    """2 epochs of the training run under `flags`: epoch seconds and peak
    device memory, or the out-of-memory error."""
    save_dir = WORK / "train_memory"
    torch.cuda.reset_peak_memory_stats()
    try:
        res = cli_train_ddi.main(train_argv(flags, 2, save_dir))
        out = {"epoch_s": res["epoch_seconds"],
               "data_build_s": res["data_seconds"]}
    except torch.cuda.OutOfMemoryError as e:
        out = {"out_of_memory": str(e).splitlines()[0]}
    shutil.rmtree(save_dir, ignore_errors=True)
    return {"phase": "train_memory", "shrink": TRAIN_SHRINK,
            "memory_flags": flags, **out,
            "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_train_memory() -> None:
    """Each of MEMORY_CHOICES in a process of its own, so that one that
    runs out of memory leaves nothing behind for the next."""
    for flags in MEMORY_CHOICES:
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--memory_choice",
             json.dumps(flags)], capture_output=True, text=True, timeout=600)
        lines = res.stdout.strip().splitlines()
        require(res.returncode == 0 and lines,
                f"memory choice {flags} failed:\n{res.stderr[-3000:]}")
        print(lines[-1], flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs an NVIDIA GPU: "
                 "torch.cuda.is_available() is false")
    pkg = Path(madrigal_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        sys.exit(f"chip_smoke.py must run beside its package; found {pkg}")
    resolve_device("cuda")  # TF32 off: float32 stays float32
    if argv[:1] == ["--memory_choice"]:
        emit(memory_choice(json.loads(argv[1])))
        return 0
    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"phase": "device", "nvidia_smi": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    if argv == ["--train_memory"]:
        _build.build(["segment_sum"])  # not inside the first choice's time
        phase_train_memory()
        print(gpu_line(), flush=True)
        return 0
    if argv:
        sys.exit(f"unknown arguments {argv}: chip_smoke.py takes none, "
                 "or --train_memory")

    seconds = {}
    libs = _build.build(["bilinear", "segment_sum"], verbose=True,
                        seconds=seconds)
    for kernel, src in (("bilinear_scores", "bilinear"),
                        ("sorted_segment_sum", "segment_sum")):
        emit({"phase": "build", "kernel": kernel, "library": libs[src].name,
              "seconds": seconds[src]})

    k1_checks = phase_kernels()
    k2_checks = phase_k2_kernels()
    phase_small()
    serving = phase_serving()
    phase_train_small()
    training = phase_training()

    def entry(name, source, replaces, launches, checks, shape_keys):
        timed = [r for r in checks if "ms" in r]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": timed[-1]["max_abs_err"],
                "ms": timed[-1]["ms"], "plain_ms": timed[-1]["plain_ms"],
                "bound_ms": timed[-1]["bound_ms"],
                "bound_by": timed[-1]["bound_by"],
                "library_ms": timed[-1]["library_ms"],
                "timed_at": {k: timed[-1][k] for k in shape_keys},
                "timings": timed}

    # K1: timed last at the all-pairs bench shape, bf16 in and out, and
    # launched on the serving path; K2: timed last at the training run's
    # largest edge type, at the shape that run gives it, and launched on
    # the training path
    emit({"kernels": [
        entry("bilinear_scores", "madrigal_tpu_torch/csrc/bilinear.cu",
              "madrigal_tpu/ops/bilinear_pallas.py:35",
              serving["bilinear_scores"], k1_checks,
              ("L", "M", "N", "compute", "out")),
        entry("sorted_segment_sum", "madrigal_tpu_torch/csrc/segment_sum.cu",
              "madrigal_tpu/ops/segment_pallas.py:62",
              training["sorted_segment_sum"], k2_checks,
              ("edge_type", "shrink", "E", "E_real", "N", "W", "in"))]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
