"""Smoke run of the PyTorch port (`madrigal_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `madrigal_tpu_torch/csrc/` into
`build/kernels/`, holds each against its plain PyTorch version on the
card, times it, and then drives the serving path of the flagship DDI
model (TWOSIDES `sweep_config_hardy_sweep_321`: 128-d embeddings, GIN
128x3+128, 2-layer 4-head HGT, chemCPA 128 with a 512x2 autoencoder,
2-layer 8x256 norm-first x-attn fusion with 2 tx bottlenecks) at 6,843
drugs, 960 outcomes and the PrimeKG-scale synthetic KG, with random
weights from a seed, through `madrigal_tpu_torch.cli.predict` and
`madrigal_tpu_torch.eval.predict.score_all_pairs`.

Phases, in order; any failure ends the script with a non-zero exit:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: kernel K1 (`csrc/bilinear.cu`) with nvcc for sm_90a;
  3. kernels: K1 against its plain version at a ragged shape, at the
     serving shape and at the all-pairs bench shape, timed with CUDA
     events beside the plain version, one PyTorch call computing the same
     function (`library_ms`, timed only here) and the card's bound;
  4. small: the serving path on a small dataset on the card against the
     same model on the CPU;
  5. serving: the serving path at full width, with every kernel's launch
     count set to 0 just before it and read just after.

Standard output: one JSON line per phase, the `{"kernels": [...]}` line,
the nvidia-smi line, and last `{"ok": true, "device": {...}}`. The script
writes only under `build/` in the checkout and imports no JAX.
"""
from __future__ import annotations

import copy
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
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.data.synthetic import (
    make_dataset,
    make_reference_scale_dataset,
)
from madrigal_tpu_torch.device import resolve_device
from madrigal_tpu_torch.eval import predict as P
from madrigal_tpu_torch.models.encoder import build_model, init_weights
from madrigal_tpu_torch.ops import bilinear
from madrigal_tpu_torch.train.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
D = 128

# NVIDIA H100 SXM data sheet: HBM rate, dense tensor-core bf16 rate, and
# the float32 rate outside the tensor cores (float32 work here uses no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "f32"}

# the serving run: outcomes scored per K1 launch, and head drugs scored
NUM_DRUGS, NUM_LABELS, LABEL_CHUNK, SERVE_HEADS = 6843, 960, 64, 128
TRIPLES = ["0:1:2", "5:10:20"]


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


def flagship_config(num_labels: int) -> C.TrainConfig:
    """The flagship configuration (upstream configs/ddi_finetune/TWOSIDES/
    sweep_config_hardy_sweep_321.yaml), at full width."""
    enc = C.EncoderConfig(
        feature_dim=128,
        gin=C.GINConfig(hidden_dims=(128, 128, 128), num_mlp_layer=3),
        hgt=C.HGTConfig(hidden_dim=128, num_layers=2, att_heads=4),
        chemcpa=C.ChemCPAConfig(dim=128, autoencoder_width=512,
                                autoencoder_depth=2, use_drugs=False),
        transformer=C.FusionConfig(
            num_layers=2, att_heads=8, head_dim=256, ffn_dim=1024,
            dropout=0.2, actn="gelu", norm_first=True, agg="x-attn",
            num_tx_bottlenecks=2),
        pos_emb_type="sinusoidal",
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
    save_checkpoint(ckpt, random_model(flagship_config(NUM_LABELS), ds, seed),
                    flagship_config(NUM_LABELS))
    del ds

    times = PhaseTimes()
    logging.getLogger("madrigal_tpu_torch").addHandler(times)
    logging.getLogger("madrigal_tpu_torch").setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats()
    bilinear.bilinear_scores.launches = 0  # counts start here
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
    launches = bilinear.bilinear_scores.launches  # counts end here
    t_main = time.perf_counter() - t0

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
          "head_drugs": SERVE_HEADS, "k1_launches": launches,
          "chunk_max_abs_err": chunk_err, "triple_max_abs_err": triple_err,
          "data_build_s": t_data, "cli_s": t_cli, "main_path_s": t_main,
          "phase_s": times.seconds,
          "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    shutil.rmtree(WORK)
    return {"bilinear_scores": launches}


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs an NVIDIA GPU: "
                 "torch.cuda.is_available() is false")
    pkg = Path(madrigal_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        sys.exit(f"chip_smoke.py must run beside its package; found {pkg}")
    resolve_device("cuda")  # TF32 off: float32 stays float32
    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"phase": "device", "nvidia_smi": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    lib = bilinear.build(verbose=True)
    emit({"phase": "build", "kernel": "bilinear_scores", "library": lib.name,
          "seconds": time.perf_counter() - t0})

    checks = phase_kernels()
    phase_small()
    launches = phase_serving()

    timed = checks[-1]  # the all-pairs bench shape, bf16 in and out
    emit({"kernels": [{
        "name": "bilinear_scores", "route": "cuda",
        "source": "madrigal_tpu_torch/csrc/bilinear.cu",
        "replaces": "madrigal_tpu/ops/bilinear_pallas.py:35",
        "launches": launches["bilinear_scores"],
        "max_abs_err": timed["max_abs_err"],
        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
        "timed_at": {k: timed[k] for k in ("L", "M", "N", "compute", "out")},
        "timings": [r for r in checks if "ms" in r]}]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
