"""chemCPA hyperparameter sweep, stage-1 tx adaptation (port of
`madrigal_tpu/train/chemcpa_sweep.py`; reference modality_pretraining/tx/
sweep.py, madrigal/chemcpa/chemCPA/experiments_run.py:269-415 train loop,
configs/chemcpa/chemcpa_tx_adapting_configs_sweep.yaml): the generated
configs (`utils/config_gen.generate_configs`) each train with the port's
`ChemCPAAdaptTrainer`, test R2 on the checkpoint_freq cadence with
patience-based early stopping and the NaN stops (experiments_run.py:
336-366, model.py:714-727 early_stopping), and the best config by test
R2 is kept.

The semantics are the JAX package's: the `np.random.RandomState(seed)`
epoch order, the stop rules and reasons, and the JSONL lines. Each
config's rows are copied to the trainer's device once and its minibatches
gathered there. `best_variables` is the best config's chemCPA state_dict
(the trainer's `encoder_variables()`) copied to the host. Where the JAX
sweep clears jax's caches after each config, this one drops the trainer
with its optimizer state and returns the memory to the card
(`gc.collect()`, `torch.cuda.empty_cache()`), so a long sweep does not
grow on the card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ChemCPAConfig
from .modality_pretrain import ChemCPAAdaptTrainer, evaluate_r2_tx_adapting


def sweep_config_to_trainer_args(
    args: Dict, base: Optional[ChemCPAConfig] = None
) -> Tuple[ChemCPAConfig, Dict, Dict]:
    """Map one generated seml-style config dict onto
    (ChemCPAConfig, ChemCPAAdaptTrainer kwargs, training-loop kwargs).

    Mirrors the hparam surface of the reference sweep YAML
    (model.hparams.*, model.additional_params.*, model.use_drugs,
    training.*); unknown keys are ignored (dataset paths etc. are handled
    by the caller's data loading).
    """
    base = base or ChemCPAConfig()
    model = args.get("model", {})
    hp = model.get("hparams", {})
    ap = model.get("additional_params", {})
    tr = args.get("training", {})

    cfg_updates = {}
    for name in ("dim", "autoencoder_width", "autoencoder_depth",
                 "adversary_width", "adversary_depth", "dosers_width",
                 "dosers_depth", "embedding_encoder_width",
                 "embedding_encoder_depth", "dropout"):
        if name in hp:
            cfg_updates[name] = type(getattr(base, name))(hp[name])
    if "decoder_activation" in ap:
        act = str(ap["decoder_activation"])
        cfg_updates["decoder_activation"] = (
            "linear" if act.lower() == "linear" else act.lower()
        )
    if "doser_type" in ap:
        cfg_updates["doser_type"] = ap["doser_type"]
    if "use_drugs" in model:
        cfg_updates["use_drugs"] = bool(model["use_drugs"])
    cfg = dataclasses.replace(base, **cfg_updates)

    trainer_kwargs = {
        "lr": float(hp.get("autoencoder_lr", 1e-3)),
        "adversary_lr": float(hp.get("adversary_lr", 1e-3)),
        "adversary_steps": int(hp.get("adversary_steps", 2)),
        "reg_adversary": float(hp.get("reg_adversary", 5.0)),
        "reg_adversary_cov": float(hp.get("reg_adversary_covariates",
                                          40.0)),
        "penalty_adversary": float(hp.get("penalty_adversary", 4.0)),
        "seed": int(ap.get("seed", 0)),
    }
    train_kwargs = {
        "num_epochs": int(tr.get("num_epochs", 300)),
        "checkpoint_freq": int(tr.get("checkpoint_freq", 50)),
        "max_minutes": float(tr.get("max_minutes", 600)),
        "batch_size": int(hp.get("batch_size", 4096)),
        "patience": int(ap.get("patience", 10)),
    }
    return cfg, trainer_kwargs, train_kwargs


def host_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of `sd` on the host (later steps do not move it)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def train_one_config(
    cfg: ChemCPAConfig,
    trainer_kwargs: Dict,
    train_kwargs: Dict,
    genes_train: np.ndarray,
    cov_train: np.ndarray,
    genes_test: np.ndarray,
    cov_test: np.ndarray,
    drugs_train: Optional[np.ndarray] = None,
    dosages_train: Optional[np.ndarray] = None,
    log=None,
    device=None,
) -> Dict:
    """Reference train-loop semantics for one config
    (experiments_run.py:294-366): minibatch epochs, R2 eval every
    checkpoint_freq epochs (and at any stop), early stopping when the
    test R2 fails to improve `patience` consecutive evals, NaN-loss stop,
    wall-clock cap. `device` is the trainer's (None: the card). Returns
    {best_r2, best_variables (on the host), epochs_run, stop_reason,
    history, trainer}.
    """
    trainer = ChemCPAAdaptTrainer(cfg, device=device, **trainer_kwargs)
    bs = min(train_kwargs["batch_size"], len(genes_train))
    rng = np.random.RandomState(trainer_kwargs.get("seed", 0))
    rows = [None if a is None else trainer._tensor(a)
            for a in (genes_train, cov_train, drugs_train, dosages_train)]
    best, best_vars, trials = -math.inf, None, 0
    history: List[Dict] = []
    stop_reason = "max_epochs"
    t0 = time.time()
    epoch = -1
    for epoch in range(train_kwargs["num_epochs"]):
        order = rng.permutation(len(genes_train))
        recon = []
        for s in range(0, len(order), bs):
            idx = trainer._tensor(order[s:s + bs])
            out = trainer.train_step(*(None if a is None else a[idx]
                                       for a in rows))
            if "loss_reconstruction" in out:
                recon.append(out["loss_reconstruction"])
        loss = float(np.mean(recon)) if recon else float("nan")
        stop = (
            math.isnan(loss)
            or epoch == train_kwargs["num_epochs"] - 1
            or (time.time() - t0) / 60 > train_kwargs["max_minutes"]
        )
        if math.isnan(loss):
            stop_reason = "nan_loss"
        elif (time.time() - t0) / 60 > train_kwargs["max_minutes"]:
            stop_reason = "max_minutes"
        if (epoch % train_kwargs["checkpoint_freq"] == 0 and epoch > 0) \
                or stop:
            r2 = (float("nan") if math.isnan(loss)
                  else evaluate_r2_tx_adapting(trainer, genes_test,
                                               cov_test))
            history.append({"epoch": epoch, "loss_reconstruction": loss,
                            "test_r2": r2})
            if log:
                log(history[-1])
            if math.isnan(r2):
                stop, stop_reason = True, "nan_r2"
            elif r2 > best:
                best, trials = r2, 0
                best_vars = host_state_dict(trainer.encoder_variables())
            else:
                trials += 1
                if trials > train_kwargs["patience"]:
                    stop, stop_reason = True, "early_stop"
        if stop:
            break
    return {
        "best_r2": best,
        "best_variables": best_vars,
        "epochs_run": epoch + 1,
        "stop_reason": stop_reason,
        "history": history,
        "trainer": trainer,
    }


def run_chemcpa_sweep(
    configs: List[Dict],
    genes_train: np.ndarray,
    cov_train: np.ndarray,
    genes_test: np.ndarray,
    cov_test: np.ndarray,
    base_cfg: Optional[ChemCPAConfig] = None,
    out_jsonl: Optional[str] = None,
    max_configs: Optional[int] = None,
    epoch_cap: Optional[int] = None,
    logger=None,
    device=None,
) -> Dict:
    """Loop generated configs through the trainer on `device` (None: the
    card); returns {results: [...], best_index, best_r2, best_variables,
    best_config}.

    out_jsonl: per-eval + per-config summary lines (the sweep artifact
    the reference keeps in mongoDB/seml; here a plain JSONL).
    epoch_cap: clamp training.num_epochs (tiny-grid tests).
    """
    fh = open(out_jsonl, "a") if out_jsonl else None

    def emit(obj):
        if fh:
            fh.write(json.dumps(obj) + "\n")
            fh.flush()

    results = []
    best_i, best = -1, -math.inf
    best_vars, best_cfg = None, None
    try:
        for i, args in enumerate(configs[:max_configs]):
            cfg, tkw, rkw = sweep_config_to_trainer_args(args, base_cfg)
            if epoch_cap:
                rkw["num_epochs"] = min(rkw["num_epochs"], epoch_cap)
            if logger:
                logger.info(f"sweep config {i}: lr={tkw['lr']:.2e} "
                            f"width={cfg.autoencoder_width} "
                            f"depth={cfg.autoencoder_depth}")
            res = train_one_config(
                cfg, tkw, rkw, genes_train, cov_train, genes_test, cov_test,
                log=lambda h: emit({"config": i, **h}), device=device,
            )
            summary = {
                "config": i,
                "best_r2": res["best_r2"],
                "epochs_run": res["epochs_run"],
                "stop_reason": res["stop_reason"],
                "hparams": {"lr": tkw["lr"],
                            "autoencoder_width": cfg.autoencoder_width,
                            "autoencoder_depth": cfg.autoencoder_depth,
                            "dropout": cfg.dropout,
                            "use_drugs": cfg.use_drugs},
            }
            emit({"summary": summary})
            results.append(summary)
            if res["best_r2"] > best:
                best_i, best = i, res["best_r2"]
                best_vars, best_cfg = res["best_variables"], cfg
            # the trainer holds this config's weights and optimizer state
            # on the card; once it is dropped, its memory goes back
            del res
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        if fh:
            fh.close()
    return {
        "results": results,
        "best_index": best_i,
        "best_r2": best,
        "best_variables": best_vars,
        "best_config": best_cfg,
    }
