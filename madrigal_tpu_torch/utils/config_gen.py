"""seml-style experiment-config generation (port of `madrigal_tpu/utils/
config_gen.py`; reference madrigal/chemcpa/chemcpa_config_utils.py:1-935,
read_config / generate_configs / unpack_config): experiment files with
`fixed:`, `grid:` and `random:` blocks expand into the cartesian product
of the grid options (times the random draws), with dotted keys unpacked
into nested dicts. The chemCPA adaptation sweeps use it
(`cli/chemcpa_sweep.py`).

The expansion and its `random.Random` draws are the JAX package's, so one
file gives both packages the same configs.

`read_config` reads a `.json` file with the `json` module and anything
else with pyyaml (imported when called; the card's machine has none).
JSON is also YAML, so the JAX package's `read_config` reads the same
`.json` file. pyyaml reads YAML 1.1, in which `1e-05` (how `json.dumps`
writes 0.00001) is a string, not a float: a file meant for both readers
writes its floats with a dot and a signed exponent (`1.0e-05`), or
pyyaml hands the string to `math.log` in a loguniform block.
"""
from __future__ import annotations

import itertools
import json
import random as _random
from pathlib import Path
from typing import Any, Dict, List, Tuple

RESERVED = {"seml", "slurm"}


def unflatten(d: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted keys -> nested dicts ('model.hparams.dim' -> {...})."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        node = out
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def merge_dicts(a: Dict, b: Dict) -> Dict:
    """Recursive merge; b wins (chemcpa_config_utils merge_dicts)."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def _grid_values(spec: Dict[str, Any]) -> List[Any]:
    t = spec.get("type", "choice")
    if t == "choice":
        return list(spec["options"])
    if t == "range":
        import numpy as np

        return list(np.arange(spec["min"], spec["max"], spec["step"]))
    if t == "uniform":
        raise ValueError("uniform belongs in the random block")
    raise ValueError(f"unknown grid type {t}")


def _random_values(spec: Dict[str, Any], samples: int, rng) -> List[Any]:
    t = spec.get("type", "uniform")
    if t == "uniform":
        return [rng.uniform(spec["min"], spec["max"]) for _ in range(samples)]
    if t == "loguniform":
        import math

        lo, hi = math.log(spec["min"]), math.log(spec["max"])
        return [math.exp(rng.uniform(lo, hi)) for _ in range(samples)]
    if t == "choice":
        return [rng.choice(spec["options"]) for _ in range(samples)]
    raise ValueError(f"unknown random type {t}")


def read_config(path: str) -> Tuple[Dict, Dict, Dict]:
    """Returns (seml_config, slurm_config, experiment_config)."""
    text = Path(path).read_text()
    if Path(path).suffix == ".json":
        data = json.loads(text) if text.strip() else {}
    else:
        import yaml

        data = yaml.safe_load(text) or {}
    seml_cfg = data.pop("seml", {})
    slurm_cfg = data.pop("slurm", {})
    return seml_cfg, slurm_cfg, data


def generate_configs(experiment_config: Dict, seed: int = 0) -> List[Dict]:
    """Expand fixed/grid/random blocks into concrete config dicts."""
    fixed = experiment_config.get("fixed", {})
    grid = experiment_config.get("grid", {})
    rnd = dict(experiment_config.get("random", {}))

    grid_keys = sorted(grid)
    grid_options = [_grid_values(grid[k]) for k in grid_keys]
    combos = list(itertools.product(*grid_options)) if grid_keys else [()]

    samples = int(rnd.pop("samples", 1)) if rnd else 1
    # the random block's own meta keys (seml: `samples` + `seed`, e.g.
    # chemcpa_tx_adapting_configs_sweep.yaml random.seed) are not specs
    rnd_seed = rnd.pop("seed", None) if rnd else None
    rng = _random.Random(seed if rnd_seed is None else rnd_seed)
    rnd_keys = sorted(rnd)
    rnd_draws = (
        [{k: _random_values(rnd[k], samples, rng)[i] for k in rnd_keys}
         for i in range(samples)]
        if rnd_keys else [{}]
    )

    configs = []
    for combo in combos:
        base = dict(fixed)
        base.update(dict(zip(grid_keys, combo)))
        for draw in rnd_draws:
            flat = dict(base)
            flat.update(draw)
            configs.append(unflatten(flat))
    return configs
