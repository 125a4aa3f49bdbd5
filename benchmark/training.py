"""What the training runners share (`runners/finetune_epoch.py`,
`runners/cl_step.py`): one trainer built in set-up and driven through
its first `checked_steps` steps by the window's own call, the reference
following the same steps from the same inputs, and the numbers compared.

The numbers (`gaps`; a cell compares those its limits file names): the
steps' losses, the worst step; each leaf's first gradient norm as the
optimizer got it (AdamW's first moment after one step over 1 - beta1),
the worst leaf; each leaf's change after the
checked steps, the worst of the leaves whose reference gradient is at
least a thousandth of the median leaf's.
"""
from __future__ import annotations

import contextlib
import importlib
from types import SimpleNamespace

import numpy as np
import torch

import counting
import inputs
from harness import Check, free, precision

PORT = "madrigal_tpu_torch"


def package(name: str) -> SimpleNamespace:
    """The modules a training runner builds from, of the port or of the
    reference (a copy with the port's module paths under `reference`)."""
    mod = lambda m: importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(
        C=mod("config"), collate=mod("data.collate"), kg=mod("data.kg"),
        encoder=mod("models.encoder"), finetune=mod("train.finetune"),
        pretrain_cl=mod("train.pretrain_cl"))


def step_readings(trainer, step, n: int) -> dict:
    """Drive `trainer` through `n` calls of `step` (each returning the
    loss): {'loss': [n], 'grad': {leaf: norm of the first gradient, from
    AdamW's first moment after step 1}, 'change': {leaf: norm of the
    change over the n steps}}, for the leaves the optimizer holds."""
    named = [(k, p) for k, p in trainer.model.named_parameters()
             if any(p is q for g in trainer.optimizer.param_groups
                    for q in g["params"])]
    start = [p.detach().clone() for _, p in named]
    losses, grad = [], None
    for i in range(n):
        losses.append(float(step()))
        if i == 0:
            beta1 = {id(q): g["betas"][0]
                     for g in trainer.optimizer.param_groups
                     for q in g["params"]}
            norms = []
            for _, p in named:
                m = trainer.optimizer.state.get(p, {}).get("exp_avg")
                norms.append(torch.zeros((), device=p.device)
                             if m is None else m.norm() / (1 - beta1[id(p)]))
            grad = torch.stack(norms).double().cpu().numpy()
    change = torch.stack([(p.detach() - s).norm()
                          for (_, p), s in zip(named, start)])
    change = change.double().cpu().numpy()
    del start
    keys = [k for k, _ in named]
    return {"loss": np.asarray(losses), "grad": dict(zip(keys, grad)),
            "change": dict(zip(keys, change))}


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell (module docstring): a gap
    of norms is |program - reference| over the larger of the reference's
    norm of the leaf and of the median leaf (the median over the leaves
    the reference's gradient reaches: under raw_encoder_output stage 2
    reaches no fusion weight)."""
    loss = float(np.max(np.abs(prog["loss"] - ref["loss"])
                        / np.abs(ref["loss"])))
    out = {"loss_gap": loss}
    by_leaf = leaf_gaps(prog, ref)
    for key, leaves in by_leaf.items():
        out[f"{key}_gap"] = max(leaves.values())
    return out


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{'grad': {leaf: gap}, 'change': {leaf: gap}}, the change over the
    leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone under Adam)."""
    g = np.array(list(ref["grad"].values()))
    g_med = np.median(g[g > 0])
    moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
    out = {}
    for key, leaves in (("grad", list(ref["grad"])), ("change", moved)):
        r = np.array([ref[key][k] for k in leaves])
        p = np.array([prog[key].get(k, 0.0) for k in leaves])
        scale = np.maximum(r, np.median(r[r > 0]))
        out[key] = dict(zip(leaves, (np.abs(p - r) / scale).tolist()))
    return out


@contextlib.contextmanager
def k2_spans(calls: dict):
    """Each call of the port's K2 entry (`ops.segment_sorted.
    sorted_segment_sum`, also bound in `ops.gather`) inside its own
    profiler span `bench.k2#<i>`, and its shape kept in `calls`:
    {span: (starts, segments, width, dtype)}."""
    from madrigal_tpu_torch.ops import gather, segment_sorted

    orig = segment_sorted.sorted_segment_sum

    def spanned(data, starts, num_segments):
        name = f"bench.k2#{len(calls)}"
        calls[name] = (starts, num_segments, data.shape[-1], data.dtype)
        with torch.profiler.record_function(name):
            return orig(data, starts, num_segments)

    # the entry counts its launches on the name its module binds
    spanned.launches = orig.launches
    segment_sorted.sorted_segment_sum = gather.sorted_segment_sum = spanned
    try:
        yield
    finally:
        segment_sorted.sorted_segment_sum = gather.sorted_segment_sum = orig
        orig.launches = spanned.launches


def k2_shapes(calls: dict) -> dict:
    """{span: (real rows, segments, width, dtype)}: a call reads the rows
    starts[segments] - starts[0] of its boundary table."""
    if not calls:
        return {}
    ends = torch.stack([(s[n] - s[0]).to(torch.int64)
                        for s, n, _, _ in calls.values()]).cpu().tolist()
    return {name: (rows, n, w, dt) for (name, (_, n, w, dt)), rows
            in zip(calls.items(), ends)}


class TrainRunner:
    """A training cell's runner. A subclass gives `build(pkg, clock)` ->
    (trainer, step) for the port (`PORT`) or the reference, its
    `reference_forward(trainer)` (the forwards of one step, counted for
    the model operations) and `faults` ({name: a function that plants
    the fault in a built trainer})."""
    faults: dict = {}

    def __init__(self, config: dict, mix: dict, seed: int, device, clock):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.k2_calls, self._reference = {}, None
        with clock.part("kernel_load"):
            if self.device.type == "cuda":
                from madrigal_tpu_torch.ops import segment_sorted

                segment_sorted.split_rows()  # builds or loads K2
        with clock.part("data"):
            self.ds = inputs.dataset(config["data"], mix, seed)
            self.rows = inputs.train_rows(self.ds, mix.get("train_share", 1.0),
                                          seed)
        self.trainer, self.step = self.build(PORT, clock)
        with clock.part("warm_up"), precision("f32", self.device):
            self.readings = step_readings(self.trainer, self.step,
                                          mix["checked_steps"])

    def unit(self):
        self.step()

    def traced_unit(self):
        with k2_spans(self.k2_calls):
            self.step()

    def attempted(self, units: int) -> int:
        return units

    def end_to_end(self, units: int, seconds: float) -> dict:
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        return {"train_step_s": seconds / units, "peak_mem_gb": peak / 1e9}

    def free_program(self) -> None:
        self.trainer = self.step = None
        free(self.device)

    def reference_readings(self, mode: str = "f32", fault=None) -> dict:
        """The readings of the plain reference put in the program's place
        (built from the same inputs), in `mode`'s precision, with
        `fault` (a name of `faults`) planted in it."""
        self._reference = None
        free(self.device)
        with precision(mode, self.device):
            trainer, step = self.build("reference", None)
            if fault:
                self.faults[fault](trainer)
            out = step_readings(trainer, step, self.mix["checked_steps"])
        self._reference = trainer
        return out

    def checks(self, limits: dict) -> list:
        """The numbers the cell's limits name, each beside its limit."""
        g = gaps(self.readings, self.reference_readings())
        return [Check(k, g[k], v) for k, v in limits.items()]

    def layer_context(self, units: int, trace) -> dict:
        """The model operations a step needs (the reference's forward
        counted, times 3) and K2's calls: their shapes and the device
        operations launched in each call's span."""
        ops = 3 * counting.forward_matmul_ops(
            lambda: self.reference_forward(self._reference))
        shapes = k2_shapes(self.k2_calls)
        return {"kind": "train", "model_ops_per_unit": ops,
                "k2_calls": shapes,
                "k2_ops": trace.ops_by_span("bench.k2#") if shapes else {}}

    def calibration(self, control: bool, units: int) -> dict:
        """{'program': the numbers, 'worst_leaves': the program's three
        widest leaves of each gap, and with `control` the numbers of the
        reference in TF32 ('tf32') and of each fault planted in it}."""
        self.free_program()
        ref = self.reference_readings()
        out = {"program": gaps(self.readings, ref), "worst_leaves": {
            key: sorted(v.items(), key=lambda kv: -kv[1])[:3]
            for key, v in leaf_gaps(self.readings, ref).items()}}
        if control:
            out["tf32"] = gaps(self.reference_readings("tf32"), ref)
            for name in self.faults:
                out[name] = gaps(self.reference_readings("f32", fault=name),
                                 ref)
        return out

    @staticmethod
    def parts(clock):
        """The set-up clock's parts, or none for the reference."""
        return clock.part if clock else (lambda _: contextlib.nullcontext())
