"""Runner `rank_chunk`: the card's part of the rank export,
`eval.ranks.normalized_ranks_for_outcomes` on a chunk of the mix's
`outcomes_per_call` outcomes at a time, cycling over every outcome.

The outputs of a call drawn from the seed among the mix's
`sample_from_first` first ones and of the last call are kept and
compared outcome by outcome once the window has closed: the widest
shift of a rank against the reference's ranks of float32 scores, in
positions, and exactly, that each outcome's lower triangle is a
permutation of the ranks, symmetric, with a zero diagonal.
"""
from __future__ import annotations

import numpy as np
import torch

import counting
import inputs
from harness import Check, free, precision


class Runner:
    def __init__(self, config: dict, mix: dict, seed: int, device, clock):
        from madrigal_tpu_torch.eval.ranks import (
            normalized_ranks_for_outcomes,
        )

        self.device = torch.device(device)
        shape = config["ranks"]
        self.chunk = mix["outcomes_per_call"]
        self.stable = mix["stable"]
        self.rank = normalized_ranks_for_outcomes
        with clock.part("kernel_load"):
            if self.device.type == "cuda":
                from madrigal_tpu_torch.ops.bilinear import bilinear_scores

                one = torch.zeros(1, counting.D, device=self.device)
                bilinear_scores(one, one, torch.zeros(
                    1, counting.D, counting.D, device=self.device),
                    torch.float32, torch.float32)
        with clock.part("data"):
            self.z, self.w = inputs.rank_inputs(
                shape["num_drugs"], shape["num_labels"], shape["dim"],
                seed, self.device)
        self.starts = list(range(0, self.w.shape[0], self.chunk))
        rng = np.random.RandomState(inputs.seed32(seed))
        self.keep_call = int(rng.randint(mix["sample_from_first"]))
        self.calls, self.kept, self.last = 0, {}, None
        with clock.part("warm_up"), precision("f32", self.device):
            self.rank(self.z, self.w[:self.chunk], stable=self.stable)

    def unit(self):
        s = self.starts[self.calls % len(self.starts)]
        out = self.rank(self.z, self.w[s:s + self.chunk], stable=self.stable)
        if self.calls == self.keep_call:
            self.kept[self.calls] = (s, out)
        self.last = (self.calls, s, out)
        self.calls += 1

    traced_unit = unit

    def attempted(self, units: int) -> int:
        return units * self.chunk

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"rank_outcomes_per_s": units * self.chunk / seconds}

    def free_program(self) -> None:
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1:]
        self.last = None
        free(self.device)

    def readings(self, planted=None) -> dict:
        """{'rank_shift': the widest shift in positions of a kept rank
        against the reference's ranks of float32 scores, 'rank_errors':
        the kept outcomes that are not a symmetric permutation of the
        ranks with a zero diagonal}. `planted` (a precision of the scores)
        puts the reference's own ranks in the program's place: the
        control."""
        from reference.ranks import lower_tri_ranks, rank_values

        n = self.z.shape[0]
        m = n * (n - 1) // 2
        rows, cols = torch.tril_indices(n, n, -1, device=self.device)
        flat = rows * n + cols
        want = rank_values(m, self.device)
        shift, errors = 0.0, 0
        for s, out in self.kept.values():
            for l in range(out.shape[0]):
                with precision("f32", self.device):
                    ref = lower_tri_ranks(self.z, self.w[s + l], self.stable)
                if planted is None:
                    got = out[l].reshape(-1)[flat]
                    sym = bool(torch.equal(out[l], out[l].T)) and not bool(
                        out[l].diagonal().any())
                else:
                    with precision(planted, self.device):
                        got = lower_tri_ranks(self.z, self.w[s + l],
                                              self.stable)
                    sym = True
                errors += int(not (sym and torch.equal(torch.sort(got)[0],
                                                       want)))
                shift = max(shift, float(
                    (got.double() - ref.double()).abs().max()) * m)
                del ref, got
        return {"rank_shift": shift, "rank_errors": float(errors)}

    def checks(self, limits: dict) -> list:
        got = self.readings()
        return [Check(k, got[k], v) for k, v in limits.items()]

    def layer_context(self, units: int, trace) -> dict:
        """K1's operations an outcome needs, and its calls' shapes."""
        n = self.z.shape[0]
        return {"kind": "ranks", "model_ops_per_unit": counting.k1_ops(1, n, n),
                "k1_calls": [(self.chunk, n, n, torch.float32,
                              torch.float32)] * units}

    def calibration(self, control: bool, units: int) -> dict:
        """{'program': the numbers after `units` calls of the timed path,
        and with `control` 'tf32': the reference's ranks of TF32 scores in
        the program's place}."""
        with precision("f32", self.device):
            for _ in range(units):
                self.unit()
        self.free_program()
        out = {"program": self.readings()}
        if control:
            out["tf32"] = self.readings(planted="tf32")
        return out
