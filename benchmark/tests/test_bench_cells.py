"""Each cell driven on the CPU at tiny sizes: the port's plain path
against the reference (correct), the result line's schema, the control
(the reference in TF32 in the port's place) and the faults a cell can
have, planted in the port underneath the timed path (not correct).

One chip only, so no cell has an exchange between chips to leave out."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import harness
import run
import tiny

CELLS = ["twosides-ddi-train", "twosides-cl-pretrain", "twosides-rank-device"]
TRAIN = CELLS[:2]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_port_matches_reference(tiny_root, workload, trace):
    out = tiny.run_cell(tiny_root, workload, trace=trace)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    bench, work, _, _ = run.cell(tiny_root, workload)
    kind = "per_layer" if trace else "end_to_end"
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU runs no device operation: the readers of device time
        # find nothing and leave their metrics out
        assert set(out["metrics"]) <= set(run.metric_names(bench, work, kind))
    else:
        assert set(out["metrics"]) == set(run.metric_names(bench, work,
                                                           kind))
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert out["device"]["count"] == 1
    json.dumps(out)


def _runner(root, workload, seed=3_000_000_019):
    _, _, config, mix = run.cell(root, workload)
    cpu = torch.device("cpu")
    return run.runner_class(mix)(config, mix, seed, cpu,
                                 harness.SetupClock(cpu))


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_not_correct(tiny_root, workload):
    """The reference in TF32 (on the CPU: float32 matmul operands rounded
    to a 10-bit mantissa) in the port's place fails one of the numbers,
    while the port passes them."""
    got = _runner(tiny_root, workload).calibration(True, 3)
    lim = tiny.LIMITS[workload]
    assert all(got["program"][k] <= v for k, v in lim.items()), got
    assert any(got["tf32"][k] > v for k, v in lim.items()), got
    if workload in TRAIN:
        assert any(got["half_batch"][k] > v for k, v in lim.items()), got


def _state_unchanged(monkeypatch, workload):
    """Each step computes and returns its loss, and leaves the weights as
    they were."""
    from madrigal_tpu_torch.train.finetune import FinetuneTrainer
    from madrigal_tpu_torch.train.pretrain_cl import CLPretrainer

    cls, name = ((FinetuneTrainer, "train_epoch")
                 if workload == "twosides-ddi-train"
                 else (CLPretrainer, "_run_step"))
    step = getattr(cls, name)

    def unchanged(self, *a):
        kept = [p.detach().clone() for p in self.model.parameters()]
        out = step(self, *a)
        with torch.no_grad():
            for p, k in zip(self.model.parameters(), kept):
                p.copy_(k)
        return out

    monkeypatch.setattr(cls, name, unchanged)


def _half_batch(monkeypatch, workload):
    """The loss over half of the batch, its mean over the rest."""
    if workload == "twosides-ddi-train":
        from madrigal_tpu_torch.train import finetune

        bce = finetune.masked_bce

        def half(logits, targets, weights, *a, **k):
            live = torch.nonzero(weights).flatten()
            keep = torch.arange(len(weights)) < live[len(live) // 2]
            return bce(logits, targets, weights & keep, *a, **k)

        monkeypatch.setattr(finetune, "masked_bce", half)
    elif workload == "twosides-cl-pretrain":
        from madrigal_tpu_torch.models import simclr

        nce = simclr.info_nce

        def half(aug1, aug2, *a, **k):
            h = aug1.shape[0] // 2
            return nce(aug1[:h], aug2[:h], *a, **k)

        monkeypatch.setattr(simclr, "info_nce", half)
    else:
        from madrigal_tpu_torch.eval import ranks

        fn = ranks.normalized_ranks_for_outcomes

        def half(z, w, *a, **k):
            out = fn(z, w, *a, **k)
            out[out.shape[0] // 2:] = 0
            return out

        monkeypatch.setattr(ranks, "normalized_ranks_for_outcomes", half)


def _answer_altered(monkeypatch, workload):
    """One rank of each outcome changed where it is produced."""
    from madrigal_tpu_torch.eval import ranks

    fn = ranks.rank_lower

    def altered(scores, order_idx, stable):
        out = fn(scores, order_idx, stable)
        out[1, 0] += 1.0 / order_idx.shape[0]
        return out

    monkeypatch.setattr(ranks, "rank_lower", altered)


FAULTS = [(w, f) for w in TRAIN for f in (_state_unchanged, _half_batch)] + [
    ("twosides-rank-device", _half_batch),
    ("twosides-rank-device", _answer_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_reads_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    out = tiny.run_cell(tiny_root, workload)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


def test_no_card_no_result(monkeypatch, capsys):
    """The command exits 2 without a result line where no card is
    present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "twosides-rank-device", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_lone_benchmark_fails(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ exits with
    another code than 0 and prints no result."""
    root = Path(run.__file__).resolve().parents[1]
    subprocess.run(["cp", "-r", str(root / "benchmark"),
                    str(root / "BENCHMARK.json"), str(tmp_path)], check=True)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "twosides-rank-device", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
