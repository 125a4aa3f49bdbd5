"""The readers of the port's own spans (`spans.py` and the nine metrics
over it) on records filled by hand: each value, and None for a cell of
the other kind, for a window that completed no unit, for no records, for
records without device times (a CPU run) and for a port that keeps no
records."""
import json

import pytest

import harness
import run
from madrigal_tpu_torch.utils import profiling

TRAIN = ["draw_ms_per_step", "forward_ms_per_step", "kg_pass_ms_per_step",
         "backward_ms_per_step", "optimizer_ms_per_step", "k2_ms_per_step",
         "forward_live_gb"]
RANKS = ["k1_span_ms_per_outcome", "rank_sort_span_ms_per_outcome"]


def _rec(name, ms, parent=None, live=None):
    return profiling.SpanRecord(name, parent=parent, host_start=0.0,
                                host_end=1.0, device_ms=ms, live_bytes=live)


def train_records(device=True):
    """Two stage-2 steps: draw, forward (the KG pass and two K2 calls
    inside), backward (a K2 call on autograd's thread), optimizer."""
    ms = live = (lambda v: v) if device else (lambda v: None)
    out = []
    for step in range(2):
        fwd = _rec("madrigal.forward", ms(10.0 + step),
                   live=live(5e9 + step * 1e9))
        kg = _rec("madrigal.kg_pass", ms(4.0), parent=fwd,
                  live=live(3e9))
        out += [_rec("madrigal.draw", ms(1.5), live=live(2e9)), fwd, kg,
                _rec("madrigal.k2", ms(0.25), parent=kg),
                _rec("madrigal.k2", ms(0.75), parent=kg),
                _rec("madrigal.backward", ms(20.0), live=live(2e9)),
                _rec("madrigal.k2", ms(0.5)),
                _rec("madrigal.optimizer", ms(3.0), live=live(2e9))]
    return out


def rank_records():
    """Two calls: K1, then the sort of its outcomes."""
    return [_rec("madrigal.k1", 2.0), _rec("madrigal.rank_sort", 30.0),
            _rec("madrigal.k1", 2.5), _rec("madrigal.rank_sort", 31.0)]


def ctx(kind, units):
    return harness.LayerContext(kind=kind, units=units, window_s=1.0,
                                busy_s=0.9, ops=[])


@pytest.fixture
def filled(monkeypatch):
    """The port's recorder returning the records given to it."""
    def fill(records):
        monkeypatch.setattr(profiling, "recorded", lambda: list(records))
    return fill


WANT = {
    "draw_ms_per_step": 1.5,
    "forward_ms_per_step": (10.0 + 11.0) / 2,
    "kg_pass_ms_per_step": 4.0,
    "backward_ms_per_step": 20.0,
    "optimizer_ms_per_step": 3.0,
    "k2_ms_per_step": (0.25 + 0.75 + 0.5),
    "forward_live_gb": 6.0,
    "k1_span_ms_per_outcome": (2.0 + 2.5) / 64,
    "rank_sort_span_ms_per_outcome": (30.0 + 31.0) / 64,
}


@pytest.mark.parametrize("name", TRAIN + RANKS)
def test_reader_values(filled, name):
    train = name in TRAIN
    filled(train_records() if train else rank_records())
    got = run.read_metric(name, ctx("train" if train else "ranks",
                                    2 if train else 64))
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", TRAIN + RANKS)
def test_reader_of_the_other_kind_reads_none(filled, name):
    filled(train_records() + rank_records())
    kind = "ranks" if name in TRAIN else "train"
    assert run.read_metric(name, ctx(kind, 2)) is None


@pytest.mark.parametrize("name", TRAIN + RANKS)
def test_reader_of_nothing_reads_none(filled, name):
    """No record, or a window that completed no unit."""
    kind = "train" if name in TRAIN else "ranks"
    filled([])
    assert run.read_metric(name, ctx(kind, 2)) is None
    filled(train_records() + rank_records())
    assert run.read_metric(name, ctx(kind, 0)) is None


@pytest.mark.parametrize("name", TRAIN + RANKS)
def test_reader_of_cpu_records_reads_none(filled, name):
    kind = "train" if name in TRAIN else "ranks"
    cpu = train_records(device=False) + [
        _rec(r.name, None) for r in rank_records()]
    filled(cpu)
    assert run.read_metric(name, ctx(kind, 2)) is None


def test_port_without_recorder_reads_none(monkeypatch):
    """A port whose `profiling` module keeps no records (no
    `recorded`), as before the spans were added."""
    monkeypatch.delattr(profiling, "recorded")
    for name in TRAIN:
        assert run.read_metric(name, ctx("train", 2)) is None
    for name in RANKS:
        assert run.read_metric(name, ctx("ranks", 64)) is None


def test_every_span_reader_is_listed():
    """Each reader is a per-layer metric of BENCHMARK.json, read from the
    card's trace, in the cells of its kind."""
    with open(run.ROOT / "BENCHMARK.json") as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in TRAIN + RANKS:
        m = per_layer[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        assert m["workloads"] == (
            ["twosides-ddi-train", "twosides-cl-pretrain"] if name in TRAIN
            else ["twosides-rank-device"])
