"""`utils/profiling.py` of the port on the CPU: `trace` writes a Chrome
trace that holds a `span`'s name, `span` is one shared null context while
no profiler records and records the trainers' phases while one does (the
newest session only), `StepTimer` gives the JAX package's summary keys,
and `memory_stats()` is empty without a card."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from madrigal_tpu.utils import profiling as j_prof
from madrigal_tpu_torch import config as t_config
from madrigal_tpu_torch.data import synthetic as t_syn
from madrigal_tpu_torch.data.collate import DDICollator
from madrigal_tpu_torch.data.kg import kg_schema
from madrigal_tpu_torch.models.encoder import MadrigalMultilabel, init_weights
from madrigal_tpu_torch.train import finetune as t_ft
from madrigal_tpu_torch.train import pretrain_cl as t_pcl
from madrigal_tpu_torch.utils import profiling as t_prof
from test_torch_pretrain import DATA as CL_DATA
from test_torch_pretrain import tiny_pretrain_cfg
from test_torch_train import DATA as FT_DATA
from test_torch_train import one_thread  # noqa: F401  (fixture)
from test_torch_train import tiny_cfg


def test_trace_writes_annotated_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with t_prof.trace(str(tmp_path / "tr")) as prof:
        with t_prof.span("madrigal_region") as record:
            y = x @ x
    files = glob.glob(os.path.join(tmp_path, "tr", "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "madrigal_region" in names
    assert any(e.key == "madrigal_region" for e in prof.key_averages())
    assert torch.isfinite(y).all()
    assert t_prof.recorded() == [record]
    assert record.host_end >= record.host_start
    assert record.device_ms is None and record.live_bytes is None


def test_span_off_is_one_shared_null_context():
    before = t_prof.recorded()
    first = t_prof.span("madrigal.forward")
    assert t_prof.span("madrigal.k2") is first
    with first as record:
        assert record is None
    assert t_prof.recorded() == before


# ------------------------------------------------------ the trainers' spans
def finetune_trainer():
    """A tiny stage-3 trainer in the benchmark's mode (three-way loss)
    and its step."""
    ds = t_syn.make_dataset(**FT_DATA)
    batch, kg = DDICollator(ds, split="train", device="cpu",
                            kg_src_sort=True)()
    cfg = tiny_cfg(t_config, "str_random_sample")
    model = init_weights(MadrigalMultilabel(
        cfg.model.encoder, 6, *kg_schema(ds.kg_node_feats,
                                         ds.kg_edge_indices)),
        torch.Generator().manual_seed(0))
    trainer = t_ft.FinetuneTrainer(cfg, batch, kg, model)
    return lambda: trainer.train_epoch()["total"]


def pretrain_trainer():
    """A tiny stage-2 trainer on the device-table path and its step."""
    ds = t_syn.make_dataset(**CL_DATA)
    coll = DDICollator(ds, split="train", device="cpu", kg_src_sort=True)
    cfg = tiny_pretrain_cfg(t_config)
    model = init_weights(t_pcl.build_simclr_model(
        cfg, *kg_schema(ds.kg_node_feats, ds.kg_edge_indices)),
        torch.Generator().manual_seed(0))
    trainer = t_pcl.CLPretrainer(cfg, coll, coll.kg_batch(), model)
    return trainer.train_step


# the spans of one step, in the order they open: stage 3's KG table and
# each of its two forwards (X_X, str_X) and backwards, then the table's
# backward; stage 2's one forward and backward
STEP_SPANS = {
    "stage3": (finetune_trainer, [
        "madrigal.draw", "madrigal.forward", "madrigal.kg_pass",
        "madrigal.forward", "madrigal.backward", "madrigal.forward",
        "madrigal.backward", "madrigal.backward", "madrigal.optimizer"]),
    "stage2": (pretrain_trainer, [
        "madrigal.draw", "madrigal.forward", "madrigal.kg_pass",
        "madrigal.backward", "madrigal.optimizer"]),
}
STAGES = sorted(STEP_SPANS)


@pytest.mark.parametrize("stage", STAGES)
def test_steps_without_profiler_record_nothing(stage):
    make, _ = STEP_SPANS[stage]
    step = make()
    before = t_prof.recorded()
    for _ in range(2):
        assert np.isfinite(step())
    assert t_prof.recorded() == before


@pytest.mark.parametrize("stage", STAGES)
def test_steps_under_profiler_record_each_phase(stage, tmp_path):
    """Two steps under torch.profiler: each step's phases in order, the
    KG pass inside the first forward, the phases siblings at the top of
    the thread, each a user_annotation of the chrome trace."""
    make, want = STEP_SPANS[stage]
    step = make()
    step()  # untraced
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step()
    records = t_prof.recorded()
    assert [r.name for r in records] == want * 2
    for r in records:
        if r.name == "madrigal.kg_pass":
            assert r.parent.name == "madrigal.forward"
        else:
            assert r.parent is None
        assert r.host_start <= r.host_end
        assert r.device_ms is None and r.live_bytes is None  # the CPU
    tops = [r for r in records if r.parent is None]
    assert all(a.host_end <= b.host_start for a, b in zip(tops, tops[1:]))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert set(want) <= spans


def test_second_session_starts_with_empty_records(tmp_path):
    """The first span of a profiler session drops the last session's
    records: after an untraced step, as the benchmark runs one before its
    traced window, and at the start of each `trace`, back to back."""
    step = pretrain_trainer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    step()  # untraced
    with torch.profiler.profile(activities=acts):
        step()
        step()
    assert len(t_prof.recorded()) == 10
    step()  # untraced: the records stay until the next session
    assert len(t_prof.recorded()) == 10
    with torch.profiler.profile(activities=acts):
        step()
    assert len(t_prof.recorded()) == 5
    for _ in range(2):  # two traces back to back
        with t_prof.trace(str(tmp_path)):
            step()
        assert len(t_prof.recorded()) == 5


def test_step_timer_summary_matches_jax_keys():
    tt, jt = t_prof.StepTimer(), j_prof.StepTimer()
    for timer, out in ((tt, {"a": [torch.ones(3)], "b": 1.0}),
                       (jt, np.ones(3))):
        for _ in range(3):
            timer.start()
            assert timer.stop(out) >= 0
    assert tt.summary().keys() == jt.summary().keys()
    assert tt.summary()["n"] == 3 and tt.mean > 0
    assert t_prof.StepTimer().summary() == {}


def test_memory_stats_without_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    assert t_prof.memory_stats() == {}
