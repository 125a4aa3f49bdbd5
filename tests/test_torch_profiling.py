"""`utils/profiling.py` of the port on the CPU: `trace` writes a Chrome
trace that holds an `annotate` region's name, `StepTimer` gives the JAX
package's summary keys, and `memory_stats()` is empty without a card."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from madrigal_tpu.utils import profiling as j_prof
from madrigal_tpu_torch.utils import profiling as t_prof


def test_trace_writes_annotated_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with t_prof.trace(str(tmp_path / "tr")) as prof:
        with t_prof.annotate("madrigal_region"):
            y = x @ x
    files = glob.glob(os.path.join(tmp_path, "tr", "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "madrigal_region" in names
    assert any(e.key == "madrigal_region" for e in prof.key_averages())
    assert torch.isfinite(y).all()


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
