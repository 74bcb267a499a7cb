"""On the card: a traced run of the tiny cell in both steppings reads its
device metrics from the trace, within their ranges, and is correct. Run
on the card with ``python -m pytest benchmark/tests -m cuda``; skips
itself without one."""

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import TinySpec, use_tiny, workload


@pytest.mark.cuda
@pytest.mark.parametrize("stepping", ["scan", "frame"])
def test_a_traced_card_run_reads_the_trace(monkeypatch, stepping):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    use_tiny(monkeypatch)
    out = run.measure(TinySpec(), workload(stepping), seed=31337,
                      seconds=1.0, trace=True,
                      device=torch.device("cuda", 0), t_start=0.0,
                      log=lambda s: None)
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105, (name, m)
    assert out["breakdown"]["device_ops"]
