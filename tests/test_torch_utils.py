"""The logging and profiling utilities of swraytracing_torch (utils/)
against swraytracing_tpu's: the same messages through both loggers and
progress tickers, the timers of tests/test_io.py::test_profiling_helpers,
and trace's Chrome trace."""

import io
import json
import time

import numpy as np
import pytest
import torch

from swraytracing_tpu.utils import logging as jlog
from swraytracing_torch import utils
from swraytracing_torch.utils import logging as tlog
from swraytracing_torch.utils import profiling

import torch_parity  # noqa: F401  (one torch thread per worker)


@pytest.mark.parametrize("max_level", [tlog.LOG_ERROR, tlog.LOG_INFO,
                                       tlog.LOG_VERBOSE])
def test_create_logger_levels_match_jax(max_level):
    """Messages at or below max_level are printed, printf-style, one line
    each, as the JAX package's logger prints them."""
    assert (tlog.LOG_ERROR, tlog.LOG_INFO, tlog.LOG_VERBOSE) == \
        (jlog.LOG_ERROR, jlog.LOG_INFO, jlog.LOG_VERBOSE) == (0, 1, 2)
    outs = []
    for mod in (tlog, jlog):
        stream = io.StringIO()
        log = mod.create_logger(max_level, stream)
        log("error %d", mod.LOG_ERROR, 7)
        log("info\n")
        log("verbose %s %.2f", mod.LOG_VERBOSE, "x", 0.5)
        outs.append(stream.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") == max_level + 1
    assert outs[0].startswith("error 7\n")


def test_progress_ticks_like_jax():
    """Progress prints every `every` steps (not at step 0) at
    LOG_VERBOSE, with the percentage done."""
    calls = {}
    for name, mod in (("torch", tlog), ("jax", jlog)):
        seen = calls[name] = []
        p = mod.Progress(200, every=51,
                         log=lambda msg, level: seen.append((msg, level)))
        for step in range(200):
            p.tick(step)
    assert [(m.split("%")[0], lv) for m, lv in calls["torch"]] == \
        [(m.split("%")[0], lv) for m, lv in calls["jax"]] == \
        [(" 25.50", 2), (" 51.00", 2), (" 76.50", 2)]


def test_timer_and_time_callable(monkeypatch):
    """tests/test_io.py::test_profiling_helpers: Timer measures wall time;
    time_callable returns the mean seconds and the last output. The
    outputs lie on the CPU, so no CUDA device is synchronised."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    with utils.Timer() as t:
        time.sleep(0.01)
    assert 0.005 < t.elapsed < 1.0
    with utils.Timer(device="cpu") as t:
        time.sleep(0.01)
    assert 0.005 < t.elapsed < 1.0

    def f(x):
        return x * 2.0, {"s": x.sum()}

    dt, out = utils.time_callable(f, torch.arange(8.0), warmup=1, iters=2)
    assert dt >= 0.0
    np.testing.assert_allclose(out[0].numpy(), 2.0 * np.arange(8.0))
    assert float(out[1]["s"]) == 28.0
    assert synced == []


def test_time_callable_syncs_each_cuda_device_of_the_output(monkeypatch):
    """The devices time_callable waits for are those of the CUDA tensors
    in the output (nested in tuples, lists, dicts and dataclasses), each
    once; host tensors add none."""
    class FakeCuda:
        is_cuda = True

        def __init__(self, index):
            self.device = torch.device("cuda", index)

    monkeypatch.setattr(profiling.torch, "Tensor", FakeCuda)
    out = (FakeCuda(0), [FakeCuda(1), {"a": FakeCuda(0)}], 3.0)
    assert profiling._cuda_devices(out) == {torch.device("cuda", 0),
                                           torch.device("cuda", 1)}


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(log_dir) profiles the block (here host operations only: no
    CUDA device) and writes log_dir/<name>.json."""
    x = torch.randn(64, 64, dtype=torch.float64)
    with utils.trace(tmp_path / "tr", name="step") as prof:
        y = torch.fft.rfft2(x @ x)
    assert y.shape == (64, 33)
    names = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in names and "aten::fft_rfft2" in names
    doc = json.loads((tmp_path / "tr" / "step.json").read_text())
    assert any(e.get("name") == "aten::matmul" for e in doc["traceEvents"])
