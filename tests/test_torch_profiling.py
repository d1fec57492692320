"""Port of utils/profiling.py against the JAX module on the CPU: the
analytic T5 FLOPs, ``cost_analysis`` of one matmul (dispatched-op counts
against XLA's compiled cost), ``debug_nans``, ``trace``, the card's peak
and ``StepTimer``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacednegatives_tpu.models import t5 as jt5
from pacednegatives_tpu.utils import profiling as jprof
from pacednegatives_tpu_torch.models import t5 as tt5
from pacednegatives_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("size", ["tiny", "small", "base"])
def test_t5_flops_equal_jax(size):
    jcfg, tcfg = getattr(jt5.T5Config, size)(), getattr(tt5.T5Config, size)()
    for n, l_enc, l_dec in ((16, 188, 2), (3, 512, 5)):
        assert tprof.t5_forward_flops(tcfg, n, l_enc, l_dec) == \
            jprof.t5_forward_flops(jcfg, n, l_enc, l_dec)
    assert tprof.t5_step_flops(tcfg, 32, 188) == \
        jprof.t5_step_flops(jcfg, 32, 188)


def test_cost_analysis_of_a_matmul_equals_jax():
    a, b = (np.random.default_rng(0).standard_normal(s).astype(np.float32)
            for s in ((64, 96), (96, 128)))
    want = jprof.cost_analysis(lambda x, y: x @ y, jnp.asarray(a),
                               jnp.asarray(b))
    got = tprof.cost_analysis(torch.matmul, torch.from_numpy(a),
                              torch.from_numpy(b))
    assert got == want == {"flops": 2.0 * 64 * 96 * 128,
                           "bytes_accessed": 4.0 * (64 * 96 + 96 * 128
                                                    + 64 * 128)}


def test_debug_nans_raises_restores_and_can_be_disabled():
    minus_one = torch.tensor(-1.0)
    with pytest.raises(FloatingPointError):
        with tprof.debug_nans():
            torch.log(minus_one)
    # the mode is gone after the block, and disabled it checks nothing
    assert torch.isnan(torch.log(minus_one))
    with tprof.debug_nans(enable=False):
        assert torch.isnan(torch.log(minus_one))
    # a clean forward and backward passes; a NaN made only in the backward
    # (sqrt's gradient at 0 is 0 / 0 when the cotangent is 0) raises
    x = torch.tensor([1.0, 4.0], requires_grad=True)
    with tprof.debug_nans():
        torch.sqrt(x).sum().backward()
        y = torch.tensor([0.0, 1.0], requires_grad=True)
        loss = (torch.sqrt(y) * 0.0).sum()
        assert loss.item() == 0.0
        with pytest.raises(FloatingPointError):
            loss.backward()
    torch.testing.assert_close(x.grad, 0.5 / torch.sqrt(x.detach()))


def test_trace_writes_a_file_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as prof:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_device_peak_flops_is_none_on_the_cpu():
    assert tprof.device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert tprof.device_peak_flops() is None


def test_step_timer_summary():
    timer = tprof.StepTimer()
    for _ in range(3):
        with timer.section("step"):
            pass
    with timer.section("eval"):
        pass
    s = timer.summary()
    assert set(s) == {"step", "eval"}
    assert s["step"]["count"] == 3 and s["eval"]["count"] == 1
    assert s["step"]["mean_s"] == pytest.approx(s["step"]["total_s"] / 3)
    assert s["step"]["total_s"] >= 0.0
