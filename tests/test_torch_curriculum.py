"""Port of the pacing controllers (slice C): interp, level, contrast and the
meta-weight table against the JAX package's controllers over 200 steps of
seeded numpy signals, pair-shaped (per-token CE, 2 label tokens an
example; success per example) and LCE-shaped (everything per example).

Difficulties must agree bit for bit: ``difficulty_to_index`` floors
``difficulty * (P - 1)``, so one ulp can pick another negative. The rest
(eta, its Adam moments, the window's rate sum, the meta table) at the
optimizer tolerances of tests/test_torch_train.py, both fp32 on the CPU.
The JAX controllers run op by op, in their module's order of operations,
which the port keeps (inside a jitted step XLA may reassociate: see the
port's curriculum/interp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pacednegatives_tpu.curriculum as jcurriculum
from pacednegatives_tpu.curriculum import ContrastController as JContrast
from pacednegatives_tpu.curriculum import InterpController as JInterp
from pacednegatives_tpu.curriculum import LevelController as JLevel
from pacednegatives_tpu.curriculum import MetaWeightTable as JTable
from pacednegatives_tpu.curriculum.base import StepSignals as JSignals
import pacednegatives_tpu_torch.curriculum as tcurriculum
from pacednegatives_tpu_torch.curriculum import (
    ContrastController,
    InterpController,
    LevelController,
    MetaWeightTable,
    StepSignals,
)

# as tests/test_torch_train.py: fp32 optimizer and controller arithmetic a
# few roundings apart (pow, sqrt, summation order)
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
STEPS = 200
B = 6


def _signals(rng, shape: str, ce_scale: float = 1.0):
    """One step's signals: CE values spread around ``ce_scale`` x 0.5 (so
    that a scaled CE falls on either side of an eta near 0.5), success a
    0/1 draw per example."""
    n = 2 * B if shape == "pair" else B
    pce, nce = (rng.random(n).astype(np.float32) * ce_scale
                for _ in range(2))
    ce = ((pce + nce) / np.float32(2)).astype(np.float32)
    success = (rng.random(B) < 0.6).astype(np.float32)
    return pce, nce, ce, success


def _both(sig):
    return (JSignals(*map(jnp.asarray, sig)),
            StepSignals(*map(torch.from_numpy, sig)))


def _assert_bitwise(t, j, what):
    a, b = np.asarray(t.numpy()), np.asarray(j)
    assert a.dtype == b.dtype and np.array_equal(a, b), (what, a, b)


def _close(t, j, what):
    np.testing.assert_allclose(np.asarray(t.numpy(), np.float64),
                               np.asarray(j, np.float64), rtol=OPT_RTOL,
                               atol=OPT_ATOL, err_msg=what)


def test_controllers_has_jax_keys():
    assert set(tcurriculum.CONTROLLERS) == set(jcurriculum.CONTROLLERS)
    assert set(tcurriculum.__all__) >= set(jcurriculum.__all__)


@pytest.mark.parametrize("start,end,num_steps,batch_size", [
    (0.0, 1.0, 300, 3),      # the ramp ends at step 100
    (0.9, 0.1, 1000, 7),     # decreasing, capped at its lower end
    (0.1, 0.9, 0, 1),        # num_steps 0: max(num_steps, 1)
])
def test_interp_matches_jax_bitwise(start, end, num_steps, batch_size):
    kw = dict(start=start, end=end, num_steps=num_steps,
              batch_size=batch_size)
    jc, tc = JInterp(**kw), InterpController(**kw)
    js, ts = jc.init(), tc.init()
    jupdate, jdiff, jmetrics = jc.update, jc.difficulty, jc.metrics
    rng = np.random.default_rng(0)
    for step in range(STEPS):
        _assert_bitwise(tc.difficulty(ts), jdiff(js), f"step {step}")
        _assert_bitwise(tc.metrics(ts)["difficulty"],
                        jmetrics(js)["difficulty"], f"metric {step}")
        jsig, tsig = _both(_signals(rng, "pair"))
        js, ts = jupdate(js, jsig), tc.update(ts, tsig)
    _assert_bitwise(ts.step, js.step, "step counter")


@pytest.mark.parametrize("shape", ["pair", "lce"])
@pytest.mark.parametrize("n_neg,threshold,check_every", [
    (99, 0.5, 3),
    (7, 0.55, 1),   # reaches the 1.0 cap
    (99, 0.6, 5),   # windows of 5 x k/6 reach 18/30 = 0.6 exactly
])
def test_level_matches_jax_bitwise(shape, n_neg, threshold, check_every):
    kw = dict(n_neg=n_neg, threshold=threshold, check_every=check_every)
    jc, tc = JLevel(**kw), LevelController(**kw)
    js, ts = jc.init(), tc.init()
    jupdate, jmetrics = jc.update, jc.metrics
    rng = np.random.default_rng(1)
    bumps = 0
    for step in range(STEPS):
        jsig, tsig = _both(_signals(rng, shape))
        before = float(ts.difficulty)
        js, ts = jupdate(js, jsig), tc.update(ts, tsig)
        bumps += float(ts.difficulty) != before
        _assert_bitwise(ts.difficulty, js.difficulty, f"step {step}")
        for field in ("success_count", "step"):
            _assert_bitwise(getattr(ts, field), getattr(js, field), field)
        _close(ts.success_sum, js.success_sum, f"sum {step}")
        for key, val in jmetrics(js).items():
            _close(tc.metrics(ts)[key], val, f"{key} {step}")
    assert bumps > 0, "no bump in 200 steps"
    if n_neg == 7:
        assert float(ts.difficulty) == 1.0


@pytest.mark.parametrize("shape", ["pair", "lce"])
def test_contrast_matches_jax(shape):
    kw = dict(eta0=0.5, meta_lr=0.05, warmup_steps=5, total_steps=STEPS,
              n_neg=99, threshold=0.5, rate_check=3, ce_scale=2.0,
              milestones=((50, 0.1),))
    jc, tc = JContrast(**kw), ContrastController(**kw)
    js, ts = jc.init(), tc.init()
    jupdate, jmetrics = jc.update, jc.metrics
    jrate, jloss = jc.success_rate, jc.meta_loss
    rng = np.random.default_rng(2)
    for step in range(STEPS):
        jsig, tsig = _both(_signals(rng, shape, ce_scale=2.0))
        _close(tc.meta_loss(ts, tsig), jloss(js, jsig), "meta_loss")
        js, ts = jupdate(js, jsig), tc.update(ts, tsig)
        _assert_bitwise(tc.difficulty(ts), jc.difficulty(js), f"step {step}")
        _close(ts.eta.eta, js.eta.eta, f"eta {step}")
        _assert_bitwise(tc.success_rate(ts, tsig), jrate(js, jsig),
                        f"success_rate {step}")
        tm, jm = tc.metrics(ts), jmetrics(js)
        assert set(tm) == set(jm)
        for key in jm:
            _close(tm[key], jm[key], f"{key} {step}")
    assert float(ts.level.difficulty) > 0.0, "no bump in 200 steps"
    _assert_bitwise(ts.level.step, js.level.step, "level step")
    assert ts.eta.step == int(js.eta.step) == STEPS


def test_meta_table_matches_jax():
    """lookup -> cheap_update -> store over 200 steps, walking the rows in
    order as the runner does, with the meta learning rate of the linear
    warmup-decay schedule."""
    from pacednegatives_tpu.curriculum.eta import linear_warmup_decay as jsched
    from pacednegatives_tpu_torch.curriculum import linear_warmup_decay

    jt, tt = JTable(num_batches=7, batch_size=B), MetaWeightTable(
        num_batches=7, batch_size=B)
    js, ts = jt.init(), tt.init()
    jlr, tlr = jsched(0.05, 10, STEPS), linear_warmup_decay(0.05, 10, STEPS)
    rng = np.random.default_rng(3)
    for step in range(STEPS):
        j = step % 7
        pce, nce, _, _ = _signals(rng, "lce", ce_scale=3.0)
        lr_j, lr_t = jlr(step), torch.tensor(float(tlr(step)))
        assert float(lr_t) == float(lr_j)
        raw_j = jt.cheap_update(jt.lookup(js, jnp.int32(j)),
                                jnp.asarray(pce), jnp.asarray(nce), lr_j)
        raw_t = tt.cheap_update(tt.lookup(ts, j), torch.from_numpy(pce),
                                torch.from_numpy(nce), lr_t)
        _close(raw_t, raw_j, f"raw {step}")
        js, ts = jt.store(js, jnp.int32(j), raw_j), tt.store(ts, j, raw_t)
        _close(tt.metrics(ts, j)["avg_weight"],
               jt.metrics(js, jnp.int32(j))["avg_weight"], "avg_weight")
    _close(ts.table, js.table, "table")
    assert ts.table.dtype == torch.float32
    assert not torch.equal(ts.table, torch.ones_like(ts.table))


def test_cheap_update_is_the_closed_form():
    """cheap_update is one SGD step on the frozen-model objective: its
    gradient by autograd equals the closed form (pce + nce) / B - 1."""
    rng = np.random.default_rng(4)
    pce, nce = (torch.from_numpy(rng.random(B).astype(np.float32) * 4)
                for _ in range(2))
    v = torch.from_numpy(rng.random(B).astype(np.float32)).requires_grad_()
    obj = (pce * v).sum() / B + (nce * v).sum() / B - v.sum()
    (grad,) = torch.autograd.grad(obj, v)
    lr = torch.tensor(0.3)
    got = MetaWeightTable.cheap_update(v.detach(), pce, nce, lr)
    torch.testing.assert_close(got, v.detach() - lr * grad, rtol=0,
                               atol=1e-6)
    want = JTable.cheap_update(jnp.asarray(v.detach().numpy()),
                               jnp.asarray(pce.numpy()),
                               jnp.asarray(nce.numpy()), jnp.float32(0.3))
    _close(got, want, "cheap_update")


def _jax_state_after(kind, steps=4):
    """(JAX controller or table, its state after ``steps`` updates on
    pair-shaped signals, the port's controller or table)."""
    from pacednegatives_tpu.curriculum import EtaController as JEta
    from pacednegatives_tpu_torch.curriculum import EtaController

    rng = np.random.default_rng(5)
    if kind == "meta":
        jt, tt = JTable(num_batches=3, batch_size=B), MetaWeightTable(3, B)
        js = jt.init()
        for j in range(steps):
            pce, nce, _, _ = _signals(rng, "lce", ce_scale=3.0)
            js = jt.store(js, j % 3, jt.cheap_update(
                jt.lookup(js, j % 3), jnp.asarray(pce), jnp.asarray(nce),
                jnp.float32(0.1)))
        return jt, js, tt
    kw = {
        "eta": dict(eta0=0.5, meta_lr=0.05, warmup_steps=2, total_steps=10,
                    ce_scale=2.0),
        "interp": dict(start=0.0, end=1.0, num_steps=30, batch_size=B),
        "level": dict(n_neg=9, threshold=0.3, check_every=2),
        "contrast": dict(eta0=0.5, meta_lr=0.05, warmup_steps=2,
                         total_steps=10, n_neg=9, threshold=0.3,
                         rate_check=2, ce_scale=2.0),
    }[kind]
    jcls, tcls = {"eta": (JEta, EtaController),
                  "interp": (JInterp, InterpController),
                  "level": (JLevel, LevelController),
                  "contrast": (JContrast, ContrastController)}[kind]
    jc = jcls(**kw)
    js = jc.init()
    for _ in range(steps):
        js = jc.update(js, _both(_signals(rng, "pair", ce_scale=2.0))[0])
    return jc, js, tcls(**kw)


def _leaves(state, prefix=""):
    """{path: value} over a curriculum state's NamedTuples and optimizer
    states (tensors, arrays and ints)."""
    out = {}
    for name, val in getattr(state, "_asdict", lambda: {})().items():
        if hasattr(val, "_asdict"):
            out.update(_leaves(val, f"{prefix}{name}."))
        else:
            out[prefix + name] = val
    return out


@pytest.mark.parametrize("kind", ["eta", "interp", "level", "contrast",
                                  "meta"])
def test_curriculum_state_from_jax_round_trips(kind, tmp_path):
    """train_state_from_jax carries each controller's state over exactly
    (values and dtypes), the port's checkpoint round-trips it, and the
    port's controller continues from it as the JAX controller does."""
    from pacednegatives_tpu.train import init_train_state as j_init_state
    from pacednegatives_tpu.train import make_optimizer as j_make_optimizer
    from pacednegatives_tpu_torch.models.convert import train_state_from_jax
    from pacednegatives_tpu_torch.train import (
        restore_checkpoint,
        save_checkpoint,
    )

    jc, js, tc = _jax_state_after(kind)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jstate = j_init_state({"w": jnp.zeros(2)}, j_make_optimizer(0.1, 10), js)
    state = train_state_from_jax(np_tree(jstate._replace(key=None)))
    cur = state.curriculum
    assert type(cur).__name__ == type(js).__name__
    jleaves = {k: v for k, v in _leaves(np_tree(js)).items()
               if k != "eta.opt_state" and k != "opt_state"}
    tleaves = _leaves(cur)
    for key, want in jleaves.items():
        got = tleaves[key]
        if isinstance(got, int):  # the port counts eta's steps in an int
            assert got == int(want), key
        else:
            assert got.dtype == torch.from_numpy(np.array(want)).dtype, key
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=key)
    save_checkpoint(str(tmp_path / "ckpt"), state)
    template = train_state_from_jax(np_tree(j_init_state(
        {"w": jnp.zeros(2)}, j_make_optimizer(0.1, 10),
        jc.init())._replace(key=None)))
    restored = restore_checkpoint(str(tmp_path / "ckpt"), template)
    for key, val in _leaves(restored.curriculum).items():
        want = tleaves[key]
        assert (val == want if isinstance(val, int)
                else torch.equal(val, want) and val.dtype == want.dtype), key
    if kind != "meta":
        rng = np.random.default_rng(6)
        jsig, tsig = _both(_signals(rng, "pair", ce_scale=2.0))
        _assert_bitwise(tc.difficulty(tc.update(restored.curriculum, tsig)),
                        jc.difficulty(jc.update(js, jsig)), "next update")
