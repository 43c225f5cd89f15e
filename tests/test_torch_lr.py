"""The port's LR schedulers against the reference's, float for float.

Each of the 16 schedulers is built the same way in ``paddle_tpu`` and in
``paddle_tpu_torch`` and stepped 30 times (``ReduceOnPlateau`` on one
seeded metric stream); the lr sequences must be equal exactly (both are
the same pure Python).  The ``state_dict`` round trip: a scheduler
rebuilt from another's ``state_dict`` halfway runs on as the original,
and the dict equals the reference's.
"""
import math

import numpy as np
import pytest

from paddle_tpu.optimizer import lr as ref_lr

from paddle_tpu_torch import optimizer as optim
from paddle_tpu_torch.optimizer import lr as port_lr

STEPS = 30

CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.3),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, power=1.5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-3, T_max=20), warmup_steps=5,
        start_lr=0.0, end_lr=1e-3),
    "LinearWarmup_float": lambda m: m.LinearWarmup(0.01, warmup_steps=4,
                                                   start_lr=0.001,
                                                   end_lr=0.01),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 17],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=6, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.2, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-4),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.05, T_max=11, eta_min=1e-4),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.2, lambda e: 0.9 if e % 2 else 0.99),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=25, anneal_strategy="linear", phase_pct=0.4),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=12),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=1e-3),
}

_METRICS = np.random.default_rng(0).normal(1.0, 0.05, STEPS).cumsum()


def _advance(sched, i):
    if isinstance(sched, (ref_lr.ReduceOnPlateau, port_lr.ReduceOnPlateau)):
        sched.step(float(_METRICS[i]))
    else:
        sched.step()


def _run(sched, start=0, stop=STEPS):
    out = []
    for i in range(start, stop):
        out.append(sched())
        _advance(sched, i)
    return out


def test_every_scheduler_has_a_case():
    concrete = {n for n in port_lr.__all__ if n != "LRScheduler"}
    assert len(concrete) == 16
    assert concrete == {n.split("_")[0] for n in CASES}
    assert port_lr.__all__ == ref_lr.__all__


@pytest.mark.parametrize("name", sorted(CASES))
def test_lr_sequence_equals_reference(name):
    got = _run(CASES[name](port_lr))
    want = _run(CASES[name](ref_lr))
    assert got == want
    assert all(math.isfinite(x) for x in got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_round_trip(name):
    make = CASES[name]
    whole = _run(make(port_lr))
    first = make(port_lr)
    head = _run(first, 0, STEPS // 2)
    sd = first.state_dict()
    ref = make(ref_lr)
    _run(ref, 0, STEPS // 2)
    assert sd == ref.state_dict()
    second = make(port_lr)
    second.set_state_dict(dict(sd))
    assert head + _run(second, STEPS // 2, STEPS) == whole


def test_optimizer_reads_the_schedule():
    """``get_lr`` follows the scheduler, ``set_lr`` refuses under one,
    and a float lr can be set."""
    sched = port_lr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = optim.SGD(learning_rate=sched)
    assert opt._lr_scheduler is sched
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        sched.step()
    assert seen == [0.1, 0.1, 0.05, 0.05, 0.025]
    with pytest.raises(Exception, match="LRScheduler"):
        opt.set_lr(0.3)
    plain = optim.SGD(learning_rate=0.1)
    plain.set_lr(0.3)
    assert plain.get_lr() == 0.3 and plain._lr_scheduler is None
