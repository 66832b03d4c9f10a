"""The port's learning-rate schedulers against the JAX package's.

``paddle_tpu_torch.optimizer.lr`` is a copy of ``paddle_tpu.optimizer.lr``:
both are pure Python, so each scheduler must give the very same float at
every step (compared with ``==``), and its ``state_dict`` must carry a
run over to a fresh scheduler.
"""
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30

# name: a scheduler, built from either module
SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=1.0),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12, 20],
                                            [0.1, 0.05, 0.01, 0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, decay_steps=20,
                                              end_lr=1e-4, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=7, end_lr=1e-3, power=1.5, cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.5, warmup_steps=6,
                                              start_lr=0.0, end_lr=0.5),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, T_max=20), warmup_steps=5,
        start_lr=1e-3, end_lr=0.5),
    "exponential": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "multi_step": lambda m: m.MultiStepDecay(0.5, milestones=[5, 10, 25],
                                             gamma=0.5),
    "step": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.3),
    "lambda": lambda m: m.LambdaDecay(0.5, lr_lambda=lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(
        0.5, lr_lambda=lambda e: 0.9 if e % 2 else 0.99),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        0.5, factor=0.5, patience=2, cooldown=1, min_lr=0.01),
    "reduce_on_plateau_max_abs": lambda m: m.ReduceOnPlateau(
        0.5, mode="max", threshold=0.05, threshold_mode="abs", patience=1),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, T_max=12, eta_min=0.01),
    "cosine_warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.01),
    "one_cycle": lambda m: m.OneCycleLR(1.0, total_steps=25),
    "one_cycle_linear": lambda m: m.OneCycleLR(
        1.0, total_steps=25, anneal_strategy="linear", phase_pct=0.4),
    "cyclic": lambda m: m.CyclicLR(0.1, 1.0, step_size_up=4,
                                   step_size_down=6),
    "cyclic_triangular2": lambda m: m.CyclicLR(0.1, 1.0, step_size_up=3,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(0.1, 1.0, step_size_up=5,
                                             mode="exp_range",
                                             exp_gamma=0.97),
}

# ReduceOnPlateau steps on a metric: falls, stalls, rises, falls again
METRICS = [1.0, 0.9, 0.85, 0.86, 0.9, 0.84, 0.84, 0.83, 0.9, 0.95, 0.7,
           0.72, 0.71, 0.73, 0.69, 0.75, 0.8, 0.6, 0.61, 0.62, 0.63, 0.5,
           0.55, 0.56, 0.57, 0.58, 0.4, 0.45, 0.46, 0.47]


def _advance(sched, i):
    if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        sched.step(METRICS[i % len(METRICS)])
    else:
        sched.step()


def _run(sched, steps, start=0):
    """``sched()`` at each step, then stepped."""
    out = []
    for i in range(start, start + steps):
        out.append(sched())
        _advance(sched, i)
    return out


def test_every_scheduler_is_ported():
    classes = lambda m: {n for n, v in vars(m).items()  # noqa: E731
                         if isinstance(v, type)
                         and issubclass(v, m.LRScheduler)}
    assert classes(tlr) == classes(jlr)
    assert len(classes(tlr)) == 17         # the base and 16 schedulers
    assert topt.lr is tlr


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    make = SCHEDULERS[name]
    got, want = _run(make(tlr), STEPS), _run(make(jlr), STEPS)
    assert all(type(x) in (float, int) for x in got)
    assert got == want
    assert len(set(got)) > 1           # the schedule moves in 30 steps


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_state_dict_round_trips(name):
    """A run's state carried over at step 13 into a fresh scheduler goes
    on as the run itself does, and the state is the JAX scheduler's."""
    make = SCHEDULERS[name]
    run, ref = make(tlr), make(jlr)
    _run(run, 13)
    _run(ref, 13)
    state = run.state_dict()
    assert state == ref.state_dict()
    assert state and all(isinstance(v, (int, float, bool, str))
                         for v in state.values())
    fresh = make(tlr)
    fresh.set_state_dict(state)
    assert fresh.state_dict() == state
    assert _run(fresh, 17, 13) == _run(run, 17, 13) == _run(ref, 17, 13)
