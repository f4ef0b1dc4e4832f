"""The torch port's optimizer rules and lr schedulers against the JAX
package on the CPU: Adam, RMSprop and Adadelta (with weight decay and
momentum) over 20 steps, the ``betas`` alias, every scheduler's lr scale
over epochs 0-40, ``safe_eval_lr_lambda``'s accepted and rejected
expressions, phase switches that change the optimizer type, and the scaled
learning rate reaching the Adagrad update on every call.

Parameters and gradients are made from a numpy seed.  Rules are held
within 2 f32 ulps of the largest |p| of the leaf: both packages round the
same f32 operations, but XLA on the CPU may contract a product and a sum
into one FMA (one ulp; ROADMAP Queue 3, the note on fault 6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.train import optim as jopt
from open_knowledge_graph_embeddings_tpu_torch.train import optim as popt

torch.set_num_threads(1)

SHAPES = ((4, 3), (7,), (33,))


def _grads(seed, steps):
    rng = np.random.default_rng(seed)
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(SHAPES)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()} for _ in range(steps)]
    return params, grads


def _run(mod, cfg, params, grads, to, from_):
    reg = mod.OptimizerRegimes(cfg)
    reg.update(1, 0)
    p = {k: to(v.copy()) for k, v in params.items()}
    state = reg.init_state(p)
    apply = reg.make_apply(p)
    for g in grads:
        hp = reg.hparams()
        if mod is jopt:
            hp = [{k: jnp.float32(v) for k, v in h.items()} for h in hp]
        p, state = apply({k: to(v) for k, v in g.items()}, state, p, hp)
    return {k: from_(v) for k, v in p.items()}, {k: {n: from_(t) for n, t in s.items()} for k, s in state.items()}


RULES = {
    "adam": {"optimizer": "Adam", "lr": 1e-2, "weight_decay": 1e-4},
    "adam-betas": {"optimizer": "Adam", "lr": 3e-3, "betas": [0.8, 0.99], "eps": 1e-6},
    "rmsprop": {"optimizer": "RMSprop", "lr": 1e-2, "weight_decay": 1e-3},
    "rmsprop-momentum": {"optimizer": "RMSprop", "lr": 1e-2, "momentum": 0.9, "alpha": 0.95, "weight_decay": 1e-3},
    "adadelta": {"optimizer": "Adadelta", "lr": 1.0, "rho": 0.9},
    "adadelta-wd": {"optimizer": "Adadelta", "lr": 0.5, "rho": 0.95, "weight_decay": 1e-2},
    "sgd-nesterov": {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-4},
}


@pytest.mark.parametrize("name", list(RULES))
def test_rule_matches_jax(name):
    """20 steps of a rule: every parameter within 2 f32 ulps of its leaf's
    largest |p| of JAX's (the largest gap in ulps is printed), the state
    under JAX's names (a checkpoint carries it both ways), each state
    tensor to rtol 1e-5, the step count exact."""
    params, grads = _grads(0, 20)
    wp, ws = _run(jopt, RULES[name], params, grads, jnp.asarray, np.asarray)
    gp, gs = _run(popt, RULES[name], params, grads, torch.from_numpy, lambda t: t.numpy())
    worst = 0.0
    for k, want in wp.items():
        ulp = np.spacing(np.float32(np.abs(want).max()))
        gap = float(np.abs(gp[k] - want).max() / ulp)
        worst = max(worst, gap)
        assert gap <= 2, (k, gap)
    print(f"{name}: largest gap {worst:g} ulps of max|p|")
    for k, s in ws.items():
        assert set(gs[k]) == set(s), (k, set(gs[k]), set(s))
        for n, want in s.items():
            if n == "step":
                assert gs[k][n] == want == 20
            else:
                np.testing.assert_allclose(gs[k][n], want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=n)


def test_phase_hparams_match_jax():
    """Every rule's defaults and overrides, the ``betas`` alias and
    ``nesterov`` as a flag, merged over phases, as JAX resolves them."""
    for cfg in RULES.values():
        j, p = jopt.OptimizerRegimes(cfg), popt.OptimizerRegimes(cfg)
        j.update(1, 0)
        p.update(1, 0)
        assert p.hparams() == j.hparams()
    phases = [[{"optimizer": "Adam", "lr": 0.1, "betas": [0.5, 0.6]}, {"step": 3, "lr": 0.01}]]
    j, p = jopt.OptimizerRegimes(phases), popt.OptimizerRegimes(phases)
    for steps in (1, 3):
        j.update(1, steps)
        p.update(1, steps)
        assert p.hparams() == j.hparams()
    assert p.hparams()[0]["beta1"] == 0.5 and p.hparams()[0]["lr"] == 0.01


SCHEDULERS = {
    "step": {"lr_scheduler": "StepLR", "step_size": 7, "gamma": 0.5},
    "multistep": {"lr_scheduler": "MultiStepLR", "milestones": [30, 5, 12], "gamma": 0.3},
    "exponential": {"lr_scheduler": "ExponentialLR", "gamma": 0.93},
    "cosine": {"lr_scheduler": "CosineAnnealingLR", "T_max": 17, "eta_min": 0.001},
    "cosine-restarts": {"lr_scheduler": "CosineAnnealingWarmRestarts", "T_0": 4, "T_mult": 2, "eta_min": 0.01},
    "cosine-restarts-flat": {"lr_scheduler": "CosineAnnealingWarmRestarts", "T_0": 6},
    "linear": {"lr_scheduler": "LinearLR", "start_factor": 0.25, "end_factor": 1.0, "total_iters": 9},
    "polynomial": {"lr_scheduler": "PolynomialLR", "total_iters": 25, "power": 2.0},
    "lambda": {"lr_scheduler": "LambdaLR", "lr_lambda": "0.95 ** epoch if epoch < 20 else 0.5 * math.cos(epoch / 40)"},
    "plateau": {"lr_scheduler": "ReduceLROnPlateau", "factor": 0.5, "patience": 2},
    "plateau-min": {"lr_scheduler": "ReduceLROnPlateau", "factor": 0.1, "patience": 0},
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax(name):
    """Two regimes (the second without a scheduler), stepped at epochs
    0-40 with a metric that rises, stalls and falls (mrr, greater is
    better; the '-min' case smaller is better): every lr scale, the
    plateau state and the merged lr exactly equal to JAX's."""
    opt = [[{"optimizer": "Adagrad", "lr": 0.2, "match": "a"}, {"epoch": 10, "lr": 0.1}],
           {"optimizer": "SGD", "lr": 0.3}]
    j, p = jopt.OptimizerRegimes(opt, [SCHEDULERS[name]]), popt.OptimizerRegimes(opt, [SCHEDULERS[name]])
    metric = np.concatenate([np.linspace(0.1, 0.5, 10), np.full(10, 0.5), np.linspace(0.5, 0.2, 21)])
    scales = []
    for epoch in range(41):
        for r in (j, p):
            r.update(epoch, 0)
            r.lr_scheduler_step(float(metric[epoch]), greater_is_better=not name.endswith("-min"), epoch=epoch)
        assert p.lr_scale == j.lr_scale, epoch
        assert p.hparams() == j.hparams(), epoch
        assert p.host_state() == j.host_state()
        scales.append(p.lr_scale[0])
    assert len(set(scales)) > 1 and p.lr_scale[1] == 1.0


LAMBDA_OK = ["0.95 ** epoch", "1 / (1 + 0.1 * epoch)", "max(0.1, 1 - epoch / 30)", "exp(-epoch / 10)",
             "math.sqrt(epoch + 1) / 5", "1.0 if epoch < 5 else 0.5", "-epoch % 7 + pi - e", "floor(epoch / 3) // 2",
             "abs(cos(epoch)) + log10(epoch + 1)", "+epoch <= 3"]
LAMBDA_BAD = ["__import__('os').system('true')", "epoch.__class__", "(lambda: 1)()", "[1][0]", "'a'", "x + 1",
              "math.exp.__name__", "round(epoch)", "min(epoch, key=abs)", "1 < epoch < 3", "not epoch", "epoch +"]


@pytest.mark.parametrize("epoch", [0, 3, 17])
def test_safe_eval_lr_lambda_matches_jax(epoch):
    """Accepted expressions give JAX's value exactly; rejected ones raise
    ``ValueError`` in both packages."""
    for expr in LAMBDA_OK:
        assert popt.safe_eval_lr_lambda(expr, epoch) == jopt.safe_eval_lr_lambda(expr, epoch), expr
    for expr in LAMBDA_BAD:
        for fn in (popt.safe_eval_lr_lambda, jopt.safe_eval_lr_lambda):
            with pytest.raises(ValueError):
                fn(expr, epoch)


def test_unknown_scheduler_and_optimizer_raise():
    reg = popt.OptimizerRegimes({"optimizer": "Adagrad"}, {"lr_scheduler": "OneCycleLR"})
    reg.update(1, 0)
    with pytest.raises(ValueError, match="unsupported lr_scheduler"):
        reg.lr_scheduler_step(0.1, epoch=1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        popt.OptimizerRegimes({"optimizer": "Lion"}).init_state({"p": torch.zeros(2)})


def test_type_switch_to_adadelta_state_matches_jax():
    """Adagrad switching to Adadelta at a step trigger: ``update`` reports
    the type change at JAX's step, and the fresh state has JAX's keys."""
    opt = [[{"optimizer": "Adagrad", "lr": 0.1}, {"step": 4, "optimizer": "Adadelta", "lr": 1.0}]]
    j, p = jopt.OptimizerRegimes(opt), popt.OptimizerRegimes(opt)
    changed = []
    for step in range(1, 7):
        jc, pc = j.update(1, step), p.update(1, step)
        assert jc == pc
        changed.append(pc)
    assert changed == [False, False, False, True, False, False]
    params = {"w": np.ones((3, 2), np.float32)}
    js = j.init_state({k: jnp.asarray(v) for k, v in params.items()})
    ps = p.init_state({k: torch.from_numpy(v) for k, v in params.items()})
    assert set(ps["w"]) == set(js["w"]) == {"sq", "acc_delta", "step"}


def test_scaled_lr_reaches_every_adagrad_call(monkeypatch):
    """The scheduler's scale reaches the Adagrad group update through
    ``hparams()`` on the next call, and again on every later one: the
    update is handed the scaled lr each time (nothing caches the old
    value)."""
    seen = []
    orig = popt.adagrad_update_leaves

    def record(gs, ps, accs, steps, hp):
        seen.append(hp["lr"])
        return orig(gs, ps, accs, steps, hp)

    monkeypatch.setattr(popt, "adagrad_update_leaves", record)
    reg = popt.OptimizerRegimes({"optimizer": "Adagrad", "lr": 0.2}, {"lr_scheduler": "StepLR", "step_size": 1,
                                                                        "gamma": 0.5})
    reg.update(1, 0)
    p = {"w": torch.ones(4, 3)}
    state, apply = reg.init_state(p), reg.make_apply(p)
    for epoch in range(4):
        reg.lr_scheduler_step(0.0, epoch=epoch)
        for _ in range(2):
            p, state = apply({"w": torch.full((4, 3), 0.5)}, state, p, reg.hparams())
    assert seen == [0.2, 0.2, 0.1, 0.1, 0.05, 0.05, 0.025, 0.025]
