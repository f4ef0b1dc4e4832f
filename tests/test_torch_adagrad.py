"""The grouped Adagrad of the torch port on the CPU: one update of every
Adagrad leaf of a regime group (``ops/adagrad_kernel.py::
adagrad_update_leaves``, one launch on the card) and the optimizer that
groups them (``train/optim.py::OptimizerRegimes.make_apply``) against the
one-leaf plain path, leaf by leaf, bit for bit: the same f32 operations in
the same order.  The card's kernel is held to the same plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak
from open_knowledge_graph_embeddings_tpu_torch.train import optim

HP = dict(lr=0.2, lr_decay=0.01, weight_decay=1e-3, eps=1e-10)


def _leaf(rng, shape):
    f = lambda: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return f() * 0.1, f() * 0.1, f().abs()


def _one_leaf_reference(g, p, acc, step, hp):
    """The one-leaf plain path: the step, its learning rate, the update."""
    step = step + 1.0
    p, acc = p.clone(), acc.clone()
    ak.adagrad_update_plain(g, p, acc, ak.adagrad_clr(step, hp["lr"], hp["lr_decay"]), hp["weight_decay"], hp["eps"])
    return p, acc, step


CASES = {
    "different-steps": ([(64, 16), (16,), (64, 16)], [0.0, 5.0, 2999.0]),
    "tail-n-mod-4": ([(3, 5), (7,), (2048,)], [1.0, 1.0, 40.0]),
    "empty-leaf": ([(0,), (33,), (0, 4)], [0.0, 3.0, 9.0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_leaves_plain_equals_the_one_leaf_path(case):
    shapes, steps0 = CASES[case]
    rng = np.random.default_rng(len(case))
    leaves = [_leaf(rng, s) for s in shapes]
    steps = [torch.tensor(s) for s in steps0]
    want = [_one_leaf_reference(g, p, a, s, HP) for (g, p, a), s in zip(leaves, steps)]
    ps, accs = [p.clone() for _, p, _ in leaves], [a.clone() for _, _, a in leaves]
    before = ak.adagrad_update.launches
    new = ak.adagrad_update_leaves([g for g, _, _ in leaves], ps, accs, steps, HP)
    assert ak.adagrad_update.launches == before  # the CPU takes the plain version
    for (wp, wa, ws), p, a, s, s0 in zip(want, ps, accs, new, steps0):
        assert torch.equal(p, wp) and torch.equal(a, wa) and torch.equal(s, ws)
        assert s.dtype == torch.float32 and float(s) == s0 + 1
    assert [float(s) for s in steps] == steps0  # the given steps are not written


def test_leaves_refuse_mismatched_groups():
    g, p, a = _leaf(np.random.default_rng(0), (4,))
    with pytest.raises(ValueError, match="one g, p, acc and step per leaf"):
        ak.adagrad_update_leaves([g], [p], [a], [], HP)
    with pytest.raises(ValueError, match="shape"):
        ak.adagrad_update_leaves([g[:3]], [p], [a], [torch.tensor(0.0)], HP)
    assert ak.adagrad_update_leaves([], [], [], [], HP) == []


def _regimes(two_groups):
    if two_groups:
        cfg = [{"optimizer": "Adagrad", "lr": 0.1, "lr_decay": 0.05, "match": "^lstm/"},
               {"optimizer": "Adagrad", "lr": 0.2, "lr_decay": 0.01, "weight_decay": 1e-3},
               ]
    else:
        cfg = {"optimizer": "Adagrad", "lr": 0.2, "lr_decay": 0.01, "weight_decay": 1e-3}
    reg = optim.OptimizerRegimes(cfg, frozen_patterns=["frozen"])
    reg.update(0, 0)
    return reg


@pytest.mark.parametrize("two_groups", [False, True], ids=["one-group", "two-groups"])
def test_grouped_make_apply_equals_the_one_leaf_path(two_groups, monkeypatch):
    """Leaves at different steps, with n % 4 != 0, an empty one, one without
    a gradient (left untouched, its state the same objects) and a frozen one,
    in one or two regime groups: one grouped update per group, each leaf as
    the one-leaf plain path gives it."""
    rng = np.random.default_rng(5)
    shapes = {"lstm/w_ih": (64, 16), "lstm/b": (16,), "bn/scale": (7,), "emb": (0, 4), "nograd": (8,),
              "frozen": (4,)}
    leaves = {k: _leaf(rng, s) for k, s in shapes.items()}
    params = {"lstm": {"w_ih": leaves["lstm/w_ih"][1].clone(), "b": leaves["lstm/b"][1].clone()},
              "bn": {"scale": leaves["bn/scale"][1].clone()}, "emb": leaves["emb"][1].clone(),
              "nograd": leaves["nograd"][1].clone(), "frozen": leaves["frozen"][1].clone()}
    reg = _regimes(two_groups)
    state = reg.init_state(params)
    assert state["frozen"] == {}
    flat_state = dict(optim.leaves(state))
    for i, (path, (_, _, acc)) in enumerate(leaves.items()):
        if path != "frozen":
            flat_state[path + "/sum"].copy_(acc)
            flat_state[path + "/step"].fill_(3 * i)
    grads = {"lstm": {"w_ih": leaves["lstm/w_ih"][0], "b": leaves["lstm/b"][0]},
             "bn": {"scale": leaves["bn/scale"][0]}, "emb": leaves["emb"][0], "frozen": leaves["frozen"][0]}
    hps = reg.hparams()
    labels = dict(optim.leaves(optim.assign_regimes(params, reg.matches, reg.frozen_patterns)))
    want = {path: _one_leaf_reference(leaves[path][0], leaves[path][1], leaves[path][2],
                                      flat_state[path + "/step"], hps[labels[path]])
            for path in ("lstm/w_ih", "lstm/b", "bn/scale", "emb")}
    nograd_state = dict(state["nograd"])

    calls = []
    real = optim.adagrad_update_leaves

    def record(gs, ps, accs, steps, hp):
        calls.append((len(ps), hp["lr"]))
        return real(gs, ps, accs, steps, hp)

    monkeypatch.setattr(optim, "adagrad_update_leaves", record)
    new_params, new_state = reg.make_apply(params)(grads, state, params, hps)
    assert sorted(calls) == ([(2, 0.1), (2, 0.2)] if two_groups else [(4, 0.2)])
    flat_p, flat_s = dict(optim.leaves(new_params)), dict(optim.leaves(new_state))
    for path, (wp, wa, ws) in want.items():
        assert torch.equal(flat_p[path], wp) and torch.equal(flat_s[path + "/sum"], wa), path
        assert torch.equal(flat_s[path + "/step"], ws), path
    assert torch.equal(new_params["nograd"], leaves["nograd"][1])
    assert all(new_state["nograd"][k] is nograd_state[k] for k in ("sum", "step"))
    assert torch.equal(new_params["frozen"], leaves["frozen"][1]) and new_state["frozen"] == {}


def test_sgd_leaves_stay_one_update_each(monkeypatch):
    """An SGD regime beside an Adagrad one: the SGD leaves keep their own
    update; only the Adagrad leaves are grouped."""
    reg = optim.OptimizerRegimes([{"optimizer": "SGD", "lr": 0.5, "match": "^a$"},
                                  {"optimizer": "Adagrad", "lr": 0.2}])
    reg.update(0, 0)
    params = {"a": torch.ones(3), "b": torch.ones(5), "c": torch.ones(2)}
    state = reg.init_state(params)
    calls = []
    real = optim.adagrad_update_leaves
    monkeypatch.setattr(optim, "adagrad_update_leaves", lambda *a: calls.append(len(a[1])) or real(*a))
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    new_params, new_state = reg.make_apply(params)(grads, state, params, reg.hparams())
    assert calls == [2]
    assert torch.equal(new_params["a"], torch.full((3,), 0.75)) and "momentum" in new_state["a"]
    assert float(new_state["b"]["step"]) == 1.0 and float(new_state["a"]["step"]) == 1.0
