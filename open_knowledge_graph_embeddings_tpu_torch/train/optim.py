"""Optimizer regimes with torch-matching update rules.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/optim.py``: a
list of phase dicts ``{'epoch'/'step', 'optimizer', 'lr', ...}`` switched
during training, with independent regimes selected by a parameter-path
regex ``match`` (per-parameter-group optimizers) and frozen patterns.

Ported rules: Adagrad (lr_decay, eps, additive weight decay; the dense
update is :func:`..ops.adagrad_kernel.adagrad_update`, the Triton kernel on
the card) and SGD (momentum, nesterov).  Adam, RMSprop, Adadelta and the
lr schedulers come with ROADMAP Queue 1 item 12.

Optimizer state is a nested dict parallel to the params, ``{"sum",
"step"}`` / ``{"momentum", "step"}`` per optimized leaf and ``{}`` per
frozen one, with the JAX names, so checkpoints carry it both ways.  The
updates run in place on the parameter and state tensors.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import adagrad_update

logger = logging.getLogger(__name__)

Params = Dict[str, Any]
HParams = Dict[str, float]


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is not ported to the torch package yet: ROADMAP Queue 1 item 12")


# ------------------------------------------------------------- update rules


def _adagrad_init(p):
    return {"sum": torch.zeros_like(p), "step": torch.zeros((), dtype=torch.float32, device=p.device)}


def adagrad_clr(step: torch.Tensor, hp: HParams) -> torch.Tensor:
    """``lr / (1 + (step - 1) * lr_decay)`` as a device scalar."""
    return hp["lr"] / (1.0 + (step - 1.0) * hp["lr_decay"])


def _adagrad_update(g, s, p, hp):
    step = s["step"] + 1.0
    adagrad_update(g.contiguous(), p, s["sum"], adagrad_clr(step, hp), hp["weight_decay"], hp["eps"])
    return p, {"sum": s["sum"], "step": step}


def _sgd_init(p):
    return {"momentum": torch.zeros_like(p), "step": torch.zeros((), dtype=torch.float32, device=p.device)}


def _sgd_update(g, s, p, hp):
    g = g + hp["weight_decay"] * p
    buf = hp["momentum"] * s["momentum"] + g
    if hp["momentum"] > 0:  # momentum == 0: plain SGD (torch skips the buffer)
        g = g + hp["momentum"] * buf if hp["nesterov"] > 0 else buf
    p.sub_(hp["lr"] * g)
    return p, {"momentum": buf, "step": s["step"] + 1.0}


_RULES: Dict[str, Tuple[Callable, Callable, Dict[str, float]]] = {
    "Adagrad": (_adagrad_init, _adagrad_update, dict(lr=0.01, lr_decay=0.0, weight_decay=0.0, eps=1e-10)),
    "SGD": (_sgd_init, _sgd_update, dict(lr=0.01, momentum=0.0, weight_decay=0.0, nesterov=0.0)),
}
_UNPORTED = ("Adam", "RMSprop", "Adadelta")


def _rule(name: str):
    if name in _UNPORTED:
        raise _not_ported(f"the {name} optimizer")
    if name not in _RULES:
        raise ValueError(f"unknown optimizer {name!r}")
    return _RULES[name]


def _phase_hparams(opt_name: str, phase: Dict) -> Dict[str, float]:
    """Full hyperparameter dict for one regime phase (defaults + overrides)."""
    hp = dict(_rule(opt_name)[2])
    for k, v in phase.items():
        if k in ("optimizer", "epoch", "step", "match"):
            continue
        if k == "nesterov":
            hp["nesterov"] = 1.0 if v else 0.0
        elif k in hp:
            hp[k] = float(v)
    return hp


# ------------------------------------------------------------ param labels


def leaves(tree: Dict[str, Any], prefix: str = ""):
    """(slash-joined path, leaf) of every leaf of a nested dict."""
    for key, leaf in tree.items():
        path = f"{prefix}{key}"
        if isinstance(leaf, dict):
            yield from leaves(leaf, path + "/")
        else:
            yield path, leaf


def _map_leaves(fn, tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}{key}"
        out[key] = _map_leaves(fn, leaf, path + "/") if isinstance(leaf, dict) else fn(path, leaf)
    return out


def assign_regimes(params: Params, regime_matches: Sequence[Optional[str]],
                   frozen_patterns: Sequence[str] = ()) -> Dict[str, Any]:
    """Nested dict of int regime indices per leaf (-1 = not optimized): each
    leaf goes to the first regime whose ``match`` regex hits its
    slash-joined path (None matches everything); leaves matching a frozen
    pattern are never optimized."""

    def label(path, _leaf):
        if any(re.search(p, path) is not None for p in frozen_patterns):
            return -1
        for i, pattern in enumerate(regime_matches):
            if pattern is None or re.search(pattern, path) is not None:
                return i
        return -1

    return _map_leaves(label, params)


# ----------------------------------------------------------------- regimes


class OptimizerRegimes:
    """A set of per-param-group phase-switched optimizers."""

    def __init__(self, optimization_config, lr_scheduler_config=None, frozen_patterns=None):
        if isinstance(optimization_config, dict):
            optimization_config = [optimization_config]
        self.regimes: List[List[Dict]] = []
        self.matches: List[Optional[str]] = []
        for rc in optimization_config:
            phases = [dict(p) for p in (rc if isinstance(rc, list) else [rc])]
            # only the first phase starts at once; later phases keep their own triggers
            if phases and "epoch" not in phases[0] and "step" not in phases[0]:
                phases[0]["epoch"] = 0
            self.regimes.append(phases)
            self.matches.append(phases[0].get("match"))
        if lr_scheduler_config and any(lr_scheduler_config if isinstance(lr_scheduler_config, list)
                                       else [lr_scheduler_config]):
            raise _not_ported("lr_scheduler_config")
        self.current_phase: List[Optional[int]] = [None] * len(self.regimes)
        self.lr_scale = [1.0] * len(self.regimes)
        self._plateau_state = [None] * len(self.regimes)
        self.frozen_patterns: List[str] = list(frozen_patterns or [])

    # -- host-side phase logic

    def phase_for(self, ri: int, epoch: int, steps: int) -> int:
        phases = self.regimes[ri]
        current = self.current_phase[ri]
        if current is None:
            # initial scan (e.g. a resume without host state): the LAST phase
            # whose trigger has passed
            current = 0
            for i, ph in enumerate(phases):
                if epoch >= ph.get("epoch", float("inf")) or steps >= ph.get("step", float("inf")):
                    current = i
        if current + 1 < len(phases):
            nxt = phases[current + 1]
            if epoch >= nxt.get("epoch", float("inf")) or steps >= nxt.get("step", float("inf")):
                current += 1
        return current

    def update(self, epoch: int, steps: int) -> bool:
        """Advance phases; True if an optimizer *type* changed (the caller
        resets that state and rebuilds the step)."""
        type_changed = False
        for ri in range(len(self.regimes)):
            new_phase = self.phase_for(ri, epoch, steps)
            old = self.current_phase[ri]
            if old is None or new_phase != old:
                if old is not None and self.opt_name(ri, new_phase) != self.opt_name(ri, old):
                    type_changed = True
                if old is not None:
                    logger.info("OPTIMIZER regime %d phase -> %s", ri, self.regimes[ri][new_phase])
                self.current_phase[ri] = new_phase
        return type_changed

    def opt_name(self, ri: int, phase: Optional[int] = None) -> str:
        phase = self.current_phase[ri] if phase is None else phase
        phases = self.regimes[ri]
        for i in range(phase if phase is not None else 0, -1, -1):
            if "optimizer" in phases[i]:
                return phases[i]["optimizer"]
        return "Adam"  # the reference's default placeholder

    def opt_names(self) -> List[str]:
        return [self.opt_name(ri) for ri in range(len(self.regimes))]

    def hparams(self) -> List[HParams]:
        """Each regime's hyperparameters: later phases override earlier
        settings and inherit the rest."""
        out = []
        for ri in range(len(self.regimes)):
            merged: Dict = {}
            for ph in self.regimes[ri][: (self.current_phase[ri] or 0) + 1]:
                merged.update(ph)
            hp = _phase_hparams(self.opt_name(ri), merged)
            hp["lr"] *= self.lr_scale[ri]
            out.append(hp)
        return out

    # -- state and updates

    def init_state(self, params: Params) -> Dict[str, Any]:
        labels = assign_regimes(params, self.matches, self.frozen_patterns)
        names = self.opt_names()
        flat_labels = dict(leaves(labels))
        return _map_leaves(lambda path, p: {} if flat_labels[path] < 0 else _rule(names[flat_labels[path]])[0](p),
                           params)

    def make_apply(self, params_example: Params, grad_clip: Optional[float] = None):
        """``apply(grads, state, params, hparams) -> (params, state)``, with
        the updates in place; leaves without a gradient are left alone."""
        flat_labels = dict(leaves(assign_regimes(params_example, self.matches, self.frozen_patterns)))
        names = self.opt_names()

        def apply(grads, state, params, hparams: List[HParams]):
            if grad_clip is not None and grad_clip > 0:
                grads = clip_by_global_norm(grads, grad_clip)

            def upd(path, p):
                lbl = flat_labels[path]
                node = _get(state, path)
                g = _get(grads, path)
                if lbl < 0 or g is None:
                    return p, node
                return _rule(names[lbl])[1](g, node, p, hparams[lbl])

            out = _map_leaves(upd, params)
            new_params = _map_leaves(lambda _p, t: t[0], out)
            new_state = _map_leaves(lambda _p, t: t[1], out)
            return new_params, new_state

        return apply

    # -- checkpointing

    def host_state(self) -> Dict:
        return {
            "current_phase": list(self.current_phase),
            "lr_scale": list(self.lr_scale),
            "plateau": [dict(s) if s else None for s in self._plateau_state],
            "regimes": self.regimes,
        }

    def load_host_state(self, d: Dict, reset: bool = False) -> None:
        self.regimes = d.get("regimes", self.regimes)
        if not reset:
            self.current_phase = d["current_phase"]
            self.lr_scale = d["lr_scale"]
            self._plateau_state = d["plateau"]


def _get(tree: Dict[str, Any], path: str):
    node = tree
    for key in path.split("/"):
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def clip_by_global_norm(grads: Dict[str, Any], max_norm: float) -> Dict[str, Any]:
    """Scale every gradient by ``min(1, max_norm / (‖g‖ + 1e-6))``, the norm
    taken over all leaves together."""
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for _, g in leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return _map_leaves(lambda _p, g: g * scale, grads)
