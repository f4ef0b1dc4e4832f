"""Optimizer regimes with torch-matching update rules.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/optim.py``: a
list of phase dicts ``{'epoch'/'step', 'optimizer', 'lr', ...}`` switched
during training, with independent regimes selected by a parameter-path
regex ``match`` (per-parameter-group optimizers) and frozen patterns.

The rules follow torch.optim's arithmetic as the JAX package writes it:
Adagrad (lr_decay, eps, additive weight decay; the dense update of every
leaf of a regime group is one
:func:`..ops.adagrad_kernel.adagrad_update_leaves` call, one CUDA launch on
the card), SGD (momentum, nesterov), Adam, RMSprop (momentum) and Adadelta,
the last three plain PyTorch on the card as they are plain XLA in JAX.
Their scalar coefficients (``1 - beta1`` and the like) are formed in f32, as
JAX forms them from its f32 hyperparameters.  The lr schedulers are
host-side: ReduceLROnPlateau and eight epoch-indexed closed forms scale a
regime's learning rate, which reaches every update through
:meth:`OptimizerRegimes.hparams` on each call (no device copy of it is
kept).

Optimizer state is a nested dict parallel to the params, ``{"sum",
"step"}`` (Adagrad), ``{"momentum", "step"}`` (SGD), ``{"m", "v",
"step"}`` (Adam), ``{"sq", "momentum", "step"}`` (RMSprop), ``{"sq",
"acc_delta", "step"}`` (Adadelta) per optimized leaf and ``{}`` per frozen
one, with the JAX names, so checkpoints carry it both ways.  The updates run
in place on the parameters.
"""

from __future__ import annotations

import ast
import logging
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import adagrad_update_leaves

logger = logging.getLogger(__name__)

Params = Dict[str, Any]
HParams = Dict[str, float]


def safe_eval_lr_lambda(expr: str, epoch: float) -> float:
    """A LambdaLR factor expression of ``epoch`` (e.g. ``"0.95 ** epoch"``,
    the config's stand-in for torch's ``lr_lambda`` callable) evaluated
    without ``eval``: the AST may hold only numeric literals, ``epoch``,
    ``pi``, ``e``, arithmetic and one-operator comparisons, conditional
    expressions and a whitelist of ``math`` functions (also spelled
    ``math.<name>``); anything else raises ``ValueError``."""
    funcs = {"exp": math.exp, "log": math.log, "log2": math.log2, "log10": math.log10, "sqrt": math.sqrt,
             "cos": math.cos, "sin": math.sin, "tan": math.tan, "floor": math.floor, "ceil": math.ceil,
             "pow": math.pow, "min": min, "max": max, "abs": abs}
    consts = {"epoch": float(epoch), "pi": math.pi, "e": math.e}
    binops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b, ast.Mult: lambda a, b: a * b,
              ast.Div: lambda a, b: a / b, ast.FloorDiv: lambda a, b: a // b, ast.Mod: lambda a, b: a % b,
              ast.Pow: lambda a, b: a ** b}
    cmpops = {ast.Lt: lambda a, b: a < b, ast.LtE: lambda a, b: a <= b, ast.Gt: lambda a, b: a > b,
              ast.GtE: lambda a, b: a >= b, ast.Eq: lambda a, b: a == b, ast.NotEq: lambda a, b: a != b}

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float, bool)):
                return node.value
            raise ValueError(f"non-numeric literal {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in consts:
                return consts[node.id]
            raise ValueError(f"unknown name {node.id!r}")
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "math":
                if node.attr in funcs:
                    return funcs[node.attr]
                if node.attr in ("pi", "e"):
                    return getattr(math, node.attr)
            raise ValueError("attribute access not allowed in lr_lambda")
        if isinstance(node, ast.BinOp) and type(node.op) in binops:
            return binops[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return -ev(node.operand)
            if isinstance(node.op, ast.UAdd):
                return +ev(node.operand)
            raise ValueError("unsupported unary op in lr_lambda")
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            if type(node.ops[0]) in cmpops:
                return cmpops[type(node.ops[0])](ev(node.left), ev(node.comparators[0]))
            raise ValueError("unsupported comparison in lr_lambda")
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id in funcs:
                fn = funcs[node.func.id]
            elif isinstance(node.func, ast.Attribute):
                fn = ev(node.func)
            else:
                raise ValueError("only whitelisted math calls allowed")
            if node.keywords:
                raise ValueError("keyword arguments not allowed in lr_lambda")
            return fn(*[ev(a) for a in node.args])
        raise ValueError(f"disallowed syntax in lr_lambda: {type(node).__name__}")

    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as exc:
        raise ValueError(f"invalid lr_lambda expression: {exc}") from exc
    return float(ev(tree))


# ------------------------------------------------------------- update rules


def _f32(x) -> float:
    """``x`` rounded to f32 (an exact f32 value as a Python float)."""
    return float(np.float32(x))


def _one_minus(x) -> float:
    """``1 - x`` in f32, as JAX forms it from an f32 hyperparameter."""
    return float(np.float32(1.0) - np.float32(x))


def _step0(p):
    return torch.zeros((), dtype=torch.float32, device=p.device)


def _adagrad_init(p):
    return {"sum": torch.zeros_like(p), "step": _step0(p)}


def _adagrad_update_group(gs, states, ps, hp):
    """The dense Adagrad step of a regime group's leaves; their new states."""
    steps = adagrad_update_leaves([g.contiguous() for g in gs], ps, [s["sum"] for s in states],
                                  [s["step"] for s in states], hp)
    return [{"sum": s["sum"], "step": step} for s, step in zip(states, steps)]


def _sgd_init(p):
    return {"momentum": torch.zeros_like(p), "step": _step0(p)}


def _sgd_update(g, s, p, hp):
    g = g + hp["weight_decay"] * p
    buf = hp["momentum"] * s["momentum"] + g
    if hp["momentum"] > 0:  # momentum == 0: plain SGD (torch skips the buffer)
        g = g + hp["momentum"] * buf if hp["nesterov"] > 0 else buf
    p.sub_(hp["lr"] * g)
    return p, {"momentum": buf, "step": s["step"] + 1.0}


def _adam_init(p):
    return {"m": torch.zeros_like(p), "v": torch.zeros_like(p), "step": _step0(p)}


def _adam_update(g, s, p, hp):
    step = s["step"] + 1.0
    g = g + _f32(hp["weight_decay"]) * p
    b1, b2 = _f32(hp["beta1"]), _f32(hp["beta2"])
    m = b1 * s["m"] + _one_minus(b1) * g
    v = b2 * s["v"] + _one_minus(b2) * g * g
    m_hat = m / (1.0 - torch.pow(b1, step))
    v_hat = v / (1.0 - torch.pow(b2, step))
    p.sub_(_f32(hp["lr"]) * m_hat / (torch.sqrt(v_hat) + _f32(hp["eps"])))
    return p, {"m": m, "v": v, "step": step}


def _rmsprop_init(p):
    return {"sq": torch.zeros_like(p), "momentum": torch.zeros_like(p), "step": _step0(p)}


def _rmsprop_update(g, s, p, hp):
    g = g + _f32(hp["weight_decay"]) * p
    alpha, mom, lr = _f32(hp["alpha"]), _f32(hp["momentum"]), _f32(hp["lr"])
    sq = alpha * s["sq"] + _one_minus(alpha) * g * g
    avg = torch.sqrt(sq) + _f32(hp["eps"])
    buf = mom * s["momentum"] + g / avg
    p.sub_(lr * buf if mom > 0 else lr * g / avg)
    return p, {"sq": sq, "momentum": buf, "step": s["step"] + 1.0}


def _adadelta_init(p):
    return {"sq": torch.zeros_like(p), "acc_delta": torch.zeros_like(p), "step": _step0(p)}


def _adadelta_update(g, s, p, hp):
    g = g + _f32(hp["weight_decay"]) * p
    rho, eps = _f32(hp["rho"]), _f32(hp["eps"])
    sq = rho * s["sq"] + _one_minus(rho) * g * g
    delta = torch.sqrt(s["acc_delta"] + eps) / torch.sqrt(sq + eps) * g
    acc_delta = rho * s["acc_delta"] + _one_minus(rho) * delta * delta
    p.sub_(_f32(hp["lr"]) * delta)
    return p, {"sq": sq, "acc_delta": acc_delta, "step": s["step"] + 1.0}


# (init, update, defaults); Adagrad's update takes a whole regime group at
# once: (grads, states, params, hparams) -> states
_RULES: Dict[str, Tuple[Callable, Callable, Dict[str, float]]] = {
    "Adagrad": (_adagrad_init, _adagrad_update_group, dict(lr=0.01, lr_decay=0.0, weight_decay=0.0, eps=1e-10)),
    "Adam": (_adam_init, _adam_update, dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)),
    "SGD": (_sgd_init, _sgd_update, dict(lr=0.01, momentum=0.0, weight_decay=0.0, nesterov=0.0)),
    "RMSprop": (_rmsprop_init, _rmsprop_update, dict(lr=0.01, alpha=0.99, eps=1e-8, weight_decay=0.0,
                                                     momentum=0.0)),
    "Adadelta": (_adadelta_init, _adadelta_update, dict(lr=1.0, rho=0.9, eps=1e-6, weight_decay=0.0)),
}


def _rule(name: str):
    if name not in _RULES:
        raise ValueError(f"unknown optimizer {name!r}")
    return _RULES[name]


def _phase_hparams(opt_name: str, phase: Dict) -> Dict[str, float]:
    """Full hyperparameter dict for one regime phase (defaults + overrides)."""
    hp = dict(_rule(opt_name)[2])
    for k, v in phase.items():
        if k in ("optimizer", "epoch", "step", "match"):
            continue
        if k == "betas":
            hp["beta1"], hp["beta2"] = float(v[0]), float(v[1])
        elif k == "nesterov":
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
        if lr_scheduler_config is None:
            lr_scheduler_config = [None] * len(self.regimes)
        elif isinstance(lr_scheduler_config, dict):
            lr_scheduler_config = [lr_scheduler_config]
        self.lr_scheduler_config = lr_scheduler_config
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

    # -- lr schedulers: stepped at each validation with (metric, epoch)

    SCHEDULERS = ("ReduceLROnPlateau", "StepLR", "MultiStepLR", "ExponentialLR", "CosineAnnealingLR",
                  "CosineAnnealingWarmRestarts", "LinearLR", "PolynomialLR", "LambdaLR")

    def lr_scheduler_step(self, metric_value: float, greater_is_better: bool = True,
                          epoch: Optional[int] = None) -> None:
        """Step each regime's scheduler: ReduceLROnPlateau scales its lr by
        ``factor`` after more than ``patience`` evals without improvement;
        the epoch-indexed ones set the scale to torch's closed form at
        ``epoch``."""
        for ri, cfg in enumerate(self.lr_scheduler_config):
            if not cfg:
                continue
            kind = cfg.get("lr_scheduler")
            if kind == "ReduceLROnPlateau":
                factor = float(cfg.get("factor", 0.1))
                patience = int(cfg.get("patience", 10))
                st = self._plateau_state[ri] or {"best": None, "bad": 0}
                better = st["best"] is None or (
                    metric_value > st["best"] if greater_is_better else metric_value < st["best"])
                if better:
                    st["best"], st["bad"] = metric_value, 0
                else:
                    st["bad"] += 1
                    if st["bad"] > patience:
                        self.lr_scale[ri] *= factor
                        st["bad"] = 0
                        logger.info("ReduceLROnPlateau: regime %d lr_scale -> %g", ri, self.lr_scale[ri])
                self._plateau_state[ri] = st
            elif kind in self.SCHEDULERS:
                if epoch is None:
                    continue
                scale = self._closed_form(ri, kind, cfg, epoch)
                if scale != self.lr_scale[ri]:
                    self.lr_scale[ri] = scale
                    logger.info("%s: regime %d lr_scale -> %g", kind, ri, scale)
            elif kind:
                raise ValueError(f"unsupported lr_scheduler {kind!r} (supported: {', '.join(self.SCHEDULERS)})")

    def _closed_form(self, ri: int, kind: str, cfg: Dict, epoch: int) -> float:
        """torch's lr scale of an epoch-indexed scheduler at ``epoch``."""
        gamma = float(cfg.get("gamma", 0.1))
        if kind == "StepLR":
            return gamma ** (epoch // int(cfg.get("step_size", 1)))
        if kind == "MultiStepLR":
            return gamma ** sum(1 for m in sorted(cfg.get("milestones", [])) if epoch >= int(m))
        if kind == "ExponentialLR":
            return gamma ** epoch
        if kind in ("CosineAnnealingLR", "CosineAnnealingWarmRestarts"):
            # eta_min + (base - eta_min) * (1 + cos(pi t / T)) / 2; eta_min is an absolute lr
            base = self._base_lr(ri)
            eta_min = float(cfg.get("eta_min", 0.0))
            if kind == "CosineAnnealingLR":
                t, T = epoch, int(cfg.get("T_max", 50))
            else:
                t, T = epoch, int(cfg.get("T_0", 10))
                t_mult = int(cfg.get("T_mult", 1))
                while t >= T:
                    t -= T
                    T = T * t_mult if t_mult > 1 else T
            lr = eta_min + (base - eta_min) * (1 + math.cos(math.pi * t / T)) / 2
            return lr / base if base else 1.0
        if kind == "LinearLR":
            start = float(cfg.get("start_factor", 1.0 / 3.0))
            end = float(cfg.get("end_factor", 1.0))
            total = max(1, int(cfg.get("total_iters", 5)))
            return start + (end - start) * (min(epoch, total) / total)
        if kind == "PolynomialLR":
            total = max(1, int(cfg.get("total_iters", 5)))
            return (1.0 - min(epoch, total) / total) ** float(cfg.get("power", 1.0))
        expr = cfg.get("lr_lambda")  # LambdaLR: a factor expression of `epoch`
        if not expr:
            raise ValueError("LambdaLR needs an lr_lambda expression")
        return safe_eval_lr_lambda(expr, epoch)

    def _base_lr(self, ri: int) -> float:
        """The regime's current unscaled lr (merged over reached phases)."""
        merged: Dict = {}
        for ph in self.regimes[ri][: (self.current_phase[ri] or 0) + 1]:
            merged.update(ph)
        return float(merged.get("lr", 0.0))

    # -- state and updates

    def init_state(self, params: Params) -> Dict[str, Any]:
        labels = assign_regimes(params, self.matches, self.frozen_patterns)
        names = self.opt_names()
        flat_labels = dict(leaves(labels))
        return _map_leaves(lambda path, p: {} if flat_labels[path] < 0 else _rule(names[flat_labels[path]])[0](p),
                           params)

    def make_apply(self, params_example: Params, grad_clip: Optional[float] = None, sharded=(), group=None):
        """``apply(grads, state, params, hparams) -> (params, state)``, with
        the updates in place; leaves without a gradient are left alone.  The
        Adagrad leaves with a gradient are updated together, one
        ``adagrad_update_leaves`` call per regime (one launch on the card for
        up to ``MAX_LEAVES`` leaves; a row-sharded table's slab is a leaf
        like any other).  ``sharded`` / ``group``: the clip's global norm
        (:func:`clip_by_global_norm`)."""
        flat_labels = dict(leaves(assign_regimes(params_example, self.matches, self.frozen_patterns)))
        names = self.opt_names()

        def apply(grads, state, params, hparams: List[HParams]):
            if grad_clip is not None and grad_clip > 0:
                grads = clip_by_global_norm(grads, grad_clip, sharded, group)
            groups: Dict[int, List[Tuple[str, Any, Any, Any]]] = {}

            def upd(path, p):
                lbl = flat_labels[path]
                node = _get(state, path)
                g = _get(grads, path)
                if lbl < 0 or g is None:
                    return p, node
                if names[lbl] == "Adagrad":
                    groups.setdefault(lbl, []).append((path, g, node, p))
                    return p, node  # its new state comes from the group's update below
                return _rule(names[lbl])[1](g, node, p, hparams[lbl])

            out = _map_leaves(upd, params)
            grouped = {}
            for lbl, members in groups.items():
                paths, gs, nodes, ps = zip(*members)
                grouped.update(zip(paths, _adagrad_update_group(gs, nodes, ps, hparams[lbl])))
            new_params = _map_leaves(lambda _p, t: t[0], out)
            new_state = _map_leaves(lambda path, t: grouped.get(path, t[1]), out)
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


def clip_by_global_norm(grads: Dict[str, Any], max_norm: float, sharded=(), group=None) -> Dict[str, Any]:
    """Scale every gradient by ``min(1, max_norm / (‖g‖ + 1e-6))``, the norm
    taken over all leaves together.  The top-level keys in ``sharded`` are
    this rank's slabs of row-sharded leaves: their squares are summed over
    the slabs of ``group`` (each counted once), the others' are whole on
    every rank."""
    sq = [(g.float() ** 2).sum() for path, g in leaves(grads) if path.split("/", 1)[0] not in sharded]
    total = sum(sq) if sq else torch.zeros(())
    slab_sq = [(g.float() ** 2).sum() for path, g in leaves(grads) if path.split("/", 1)[0] in sharded]
    if slab_sq:
        from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import _all_reduce

        total = total + _all_reduce(torch.stack(slab_sq).sum().reshape(1), group)[0]
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return _map_leaves(lambda _p, g: g * scale, grads)
