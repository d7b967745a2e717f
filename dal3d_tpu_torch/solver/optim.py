"""Optimizer + OneCycle schedules (port of ``dal3d_tpu/solver/optim.py``).

The JAX package chains ``optax.clip_by_global_norm`` with ``optax.adamw``
whose learning rate and ``b1`` are injected per step from the OneCycle cosine
schedules. ``OneCycleAdamW`` writes that chain out:

- the clip scales every gradient by ``max_norm / norm`` when ``norm >=
  max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- both schedules are read at the count before the update (step 0 first);
- ``mu``/``nu`` moments with ``b2 = 0.99``; the bias corrections use the
  current ``b1`` and the incremented count; ``eps = 1e-8`` outside the root;
- decoupled weight decay on every parameter, BN scale and bias included;
- ``p <- p - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``.

``Adam`` is ``optax.adam`` with a constant learning rate (the estimator's
optimizer of the partial-label trainer): no clip, no weight decay.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class OneCycleSchedule:
    lr_max: float = 0.002
    moms: Tuple[float, float] = (0.95, 0.85)
    div_factor: float = 10.0
    pct_start: float = 0.4
    total_steps: int = 1000


def _annealing_cos(start: float, end: float, pct: float) -> float:
    cos_out = math.cos(math.pi * pct) + 1
    return end + (start - end) / 2 * cos_out


def _two_phase(cfg: OneCycleSchedule, up: Tuple[float, float],
               down: Tuple[float, float]) -> Callable[[int], float]:
    split = cfg.pct_start * cfg.total_steps

    def schedule(step: int) -> float:
        step = min(int(step), cfg.total_steps)
        if step < split:
            return _annealing_cos(*up, step / max(split, 1))
        pct2 = (step - split) / max(cfg.total_steps - split, 1)
        return _annealing_cos(*down, min(max(pct2, 0.0), 1.0))

    return schedule


def one_cycle_lr(cfg: OneCycleSchedule) -> Callable[[int], float]:
    low_lr = cfg.lr_max / cfg.div_factor
    return _two_phase(cfg, (low_lr, cfg.lr_max), (cfg.lr_max, low_lr / 1e4))


def one_cycle_momentum(cfg: OneCycleSchedule) -> Callable[[int], float]:
    return _two_phase(cfg, (cfg.moms[0], cfg.moms[1]), (cfg.moms[1], cfg.moms[0]))


class OneCycleAdamW:
    """AdamW + OneCycle lr / momentum + global-norm clipping over named
    parameters; ``init`` binds them and zeroes the state (optax's ``init``)."""

    def __init__(self, one_cycle: OneCycleSchedule, weight_decay: float = 0.01,
                 grad_clip_norm: Optional[float] = 35.0, b2: float = 0.99, eps: float = 1e-8):
        self.lr_fn = one_cycle_lr(one_cycle)
        self.mom_fn = one_cycle_momentum(one_cycle)
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.b2, self.eps = b2, eps
        self.count = 0
        self.params: Dict[str, torch.Tensor] = {}
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def init(self, named_params) -> "OneCycleAdamW":
        self.params = {n: p for n, p in named_params if p.requires_grad}
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        return self

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the ``.grad`` of every bound parameter (a missing
        one counts as zeros). Returns the global gradient norm taken before
        the clip, a 0-d tensor on the parameters' device."""
        names = list(self.params)
        params = [self.params[n] for n in names]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip_norm is not None:
            keep = norm < self.grad_clip_norm
            one = torch.ones_like(norm)
            # (g / norm) * max_norm where the clip bites, g where it does not
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip_norm))
        lr, b1, b2 = self.lr_fn(self.count), self.mom_fn(self.count), self.b2
        self.count += 1
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": {n: v.detach().cpu() for n, v in self.mu.items()},
                "nu": {n: v.detach().cpu() for n, v in self.nu.items()}}

    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.params) or set(state["nu"]) != set(self.params):
            raise KeyError("optimizer state does not match the bound parameters")
        self.count = int(state["count"])
        for n in self.params:
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])


class Adam:
    """``optax.adam(lr)`` over named parameters: ``mu <- b1 mu + (1 - b1) g``,
    ``nu <- b2 nu + (1 - b2) g^2``, bias corrections at the incremented
    count, ``p <- p - lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.params: Dict[str, torch.Tensor] = {}
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def init(self, named_params) -> "Adam":
        self.params = {n: p for n, p in named_params if p.requires_grad}
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        return self

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.eps)))


def build_optimizer(one_cycle: OneCycleSchedule, weight_decay: float = 0.01,
                    grad_clip_norm: Optional[float] = 35.0) -> OneCycleAdamW:
    """AdamW + OneCycle lr / momentum + global-norm clipping, not yet bound
    to parameters (``init`` binds them)."""
    return OneCycleAdamW(one_cycle, weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)
