"""Per-group AdamW with the JAX package's update (counterpart of
cartseg_tpu/train/optim.py:40-72).

Each parameter carries a group id (encoder=0, decoder=1, head=2); the
step takes per-group learning rates and active flags:

    mu <- a*(b1*mu + (1-b1)*g) + (1-a)*mu
    nu <- a*(b2*nu + (1-b2)*g*g) + (1-a)*nu
    p  <- p - a*lr*(mu_hat / (sqrt(nu_hat) + eps) + wd*p)

with per-group step counts t (bias corrections 1 - b^t). A group whose
host-side active flag is 0 (a frozen encoder) is left untouched:
parameters, moments and count, as torch with requires_grad=False. The
finite-loss gate `ok` of the train step is a device tensor multiplied
into a, so skipping a bad batch costs no host sync.

The port updates parameters and moments in place (torch._foreach ops,
a few launches per group) where JAX returns new trees.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

GROUP_IDS = {"encoder": 0, "decoder": 1, "head": 2}


@dataclasses.dataclass
class AdamWState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor  # [3] int32 per-group step counts, on the device

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @classmethod
    def from_state_dict(cls, sd: dict, device) -> "AdamWState":
        return cls(mu={k: v.to(device) for k, v in sd["mu"].items()},
                   nu={k: v.to(device) for k, v in sd["nu"].items()},
                   count=sd["count"].to(device))


def init_adamw(params: Dict[str, torch.Tensor]) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(
        mu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        count=torch.zeros((3,), dtype=torch.int32, device=dev))


def group_ids(labels: Dict[str, str]) -> Dict[str, int]:
    """Parameter name -> label ('encoder'|'decoder'|'head') -> int id."""
    return {k: GROUP_IDS[v] for k, v in labels.items()}


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 gids: Dict[str, int], lrs: Sequence[float],
                 active: Sequence[float], weight_decay: float,
                 ok: Optional[torch.Tensor] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> AdamWState:
    """In place on `params` and `state`. lrs, active: per-group host
    floats (active in {0, 1}); ok: optional 0-dim float32 device tensor
    in {0, 1} (the finite-loss gate)."""
    for g in range(3):
        if active[g] == 0.0:
            continue
        names = [k for k, i in gids.items() if i == g]
        if not names:
            continue
        a = 1.0 if ok is None else ok
        state.count[g] += 1 if ok is None else ok.to(torch.int32)
        t = torch.clamp(state.count[g].to(torch.float32), min=1.0)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        p = [params[k] for k in names]
        gr = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]

        mu2 = torch._foreach_mul(mu, b1)
        torch._foreach_add_(mu2, torch._foreach_mul(gr, 1 - b1))
        sq = torch._foreach_mul(gr, 1 - b2)
        torch._foreach_mul_(sq, gr)
        nu2 = torch._foreach_mul(nu, b2)
        torch._foreach_add_(nu2, sq)
        if ok is not None:
            for new, old in ((mu2, mu), (nu2, nu)):
                torch._foreach_mul_(new, a)
                torch._foreach_add_(new, torch._foreach_mul(old, 1 - a))
        den = torch._foreach_div(nu2, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        step = torch._foreach_div(mu2, bc1)
        torch._foreach_div_(step, den)
        torch._foreach_add_(step, torch._foreach_mul(p, weight_decay))
        torch._foreach_mul_(step, a * lrs[g])
        torch._foreach_sub_(p, step)
        for k, m, v in zip(names, mu2, nu2):
            state.mu[k], state.nu[k] = m, v
    return state
