"""BatchNorm with flax's running-statistics update (counterpart of the BN
semantics of cartseg_tpu/models/norm.py).

Train mode normalises with the biased batch variance in both
frameworks, and torch's momentum 0.1 is flax's 0.9. They differ in the
running variance: flax blends in the biased batch variance
(norm.py:113-118, flax.linen.BatchNorm), stock `nn.BatchNorm2d` the
unbiased one, n / (n - 1) times larger. `BatchNorm2d` here keeps
torch's fused kernel and corrects the running variance afterwards in
O(C): with rv0 the old value, u the unbiased and b = u (n-1)/n the
biased batch variance, torch stores r = (1-m) rv0 + m u, and flax's
value is (1-m) rv0 + m b = ((n-1) r + (1-m) rv0) / n.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance follows flax."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats
                and self.momentum is not None):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        # the op updates (and autograd may keep) its own copy r; the
        # buffer takes flax's value from r and the old value rv0
        r = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, r, self.weight, self.bias,
                         True, m, self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_var.mul_(1.0 - m).add_(r, alpha=n - 1).div_(n)
        return y
