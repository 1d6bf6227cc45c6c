"""V(x) = ½·μ²·x² + λ·x⁴, the λφ⁴ quartic oscillator: no background, no
zero mode.  Expressions in the operand order the port's float32 program uses."""

import torch


class Action:
    has_zero_mode = False

    def __init__(self, mu2=1.0, lam=1.0, mass=1.0):
        self.mu2, self.lam, self.mass = mu2, lam, mass

    def dV(self, x, div):
        return self.mu2 * x + 4.0 * self.lam * x * x * x

    def ddV(self, x, div):
        return self.mu2 + 12.0 * self.lam * x * x

    def x_cl(self, t, omega):
        return torch.zeros(torch.broadcast_shapes(t.shape, omega.shape), dtype=omega.dtype,
                           device=omega.device)

    def asymptote(self, side):
        return 0.0

    def zero_mode_const(self):
        return 0.0
