"""V(x) = V0·((x/η)² − 1)² with the kink background x_cl(t, ω) =
η·tanh(√(2V0/m)·(t − ω)/η) and the collective coordinate's zero-mode
normalisation √3·2^(−5/4)·V0^(−1/4)/√η (the reference solver's ``pot`` 3).
Expressions in the operand order the port's float32 program uses."""

import math

import torch


class Action:
    has_zero_mode = True

    def __init__(self, v0=2.0, eta=0.8, mass=1.0):
        self.v0, self.eta, self.mass = v0, eta, mass

    def dV(self, x, div):
        e2 = self.eta * self.eta
        return div(4.0 * self.v0 * x * (x * x - e2), e2 * e2)

    def ddV(self, x, div):
        e2 = self.eta * self.eta
        return div(div(12.0 * self.v0 * x * x, e2) - 4.0 * self.v0, e2)

    def x_cl(self, t, omega):
        w = math.sqrt(2.0 * self.v0 / self.mass) / self.eta
        return self.eta * torch.tanh(w * (t - omega))

    def asymptote(self, side):
        return side * self.eta

    def zero_mode_const(self):
        return math.sqrt(3.0) * 2.0 ** (-5.0 / 4.0) * self.v0 ** (-1.0 / 4.0) / math.sqrt(self.eta)
