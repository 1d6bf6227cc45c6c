"""V(φ) = ½·m²·φ² + (λ/4!)·φ⁴ on a periodic D-dimensional lattice: the λφ⁴
field action of a field cell.  Expressions in the operand order the port's
float32 program uses: Python-float constants fold first (``lam / 6.0``,
``0.5 * m2``) and round once to the tensor's precision where they meet it."""

import torch


class Action:
    def __init__(self, m2=1.0, lam=1.0):
        self.m2, self.lam = m2, lam

    def V(self, phi):
        p2 = phi * phi
        return 0.5 * self.m2 * p2 + (self.lam / 24.0) * p2 * p2

    def dV(self, phi):
        return self.m2 * phi + (self.lam / 6.0) * phi * phi * phi

    def drift(self, phi, spacing: float, ndim: int):
        """∇²φ − V′(φ): the periodic nearest-neighbour Laplacian over the
        trailing ``ndim`` axes, summed from zero in axis order, times 1/a²."""
        inv_a2 = 1.0 / (spacing * spacing)
        lap = torch.zeros_like(phi)
        for d in range(phi.dim() - ndim, phi.dim()):
            lap = lap + (torch.roll(phi, 1, dims=d) + torch.roll(phi, -1, dims=d) - 2.0 * phi)
        return lap * inv_a2 - self.dV(phi)

    def action_density(self, phi, spacing: float, ndim: int):
        """Per-site action density: the forward-difference kinetic term plus V."""
        inv_a2 = 1.0 / (spacing * spacing)
        kin = torch.zeros_like(phi)
        for d in range(phi.dim() - ndim, phi.dim()):
            diff = torch.roll(phi, -1, dims=d) - phi
            kin = kin + 0.5 * diff * diff * inv_a2
        return kin + self.V(phi)
