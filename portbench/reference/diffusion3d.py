"""Plain reference of part 1's dual-time diffusion (FinalProjectRepo.jl
scripts-part1/part1_kernel_programming.jl), written apart from the program
under test; it imports nothing of it.

Each backward-Euler step of dH/dt = D lap H (H = 0 on the six faces) is
solved by pseudo-time iteration on the (nz, ny, nx) cell-centred grid, x
last, of spacing d = l / n:

    R     = (Htau - Ht) / dt - D lap Htau          (interior cells)
    Htau' = Htau - dtau R,   dtau = min(d)^2 / D / 8.1

with the faces kept at 0.  A physical step starts from Htau = Ht and runs
K iterations between tests until err = sqrt(sum R^2) dt / sqrt(nx ny nz)
<= tol, R of the test's last iteration, or until the count reaches
iter_max; then Ht <- Htau.  The initial field is 2 exp(-|x - centre|^2) at
the cell centres, 0 on the faces.

``DualTime.solve`` computes that exactly, in float64, without iterating:
the 7-point operator on the interior is diagonal in the orthonormal sine
basis of each axis, so mode k of Htau after n iterations is

    h* + a^n (ht - h*),  a = 1 - dtau/dt + dtau D lam,  h* = ht / (1 - dt D lam),

and mode k of the R that the n-th iteration reads is -D lam a^(n-1) ht
(lam < 0 the operator's eigenvalue).  err(n) falls with n, so the count of
a step is found by bisection over the multiples of K.  A solve is three
dense products per axis and direction, whatever the count.

``DualTime.iterate_solve`` runs the iteration itself, K iterations between
tests, with the field rounded to ``store_dtype`` after every iteration: the
control of the benchmark's comparison, in a precision below the
configuration's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.ns2d import sine_basis


def outer_steps(ttot: float, dt: float) -> int:
    """Physical steps of t in 0:dt:ttot-dt."""
    return max(0, math.floor((ttot - dt) / dt + 1e-12) + 1)


class DualTime:
    """The iteration of one grid.  p: nx, ny, nz, lx, ly, lz, D, dt, ttot,
    tol, iter_max, check_every."""

    def __init__(self, p: dict, device="cpu"):
        self.p, self.device = p, torch.device(device)
        self.n = [int(p["nz"]), int(p["ny"]), int(p["nx"])]
        self.d = [float(p["lz"]) / self.n[0], float(p["ly"]) / self.n[1],
                  float(p["lx"]) / self.n[2]]
        self.D, self.dt = float(p["D"]), float(p["dt"])
        self.dtau = min(self.d) ** 2 / self.D / 8.1
        self.n_all = self.n[0] * self.n[1] * self.n[2]
        self.nt = outer_steps(float(p["ttot"]), self.dt)
        self.tol, self.iter_max = float(p["tol"]), int(p["iter_max"])
        self.K = int(p.get("check_every", 1))

    def gaussian(self, dtype=torch.float64) -> torch.Tensor:
        axes = []
        for m, d in zip(self.n, self.d):
            L = m * d
            axes.append((torch.arange(m, dtype=torch.float64, device=self.device) + 0.5) * d
                        - L / 2)
        z, y, x = axes
        H = 2.0 * torch.exp(-(z[:, None, None] ** 2 + y[None, :, None] ** 2
                              + x[None, None, :] ** 2))
        H[0], H[-1], H[:, 0], H[:, -1], H[:, :, 0], H[:, :, -1] = 0, 0, 0, 0, 0, 0
        return H.to(dtype)

    # -- exact, in the sine basis -----------------------------------------

    def _bases(self):
        Q, lam = [], torch.zeros((), dtype=torch.float64, device=self.device)
        for axis, (m, d) in enumerate(zip(self.n, self.d)):
            q, l = sine_basis(m - 2, torch.float64, self.device)
            Q.append(q)
            shape = [1, 1, 1]
            shape[axis] = m - 2
            lam = lam + (l / (d * d)).reshape(shape)
        return Q, lam

    @staticmethod
    def _apply(X, Q, transpose: bool):
        """X with Q (or Q^T) applied along each of its three axes."""
        for axis in range(3):
            q = Q[axis].T if transpose else Q[axis]
            X = torch.tensordot(X, q, dims=([0], [0]))  # axis 0 becomes the last
        return X

    def solve(self) -> dict:
        """H (float64 numpy), iters (all steps), steps (per step) and
        converged, exactly."""
        Q, lam = self._bases()
        a = 1.0 - self.dtau / self.dt + self.dtau * self.D * lam
        g = self.D * lam.abs()
        scale = self.dt / math.sqrt(self.n_all)
        h = self._apply(self.gaussian()[1:-1, 1:-1, 1:-1], Q, transpose=False)
        jmax = -(-self.iter_max // self.K)
        steps, converged = [], True

        def err(j):
            return float(torch.sqrt(torch.sum((g * a.pow(j * self.K - 1) * h) ** 2))) * scale

        for _ in range(self.nt):
            if err(jmax) > self.tol:
                j = jmax
                converged = False
            else:
                lo, hi = 0, jmax  # err(lo) > tol (lo = 0: err is inf), err(hi) <= tol
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    if err(mid) <= self.tol:
                        hi = mid
                    else:
                        lo = mid
                j = hi
            n = j * self.K
            star = h / (1.0 - self.dt * self.D * lam)
            h = star + a.pow(n) * (h - star)
            steps.append(n)
        H = torch.zeros(self.n, dtype=torch.float64, device=self.device)
        H[1:-1, 1:-1, 1:-1] = self._apply(h, Q, transpose=True)
        return dict(H=H.cpu().numpy(), iters=sum(steps), steps=steps, converged=converged)

    # -- the iteration itself (the control) ---------------------------------

    def iterate(self, Ht, Htau, store_dtype=None):
        """(Htau', sum R^2) of one iteration, in Ht's dtype."""
        dz, dy, dx = self.d
        c = Htau[1:-1, 1:-1, 1:-1]
        R = (c - Ht[1:-1, 1:-1, 1:-1]) / self.dt
        for d, hi, lo in ((dx, Htau[1:-1, 1:-1, 2:], Htau[1:-1, 1:-1, :-2]),
                          (dy, Htau[1:-1, 2:, 1:-1], Htau[1:-1, :-2, 1:-1]),
                          (dz, Htau[2:, 1:-1, 1:-1], Htau[:-2, 1:-1, 1:-1])):
            second = hi + lo
            second -= 2.0 * c
            R -= (self.D / (d * d)) * second
            del second
        out = Htau.clone()
        out[1:-1, 1:-1, 1:-1] -= self.dtau * R
        if store_dtype is not None:
            out = out.to(store_dtype).to(Ht.dtype)
        return out, torch.sum(R * R)

    def iterate_solve(self, dtype=torch.float32, store_dtype=torch.bfloat16,
                      iter_max=None, block: int = 32) -> dict:
        """The iteration run as written, in dtype with the field rounded to
        store_dtype after every iteration; iter_max caps each step (the
        configuration's by default).  Reads the host once per block of
        tests."""
        iter_max = self.iter_max if iter_max is None else int(iter_max)
        Ht = self.gaussian(dtype)
        if store_dtype is not None:
            Ht = Ht.to(store_dtype).to(dtype)
        scale = self.dt / math.sqrt(self.n_all)
        steps, converged = [], True
        for _ in range(self.nt):
            Htau = Ht.clone()
            err = torch.full((), math.inf, dtype=torch.float64, device=self.device)
            it = torch.zeros((), dtype=torch.int64, device=self.device)
            while True:
                for _ in range(block):
                    live = (err > self.tol) & (it < iter_max)
                    new, s = Htau, None
                    for _ in range(self.K):
                        new, s = self.iterate(Ht, new, store_dtype)
                    Htau = torch.where(live, new, Htau)
                    err = torch.where(live, torch.sqrt(s.double()) * scale, err)
                    it = it + self.K * live.to(torch.int64)
                if not bool((err > self.tol) & (it < iter_max)):
                    break
            steps.append(int(it))
            converged = converged and bool(err <= self.tol)
            Ht = Htau
        return dict(H=Ht.double().cpu().numpy(), iters=sum(steps), steps=steps,
                    converged=converged)


def field_error(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the interior cells, over max |want| there."""
    g, w = got[1:-1, 1:-1, 1:-1], want[1:-1, 1:-1, 1:-1]
    return float(np.max(np.abs(g - w)) / max(float(np.max(np.abs(w))), 1e-300))
