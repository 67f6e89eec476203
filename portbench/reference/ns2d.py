"""Plain reference of part 2's thermal convection (FinalProjectRepo.jl
scripts-part2/part2.jl), written apart from the program under test.

    dT/dt = k lap T - (v . grad) T
    dW/dt = Pr lap W - (v . grad) W - Pr Ra dT/dx
    lap S = W,   (vx, vy) = (dS/dy, -dS/dx)

on a (ny, nx) vertex grid of spacing h = 1/(ny - 1), x last.  A step solves
for S first, takes dt from the velocity maxima (dt_dif = a_dif h^2 /
max(k, Pr), dt_adv = a_adv min(h/max|vx|, h/max|vy|); the smaller of the two
for beta < 0.5, dt_adv alone otherwise), applies T's boundary conditions
(1 on row 0, 0 on the last row, then each side column a copy of its
neighbour), and advances T and W with central diffusion and buoyancy and
first-order upwind advection: explicit Euler for beta = 0, the theta method
otherwise, whose two Helmholtz problems (lap - c) u = rhs are solved here.

Every linear problem is solved exactly, not iterated: the 5-point operator
on the interior is diagonal in a sine basis along a side with fixed
(Dirichlet) values and in a cosine basis along a side whose boundary cell
copies its neighbour, so a solve is four dense products with orthonormal
bases and one division.  S and W keep their boundary values; T's solve
takes its boundary conditions as above.

Steps run while the simulated time is below ttot.  Nothing is read to the
host inside the loop: a step that starts at or past ttot leaves the state
as it is, and the loop stops once a block of steps has found it so.

``store_dtype`` rounds T, W and S to a lower precision after every step
(the control of the benchmark's comparison); ``dtype`` is the arithmetic's.
This module imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sine_basis(m: int, dtype, device):
    """(Q, lam): the orthonormal eigenvectors (columns) and eigenvalues of
    the second difference on m interior points between two fixed ends."""
    j = torch.arange(1, m + 1, dtype=torch.float64)
    Q = math.sqrt(2.0 / (m + 1)) * torch.sin(math.pi * torch.outer(j, j) / (m + 1))
    lam = -4.0 * torch.sin(math.pi * j / (2.0 * (m + 1))) ** 2
    return Q.to(dtype=dtype, device=device), lam.to(dtype=dtype, device=device)


def cosine_basis(m: int, dtype, device):
    """(Q, lam) of the second difference on m points whose end points copy
    their neighbour (u[-1] = u[0], u[m] = u[m-1])."""
    i = torch.arange(m, dtype=torch.float64) + 0.5
    k = torch.arange(m, dtype=torch.float64)
    w = torch.full((m,), math.sqrt(2.0 / m), dtype=torch.float64)
    w[0] = math.sqrt(1.0 / m)
    Q = torch.cos(math.pi * torch.outer(i, k) / m) * w
    lam = -4.0 * torch.sin(math.pi * k / (2.0 * m)) ** 2
    return Q.to(dtype=dtype, device=device), lam.to(dtype=dtype, device=device)


def cosine_init(p: dict) -> np.ndarray:
    """T = (1 + cos(3 pi x / width)) / 2 with x = i h (the COSINE scheme)."""
    ny, nx = int(p["ny"]), int(p["nx"])
    h, width = 1.0 / (ny - 1), (nx - 1.0) / (ny - 1.0)
    row = 0.5 * (1.0 + np.cos(3.0 * np.pi * np.arange(nx) * h / width))
    return np.ascontiguousarray(np.broadcast_to(row, (ny, nx)))


class Convection:
    """The reference model for one configuration.

    p: the configuration's numbers (nx, ny, Ra, Pr, k, beta, ttot, a_dif,
    a_adv).  device, dtype: where and in what precision it computes."""

    def __init__(self, p: dict, device="cpu", dtype=torch.float64, store_dtype=None):
        self.p, self.device, self.dtype, self.store_dtype = p, torch.device(device), dtype, \
            store_dtype
        ny, nx = int(p["ny"]), int(p["nx"])
        self.h = 1.0 / (ny - 1)
        self.Qy, ly = sine_basis(ny - 2, dtype, device)
        self.Qx, lx = sine_basis(nx - 2, dtype, device)
        self.Qc, lc = cosine_basis(nx - 2, dtype, device)
        h2 = self.h * self.h
        self.lam_dir = (ly[:, None] + lx[None, :]) / h2
        self.lam_tmp = (ly[:, None] + lc[None, :]) / h2

    # -- the solves -------------------------------------------------------

    def solve_fixed(self, f_int, c, bnd):
        """(lap - c) u = f on the interior with u = bnd on the boundary; the
        whole (ny, nx) field, boundary from bnd."""
        r = f_int.clone()
        h2 = self.h * self.h
        r[0, :] -= bnd[0, 1:-1] / h2
        r[-1, :] -= bnd[-1, 1:-1] / h2
        r[:, 0] -= bnd[1:-1, 0] / h2
        r[:, -1] -= bnd[1:-1, -1] / h2
        hat = self.Qy.T @ r @ self.Qx
        u = bnd.clone()
        u[1:-1, 1:-1] = self.Qy @ (hat / (self.lam_dir - c)) @ self.Qx.T
        return u

    def temperature_bcs(self, T):
        T = T.clone()
        T[0] = 1.0
        T[-1] = 0.0
        T[:, 0] = T[:, 1]
        T[:, -1] = T[:, -2]
        return T

    def solve_temperature(self, f_int, c):
        """(lap - c) T = f on the interior under T's boundary conditions."""
        r = f_int.clone()
        r[0, :] -= 1.0 / (self.h * self.h)
        hat = self.Qy.T @ r @ self.Qc
        T = torch.zeros((r.shape[0] + 2, r.shape[1] + 2), dtype=r.dtype, device=r.device)
        T[1:-1, 1:-1] = self.Qy @ (hat / (self.lam_tmp - c)) @ self.Qc.T
        return self.temperature_bcs(T)

    # -- one step ---------------------------------------------------------

    def step(self, T, W, S):
        """(T', W', S', dt) of one step from (T, W, S)."""
        p, h = self.p, self.h
        k, Pr, Ra, beta = float(p["k"]), float(p["Pr"]), float(p["Ra"]), float(p["beta"])
        S = self.solve_fixed(W[1:-1, 1:-1], 0.0, torch.zeros_like(W))
        vx = (S[2:, 1:-1] - S[:-2, 1:-1]) / (2.0 * h)
        vy = -(S[1:-1, 2:] - S[1:-1, :-2]) / (2.0 * h)
        ax, ay = vx.abs().max(), vy.abs().max()
        dt_dif = torch.full((), float(p["a_dif"]) * h * h / max(k, Pr), dtype=T.dtype,
                            device=T.device)
        dt_adv = float(p["a_adv"]) * torch.minimum(h / ax, h / ay)
        dt = dt_adv if beta >= 0.5 else torch.minimum(dt_dif, dt_adv)
        dt = torch.where((ax == 0) & (ay == 0), dt_dif, dt)

        T = self.temperature_bcs(T)
        I = (slice(1, -1), slice(1, -1))

        def lap(F):
            return (F[1:-1, 2:] + F[1:-1, :-2] + F[2:, 1:-1] + F[:-2, 1:-1] - 4.0 * F[I]) / (h * h)

        def advect(F):
            Fi = F[I]
            ddx = torch.where(vx > 0, Fi - F[1:-1, :-2], F[1:-1, 2:] - Fi) / h
            ddy = torch.where(vy > 0, Fi - F[:-2, 1:-1], F[2:, 1:-1] - Fi) / h
            return vx * ddx + vy * ddy

        buoy = Pr * Ra * (T[1:-1, 2:] - T[1:-1, :-2]) / (2.0 * h)
        if beta == 0.0:
            T2, W2 = T.clone(), W.clone()
            T2[I] = T[I] + dt * (k * lap(T) - advect(T))
            W2[I] = W[I] + dt * (Pr * lap(W) - advect(W) - buoy)
            return T2, W2, S, dt
        cT = 1.0 / (beta * dt)
        cW = cT / Pr
        rT = -cT * (T[I] + dt * ((1.0 - beta) * k * lap(T) - advect(T)))
        rW = -cW * (W[I] + dt * ((1.0 - beta) * Pr * lap(W) - advect(W) - buoy))
        return self.solve_temperature(rT, cT), self.solve_fixed(rW, cW, W), S, dt

    # -- the run ----------------------------------------------------------

    def run(self, W0, T0, block: int = 64, neighbours: bool = False) -> dict:
        """Steps from (T0, W0) until the simulated time reaches ttot.
        Returns T, W, S (float64 numpy), steps and sim_time; with
        ``neighbours`` also "prev" and "next", the same of the state one
        step before the last and one step after it."""
        dev, dt_ = self.device, self.dtype
        T = torch.as_tensor(np.asarray(T0, dtype=np.float64)).to(dev, dt_)
        W = torch.as_tensor(np.asarray(W0, dtype=np.float64)).to(dev, dt_)
        S = torch.zeros_like(W)
        t = torch.zeros((), dtype=torch.float64, device=dev)
        n = torch.zeros((), dtype=torch.int64, device=dev)
        prev = (T, W, S, t)
        ttot = float(self.p["ttot"])

        def advance(T, W, S, t):
            T2, W2, S2, dt = self.step(T, W, S)
            if self.store_dtype is not None:
                T2, W2, S2 = (x.to(self.store_dtype).to(dt_) for x in (T2, W2, S2))
            return T2, W2, S2, t + dt.to(torch.float64)

        while True:
            for _ in range(block):
                live = t < ttot
                new = advance(T, W, S, t)
                if neighbours:
                    prev = tuple(torch.where(live, a, b) for a, b in zip((T, W, S, t), prev))
                T, W, S, t = (torch.where(live, a, b) for a, b in zip(new, (T, W, S, t)))
                n = n + live.to(torch.int64)
            if not bool(t < ttot):
                break

        def host(T, W, S, t, steps):
            return dict(T=T.double().cpu().numpy(), W=W.double().cpu().numpy(),
                        S=S.double().cpu().numpy(), steps=steps, sim_time=float(t))

        out = host(T, W, S, t, int(n))
        if neighbours:
            out["prev"] = host(*prev, int(n) - 1)
            out["next"] = host(*advance(T, W, S, t), int(n) + 1)
        return out
