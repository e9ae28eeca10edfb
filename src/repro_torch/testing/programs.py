"""The paper's 15 Benchpress benchmarks (Table I) on the port's lazy array
API — a copy of ``benchmarks/programs.py`` bound to ``repro_torch``.

Each entry is ``fn(iters, n) -> LazyArray-or-float`` recording one bytecode
tape per iteration (the merge-cache amortization unit, §IV-F).  The default
sizes are the reference's, scaled down for a CPU; :data:`CHIP_SIZES` gives
the sizes the port runs at on an H100, where every array of a program is
128 MiB of float64 (2.5x the card's 50 MB L2, so every block streams from
device memory) and the iteration counts stay the reference's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

from repro_torch.core import lazy as bh


def black_scholes(iters=5, n=20000):
    s = bh.random((n,)) * 95.0
    s += 5.0
    bh.flush()
    r, v, t_exp = 0.02, 0.3, 1.0
    total = bh.zeros(())
    for i in range(iters):
        t = t_exp + i * 0.1
        d1 = (bh.log(s / 100.0) + (r + 0.5 * v * v) * t) / (v * math.sqrt(t))
        d2 = d1 - v * math.sqrt(t)
        cdf1 = (bh.erf(d1 / math.sqrt(2.0)) + 1.0) * 0.5
        cdf2 = (bh.erf(d2 / math.sqrt(2.0)) + 1.0) * 0.5
        call = s * cdf1 - cdf2 * (100.0 * math.exp(-r * t))
        total += call.sum().broadcast_to(())
        for x in (d1, d2, cdf1, cdf2, call):
            x.delete()
        bh.flush()
    return total


def game_of_life(iters=5, n=128):
    grid = bh.random((n, n))
    live = bh.where(grid > 0.5, 1.0, 0.0)
    grid.delete()
    bh.flush()
    for _ in range(iters):
        nb = bh.zeros((n - 2, n - 2))
        for di in (0, 1, 2):
            for dj in (0, 1, 2):
                if di == 1 and dj == 1:
                    continue
                nb += live[di:di + n - 2, dj:dj + n - 2]
        center = live[1:n - 1, 1:n - 1]
        born = bh.where(nb > 2.5, 1.0, 0.0) * bh.where(nb < 3.5, 1.0, 0.0)
        stay = bh.where(nb > 1.5, 1.0, 0.0) * bh.where(nb < 3.5, 1.0, 0.0)
        new_c = bh.minimum(born + center * stay, 1.0)
        live[1:n - 1, 1:n - 1] = new_c
        for x in (nb, center, born, stay, new_c):
            x.delete()
        bh.flush()
    return live


def heat_equation(iters=8, n=256):
    g = bh.zeros((n, n))
    g[0:1, :] = 100.0
    bh.flush()
    for _ in range(iters):
        inner = (g[1:-1, :-2] + g[1:-1, 2:] + g[:-2, 1:-1]
                 + g[2:, 1:-1]) * 0.25
        g[1:n - 1, 1:n - 1] = inner
        inner.delete()
        bh.flush()
    return g


def leibnitz_pi(iters=5, n=100000):
    acc = bh.zeros(())
    for it in range(iters):
        i = bh.arange(n) + float(it * n)
        sign = 1.0 - (i % 2.0) * 2.0
        term = sign / (i * 2.0 + 1.0)
        acc += term.sum().broadcast_to(())
        for x in (i, sign, term):
            x.delete()
        bh.flush()
    return acc


def gauss_elimination(iters=24, n=24):
    a = bh.random((n, n + 1))
    bh.flush()
    for c in range(min(iters, n - 1)):
        pivot = a[c:c + 1, c:]
        col = a[c + 1:, c:c + 1]
        denom = a[c:c + 1, c:c + 1]
        factor = col / denom.broadcast_to(col.shape)
        upd = factor.broadcast_to((n - c - 1, n + 1 - c)) \
            * pivot.broadcast_to((n - c - 1, n + 1 - c))
        rest = a[c + 1:, c:] - upd
        a[c + 1:, c:] = rest
        for x in (factor, upd, rest):
            x.delete()
        bh.flush()
    return a


def lu_factorization(iters=24, n=24):
    return gauss_elimination(iters, n)     # same op structure (paper: 2799it)


def monte_carlo_pi(iters=5, n=100000):
    acc = bh.zeros(())
    for _ in range(iters):
        x = bh.random((n,))
        y = bh.random((n,))
        inside = bh.where((x * x + y * y) < 1.0, 1.0, 0.0)
        acc += inside.sum().broadcast_to(())
        for t in (x, y, inside):
            t.delete()
        bh.flush()
    return acc


def stencil_27pt(iters=3, n=32):
    g = bh.random((n, n, n))
    bh.flush()
    for _ in range(iters):
        acc = bh.zeros((n - 2, n - 2, n - 2))
        for di in (0, 1, 2):
            for dj in (0, 1, 2):
                for dk in (0, 1, 2):
                    acc += g[di:di + n - 2, dj:dj + n - 2, dk:dk + n - 2]
        out = acc / 27.0
        g[1:n - 1, 1:n - 1, 1:n - 1] = out
        acc.delete()
        out.delete()
        bh.flush()
    return g


def shallow_water(iters=5, n=128):
    h = bh.ones((n, n))
    u = bh.zeros((n, n))
    v = bh.zeros((n, n))
    bh.flush()
    dt, dx, grav = 0.01, 1.0, 9.8
    for _ in range(iters):
        dhx = (h[2:, 1:-1] - h[:-2, 1:-1]) * (0.5 / dx)
        dhy = (h[1:-1, 2:] - h[1:-1, :-2]) * (0.5 / dx)
        nu = u[1:-1, 1:-1] - dhx * (grav * dt)
        nv = v[1:-1, 1:-1] - dhy * (grav * dt)
        dux = (u[2:, 1:-1] - u[:-2, 1:-1]) * (0.5 / dx)
        dvy = (v[1:-1, 2:] - v[1:-1, :-2]) * (0.5 / dx)
        nh = h[1:-1, 1:-1] - (dux + dvy) * dt
        u[1:n - 1, 1:n - 1] = nu
        v[1:n - 1, 1:n - 1] = nv
        h[1:n - 1, 1:n - 1] = nh
        for x in (dhx, dhy, nu, nv, dux, dvy, nh):
            x.delete()
        bh.flush()
    return h


def rosenbrock(iters=5, n=200000):
    acc = bh.zeros(())
    x = bh.random((n,))
    bh.flush()
    for _ in range(iters):
        a = x[1:]
        b = x[:-1]
        t1 = a - b * b
        t2 = 1.0 - b
        val = t1 * t1 * 100.0 + t2 * t2
        acc += val.sum().broadcast_to(())
        for t in (a, b, t1, t2, val):
            t.delete()
        bh.flush()
    return acc


def sor(iters=8, n=256):
    g = bh.zeros((n, n))
    g[0:1, :] = 100.0
    bh.flush()
    w = 1.8
    for _ in range(iters):
        avg = (g[1:-1, :-2] + g[1:-1, 2:] + g[:-2, 1:-1]
               + g[2:, 1:-1]) * 0.25
        center = g[1:-1, 1:-1]
        new = center * (1.0 - w) + avg * w
        g[1:n - 1, 1:n - 1] = new
        for x in (avg, center, new):
            x.delete()
        bh.flush()
    return g


def nbody(iters=3, n=64):
    pos = bh.random((n, 3))
    vel = bh.zeros((n, 3))
    bh.flush()
    dt, eps = 0.01, 1e-3
    for _ in range(iters):
        force = bh.zeros((n, 3))
        for d in range(3):
            pd = pos[:, d]
            dx = pd.broadcast_to((n, n)) - pd.reshape(n, 1).broadcast_to((n, n))
            if d == 0:
                r2 = dx * dx + eps
            else:
                r2 += dx * dx
            dxs = dx
            if d == 0:
                store = [dxs]
            else:
                store.append(dxs)
            pd.delete()
        inv = 1.0 / (bh.sqrt(r2) * r2)
        for d in range(3):
            f = (store[d] * inv).sum(axis=1)
            fc = force[:, d]
            force[:, d] = fc + f
            f.delete()
            fc.delete()
            store[d].delete()
        inv.delete()
        r2.delete()
        nv = vel + force * dt
        npos = pos + nv * dt
        vel[:] = nv
        pos[:] = npos
        for x in (force, nv, npos):
            x.delete()
        bh.flush()
    return pos


def nbody_nice(iters=3, n_planets=8, n_asteroids=256):
    """Planets affect everything; asteroids are massless (paper's 'nice'
    variant: 40 planets, 2e6 asteroids — scaled down)."""
    ppos = bh.random((n_planets, 3))
    apos = bh.random((n_asteroids, 3))
    avel = bh.zeros((n_asteroids, 3))
    bh.flush()
    dt, eps = 0.01, 1e-3
    for _ in range(iters):
        acc_list = []
        for d in range(3):
            pd = ppos[:, d]
            ad = apos[:, d]
            dx = pd.broadcast_to((n_asteroids, n_planets)) \
                - ad.reshape(n_asteroids, 1).broadcast_to((n_asteroids, n_planets))
            if d == 0:
                r2 = dx * dx + eps
            else:
                r2 += dx * dx
            acc_list.append(dx)
            pd.delete()
            ad.delete()
        inv = 1.0 / (bh.sqrt(r2) * r2)
        for d in range(3):
            f = (acc_list[d] * inv).sum(axis=1)
            av = avel[:, d]
            avel[:, d] = av + f * dt
            f.delete()
            av.delete()
            acc_list[d].delete()
        inv.delete()
        r2.delete()
        napos = apos + avel * dt
        apos[:] = napos
        napos.delete()
        bh.flush()
    return apos


def lattice_boltzmann(iters=3, n=24):
    """D3Q19 stream+collide, scaled down (paper: 3.375e6 cells)."""
    dirs = [(0, 0, 0)] + [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                          (0, 0, 1), (0, 0, -1)] + \
           [(1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
            (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
            (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1)]
    w = [1 / 3] + [1 / 18] * 6 + [1 / 36] * 12
    f = [bh.full((n, n, n), w[i]) for i in range(19)]
    bh.flush()
    omega = 1.0
    for _ in range(iters):
        rho = f[0].copy()
        for i in range(1, 19):
            rho += f[i]
        for i in range(19):
            feq = rho * w[i]
            fi = f[i]
            new = fi * (1.0 - omega) + feq * omega
            f[i][:] = new
            for x in (feq, new):
                x.delete()
        # streaming: shift along each direction (interior only)
        for i in range(1, 7):
            di, dj, dk = dirs[i]
            src = f[i][1 - min(di, 0):n - 1 - max(di, 0),
                       1 - min(dj, 0):n - 1 - max(dj, 0),
                       1 - min(dk, 0):n - 1 - max(dk, 0)]
            cp = src.copy()
            f[i][1 + max(di, 0):n - 1 + min(di, 0) or n - 1,
                 1 + max(dj, 0):n - 1 + min(dj, 0) or n - 1,
                 1 + max(dk, 0):n - 1 + min(dk, 0) or n - 1] = cp
            cp.delete()
            src.delete()
        rho.delete()
        bh.flush()
    return f[0]


def water_ice(iters=5, n=256):
    """Heat diffusion with a phase change (paper's water-ice simulation)."""
    temp = bh.random((n, n))
    temp *= 40.0
    temp -= 20.0
    bh.flush()
    for _ in range(iters):
        avg = (temp[1:-1, :-2] + temp[1:-1, 2:] + temp[:-2, 1:-1]
               + temp[2:, 1:-1]) * 0.25
        frozen = bh.where(avg < 0.0, 1.0, 0.0)
        # latent heat: freezing releases heat, melting absorbs it
        new = avg + frozen * 0.5 - 0.25
        temp[1:n - 1, 1:n - 1] = new
        for x in (avg, frozen, new):
            x.delete()
        bh.flush()
    return temp


def quickstart(iters=1, n=100_000):
    """``examples/quickstart.py``'s velocity-update kernel: a sin/mul/sub
    chain into two in-place updates and a kinetic-energy reduction."""
    for _ in range(iters):
        x = bh.random((n,))
        v = bh.random((n,))
        force = bh.sin(x) * 0.3 - x * 0.01        # two fusible temporaries
        v += force * 0.5
        x += v * 0.5
        ke = (v * v).sum() * 0.5                  # reduction ends the block
        force.delete()
        bh.sync(ke)
    return ke


BENCHMARKS: Dict[str, Callable] = {
    "black_scholes": black_scholes,
    "game_of_life": game_of_life,
    "heat_equation": heat_equation,
    "leibnitz_pi": leibnitz_pi,
    "gauss_elimination": gauss_elimination,
    "lu_factorization": lu_factorization,
    "monte_carlo_pi": monte_carlo_pi,
    "stencil_27pt": stencil_27pt,
    "shallow_water": shallow_water,
    "rosenbrock": rosenbrock,
    "sor": sor,
    "nbody": nbody,
    "nbody_nice": nbody_nice,
    "lattice_boltzmann": lattice_boltzmann,
    "water_ice": water_ice,
}


#: (args) per program on the card: 2**24-element vectors, 4096**2 grids,
#: 256**3 volumes, reference iteration counts
CHIP_SIZES: Dict[str, tuple] = {
    "black_scholes": (5, 2 ** 24),
    "game_of_life": (5, 4096),
    "heat_equation": (8, 4096),
    "leibnitz_pi": (5, 2 ** 24),
    "gauss_elimination": (8, 4096),
    "lu_factorization": (8, 4096),
    "monte_carlo_pi": (5, 2 ** 24),
    "stencil_27pt": (3, 256),
    "shallow_water": (5, 4096),
    "rosenbrock": (5, 2 ** 24),
    "sor": (8, 4096),
    "nbody": (3, 4096),
    "nbody_nice": (3, 64, 2 ** 18),
    "lattice_boltzmann": (3, 256),
    "water_ice": (5, 4096),
    "quickstart": (1, 2 ** 24),
}
