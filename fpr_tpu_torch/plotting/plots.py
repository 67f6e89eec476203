"""Figures from the sweeps' CSVs (fpr_tpu/plotting/plots.py, the
matplotlib equivalents of the reference's PGFPlotsX scripts): scaling
bars, operational intensity, work-precision diagrams, semi-implicit
against explicit curves, the multigrid sweep and the multigrid
work-precision diagram.

The CSVs are the port's (``benchmark-results-torch/``, written by
``scripts/run_all_torch.sh`` on the card): JAX's columns plus ``device``,
the card's name, with ``backend`` "cuda" or "cpu".  Where the JAX module
writes "TPU" or defaults a missing backend to "tpu", this one labels from
the rows' ``device`` and ``backend``.  ``card.txt`` beside the CSVs (the
card's name and power limit as nvidia-smi prints them) is written under
every figure.  The JAX package's own CSVs draw too.

matplotlib is imported by the functions that draw, so the module imports
where matplotlib is absent (as on the card's machine); a call that draws
raises ImportError there.

    python -m fpr_tpu_torch.plotting.plots --results benchmark-results-torch --figs figs-torch
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

from fpr_tpu_torch.plotting import require_matplotlib


def pyplot():
    """matplotlib.pyplot on the Agg backend (ImportError where matplotlib is
    not installed)."""
    require_matplotlib().use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _where(r) -> str:
    """The row's device: the card's name (the port's rows) or the backend
    (the JAX package's, which have no device column)."""
    return r.get("device") or r.get("backend") or "unknown device"


def _save(fig, results: Path, path: Path, **kw):
    """Write the figure with card.txt's lines under it, then close it."""
    card = results / "card.txt"
    lines = card.read_text().split("\n") if card.exists() else []
    lines = [ln.strip() for ln in lines if ln.strip()]
    if lines:
        fig.text(0.01, 0.005, "card: " + "; ".join(lines), fontsize=6, va="bottom")
        fig.tight_layout(rect=(0, 0.04, 1, 1))
    fig.savefig(path, **kw)
    pyplot().close(fig)


def plot_scaling(results: Path, figs: Path):
    path = results / "diffusion_scaling.csv"
    if not path.exists():
        return
    plt = pyplot()
    rows = _read(path)
    for mode in ("strong", "weak"):
        sel = [r for r in rows if r["mode"] == mode]
        if not sel:
            continue
        # real devices apart from the virtual-mesh series: shards sharing
        # one device validate the sharding path and measure no scaling
        real = sorted([r for r in sel if r.get("virtual") != "True"],
                      key=lambda r: int(r["devices"]))
        virt = sorted([r for r in sel if r.get("virtual") == "True"],
                      key=lambda r: int(r["devices"]))
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.8))
        for series, virtual in ((real, False), (virt, True)):
            if not series:
                continue
            devs = [f"{r['devices']} ({'virtual' if virtual else _where(r)})" for r in series]
            axes[0].bar(devs, [float(r["throughput_gbs"]) for r in series])
            axes[1].bar(devs, [float(r["performance_gflops"]) for r in series])
        if virt:
            on = ", ".join(sorted({_where(r) for r in virt}))
            fig.suptitle(f"virtual mesh on {on} (validation, not scaling)", fontsize=9)
        axes[0].set(xlabel="devices", ylabel="T_eff [GB/s]", title=f"{mode} scaling")
        axes[0].set_yscale("log")
        axes[1].set(xlabel="devices", ylabel="GFLOP/s", title=f"{mode} scaling")
        axes[1].set_yscale("log")
        for ax in axes:
            ax.tick_params(axis="x", labelsize=7, rotation=45)
        fig.tight_layout()
        _save(fig, results, figs / f"diffusion_{mode}_scaling.png", dpi=150)


def plot_intensity(results: Path, figs: Path):
    path = results / "bench_diffusion.csv"
    if not path.exists():
        return
    rows = _read(path)
    labels = [f"{r['n']}³/{r['policy']}" for r in rows]
    intens = [float(r["intensity"]) for r in rows if r["intensity"]]
    if not intens:
        return
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.bar(labels[: len(intens)], intens)
    ax.set(ylabel="operational intensity [FLOP/byte]")
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    fig.tight_layout()
    _save(fig, results, figs / "operational_intensity.png", dpi=150)


def plot_work_precision(results: Path, figs: Path):
    for name, xcol in (("error_vs_tolerance", "tol"), ("error_vs_grid_size", "nx")):
        path = results / f"{name}.csv"
        if not path.exists():
            continue
        plt = pyplot()
        rows = _read(path)
        x = [float(r[xcol]) for r in rows]
        v = [float(r["val"]) for r in rows]
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(x, v, "o-")
        if xcol == "tol":
            ax.set_xscale("log")
            ax.invert_xaxis()
        ax.set(xlabel=xcol, ylabel="H(4.5, 4.5, 4.5)")
        fig.tight_layout()
        _save(fig, results, figs / f"{name}.png", dpi=150)


def plot_timestepping(results: Path, figs: Path):
    path = results / "ns_semi_implicit_vs_explicit.csv"
    if not path.exists():
        path = results / "ns_fullscale.csv"
    if not path.exists():
        return
    plt = pyplot()
    rows = _read(path)
    # the full-scale table carries several solver tiers (mixed, fast, the
    # relaxed fast_stol100; the JAX table fast_dst* and fast_r5 too): plot
    # the newest production tier present
    for tier in ("fast_r5", "fast"):
        if any(r.get("solver") == tier for r in rows):
            rows = [r for r in rows if r.get("solver") == tier]
            break
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    for beta in sorted({r["beta"] for r in rows}):
        sel = sorted(
            [r for r in rows if r["beta"] == beta], key=lambda r: float(r["Pr"])
        )
        pr = [float(r["Pr"]) for r in sel]
        axes[0].loglog(pr, [int(r["steps"]) for r in sel], "o-", label=f"β={beta}")
        axes[1].loglog(pr, [float(r["seconds"]) for r in sel], "o-", label=f"β={beta}")
    axes[0].set(xlabel="Pr", ylabel="timesteps")
    axes[1].set(xlabel="Pr", ylabel="runtime [s]")
    axes[0].legend()
    fig.tight_layout()
    _save(fig, results, figs / "semi_implicit_vs_explicit.png", dpi=150)


def plot_mg_bench(results: Path, figs: Path):
    path = results / "bench_multigrid.csv"
    if not path.exists():
        return
    plt = pyplot()
    rows = _read(path)

    def best_time(r):
        # the device time where a row has one (the JAX rows' amortized TPU
        # time; the port's rows leave it empty)
        d = r.get("device_s", "")
        return float(d) if d else float(r["seconds"])

    fig, ax = plt.subplots(figsize=(6.5, 4))
    # one curve per backend: the cpu curve is the crossover comparison
    keys = sorted({(r["coarse"], r["solver"], r.get("backend", "")) for r in rows})
    for coarse, solver, backend in keys:
        sel = [r for r in rows
               if r["coarse"] == coarse and r["solver"] == solver
               and r.get("backend", "") == backend]
        # one (best) point per k
        byk = {}
        for r in sel:
            k = int(r["k"])
            t = best_time(r)
            if k not in byk or t < byk[k]:
                byk[k] = t
        ks = sorted(byk)
        n = [(2 ** k + 1) ** 2 for k in ks]
        t = [byk[k] for k in ks]
        style = "s--" if backend == "cpu" else "o-"
        label = f"{coarse}/{solver}" + (" (cpu)" if backend == "cpu" else "")
        ax.loglog(n, t, style, label=label)
    on = ", ".join(sorted({_where(r) for r in rows}))
    ax.set(xlabel="unknowns", ylabel="time to tol=1e-6 [s]", title=on)
    ax.title.set_fontsize(9)
    ax.legend(fontsize=6, ncol=2)
    fig.tight_layout()
    _save(fig, results, figs / "multigrid_bench.png", dpi=150)


def plot_mg_workprecision(results: Path, figs: Path):
    """MG as the solver against unpreconditioned CG and MG-preconditioned
    CG, one curve per solver tier.  Solid: wall time; a dashed companion
    where the rows have a device time (the JAX rows' ds tiers; the port's
    rows leave it empty)."""
    path = results / "mg_workprecision.csv"
    if not path.exists():
        return
    plt = pyplot()
    rows = _read(path)
    fig, ax = plt.subplots(figsize=(6.5, 4))
    for solver in sorted({r["solver"] for r in rows}):
        sel = sorted(
            [r for r in rows if r["solver"] == solver], key=lambda r: int(r["k"])
        )
        n = [(2 ** int(r["k"]) + 1) ** 2 for r in sel]
        ax.loglog(n, [float(r["seconds"]) for r in sel], "o-", label=solver)
        dev = [(x, float(r["device_s"])) for x, r in zip(n, sel)
               if r.get("device_s", "")]
        if dev:
            ax.loglog(*zip(*dev), "s--", alpha=0.6,
                      label=f"{solver} (device)")
    on = ", ".join(sorted({_where(r) for r in rows}))
    ax.set(xlabel="unknowns", ylabel="time to tol=1e-6 [s]", title=on)
    ax.title.set_fontsize(9)
    ax.legend(fontsize=8)
    fig.tight_layout()
    _save(fig, results, figs / "mg_workprecision.png", dpi=150)


PLOTS = (plot_scaling, plot_intensity, plot_work_precision, plot_timestepping, plot_mg_bench,
         plot_mg_workprecision)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="benchmark-results-torch")
    ap.add_argument("--figs", default="figs-torch")
    args = ap.parse_args(argv)
    results, figs = Path(args.results), Path(args.figs)
    figs.mkdir(parents=True, exist_ok=True)
    for plot in PLOTS:
        plot(results, figs)
    print(f"figures written to {figs}/")


if __name__ == "__main__":
    main()
