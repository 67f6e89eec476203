"""Interactive 3-plane volume viewer with sliders
(fpr_tpu/plotting/volume_viewer.py, the analog of the reference's GLMakie
volumeslices demo, makie_volumeslice_example.jl:21-34: three orthogonal
slice planes of an (x, y, z, t) dataset with x/y/z sliders plus a time
slider).

Matplotlib widgets instead of GLMakie: three imshow panes (z-, y-, x-normal
mid-planes) with one slider per axis and, when a time axis is present, a
time slider.  Headless environments (Agg backend) can still use
``render_frame`` to write PNGs.  ``demo_frames`` solves the demo's frames
with the port on ``device`` and needs no matplotlib.

    python -m fpr_tpu_torch.plotting.volume_viewer            # demo: diffusion on the card
    python -m fpr_tpu_torch.plotting.volume_viewer --n 48 --steps 4 --out frame.png
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.plotting import require_matplotlib
from fpr_tpu_torch.plotting.volume_slices import demo_config
from fpr_tpu_torch.utils import device as devinfo


def demo_frames(n: int = 48, steps: int = 4, *, device="cuda") -> list:
    """The demo's time frames: H of the n^3 diffusion at t = 0.2 k for
    k = 1..steps, each solved in float32 on device."""
    return [diffusion3d.solve(demo_config(n, ttot=0.2 * k), dtype=torch.float32,
                              device=device).H
            for k in range(1, steps + 1)]


def view(volumes, titles=("z slice", "y slice", "x slice"), cmap="viridis"):
    """Open the interactive viewer.

    volumes: (nz, ny, nx) array or a list of them (the time axis).
    Sliders: iz / iy / ix (+ t when len(volumes) > 1).  Blocks until the
    window closes; returns the Figure (for tests / headless inspection).
    """
    matplotlib = require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    vols = [np.asarray(v) for v in (volumes if isinstance(volumes, (list, tuple)) else [volumes])]
    nz, ny, nx = vols[0].shape
    vmin = min(v.min() for v in vols)
    vmax = max(v.max() for v in vols)

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    has_t = len(vols) > 1
    fig.subplots_adjust(bottom=0.32 if has_t else 0.26)

    state = dict(iz=nz // 2, iy=ny // 2, ix=nx // 2, it=0)
    ims = [
        axes[0].imshow(vols[0][state["iz"], :, :], origin="lower", cmap=cmap,
                       vmin=vmin, vmax=vmax),
        axes[1].imshow(vols[0][:, state["iy"], :], origin="lower", cmap=cmap,
                       vmin=vmin, vmax=vmax),
        axes[2].imshow(vols[0][:, :, state["ix"]], origin="lower", cmap=cmap,
                       vmin=vmin, vmax=vmax),
    ]
    for ax, t in zip(axes, titles):
        ax.set_title(t)
    fig.colorbar(ims[0], ax=axes, shrink=0.8)

    def redraw():
        v = vols[state["it"]]
        ims[0].set_data(v[state["iz"], :, :])
        ims[1].set_data(v[:, state["iy"], :])
        ims[2].set_data(v[:, :, state["ix"]])
        fig.canvas.draw_idle()

    sliders = []

    def add_slider(rect, label, vmax_, key):
        sax = fig.add_axes(rect)
        sl = Slider(sax, label, 0, vmax_, valinit=state[key], valstep=1)

        def on_change(val, key=key):
            state[key] = int(val)
            redraw()

        sl.on_changed(on_change)
        sliders.append(sl)

    add_slider([0.12, 0.16, 0.78, 0.03], "iz", nz - 1, "iz")
    add_slider([0.12, 0.11, 0.78, 0.03], "iy", ny - 1, "iy")
    add_slider([0.12, 0.06, 0.78, 0.03], "ix", nx - 1, "ix")
    if has_t:
        add_slider([0.12, 0.01, 0.78, 0.03], "t", len(vols) - 1, "it")

    fig._volume_viewer_sliders = sliders  # keep refs alive
    fig._volume_viewer_redraw = redraw
    fig._volume_viewer_state = state
    if matplotlib.get_backend().lower() != "agg":
        plt.show()
    return fig


def render_frame(volume, path, iz=None, iy=None, ix=None, cmap="viridis"):
    """Headless fallback: write one 3-pane frame to ``path``."""
    require_matplotlib().use("Agg", force=False)
    import matplotlib.pyplot as plt

    v = np.asarray(volume)
    nz, ny, nx = v.shape
    iz = nz // 2 if iz is None else iz
    iy = ny // 2 if iy is None else iy
    ix = nx // 2 if ix is None else ix
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (sl, t) in zip(
        axes,
        [(v[iz], f"z={iz}"), (v[:, iy, :], f"y={iy}"), (v[:, :, ix], f"x={ix}")],
    ):
        im = ax.imshow(sl, origin="lower", cmap=cmap)
        ax.set_title(t)
    fig.colorbar(im, ax=axes, shrink=0.8)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--steps", type=int, default=4, help="physical steps = time frames")
    ap.add_argument("--out", default=None, help="headless: write PNG here instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    frames = demo_frames(args.n, args.steps, device=devinfo.resolve(args.device))
    if args.out:
        print(render_frame(frames[-1], args.out))
    else:
        view(frames)


if __name__ == "__main__":
    main()
