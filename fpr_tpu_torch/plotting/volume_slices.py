"""3D field slice renderer (fpr_tpu/plotting/volume_slices.py, the analog
of the reference's GLMakie volumeslices demo): the three mid-plane slices
of a 3D field, from a checkpoint or from a diffusion solve, to PNG.

``demo_field`` solves the demo's diffusion with the port on ``device`` and
needs no matplotlib; ``render_slices`` draws.

    python -m fpr_tpu_torch.plotting.volume_slices --checkpoint state.npz --field H
    python -m fpr_tpu_torch.plotting.volume_slices --demo    # a 48^3 diffusion on the card
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.utils import checkpoint
from fpr_tpu_torch.utils import device as devinfo


def demo_config(n: int = 48, ttot: float = 0.4) -> DiffusionConfig:
    """The demo's diffusion: n^3, to t = ttot, tol 1e-6, plain PyTorch."""
    return DiffusionConfig(nx=n, ny=n, nz=n, ttot=ttot, tol=1e-6, policy=ExecutionPolicy.JNP)


def demo_field(n: int = 48, *, device="cuda") -> np.ndarray:
    """H of the demo's diffusion at t = 0.4 in float32, solved on device,
    as a (nz, ny, nx) numpy array."""
    return diffusion3d.solve(demo_config(n), dtype=torch.float32, device=device).H


def load_field(path, field: str = "H") -> np.ndarray:
    """A field of a checkpoint (``utils.checkpoint``), a 2D one as one
    z-plane."""
    H = np.asarray(checkpoint.load(path)[field])
    return H[None, :, :] if H.ndim == 2 else H


def render_slices(H: np.ndarray, out: Path, title: str = ""):
    from fpr_tpu_torch.plotting.plots import pyplot

    plt = pyplot()
    nz, ny, nx = H.shape
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.6))
    vmax = float(np.abs(H).max()) or 1.0
    for ax, (name, sl) in zip(
        axes,
        {
            f"z = {nz//2}": H[nz // 2, :, :],
            f"y = {ny//2}": H[:, ny // 2, :],
            f"x = {nx//2}": H[:, :, nx // 2],
        }.items(),
    ):
        im = ax.imshow(sl, origin="lower", cmap="inferno", vmin=0, vmax=vmax)
        ax.set_title(name)
        fig.colorbar(im, ax=ax, shrink=0.8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=150)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--field", type=str, default="H")
    ap.add_argument("--out", type=str, default="figs-torch/volume_slices.png")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.demo:
        dev = devinfo.resolve(args.device)
        H = demo_field(device=dev)
        title = f"diffusion 48^3 at t=0.4 ({devinfo.name(dev)})"
    else:
        if args.checkpoint is None:
            ap.error("pass --checkpoint PATH or --demo")
        H = load_field(args.checkpoint, args.field)
        title = f"{args.field} from {args.checkpoint}"
    render_slices(H, Path(args.out), title)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
