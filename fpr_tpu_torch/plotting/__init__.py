"""Figures and volume views of the port's results (fpr_tpu/plotting):
``plots`` draws the sweeps' figures from their CSVs, ``volume_slices``
renders a 3D field's mid-plane slices to PNG, and ``volume_viewer`` opens
three slice planes with sliders.  The volume modules' demos solve with
``fpr_tpu_torch.models.diffusion3d`` on ``--device`` (the card by default).

matplotlib is imported only by the functions that draw
(``require_matplotlib()``), so every module here imports where it is
absent, as on the card's machine, and the demos' solves run there.
"""

from __future__ import annotations


def require_matplotlib():
    """The matplotlib module; ImportError with one line saying so where it
    is not installed."""
    try:
        import matplotlib as mpl
    except ImportError as exc:
        raise ImportError("drawing needs matplotlib, which is not installed") from exc
    return mpl
