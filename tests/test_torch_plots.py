"""The port's plotting package (fpr_tpu_torch.plotting) on the CPU with
the Agg backend.

- Each figure function, run on the JAX package's committed CSVs
  (``benchmark-results/``), writes the files JAX's function writes.
- Every figure family regenerates from the port's committed CSVs
  (``benchmark-results-torch/``, measured on the card), as
  tests/test_plots.py pins for JAX's, and the labels come from the rows:
  the scaling figure names the CSV's card and never "TPU".
- The modules import, and the demo's solve runs, without matplotlib (as on
  the card's machine); drawing there raises ImportError.
- The volume demo's solve (which diverges below 12^3 in both packages, the
  cell size being lx / n) at 16^3 against fpr_tpu's (JNP, float32): equal
  iteration counts and H within 1e-6, tests/test_torch_diffusion3d.py's
  bound for a float32 tier (the two sides round float32 operations
  differently).
"""

import subprocess
import sys
from pathlib import Path

import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fpr_tpu.core.config import DiffusionConfig as JConfig  # noqa: E402
from fpr_tpu.core.config import ExecutionPolicy as JPolicy  # noqa: E402
from fpr_tpu.models import diffusion3d as jd  # noqa: E402
from fpr_tpu.plotting import plots as jplots  # noqa: E402
from fpr_tpu_torch.models import diffusion3d as td  # noqa: E402
from fpr_tpu_torch.plotting import plots, volume_slices, volume_viewer  # noqa: E402
from fpr_tpu_torch.utils import checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
JAX_RESULTS = REPO / "benchmark-results"
RESULTS = REPO / "benchmark-results-torch"
FUNCTIONS = ["plot_scaling", "plot_intensity", "plot_work_precision", "plot_timestepping",
             "plot_mg_bench", "plot_mg_workprecision"]
FAMILIES = [
    # (figure files, plot function, the port's CSVs it reads)
    (["diffusion_strong_scaling.png", "diffusion_weak_scaling.png"], "plot_scaling",
     ["diffusion_scaling.csv"]),
    (["operational_intensity.png"], "plot_intensity", ["bench_diffusion.csv"]),
    (["error_vs_tolerance.png", "error_vs_grid_size.png"], "plot_work_precision",
     ["error_vs_tolerance.csv", "error_vs_grid_size.csv"]),
    (["semi_implicit_vs_explicit.png"], "plot_timestepping", ["ns_fullscale.csv"]),
    (["multigrid_bench.png"], "plot_mg_bench", ["bench_multigrid.csv"]),
    (["mg_workprecision.png"], "plot_mg_workprecision", ["mg_workprecision.csv"]),
]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_jax_csvs_give_jax_file_names(tmp_path, name):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    getattr(plots, name)(JAX_RESULTS, tmp_path / "port")
    getattr(jplots, name)(JAX_RESULTS, tmp_path / "jax")
    written = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert written and written == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert all((tmp_path / "port" / f).stat().st_size > 1000 for f in written)


@pytest.mark.parametrize("figures,name,csvs", FAMILIES, ids=[f[1] for f in FAMILIES])
def test_family_regenerates_from_the_ports_csvs(tmp_path, figures, name, csvs):
    for c in csvs:
        assert (RESULTS / c).exists(), f"committed artifact missing: {c}"
        rows = plots._read(RESULTS / c)
        assert rows and all(r["backend"] == "cuda" and r["device"] for r in rows), c
    getattr(plots, name)(RESULTS, tmp_path)
    for f in figures:
        assert (tmp_path / f).exists() and (tmp_path / f).stat().st_size > 1000, f


def _texts(fig):
    return [t.get_text() for t in fig.findobj(matplotlib.text.Text)]


def test_scaling_labels_name_the_card(tmp_path, monkeypatch):
    saved = []
    real_save = matplotlib.figure.Figure.savefig

    def record(fig, *a, **kw):
        saved.append(_texts(fig))
        return real_save(fig, *a, **kw)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", record)
    plots.plot_scaling(RESULTS, tmp_path)
    cards = {r["device"] for r in plots._read(RESULTS / "diffusion_scaling.csv")}
    assert len(saved) == 2
    for texts in saved:
        assert not any("TPU" in t for t in texts)
        assert any("virtual" in t and card in t for t in texts for card in cards)
        assert any(t.startswith("card: ") for t in texts)  # card.txt's line


def test_mg_bench_dashes_the_cpu_curve(tmp_path, monkeypatch):
    """A row's backend labels its curve (no "tpu" default); cpu is dashed."""
    rows = "k,l,coarse,solver,backend,device,seconds,iters,device_s\n" + "".join(
        f"{k},2,jacobi,direct,{b},{d},{t},7,\n"
        for k in (5, 6) for b, d, t in (("cuda", "card", 0.01), ("cpu", "cpu", 0.1)))
    (tmp_path / "bench_multigrid.csv").write_text(rows)
    lines = []
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda fig, *a, **kw: lines.extend(fig.axes[0].get_lines()))
    plots.plot_mg_bench(tmp_path, tmp_path)
    styles = {ln.get_label(): ln.get_linestyle() for ln in lines}
    assert styles == {"jacobi/direct": "-", "jacobi/direct (cpu)": "--"}


def test_modules_import_and_demo_solves_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import fpr_tpu_torch.plotting.plots as p, fpr_tpu_torch.plotting.volume_viewer\n"
            "from fpr_tpu_torch.plotting import volume_slices as vs\n"
            "H = vs.demo_field(12, device='cpu')\n"
            "assert H.shape == (12, 12, 12) and 0 < H.max() < 1\n"
            "try:\n    p.plot_intensity(p.Path('benchmark-results'), p.Path('.'))\n"
            "except ImportError as e:\n    print('refused:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused: drawing needs matplotlib, which is not installed"


def test_render_slices_and_frame_write_pngs(tmp_path):
    H = volume_slices.demo_field(12, device="cpu")
    volume_slices.render_slices(H, tmp_path / "a" / "slices.png", "t")
    assert volume_viewer.render_frame(H, tmp_path / "frame.png") == tmp_path / "frame.png"
    for f in (tmp_path / "a" / "slices.png", tmp_path / "frame.png"):
        assert f.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and f.stat().st_size > 1000


def test_view_sliders_move_the_planes():
    frames = volume_viewer.demo_frames(12, 2, device="cpu")
    assert len(frames) == 2 and not np.array_equal(frames[0], frames[1])
    fig = volume_viewer.view(frames)
    sliders = fig._volume_viewer_sliders
    assert [s.label.get_text() for s in sliders] == ["iz", "iy", "ix", "t"]
    pane0 = fig.axes[0].get_images()[0]
    before = np.array(pane0.get_array())
    sliders[0].set_val(2)
    assert fig._volume_viewer_state["iz"] == 2
    np.testing.assert_array_equal(pane0.get_array(), frames[0][2])
    assert not np.array_equal(before, pane0.get_array())
    sliders[3].set_val(1)
    np.testing.assert_array_equal(pane0.get_array(), frames[1][2])
    matplotlib.pyplot.close(fig)


def test_checkpoint_field_round_trip(tmp_path):
    H = np.random.default_rng(1).random((4, 5, 6)).astype(np.float32)
    checkpoint.save(tmp_path / "s.npz", H=H, W=H[0])
    np.testing.assert_array_equal(volume_slices.load_field(tmp_path / "s.npz"), H)
    np.testing.assert_array_equal(volume_slices.load_field(tmp_path / "s.npz", "W"), H[:1])


def test_demo_solve_matches_jax():
    got = td.solve(volume_slices.demo_config(16), device="cpu")
    want = jd.solve(JConfig(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-6, policy=JPolicy.JNP),
                    dtype=jnp.float32)
    assert got.iters_total == want.iters_total
    H = volume_slices.demo_field(16, device="cpu")
    np.testing.assert_array_equal(H, got.H)
    assert H.dtype == np.float32
    np.testing.assert_allclose(H, np.asarray(want.H), rtol=0, atol=1e-6)
