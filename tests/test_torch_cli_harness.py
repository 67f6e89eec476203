"""The port's CLI flags that the harness added (fpr_tpu_torch.cli: ``ns
--save/--resume/--snapshot-every``, ``diffusion3d --scale-physical-size``,
the default device) against ``fpr_tpu.cli.main`` with the same flags.

Checkpoints cross packages: JAX's ``ns --fast --save`` payload at 4 steps,
resumed by the port to 8, agrees with JAX's own continuation to 8 within
tests/test_torch_dist_ns.py's bounds for JAX's payload (equal steps,
sim_time within 1e-6, W within 1e-4 of max|W|, T within 1e-4, S within
1e-3 of max|S|), and the port's payload resumes in JAX within the same
bounds.  Within the port a save at 4 resumed to 8 is bitwise a straight 8,
on the fast loop and on the sharded fast loop (2 row shards at 513x257).
NS runs are 129x33, Pr 0.01, tol 1e-7, explicit; W starts from each package's own draw, and the
cross-package runs share the payload.
"""

import numpy as np
import pytest
import torch

from fpr_tpu import cli as jcli
from fpr_tpu.models import navier_stokes as jns
from fpr_tpu.utils import checkpoint as jckpt
from fpr_tpu_torch import cli
from fpr_tpu_torch.models import navier_stokes as tns
from fpr_tpu_torch.utils import checkpoint

NS = ["ns", "--nx", "129", "--ny", "33", "--Pr", "0.01", "--tol", "1e-7", "--ttot", "1"]
CPU = ["--device", "cpu"]
FIELDS = ("T", "W", "S_hi", "S_lo", "w_sumsq", "t_hi", "t_lo", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tensors are small, and more threads only
    contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, module, name):
    """Record the results of module.name while it runs as before."""
    seen = []
    real = getattr(module, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's CLI: 4 steps saved, continued to 8 and saved, and a straight 8
    with --snapshot-every 2 (its snapshots recorded)."""
    d = tmp_path_factory.mktemp("jax_ns")
    base = NS + ["--fast", "--platform", "cpu"]
    jcli.main(base + ["--max-steps", "4", "--save", str(d / "p4.npz")])
    jcli.main(base + ["--max-steps", "8", "--resume", str(d / "p4.npz"), "--save",
                      str(d / "p8.npz")])
    mp = pytest.MonkeyPatch()
    try:
        seen = _spy(mp, jns, "simulate_fast")
        jcli.main(base + ["--max-steps", "8", "--snapshot-every", "2"])
    finally:
        mp.undo()
    return d, [s[4] for s in seen[0].snapshots]


def _agree(got, want):
    """tests/test_torch_dist_ns.py's bounds for JAX's payload resumed."""
    assert int(got["step"]) == int(want["step"])
    t = lambda p: float(p["t_hi"]) + float(p["t_lo"])  # noqa: E731
    assert abs(t(got) - t(want)) < 1e-6
    assert np.abs(got["W"] - want["W"]).max() / np.abs(want["W"]).max() < 1e-4
    assert np.abs(got["T"] - want["T"]).max() < 1e-4
    S = lambda p: p["S_hi"].astype(np.float64) + p["S_lo"]  # noqa: E731
    assert np.abs(S(got) - S(want)).max() / np.abs(S(want)).max() < 1e-3


def test_jax_payload_resumes_in_port(jax_runs, tmp_path):
    d, _ = jax_runs
    cli.main(NS + CPU + ["--fast", "--resume", str(d / "p4.npz"), "--max-steps", "8", "--save",
                         str(tmp_path / "q8.npz")])
    got = checkpoint.load(tmp_path / "q8.npz")
    assert sorted(got) == sorted(FIELDS)
    _agree(got, jckpt.load(d / "p8.npz"))


def test_port_payload_resumes_in_jax(jax_runs, tmp_path):
    d, _ = jax_runs
    cli.main(NS + CPU + ["--fast", "--resume", str(d / "p4.npz"), "--max-steps", "6", "--save",
                         str(tmp_path / "q6.npz")])
    jcli.main(NS + ["--fast", "--platform", "cpu", "--resume", str(tmp_path / "q6.npz"),
                    "--max-steps", "8", "--save", str(tmp_path / "j8.npz")])
    _agree(jckpt.load(tmp_path / "j8.npz"), jckpt.load(d / "p8.npz"))


@pytest.mark.parametrize("devices", [1, 2])
def test_resume_bitwise(tmp_path, devices):
    """Save at 4, resume to 8: bitwise a straight 8 (the fast loop, and the
    sharded fast loop at 513x257, the least size the CLI's sharded tier
    shards: replicate_below 257)."""
    size = [] if devices == 1 else ["--nx", "513", "--ny", "257"]
    base = NS + size + CPU + ["--fast", "--devices", str(devices)]
    cli.main(base + ["--max-steps", "4", "--save", str(tmp_path / "a4.npz")])
    cli.main(base + ["--max-steps", "8", "--resume", str(tmp_path / "a4.npz"), "--save",
                     str(tmp_path / "r8.npz")])
    cli.main(base + ["--max-steps", "8", "--save", str(tmp_path / "a8.npz")])
    got, want = checkpoint.load(tmp_path / "r8.npz"), checkpoint.load(tmp_path / "a8.npz")
    assert sorted(got) == sorted(want) == sorted(FIELDS) and int(got["step"]) == 8
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_snapshot_steps_match_jax(jax_runs, monkeypatch):
    _, want = jax_runs
    seen = _spy(monkeypatch, tns, "simulate_fast")
    cli.main(NS + CPU + ["--fast", "--max-steps", "8", "--snapshot-every", "2"])
    assert [s[4] for s in seen[0].snapshots] == want == [4, 6, 8]


def test_host_loop_snapshots(monkeypatch):
    seen = _spy(monkeypatch, tns, "simulate")
    cli.main(["ns", *CPU, "--nx", "65", "--ny", "17", "--Pr", "0.1", "--tol", "1e-7",
              "--max-steps", "5", "--snapshot-every", "2", "--f64"])
    out = seen[0]
    assert len(out.snapshots) == 3  # steps 1, 3 and 5
    np.testing.assert_array_equal(out.snapshots[-1][0], out.T)


def test_host_loop_save_and_resume(tmp_path, monkeypatch):
    """A host-loop save holds T, W, S and t; --resume restores T and W."""
    host = ["ns", *CPU, "--nx", "65", "--ny", "17", "--Pr", "0.1", "--beta", "0.5", "--tol",
            "1e-7", "--f64"]
    seen = _spy(monkeypatch, tns, "simulate")
    cli.main(host + ["--max-steps", "3", "--save", str(tmp_path / "h.npz")])
    out, h = seen[0], checkpoint.load(tmp_path / "h.npz")
    assert sorted(h) == ["S", "T", "W", "t"] and float(h["t"]) == out.sim_time
    for k in ("T", "W", "S"):
        assert h[k].dtype == np.float64 and np.array_equal(h[k], getattr(out, k)), k
    cli.main(host + ["--max-steps", "2", "--resume", str(tmp_path / "h.npz")])
    # the same two steps from T0/W0 given directly
    from fpr_tpu_torch.core.config import MGConfig, NSConfig

    cfg = NSConfig(nx=65, ny=17, Pr=0.1, beta=0.5, tol=1e-7, mg=MGConfig())
    want = tns.simulate(cfg, T0=h["T"], W0=h["W"], max_steps=2, dtype=torch.float64,
                        device="cpu")
    np.testing.assert_array_equal(seen[1].W, want.W)
    np.testing.assert_array_equal(seen[1].T, want.T)


def test_fast_payload_refused_without_fast(tmp_path):
    cli.main(NS + CPU + ["--fast", "--max-steps", "1", "--save", str(tmp_path / "f.npz")])
    with pytest.raises(SystemExit, match="fast-path state; resume with --fast"):
        cli.main(NS + CPU + ["--resume", str(tmp_path / "f.npz")])


def test_scale_physical_size_matches_jax(capsys):
    flags = ["--n", "16", "--ttot", "0.4", "--devices", "2", "--scale-physical-size"]
    jcli.main(["diffusion3d", *flags, "--platform", "cpu"])
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("iterations:")]
    cli.main(["diffusion3d", *flags, *CPU])
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("iterations:")]
    assert got == want and len(got) == 1


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag", [True, False])
def test_scale_physical_size_reaches_config(monkeypatch, flag):
    from fpr_tpu_torch.parallel import dist_diffusion

    seen = []

    def fake(cfg, mesh, **kw):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(dist_diffusion, "solve_distributed", fake)
    with pytest.raises(_Stop):
        cli.main(["diffusion3d", *CPU, "--n", "8", "--devices", "2"]
                 + (["--scale-physical-size"] if flag else []))
    assert seen[0].scale_physical_size is flag


@pytest.mark.parametrize("argv", [
    ["ns", "--max-steps", "1"], ["mg", "--k", "5"], ["diffusion3d", "--n", "8"],
    ["bench", "--quick"]])
def test_default_device_needs_a_card(argv):
    """Without a card the default --device cuda exits with a message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(argv)
