"""The control (the plain reference put in the program's place, its state
rounded to bfloat16) comes out not correct under each cell's limits, at a
size a test run holds; on the card, at the cell's own size."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import control, run
from portbench.common import judge
from portbench.tests.tiny import TINY


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_the_limits(name):
    out = control.readings(name, [], [2**31 + 3], torch.device("cpu"), overrides=TINY[name],
                           log=lambda m: None)
    checks, failed = judge(out["control"], out["limits"])
    assert failed == 1, checks


@pytest.mark.card
@pytest.mark.parametrize("name", ["diffusion_128_tol"])
def test_control_fails_on_the_card(card, name):
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload", name,
                          "--control-seeds", str(2**31 + 21)],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert any(last["control_min"][n] > lim for n, lim in last["limits"].items())
