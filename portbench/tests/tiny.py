"""Each cell cut to a size the CPU runs in a second or two: the tests' runs
take the cell's files with these numbers set over them, nothing else."""

from portbench import run
from portbench.common import load_json

TINY = {
    "ns_explicit": dict(params=dict(nx=129, ny=33, ttot=0.0015),
                        traffic=dict(burn_in_s=0.0, stretch={"from": 3, "steps": 2})),
    "ns_semi": dict(params=dict(nx=129, ny=33, ttot=0.02),
                    traffic=dict(burn_in_s=0.0, fields=2, stretch={"from": 1, "steps": 1})),
    "diffusion_512_k3": dict(params=dict(nx=20, ny=18, nz=16, iter_max=30, ttot=0.4),
                             traffic=dict(burn_in_s=0.0)),
    "diffusion_128_tol": dict(params=dict(nx=16, ny=16, nz=16, ttot=0.4),
                              traffic=dict(burn_in_s=0.0)),
}
BENCH = load_json(run.ROOT / "BENCHMARK.json")
CELLS = sorted(TINY)


class Event:
    """A stand-in for a CUDA timing event: record() stamps the next tick of
    a shared clock, elapsed_time() is in milliseconds."""

    clock = [0.0]

    def record(self):
        Event.clock[0] += 1.0
        self.t = Event.clock[0]

    def elapsed_time(self, other):
        return other.t - self.t


def run_tiny(name: str, trace: bool = False, seconds: float = 0.05, seed: int = 2**31 + 7,
             bench=None, root=run.ROOT) -> dict:
    return run.run_cell(BENCH if bench is None else bench, name, seed, seconds, trace,
                        device="cpu", log=lambda m: None, root=root, overrides=TINY[name],
                        event=Event)
