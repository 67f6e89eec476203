"""The port's experiment sweeps (fpr_tpu/experiments/), one module each:

    python -m fpr_tpu_torch.experiments.part1_benchmark
    python -m fpr_tpu_torch.experiments.part1_error_experiments --mode grid|tol
    python -m fpr_tpu_torch.experiments.part1_scaling --mode strong|weak --devices N
    python -m fpr_tpu_torch.experiments.multigrid_bench [--workprec]
    python -m fpr_tpu_torch.experiments.ns_timestepping [--solver direct|mixed|fast]
    python -m fpr_tpu_torch.experiments.dist_mg_large --k 15 --devices 4

Each takes the JAX module's flags but its TPU-only ones, with ``--device``
(default ``cuda``; no card is an error, ``cpu`` runs the plain versions).
Rows go to CSVs under ``benchmark-results-torch/`` (``RESULTS``) with the
JAX rows' columns, so that ``fpr_tpu_torch.plotting.plots`` (and JAX's
``plots.py``) read them, and two that differ: ``backend`` is "cuda" or
"cpu", and ``device`` names the card.  A row whose key (``backend``
included) is in the CSV already is skipped.  ``scripts/run_all_torch.sh``
runs the sweeps' rows.
"""

RESULTS = "benchmark-results-torch"
