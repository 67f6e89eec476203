#!/usr/bin/env bash
# Every sweep of the PyTorch + CUDA port (fpr_tpu_torch.experiments) on the
# card, the rows of run_all_benchmarks.sh: each experiment skips the rows
# whose key is in its CSV already, so a second run resumes.  Extra
# arguments go to the diffusion grid sweep, e.g. --max-e 6.
#
#   scripts/run_all_torch.sh                   # CSVs under benchmark-results-torch/
#   RESULTS=/some/dir scripts/run_all_torch.sh
set -uo pipefail

RESULTS=${RESULTS:-benchmark-results-torch}
PY=${PY:-python}
EX=fpr_tpu_torch.experiments

echo "== diffusion grid sweep =="
$PY -m $EX.part1_benchmark --out "$RESULTS/bench_diffusion.csv" "$@"

echo "== diffusion on a virtual z-mesh of 4 shards on the one card =="
$PY -m $EX.part1_scaling --mode strong --devices 4 --out "$RESULTS/diffusion_scaling.csv"
$PY -m $EX.part1_scaling --mode weak --devices 4 --out "$RESULTS/diffusion_scaling.csv"

echo "== work-precision =="
$PY -m $EX.part1_error_experiments --mode grid --out "$RESULTS/error_vs_grid_size.csv"
$PY -m $EX.part1_error_experiments --mode tol --n 128 --out "$RESULTS/error_vs_tolerance.csv"

echo "== multigrid sweep =="
$PY -m $EX.multigrid_bench --max-k 12 --dst --out "$RESULTS/bench_multigrid.csv"
$PY -m $EX.multigrid_bench --solvers ds --min-k 10 --max-k 14 --dst \
    --out "$RESULTS/bench_multigrid.csv"
# deep-smoothed rows (labelled ds_v55; the V(2,2) rows above stay)
$PY -m $EX.multigrid_bench --solvers ds --min-k 10 --max-k 14 --max-l 2 --dst --smooths 5 \
    --out "$RESULTS/bench_multigrid.csv"
$PY -m $EX.multigrid_bench --workprec --max-k 14 --out "$RESULTS/mg_workprecision.csv"

echo "== NS timestepping (full 2049x513 scale) =="
# solver labels fast and fast_stol100 (the relaxed streamfunction tolerance)
$PY -m $EX.ns_timestepping --solver fast --out "$RESULTS/ns_fullscale.csv"
$PY -m $EX.ns_timestepping --solver fast --out "$RESULTS/ns_fullscale.csv" \
    --s-tol-factor 100 --betas 0.0
$PY -m $EX.ns_timestepping --solver mixed --out "$RESULTS/ns_fullscale.csv"

# The CSVs are in $RESULTS, with the columns that fpr_tpu/plotting/plots.py
# reads (plus device, the card's name); no figures are drawn here.
