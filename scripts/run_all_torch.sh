#!/usr/bin/env bash
# Every sweep of the PyTorch + CUDA port (fpr_tpu_torch.experiments) on the
# card, the rows of run_all_benchmarks.sh: each experiment skips the rows
# whose key is in its CSV already, so a second run resumes.  Extra
# arguments go to the diffusion grid sweep, e.g. --max-e 6.  Each row
# prints its exit code and wall seconds on a "row ..." line; a sweep exits
# 1 when a configuration failed or did not converge (it writes no row
# then), and so does this script when any row did.
#
#   scripts/run_all_torch.sh                   # CSVs under benchmark-results-torch/
#   RESULTS=/some/dir scripts/run_all_torch.sh
set -uo pipefail

RESULTS=${RESULTS:-benchmark-results-torch}
PY=${PY:-python}
EX=fpr_tpu_torch.experiments
failed=0

# the card's name and power limit beside the rows, one line per card seen;
# plots.py writes them under every figure
mkdir -p "$RESULTS"
{ cat "$RESULTS/card.txt" 2>/dev/null
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null; } | sort -u > "$RESULTS/card.tmp"
mv "$RESULTS/card.tmp" "$RESULTS/card.txt"

row() {  # row NAME ARGS...: one sweep row, with its exit code and wall seconds
    local name=$1 t0=$SECONDS rc
    shift
    "$@"
    rc=$?
    echo "row $name: rc=$rc seconds=$((SECONDS - t0))"
    [[ $rc -eq 0 ]] || failed=1
}

echo "== diffusion grid sweep =="
row bench_diffusion $PY -m $EX.part1_benchmark --out "$RESULTS/bench_diffusion.csv" "$@"

echo "== diffusion on a virtual z-mesh of 4 shards on the one card =="
row scaling_strong $PY -m $EX.part1_scaling --mode strong --devices 4 \
    --out "$RESULTS/diffusion_scaling.csv"
row scaling_weak $PY -m $EX.part1_scaling --mode weak --devices 4 \
    --out "$RESULTS/diffusion_scaling.csv"

echo "== work-precision =="
row error_grid $PY -m $EX.part1_error_experiments --mode grid \
    --out "$RESULTS/error_vs_grid_size.csv"
row error_tol $PY -m $EX.part1_error_experiments --mode tol --n 128 \
    --out "$RESULTS/error_vs_tolerance.csv"

echo "== multigrid sweep =="
MG="$RESULTS/bench_multigrid.csv"
row mg_k12 $PY -m $EX.multigrid_bench --max-k 12 --dst --out "$MG"
row mg_ds $PY -m $EX.multigrid_bench --solvers ds --min-k 10 --max-k 14 --dst --out "$MG"
# deep-smoothed rows (labelled ds_v55; the V(2,2) rows above stay)
row mg_ds_v55 $PY -m $EX.multigrid_bench --solvers ds --min-k 10 --max-k 14 --max-l 2 \
    --dst --smooths 5 --out "$MG"
WP="$RESULTS/mg_workprecision.csv"
row mg_workprec $PY -m $EX.multigrid_bench --workprec --max-k 14 --out "$WP"

echo "== NS timestepping (full 2049x513 scale), the fast loop =="
# solver labels fast and fast_stol100 (the relaxed streamfunction tolerance)
row ns_fast $PY -m $EX.ns_timestepping --solver fast --out "$RESULTS/ns_fullscale.csv"
row ns_fast_stol100 $PY -m $EX.ns_timestepping --solver fast \
    --out "$RESULTS/ns_fullscale.csv" --s-tol-factor 100 --betas 0.0

echo "== NS timestepping (full 2049x513 scale), the float64 host loop =="
row ns_mixed $PY -m $EX.ns_timestepping --solver mixed --out "$RESULTS/ns_fullscale.csv"

# The CSVs are in $RESULTS, with the columns that fpr_tpu_torch/plotting/plots.py
# reads (plus device, the card's name); the figures are drawn where matplotlib is:
#   python -m fpr_tpu_torch.plotting.plots --results "$RESULTS" --figs figs-torch
exit $failed
