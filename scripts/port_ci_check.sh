#!/usr/bin/env bash
# CI gate of the PyTorch port (src/repro_torch), on the CPU: the port's
# tests plus bounded smoke runs of its CLIs, examples and scripts (the
# reference's scripts/ci_check.sh).
#
#   ./scripts/port_ci_check.sh           # the port's tests + smoke
#   ./scripts/port_ci_check.sh --fast    # tests/test_torch_*.py -m "not claims"
#                                        # (pytest-xdist when available) + smoke
#   ./scripts/port_ci_check.sh --smoke   # smoke only
#   ./scripts/port_ci_check.sh --lint    # repro_torch.analysis: the round
#                                        # programs' checks + the source lint;
#                                        # writes bench_out/analysis_report.json
#
# Everything runs with --device cpu: the hand kernels run their plain
# versions. Their builds and launches are checked on the card by
# chip_smoke.py. The reference's bench smokes (kernel_bench,
# exchange_bench, trajectory_bench, shard_bench, obs_bench, workers_bench,
# accounting_bench) have no counterpart here: the port's benches come
# with their own change (ROADMAP A18).
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
CPU="--device cpu"

if [[ "${1:-}" == "--lint" ]]; then
    echo "== lint tier: repro_torch.analysis (program checks + source lint) =="
    mkdir -p bench_out
    python -m repro_torch.analysis $CPU --hidden 16 -q \
        --json bench_out/analysis_report.json
    echo "port_ci_check --lint: OK"
    exit 0
fi

XDIST=""
if python -c "import xdist" >/dev/null 2>&1; then
    XDIST="-p xdist -n 6 --dist loadfile"
fi

if [[ "${1:-}" == "--fast" ]]; then
    echo "== fast tier: the port's tests, -m 'not claims' =="
    python -m pytest -q -m "not claims" ${XDIST} tests/test_torch_*.py
elif [[ "${1:-}" != "--smoke" ]]; then
    echo "== the port's tests =="
    python -m pytest -q ${XDIST} tests/test_torch_*.py
fi

echo "== dynamic scenario: iot_dense, 40 rounds =="
python -m repro_torch.launch.train $CPU \
    --arch dwfl-paper --steps 40 --workers 8 --hidden 64 \
    --channel-model dynamic --scenario iot_dense --coherence-rounds 10 \
    --eval-every 20

echo "== the fleet: R = 4 replicates, tree and flat =="
python -m repro_torch.launch.train $CPU \
    --arch dwfl-paper --steps 10 --workers 6 --hidden 16 \
    --channel-model dynamic --scenario iot_dense --replicates 4 \
    --eval-every 5
python -m repro_torch.launch.train $CPU \
    --arch dwfl-paper --steps 10 --workers 6 --hidden 16 \
    --channel-model dynamic --scenario iot_dense --replicates 2 \
    --flat-buffer --eval-every 5

echo "== the flat buffer, sharded columns, a checkpoint =="
python -m repro_torch.launch.train $CPU \
    --arch dwfl-paper --steps 10 --workers 6 --hidden 16 --flat-buffer \
    --eval-every 5
python -m repro_torch.launch.train $CPU \
    --arch dwfl-paper --steps 10 --workers 6 --hidden 16 --batch-size 8 \
    --flat-buffer --model-shards 2 --chunk-rounds 4 --eval-every 5 \
    --checkpoint bench_out/ci_ckpt/run

echo "== sparse neighbor lists =="
python -m repro_torch.launch.train $CPU \
    --arch dwfl-paper --steps 10 --workers 16 --hidden 16 --batch-size 8 \
    --channel-model dynamic --scenario mesh_sparse --sparse-neighbors 4 \
    --graph-fallback --flat-buffer --chunk-rounds 4 --eval-every 5

echo "== run log + report =="
OBS_RUNDIR="bench_out/runlogs_port"
rm -rf "$OBS_RUNDIR" && mkdir -p "$OBS_RUNDIR"
python -m repro_torch.launch.train $CPU \
    --arch dwfl-paper --steps 10 --workers 6 --hidden 16 --batch-size 8 \
    --channel-model dynamic --scenario iot_dense --flat-buffer \
    --chunk-rounds 4 --eval-every 5 --runlog-dir "$OBS_RUNDIR" \
    --accountant rdp
python -m repro_torch.obs.report "$OBS_RUNDIR"

echo "== the examples at their smallest settings =="
python examples/port_quickstart.py $CPU --rounds 3
python examples/port_dynamic_quickstart.py $CPU --rounds 3
python examples/port_fleet_quickstart.py $CPU --rounds 3
python examples/port_compare_schemes.py $CPU --workers 4 --steps 2
python examples/port_train_dwfl_e2e.py $CPU --steps 2 --workers 2 \
    --batch 2 --seq-len 32 --checkpoint bench_out/ci_ckpt/e2e
python examples/port_serve_batched.py $CPU --requests 2 --batch 2 --gen 4

echo "== the dev scripts =="
python scripts/port_dev_smoke.py $CPU gemma-2b zamba2-7b dwfl-paper
python scripts/port_dev_dwfl.py $CPU --rounds 2
python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k \
    --out bench_out/dryrun_ci
python scripts/port_roofline_report.py --dir bench_out/dryrun_ci
python scripts/port_perf_iter.py gemma-2b decode_32k ci --top

echo "== source lint (repro_torch.analysis) =="
python -m repro_torch.analysis $CPU --source-only

echo "port_ci_check: OK"
