#!/usr/bin/env bash
# End-to-end service gates of the PyTorch port (hyperopt_tpu_torch), under
# the *_GATE names run_tests.sh gives the JAX package's:
#
#   SLO_GATE=1 STORE_GATE=1 ./run_torch_gates.sh                      # on the card
#   TORCH_GATE_DEVICE=cpu SERVICE_CHAOS_GATE=1 ./run_torch_gates.sh   # on the CPU
#
# Each gate first runs the port's tests of its plane, then its script
# (scripts/torch_<reference script>.py), which drives the port's server,
# fleet, scrub and report processes on $TORCH_GATE_DEVICE (default cuda)
# at the reference's sizes.  On the
# CPU the plane's tests are its tests/test_torch_*.py files, which hold
# the port against the live JAX package; with a card they are the plane's
# card tests in tests/test_torch_cuda.py (the JAX package may be absent
# there).  Each script's output is kept in chiprun_out/gates, and its
# GATE_RESULT line is appended to gates.jsonl there.  TRACE_GATE, SERVE_GATE and PROFILE_GATE port no script: the
# port's obs tests already run scripts/validate_trace.py and the scrape
# lint on the port's exports.  CHAOS_GATE, SHARD_GATE, DONATION_GATE and
# BENCH_GATE have no counterpart yet (ROADMAP queue 1).
set -u
cd "$(dirname "$0")"
DEVICE="${TORCH_GATE_DEVICE:-cuda}"
export TORCH_GATE_DEVICE="$DEVICE"
LOG_DIR=chiprun_out/gates
mkdir -p "$LOG_DIR"

plane_tests() {  # $1: CPU test files, $2: card test -k expression
    if [ "$DEVICE" = "cpu" ]; then
        # shellcheck disable=SC2086
        JAX_PLATFORMS=cpu python -m pytest $1 -q -p no:cacheprovider || exit 1
    else
        python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q \
            -p no:cacheprovider -k "$2" || exit 1
    fi
}

gate_script() {  # $1: script stem
    local stem="$1"

    echo "== $stem ($DEVICE)"
    python "scripts/$stem.py" --device "$DEVICE" 2>&1 | tee "$LOG_DIR/$stem.log"
    local rc=${PIPESTATUS[0]}
    grep -h '^GATE_RESULT ' "$LOG_DIR/$stem.log" | sed 's/^GATE_RESULT //' \
        >> "$LOG_DIR/gates.jsonl"
    [ "$rc" -eq 0 ] || exit 1
}

if [ "${SLO_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_reqtrace.py tests/test_torch_service_http.py" \
        "service_resume or capture"
    gate_script torch_slo_smoke
fi
if [ "${STORE_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_service_wal.py tests/test_torch_backends.py" \
        "service_resume"
    gate_script torch_store_chaos_smoke
fi
if [ "${SERVICE_CHAOS_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_service_wal.py tests/test_torch_overload.py tests/test_torch_service_http.py" \
        "service_resume or ladder"
    gate_script torch_service_chaos_smoke
fi
if [ "${FLEET_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_service_fleet.py tests/test_torch_fleet.py" "fleet"
    gate_script torch_fleet_smoke
fi
if [ "${TENANT_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_planes.py tests/test_torch_overload.py" "planes"
    gate_script torch_tenant_smoke
fi
if [ "${LOAD_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_planes.py tests/test_torch_service_fleet.py" \
        "planes or fleet"
    gate_script torch_load_smoke
fi
if [ "${PROBE_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_prober.py" "canary or capture"
    gate_script torch_probe_smoke
fi
if [ "${QUALITY_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_planes.py" "planes"
    gate_script torch_quality_smoke
fi
if [ "${KERNEL_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_megakernel.py tests/test_torch_cohort.py tests/test_torch_wide.py" \
        "kernel or scheduler or widened"
    gate_script torch_kernel_smoke
fi
if [ "${COMPILE_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_service_wal.py" "service_resume"
    gate_script torch_coldstart_smoke
fi
if [ "${SERVICE_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_service_http.py tests/test_torch_cohort.py" \
        "scheduler or service_resume"
    gate_script torch_service_smoke
fi
if [ "${TRACE_GATE:-0}" = "1" ] || [ "${SERVE_GATE:-0}" = "1" ] \
        || [ "${PROFILE_GATE:-0}" = "1" ]; then
    plane_tests "tests/test_torch_obs.py" "armed_obs or capture"
fi
exit 0
