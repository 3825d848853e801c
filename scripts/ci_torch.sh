#!/usr/bin/env bash
# Blocking serving smokes of the PyTorch/CUDA port (src/repro_torch), the
# twins of ci.sh's --decode-smoke, --disagg-smoke, --route-smoke and
# --remote-smoke. They run on the CUDA card by default (and fail without
# one); --cpu runs them on the CPU through the kernels' plain PyTorch
# versions.
#
#   ./scripts/ci_torch.sh --decode-smoke [--cpu]  # the event-driven
#                                  # server's continuous-batching decode
#                                  # over the paged KV arena; every stream
#                                  # token-exact against the unbatched
#                                  # reference (exit 1 on mismatch or any
#                                  # local fallback)
#   ./scripts/ci_torch.sh --disagg-smoke [--cpu]  # disaggregated decode:
#                                  # a prefill-role pool hands KV blocks to a
#                                  # decode-role pool over the transport;
#                                  # token-exact, >= 1 cross-pool KV handoff
#                                  # and no local fallback (exit 1 otherwise)
#   ./scripts/ci_torch.sh --route-smoke [--cpu]   # two fleet front-ends
#                                  # over one shared pool, one wedged with a
#                                  # burst queued: the survivor must steal
#                                  # it (>= 1 steal, nothing shed, every
#                                  # result equal to the forward)
#   ./scripts/ci_torch.sh --remote-smoke [--cpu]  # launch.serve's fleet
#                                  # loop with every pool in a worker
#                                  # process behind a socket; exit 1 unless
#                                  # it drains with every result equal to
#                                  # the forward
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

case "${1:-}" in
    --decode-smoke) fn=run_decode_smoke ;;
    --disagg-smoke) fn=run_disagg_smoke ;;
    --route-smoke) fn=run_route_smoke ;;
    --remote-smoke) fn="" ;;
    *) echo "usage: $0 --decode-smoke|--disagg-smoke|--route-smoke|" \
            "--remote-smoke [--cpu]" >&2; exit 2 ;;
esac
device=""
if [[ "${2:-}" == "--cpu" ]]; then
    device="cpu"
fi

if [[ "$1" == "--remote-smoke" ]]; then
    exec python -m repro_torch.launch.serve --serve-loop --execute socket \
        --serve-seconds 2 --clients 2 --frontends 2 \
        --advertise-host 127.0.0.1 --device "${device:-cuda}"
fi

if [[ "$fn" == "run_route_smoke" ]]; then
    SMOKE_DEVICE="$device" python - <<'PY'
import os
import sys

from repro_torch.serving.smoke import run_route_smoke

report = run_route_smoke(device=os.environ["SMOKE_DEVICE"] or None,
                         log=lambda *a: print(*a, flush=True))
ok = (report["numerics_ok"] and report["steals"] >= 1
      and report["shed"] == 0)
if not ok:
    print(f"[route-smoke] FAIL: steals={report['steals']} "
          f"shed={report['shed']} "
          f"{report.get('numerics_error', '')}", file=sys.stderr)
sys.exit(0 if ok else 1)
PY
    exit $?
fi

SMOKE_FN="$fn" SMOKE_DEVICE="$device" python - <<'PY'
import os
import sys

from repro_torch.serving import smoke

fn = os.environ["SMOKE_FN"]
tag = fn.removeprefix("run_").replace("_", "-")
report = getattr(smoke, fn)(device=os.environ["SMOKE_DEVICE"] or None,
                            log=lambda *a: print(*a, flush=True))
ok = (report["numerics_ok"] and report["numerics_checked"] > 0
      and report["decode_local"] == 0
      and (fn != "run_disagg_smoke" or report["kv_handoffs"] >= 1))
dec = report.get("decode", {})
print(f"[{tag}] attainment={dec.get('attainment', 0.0):.2f} "
      f"checked={report['numerics_checked']} "
      f"handoffs={report['kv_handoffs']} local={report['decode_local']}")
if not ok:
    print(f"[{tag}] FAIL: {report.get('numerics_error', '')}",
          file=sys.stderr)
sys.exit(0 if ok else 1)
PY
