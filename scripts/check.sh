#!/usr/bin/env bash
# CPU verification pass: test suite (virtual 8-CPU mesh), multichip
# dryrun, entry compile check, multi-host dryrun.  Measurements and the
# card's own checks are `python chip_smoke.py` and `python bench.py`, on a GPU.
#
#   check.sh          full suite (tens of minutes on a small host)
#   check.sh --quick  signal in <5 min: skips @pytest.mark.slow training/e2e
#                     tests; keeps the dryruns
set -e
cd "$(dirname "$0")/.."

QUICK=0
[ "${1:-}" = "--quick" ] && QUICK=1

if [ "$QUICK" = 1 ]; then
  echo "== quick tests (virtual 8-device CPU mesh, -m 'not slow') =="
  python -m pytest tests/ -x -q -m "not slow"
else
  echo "== unit + integration tests (virtual 8-device CPU mesh) =="
  python -m pytest tests/ -x -q
fi

echo "== multichip dryrun (8 virtual devices) =="
JAX_PLATFORM_NAME=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" \
python -c "
import jax; jax.config.update('jax_platforms', 'cpu')
import __graft_entry__ as ge
ge.dryrun_multichip(8); print('dryrun OK')
fn, args = ge.entry()
img = jax.jit(fn)(*args); img.block_until_ready()
print('entry OK', img.shape)
"

echo "== multi-HOST dryrun (2 processes x 4 CPU devices, gloo) =="
python -c "
import __graft_entry__ as ge
ge.dryrun_multiprocess(n_processes=2, local_devices=4, port=12971)
"
