#!/usr/bin/env bash
# One-command quality gate (the counterpart of the reference's
# scripts/check.sh: fmt/clippy/test/doctest). Usage:
#   scripts/check.sh          # lint + native build + fast test subset (<60 s)
#   scripts/check.sh --full   # lint + native build + the whole suite
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== lint (scripts/lint.py)"
python scripts/lint.py

echo "== byte-compile"
python -m compileall -q versatiles_glyphs_tpu tests scripts __graft_entry__.py chip_smoke.py

echo "== native build (csrc)"
g++ -O3 -fPIC -shared -std=c++17 -pthread -Wall -Wextra \
    -o /tmp/vg_native_check.so csrc/vg_native.cpp
rm -f /tmp/vg_native_check.so

if [[ "${1:-}" == "--full" ]]; then
  echo "== full test suite"
  JAX_PLATFORMS=cpu python -m pytest tests/ -q
else
  echo "== fast test subset"
  JAX_PLATFORMS=cpu python -m pytest -q \
    tests/test_geometry.py tests/test_flatten.py tests/test_names.py \
    tests/test_pbf.py tests/test_writer.py tests/test_index.py \
    tests/test_font.py tests/test_native.py tests/test_cff.py \
    tests/test_errors.py tests/test_multihost.py tests/test_multihost_real.py
fi
echo "check: OK"
