#!/bin/bash
# Exhaustive-tier runner (CPU), sharded into one pytest process per test
# group.
#
# Root cause of the sharding: XLA:CPU's in-process compiler segfaults
# deterministically after ~60-70 jit compilations of the big interpret-mode
# Pallas test programs (crash frame: jax/_src/compiler.py
# backend_compile_and_load, i.e. inside jaxlib's C++ compile — reproduced
# at xla_backend_optimization_level 0 AND 1, with the persistent cache
# read-only, on two different test orderings; every individual test passes
# in a fresh process).  An accumulation bug in the bundled LLVM JIT, not
# fixable from here — so no shard may run more than ~40 kernel-compiling
# tests.  test_pallas.py (102 tests, 4x18 of them the dist x t-conorm
# matrix) is split by matrix group; every other file is one shard.
# The log (default results/exhaustive.log, git-ignored) certifies one commit.
#
# Usage: bash tools/run_exhaustive.sh [logfile]
set -u
LOG="${1:-results/exhaustive.log}"

# The log is validation evidence for the commit it names: refuse to run on
# a dirty tree, so the recorded hash is exactly the code that was tested.
if [ -n "$(git status --porcelain --untracked-files=no)" ]; then
  echo "run_exhaustive.sh: working tree is dirty — commit or stash first;" >&2
  echo "the log must certify one exact commit." >&2
  git status --porcelain --untracked-files=no >&2
  exit 2
fi

mkdir -p "$(dirname "$LOG")"
: > "$LOG"
overall=0
echo "# exhaustive tier, sharded — $(git rev-parse --short HEAD) — $(date -u +%FT%TZ)" >> "$LOG"

run_shard() {  # run_shard <label> <pytest args...>
  local label="$1"; shift
  echo "=== shard: $label ===" >> "$LOG"
  GENDR_EXHAUSTIVE=1 GENDR_CACHE_READONLY="${GENDR_CACHE_READONLY:-1}" \
    timeout 5400 python -m pytest "$@" -q >> "$LOG" 2>&1
  local rc=$?
  echo "=== shard exit: $rc ===" >> "$LOG"
  if [ "$rc" -ne 0 ]; then overall=1; fi
}

for f in tests/test_*.py; do
  if [ "$f" = "tests/test_pallas.py" ]; then
    # two parametrized matrices: test_pallas_dist_matrix (rgb-mode x 18
    # dists) and test_pallas_dist_tcn_matrix (t-conorm x 18 dists);
    # "dist_matrix" is NOT a substring of "dist_tcn_matrix", so the -k
    # selections below are disjoint and cover the file exactly
    run_shard "$f [non-matrix]" "$f" \
      -k "not dist_matrix and not dist_tcn_matrix"
    run_shard "$f [dist_matrix: rgb modes]" "$f" -k "dist_matrix"
    run_shard "$f [tcn matrix: hamacher]" "$f" \
      -k "dist_tcn_matrix and hamacher"
    run_shard "$f [tcn matrix: yager]" "$f" -k "dist_tcn_matrix and yager"
    run_shard "$f [tcn matrix: frank]" "$f" -k "dist_tcn_matrix and frank"
  else
    run_shard "$f" "$f"
  fi
done
echo "=== overall: $overall ===" >> "$LOG"
exit "$overall"
