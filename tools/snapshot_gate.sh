#!/bin/bash
# Snapshot gate: a round snapshot must not ship with a red suite.
#
# Runs the full test gate (run_tests.sh: compile + lint + pytest with
# doctests + coverage floor) and stamps TESTS_GREEN with the current
# commit on success; exits nonzero (and removes any stale stamp) on
# failure. The round workflow runs this before the final commit of a
# round — a missing or stale stamp means the snapshot was not verified
# green (round-3 shipped 1 failed / 368 passed exactly because nothing
# enforced this; VERDICT round 3, weak #1).
set -e
cd "$(dirname "$0")/.."

rm -f TESTS_GREEN
./run_tests.sh
git rev-parse HEAD > TESTS_GREEN 2>/dev/null || echo "no-git" > TESTS_GREEN
date -u +"%Y-%m-%dT%H:%M:%SZ" >> TESTS_GREEN
echo "=== snapshot gate: suite green, stamp written ==="
