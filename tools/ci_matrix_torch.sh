#!/usr/bin/env bash
# Configuration-matrix gate of the PyTorch port (`jpeg_decoder_tpu_torch/`),
# the counterpart of tools/ci_matrix.sh, whose axes it follows where the
# port honours them:
#
#   1. native C++ entropy engine  vs  pure-Python oracle (JPEG_TPU_DISABLE_NATIVE)
#   2. the CPU (plain kernels)    vs  the card (the hand-written kernels)
#   3. one device                 vs  a mesh of device slots, one or two processes
#
# plus the host switches that change the wire the card gets: the forced
# speculative prescan split (JPEG_TPU_SPEC_PRESCAN) and the span classes
# (JPEG_TPU_CLASS_COLLAPSE=0). Every leg sets its JPEG_TPU_* variable on its
# own command line, never in a process already running, and first checks
# that the host engine under that environment is the one it names
# (`engine`), so a failed g++ build cannot turn a native leg into a second
# oracle leg. The pytest legs run tier-1's options over tests/test_torch_*.py.
#
# Usage: tools/ci_matrix_torch.sh [leg ...]    (no leg: every leg)
# Prints "=== [leg] PASS (N s)", "FAIL (N s)" or "SKIP (no CUDA)" per leg;
# exits 1 if any leg failed. A skipped leg is neither a pass nor a fail.
set -u

cd "$(dirname "$0")/.."
FAILED=0
ONLY=" $* "
PYTEST=(python -m pytest -q -m 'not slow' -p no:cacheprovider -p xdist -n 6
        --dist loadfile -p no:randomly)
TORCH_TESTS=(tests/test_torch_*.py)

wanted() { [ "$ONLY" = "  " ] || [[ "$ONLY" == *" $1 "* ]]; }

run() {
  local name="$1"; shift
  wanted "$name" || return 0
  echo "=== [$name] $*"
  local t0=$SECONDS
  if "$@"; then echo "=== [$name] PASS ($((SECONDS - t0)) s)"
  else echo "=== [$name] FAIL ($((SECONDS - t0)) s)"; FAILED=1; fi
}

skip() { wanted "$1" && echo "=== [$1] SKIP ($2)"; return 0; }

# engine native|oracle [env VAR=value ...] cmd ...: fail unless the port's
# host engine (`host/entropy/native.py::get_native`) under the command's
# own environment is the one named; then run the command in it.
engine() {
  local want="$1"; shift
  local vars=()
  if [ "$1" = env ]; then
    shift
    while [[ "$1" == *=* ]]; do vars+=("$1"); shift; done
  fi
  env ${vars[@]+"${vars[@]}"} python -c '
import sys
from jpeg_decoder_tpu_torch.host.entropy.native import get_native
got = "oracle" if get_native() is None else "native"
print(f"=== engine {got}", flush=True)
sys.exit(got != sys.argv[1])' "$want" || return 1
  env ${vars[@]+"${vars[@]}"} "$@"
}

# native+cpu (ci_matrix.sh:23): every port test, native engine, CPU.
run "native+cpu" engine native "${PYTEST[@]}" "${TORCH_TESTS[@]}"

# oracle+cpu (ci_matrix.sh:26): the same through the pure-Python oracle.
# No test is deselected: every port test stages through whichever engine
# the environment selects.
run "oracle+cpu" engine oracle env JPEG_TPU_DISABLE_NATIVE=1 \
    "${PYTEST[@]}" "${TORCH_TESTS[@]}"

# interpret-slow (ci_matrix.sh:36-47) has no counterpart: the port has no
# interpret mode; the replay tests in native+cpu run the kernels' own
# sources on the CPU.

# dryrun4, dryrun8 (ci_matrix.sh:50-54): the multichip dry run on CPU slots.
for n in 4 8; do
  run "dryrun$n" engine native env PYTHONPATH= python -c "
from jpeg_decoder_tpu_torch.parallel.dryrun import dryrun_multichip
print(dryrun_multichip($n, devices=['cpu'] * $n))"
done

# multiproc2 (ci_matrix.sh:59): two gloo ranks over one mesh of CPU slots.
run "multiproc2" engine native env PYTHONPATH= \
    python tools/multiproc_mesh_torch.py --device cpu

# entry (ci_matrix.sh:62): the jpg -> png entry point.
ENTRY_PNG="${TMPDIR:-/tmp}/ci_matrix_torch_entry_$$.png"
run "entry" engine native env PYTHONPATH= python examples/decode_torch.py \
    tests/fixtures/torch_port/tower_420.jpg "$ENTRY_PNG" --device cpu
rm -f "$ENTRY_PNG"

# fuzz200 (ci_matrix.sh:66): host mode, native vs oracle vs streaming.
run "fuzz200" engine native python tools/fuzz_torch.py 200 1

# fuzzdev200 (ci_matrix.sh:70): device mode on the CPU (plain kernels).
run "fuzzdev200" engine native env PYTHONPATH= \
    python tools/fuzz_torch.py 200 1 --device --torch-device cpu

# gatherasm (ci_matrix.sh:74) has no counterpart: the assemblers behind
# JPEG_TPU_STRUCT_ASM are on ROADMAP §1 "Code the port does not need".

# specprescan (ci_matrix.sh:80): the speculative prescan split forced onto
# every baseline segment of at least 4 KiB; the wire must not change.
run "specprescan" engine native env JPEG_TPU_SPEC_PRESCAN=4096 \
    "${PYTEST[@]}" tests/test_torch_host_copy.py tests/test_torch_slice.py \
    tests/test_torch_chunk_decode.py tests/test_torch_stream_paths.py \
    tests/test_torch_batch.py tests/test_torch_stripes.py

# fuzzdev-spec (ci_matrix.sh:87): the same split under mutation.
run "fuzzdev-spec" engine native env PYTHONPATH= JPEG_TPU_SPEC_PRESCAN=4096 \
    python tools/fuzz_torch.py 150 11 --device --torch-device cpu

# fusedasm (ci_matrix.sh:94) and pack16-off (:104) have no counterpart:
# ROADMAP §1 "Code the port does not need" (the fused assemblers, pack16).

# collapse-off (ci_matrix.sh:109): the span classes, one class per budget.
run "collapse-off" engine native env JPEG_TPU_CLASS_COLLAPSE=0 \
    "${PYTEST[@]}" tests/test_torch_chunk_decode.py tests/test_torch_assemble.py \
    tests/test_torch_slice.py tests/test_torch_stripes.py tests/test_torch_batch.py

# wire-words-packed and wire-slots (ci_matrix.sh:116-119) have no
# counterpart: K1 reads the stream itself (ROADMAP §1 "Code the port does
# not need"). benchsmoke (ci_matrix.sh:125) waits for the port's benchmark.

# card, card-oracle (axis 2 of ci_matrix.sh:4-10): the card tests under each
# engine, then chip_smoke.py (which runs phase 27, the main path along the
# host switches). Only where torch sees a CUDA device; no pytest-xdist: one
# process owns the card.
if python -c "import sys, torch; sys.exit(not torch.cuda.is_available())"; then
  run "card" engine native bash -c "python -m pytest -q -p no:cacheprovider \
      tests/test_torch_cuda.py && python3 chip_smoke.py"
  run "card-oracle" engine oracle env JPEG_TPU_DISABLE_NATIVE=1 \
      python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py
else
  skip "card" "no CUDA"
  skip "card-oracle" "no CUDA"
fi

exit $FAILED
