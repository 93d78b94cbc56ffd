#!/usr/bin/env bash
# Memory-safety / UB gate for the PyTorch port's copy of the C++ entropy
# kernel (jpeg_decoder_tpu_torch/host/entropy/cpp/entropy.cc), the
# counterpart of tools/asan_check.sh (which builds only the JAX package's):
# builds an ASan+UBSan instrumented library with the same flags, points
# JPEG_TPU_NATIVE_SO at it (read by host/entropy/native_impl.py) and drives
# the port's fixtures, seeded SOF3 streams and the port's mutation fuzzer
# (tools/fuzz_torch.py) through it. Exits nonzero on any sanitizer report
# or fuzz failure.
#
#   bash tools/asan_check_torch.sh
set -u
cd "$(dirname "$0")/.."

SO="${TMPDIR:-/tmp}/libjtentropy_torch_asan.so"
g++ -O1 -g -fwrapv -fsanitize=address,undefined -fno-sanitize-recover=undefined \
    -shared -fPIC -std=c++17 -o "$SO" \
    jpeg_decoder_tpu_torch/host/entropy/cpp/entropy.cc -lpthread || exit 1

ASAN_LIB=$(g++ -print-file-name=libasan.so)
UBSAN_LIB=$(g++ -print-file-name=libubsan.so)
export LD_PRELOAD="$ASAN_LIB $UBSAN_LIB"
export ASAN_OPTIONS=detect_leaks=0
export UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1
export JPEG_TPU_NATIVE_SO="$SO"
export PYTHONPATH=

FAILED=0
run() {
  local name="$1"; shift
  echo "=== [$name]"
  if "$@"; then echo "=== [$name] PASS"; else echo "=== [$name] FAIL"; FAILED=1; fi
}

run "corpus" python - <<'PY'
import os
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
from jpeg_decoder_tpu_torch.host.decoder import Decoder
from jpeg_decoder_tpu_torch.host.entropy import native_impl
from jpeg_decoder_tpu_torch.host.entropy.native import get_native
from jpeg_decoder_tpu_torch.host.errors import JpegError
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

assert get_native() is not None, "the instrumented library did not load"
assert native_impl._lib._name == os.environ["JPEG_TPU_NATIVE_SO"], \
    native_impl._lib._name
blobs = {p.name: p.read_bytes()
         for p in sorted(Path("tests/fixtures/torch_port").glob("*.jpg"))}
for pred in range(1, 8):
    for ncomp, prec, pt in ((1, 16, 0), (3, 8, 1)):
        blobs[f"sof3 p{pred} c{ncomp} {prec}-bit pt{pt}"] = sof3_jpeg(
            sof3_samples(96, 80, ncomp, prec, pt, seed=pred), pred, pt, prec)
clean = 0
for name, blob in blobs.items():
    try:
        d = Decoder(blob, backend="numpy")
        d.set_max_decoding_buffer_size(64 << 20)
        d.decode()
        clean += 1
    except JpegError:
        clean += 1
print(f"{clean} of {len(blobs)} files clean on {native_impl._lib._name}")
PY

run "fuzz400" python tools/fuzz_torch.py 400 23
run "fuzzdev150" python tools/fuzz_torch.py 150 31 --device --torch-device cpu

exit $FAILED
