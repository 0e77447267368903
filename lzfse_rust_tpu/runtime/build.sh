#!/bin/sh
# Sanitizer builds of the native host runtime.
#
# The release library is built automatically at first use
# (runtime/native.py: build/ holds it, keyed by a hash of the source and
# flags). This script makes instrumented builds under the same name, so the
# test suite runs against them unchanged:
#
#   build.sh --sanitize  AddressSanitizer + UndefinedBehaviorSanitizer
#   build.sh --tsan      ThreadSanitizer (worker pools / arenas)
#
# Run `python -m pytest tests/ -q` with
#   LD_PRELOAD=$(g++ -print-file-name=libasan.so)  (asan intercepts malloc),
# then delete build/ to return to the release library. The recorded clean
# runs live in TESTING.md ("Sanitizer tier").
set -e
cd "$(dirname "$0")"
so=$(cd ../.. && python -c \
  'from lzfse_rust_tpu.runtime import native; print(native.library_path())')
mkdir -p build
case "${1:-}" in
  --sanitize)
    g++ -O1 -g -fno-omit-frame-pointer -fsanitize=address,undefined \
        -fno-sanitize-recover=all -march=native -fPIC -shared -std=c++17 \
        -Wall -pthread -o "$so" src/tpulzfse.cpp
    echo "built $so [asan+ubsan]"
    ;;
  --tsan)
    g++ -O1 -g -fno-omit-frame-pointer -fsanitize=thread -march=native \
        -fPIC -shared -std=c++17 -Wall -pthread -o "$so" src/tpulzfse.cpp
    echo "built $so [tsan]"
    ;;
  *)
    echo "usage: build.sh --sanitize | --tsan" >&2
    exit 2
    ;;
esac
