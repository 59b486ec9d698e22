#!/bin/sh
# Build the native host components into claragenomicsanalysis_tpu/io/_native/.
# Each library is written under a temporary name and renamed into place, so
# concurrent builds (test workers) never load a half-written file.  Every
# library has a pure-Python fallback: one that fails to build (libfasta needs
# the zlib headers) is reported and skipped, and the exit code counts them.
cd "$(dirname "$0")" || exit 1
OUT=../claragenomicsanalysis_tpu/io/_native
mkdir -p "$OUT" || exit 1
failed=0
build() {  # name source [extra flags]
    name=$1
    src=$2
    shift 2
    tmp="$OUT/.$name.$$.so"
    if g++ -O3 -std=c++17 -shared -fPIC "$src" "$@" -o "$tmp" && \
            mv -f "$tmp" "$OUT/$name.so"; then
        echo "built $OUT/$name.so"
    else
        rm -f "$tmp"
        echo "FAILED $name (Python fallback stays in use)" >&2
        failed=$((failed + 1))
    fi
}
build libtraceback traceback.cpp
build libpack2 pack2.cpp
build libfasta fasta_parser.cpp -lz
exit $failed
