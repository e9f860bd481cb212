#!/bin/bash
# Build and run tools/dpx_probe.cu on one sm_90a card; see the .cu for what
# it measures.  Prints the card, the toolkit's names of the min/max
# intrinsics, the SASS opcode histogram of each probe kernel and the
# throughput of each form.  Build outputs go to build/dpx_probe/.
set -e
ROOT=$(cd "$(dirname "$0")/.." && pwd)
OUT=$ROOT/build/dpx_probe
CUDA=${CUDA_HOME:-/usr/local/cuda}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
"$CUDA/bin/nvcc" --version | tail -1
echo "== min/max intrinsics the toolkit's headers name"
grep -rhoE "__(vimin3?|vimax3?)_[a-z0-9_]+|__v(min|max)(s|u)[24]\b" "$CUDA/include/" | sort | uniq -c
FLAGS="-gencode arch=compute_90a,code=sm_90a -O3"
"$CUDA/bin/nvcc" $FLAGS -cubin -o "$OUT/probe.cubin" "$ROOT/tools/dpx_probe.cu"
"$CUDA/bin/cuobjdump" -sass "$OUT/probe.cubin" > "$OUT/probe.sass"
echo "== SASS opcodes per kernel"
python3 - "$OUT/probe.sass" <<'PY'
import collections, re, sys
fn, hist = None, {}
for line in open(sys.argv[1]):
    m = re.search(r"Function : (\S+)", line)
    if m:
        fn = m.group(1)
        hist[fn] = collections.Counter()
        continue
    m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
    if m and fn:
        hist[fn][m.group(1)] += 1
for fn, c in hist.items():
    print(fn[:40], dict(c.most_common(6)))
PY
"$CUDA/bin/nvcc" $FLAGS -o "$OUT/probe" "$ROOT/tools/dpx_probe.cu"
"$OUT/probe"
