#!/bin/bash
# Compares the tree's flash-attention forward with another checkout's (the
# parent commit's) on a machine with the card: ptxas's report for
# flash_fwd_kernel from both builds, whether the two kernels' SASS is
# identical (the same machine code gives bit-equal outputs on the same
# inputs), then chip_smoke.py's forward kernel phase in four processes,
# other, tree, tree, other, each printing its "flash_attention main" time.
#
#   git archive <commit> | tar -x -C build/parent   # then, on the card:
#   scripts/chip_parent.sh build/parent
set -u
cd "$(dirname "$0")/.."
unset PYTHONPATH
other=$1
mkdir -p build
CUOBJDUMP=${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump
build() {
  (cd "$1" && timeout 600 python3 -c "import sys; sys.path.insert(0, 'src')
from repro_torch.kernels import build; lib = build.build(); print(lib.ptxas_log); print(lib.path)")
}
build "$other" > build/parent_build.log 2>&1 &
build . > build/tree_build.log 2>&1 &
wait
for side in parent tree; do
  log=build/${side}_build.log
  echo "== $side: $(grep -A2 "flash_fwd_kernelILi128E" "$log" | grep -E "registers|spill" | tr -s ' ' | tr '\n' ' ')"
  # the SASS of flash_fwd_kernel at D = 128 (block_k 64, the one instance there), from its "Function :" header to the
  # next, without the header: the mangled name carries a hash of the source
  # file's name and contents
  $CUOBJDUMP -sass "$(tail -1 "$log")" |
    awk '/Function :/ {keep = /flash_fwd_kernelILi128E/; next} keep' > build/${side}_fwd.sass
done
if cmp -s build/parent_fwd.sass build/tree_fwd.sass; then
  echo "flash_fwd_kernel<128, 64> SASS identical ($(wc -l < build/tree_fwd.sass) lines)"
else
  echo "flash_fwd_kernel<128, 64> SASS differs in $(diff build/parent_fwd.sass build/tree_fwd.sass | grep -c '^[<>]') lines:"
  diff build/parent_fwd.sass build/tree_fwd.sass | grep '^[<>]' | head -10
fi
for side in "$other" . . "$other"; do
  (cd "$side" && timeout 300 python3 -c "import chip_smoke as c
card = c.phase_device(); c.phase_kernels(card)" 2>&1 | grep "flash_attention main:" |
    sed "s|^|[$side] |" | cut -c1-200)
done
