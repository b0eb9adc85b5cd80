#!/bin/bash
# Builds and checks copies of the port that differ from the tree by one sed
# each, on a machine with the card: planted faults (which chip_smoke.py's
# kernel gates must catch) and design variants (whose ptxas report and time
# are compared with the tree's).
#
#   scripts/chip_variants.sh 'M11=ssd.cu:s/kXwParts = 2;/kXwParts = 1;/' ...
#
# Each argument is NAME=FILE:EXPR, FILE a source in src/repro_torch/csrc and
# EXPR one sed expression. Each copy goes to build/variants/NAME (git-ignored)
# with src/ and chip_smoke.py; all copies build at once, then each runs
# chip_smoke.py's device and build phases and the kernel phases of FILE
# (ssd.cu: the SSD phase; flash_attention.cu: the forward's and the
# backward's, which checks the forward's LSE; flash_attention_bwd.cu: the
# backward's), one after another. Prints per variant the changed lines,
# ptxas's lines for that kernel at D = 128 or the serving shape, the
# phases' [kernels] lines and their exit code (a planted fault must give 1).
set -u
cd "$(dirname "$0")/.."
unset PYTHONPATH
names=()
for arg in "$@"; do
  name=${arg%%=*}; rest=${arg#*=}; file=${rest%%:*}; expr=${rest#*:}
  d=build/variants/$name
  rm -rf "$d"; mkdir -p "$d"; cp -r src chip_smoke.py "$d"/
  sed -i "$expr" "$d/src/repro_torch/csrc/$file"
  echo "== $name ($file): $(diff "src/repro_torch/csrc/$file" "$d/src/repro_torch/csrc/$file" | grep -c '^>') line(s) changed"
  diff "src/repro_torch/csrc/$file" "$d/src/repro_torch/csrc/$file" | grep '^>'
  echo "$file" > "$d/FILE"
  (cd "$d" && timeout 600 python3 -c "import sys; sys.path.insert(0, 'src')
from repro_torch.kernels import build; print(build.build().ptxas_log)" > build.log 2>&1) &
  names+=("$name")
done
wait
for name in "${names[@]}"; do
  d=build/variants/$name
  case "$(cat "$d/FILE")" in
    ssd.cu) phases="c.phase_ssd_kernels(card)"; kernel=ssd_fwd_kernelILi64ELi128 ;;
    flash_attention.cu)
      phases="c.phase_kernels(card); c.phase_flash_bwd_kernels(card)"
      kernel=flash_fwd_kernelILi128 ;;
    *) phases="c.phase_flash_bwd_kernels(card)"; kernel="flash_bwd_[a-z]*_kernelILi128" ;;
  esac
  (cd "$d" && timeout 600 python3 -c "import chip_smoke as c
card = c.phase_device(); c.phase_build(); $phases" > run.log 2>&1)
  rc=$?
  echo "== $name"
  grep -A2 "$kernel" "$d/build.log" | grep -E "spill|registers"
  grep -E "^\[kernels\]" "$d/run.log" | cut -c1-420
  grep -E "Error|error" "$d/run.log" | tail -3
  echo "== $name exit $rc"
done
