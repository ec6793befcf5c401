#!/bin/bash
# Two versions of the port's kernels on one card, in turns: other, this, this, other.
#
#   bash chip_ab.sh OTHER [FLAG]
#
# OTHER is a directory holding another tree's merv_tpu_torch/ (for the parent
# commit: git archive HEAD merv_tpu_torch | tar -x -C OTHER, into a git-ignored
# directory such as _tree_check/parent). FLAG is chip_smoke.py's case flag,
# --int8-only by default (K4 and K5; also --decode-step-only, --flash-only,
# --small-only, --tower-only). This tree's chip_smoke.py runs in both, so both
# versions are measured the same way (warm and L2-cold graph replay). That
# script imports the package's benchkit and cli/make_randinit_run, which a tree
# older than the bench modules lacks, so this tree's copies of both go into
# OTHER's package too (neither holds a kernel). Each
# run's output goes to chiprun_out/ab/{other,this}{1,2}<flag>.log; the kernel
# and decode-step lines are printed at the end.
set -u
other=${1:?usage: chip_ab.sh OTHER [FLAG]}
flag=${2:---int8-only}
here=$(pwd)
mkdir -p chiprun_out/ab
cp chip_smoke.py "$other/"
cp merv_tpu_torch/benchkit.py "$other/merv_tpu_torch/"
cp merv_tpu_torch/cli/make_randinit_run.py "$other/merv_tpu_torch/cli/"
run() {
  (cd "$1" && python3 chip_smoke.py "$flag" > "$here/chiprun_out/ab/$2$flag.log" 2>&1)
  echo "$2 rc $?"
}
run "$other" other1
run . this1
run . this2
run "$other" other2
for f in other1 this1 this2 other2; do
  echo "== $f"
  grep -E "^\[(kernel|decode-step|digest)\]" "chiprun_out/ab/$f$flag.log" | sed -E 's/ max_err.* ms=/ ms=/' | cut -c1-260
done
