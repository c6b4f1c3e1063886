#!/bin/bash
# The end-to-end cost of the port's spans (repro_torch.obs) on one card.
#
#   tools/obs_ab.sh prepare <parent-rev>    # in a git checkout: fills build/ab/
#   tools/obs_ab.sh run [seed] [out-dir]    # on the card, from the root of the repo
#
# prepare makes three trees under build/ab/:
#   parent  the parent commit, with this tree's BENCHMARK.json and perfbench/ laid over it
#           (the new readers find no spans there and leave their metrics out);
#   change  this tree, the files git would commit;
#   stub    the change with obs's recording stubbed out: obs.span returns one shared
#           object whose __enter__ and __exit__ do nothing, so the call sites stay and
#           no clock is read, no span made and nothing kept.
# run takes the two cells untraced in the order parent, change, stub, stub, change,
# parent (seeds s+1 for the first three, s+2 for the rest; s+11.. for training), then
# one traced run of each cell on the parent and on the change (seed s+3, s+13), and
# tools/obs_cost.py on the change.  Each run's output goes to out-dir (build/ab/out by
# default); one summary line a run to its summary.jsonl.
set -u
R=$(pwd)
AB=$R/build/ab

prepare() {
    local rev=$1
    rm -rf "$AB"
    mkdir -p "$AB/parent" "$AB/change"
    git archive "$rev" | tar -x -C "$AB/parent"
    git ls-files -z -co --exclude-standard | tar --null -T - --ignore-failed-read -cf - |
        tar -x -C "$AB/change"
    rm -rf "$AB/parent/perfbench"
    cp -r "$AB/change/perfbench" "$AB/change/BENCHMARK.json" "$AB/parent/"
    cp -r "$AB/change" "$AB/stub"
    cat > "$AB/stub/src/repro_torch/obs.py" <<'EOF'
"""repro_torch.obs with its recording stubbed out (tools/obs_ab.sh)."""

RING = 65_536


class _Null:
    host_ns = self_ns = device_ns = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name):
    return _NULL


def spans():
    return []


def reset():
    pass
EOF
    du -sh "$AB"/*
}

run_one() {   # tree cell seed trace
    local tree=$1 cell=$2 seed=$3 tr=$4
    local f=$OUT/$tree.$cell.$seed.t$tr
    (cd "$AB/$tree" && python3 perfbench/run.py --workload "$cell" --seed "$seed" --seconds 30 \
        --trace "$tr" > "$f.out" 2> "$f.err")
    local rc=$?
    tail -n 1 "$f.out" | python3 -c '
import json, sys
tree, cell, seed, tr, rc = sys.argv[1:]
line = {"tree": tree, "cell": cell, "seed": int(seed), "trace": int(tr), "rc": int(rc)}
try:
    d = json.loads(sys.stdin.read())
    line |= {"correct": d["correct"], "metrics": {k: v["value"] for k, v in d["metrics"].items()},
             "busy_s": d["device"].get("busy_s"), "window_s": d["device"].get("window_s")}
except (ValueError, KeyError) as e:
    line["error"] = repr(e)
print(json.dumps(line))' "$tree" "$cell" "$seed" "$tr" "$rc" | tee -a "$OUT/summary.jsonl"
}

run() {
    local s=${1:-2147494000}
    OUT=${2:-$AB/out}
    mkdir -p "$OUT"
    OUT=$(cd "$OUT" && pwd)      # the runs write here from inside the trees
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/gpu.txt"
    (cd "$AB/change" && PYTHONPATH=src python3 tools/obs_cost.py) | tee "$OUT/obs_cost.json"
    local cell a b
    for cell in minicpm-2b.decode minicpm-2b.train; do
        if [ "$cell" = minicpm-2b.train ]; then a=$((s + 11)); b=$((s + 12)); t=$((s + 13))
        else a=$((s + 1)); b=$((s + 2)); t=$((s + 3)); fi
        run_one parent "$cell" $a 0
        run_one change "$cell" $a 0
        run_one stub "$cell" $a 0
        run_one stub "$cell" $b 0
        run_one change "$cell" $b 0
        run_one parent "$cell" $b 0
        run_one parent "$cell" $t 1
        run_one change "$cell" $t 1
    done
}

case ${1:-} in
    prepare) prepare "${2:?parent revision}" ;;
    run) run "${2:-}" "${3:-}" ;;
    *) sed -n '2,18p' "$0"; exit 2 ;;
esac
