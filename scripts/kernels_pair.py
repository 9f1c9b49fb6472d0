#!/usr/bin/env python3
"""The kernel checks of two trees on one GPU, in turns: parent, change,
change, parent.

    git archive <parent> | tar -x -C _proof/parent       # a git-ignored dir
    python3 scripts/kernels_pair.py _proof/parent [--out _proof/pair]

In each turn it runs ``python3 chip_smoke.py --phases kernels`` from the
root of the tree (the tree's own script, so each tree builds and checks
its own kernels; the second turn of a tree reuses its build), then this
tree's ``scripts/decode_split_probe.py --root <tree> --lines ""`` (both
paged kernels at chip_smoke's timed cases, by CUDA-graph replay: the
device's time without the host's). It keeps each run's output in
``<out>/<n>-<tree>[-probe].log`` and prints the card's name and power
limit, then one JSON line per timed kernel row (``kernel``, ``case``)
with its ``ms`` and its ``device_ms`` or ``graph_ms`` in each turn (the
whole-step cases among them), one per whole-step case with the sum of its stamped stages
and its attention stage (its ``whole_stages`` line), one per paged
case with both kernels' graph times (and, at decode, the digests of
their outputs, equal across the trees where a change kept the bits), and
one per dense decode case with the kernel's and SDPA's graph times. A run
that fails stops the script with its exit code. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ORDER = ("parent", "change", "change", "parent")


def rows_of(log: str):
    """(key, numbers) of each timed kernel row, whole-step stage line and
    probe line."""
    for line in log.splitlines():
        if not line.startswith("{"):
            continue
        o = json.loads(line)
        if o.get("phase") == "kernels" and o.get("ms") is not None:
            yield (o["kernel"], o.get("case")), {k: o[k] for k in ("ms", "device_ms", "graph_ms")
                                                 if o.get(k) is not None}
        elif "ragged_graph_ms" in o:  # decode_split_probe.py
            yield ("paged_graph", o["case"]), {k: o[k] for k in (
                "ragged_graph_ms", "fused_graph_ms", "splits", "ragged_sha", "fused_sha")
                if k in o}
        elif "dense_graph_ms" in o:
            yield ("dense_graph", o["case"]), {k: o[k] for k in (
                "dense_graph_ms", "sdpa_graph_ms", "bound_ms", "splits") if k in o}
        elif o.get("phase") == "whole_stages":
            yield ("whole_stages", o["case"]), {"stages_sum_ms": o["stages_sum_ms"],
                                                "attention_ms": o["stages_ms"]["attention"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="root of the parent tree")
    ap.add_argument("--out", default="_proof/pair")
    args = ap.parse_args(argv)
    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    runs = []
    for n, tree in enumerate(ORDER):
        rows = {}
        for tag, cmd in (("", ["chip_smoke.py", "--phases", "kernels"]),
                         ("-probe", [str(ROOT / "scripts" / "decode_split_probe.py"),
                                     "--root", str(trees[tree]), "--lines", ""])):
            proc = subprocess.run([sys.executable, *cmd], cwd=trees[tree], capture_output=True,
                                  text=True)
            (out / f"{n}-{tree}{tag}.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                print(f"run {n} ({tree}{tag}) failed with exit {proc.returncode}:\n"
                      + (proc.stdout + proc.stderr)[-4000:], flush=True)
                return proc.returncode
            rows.update(rows_of(proc.stdout))
        runs.append(rows)
    for key in dict.fromkeys(k for r in runs for k in r):
        print(json.dumps({"kernel": key[0], "case": key[1],
                          "runs": [{"tree": t, **r.get(key, {})} for t, r in zip(ORDER, runs)]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
