"""The readings that each cell's limits are set from (not run by the benchmark's runs).

    python3 -m perfbench.control --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]
    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 --faults <name>,...

For each seed, in one process: the cell's rows, one fit at the cell's size
as a timed fit makes it, the numbers that decide ``correct`` for that fit
(the program's reading), and for each control seed the same numbers with
the control in the program's place: the reference one precision below the
configuration's float32 (:mod:`perfbench.reference.precision`: TF32
products, bfloat16 elementwise arithmetic). One JSON line a seed, then the
largest program reading and the smallest control reading of each number.
With ``--faults`` the program runs with each of those faults planted in
turn (:mod:`perfbench.faults`), and each line says which numbers failed
their limits; the summary gives each fault's smallest reading of each.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from perfbench.cells import Cell
from perfbench.faults import FAULTS, planted
from perfbench.reference.precision import CONTROL, REFERENCE
from perfbench.run import prepare


def readings(cell: Cell, seed: int, control: bool, device: str = "cuda",
             params_override=None, data_override=None, fault: str | None = None) -> dict:
    """The program's numbers for one fit at ``seed`` (with ``fault``
    planted, where given), and the control's."""
    params, est, X, watch, model = prepare(cell, seed, device, params_override, data_override)
    with planted(fault, cell.config["estimator"]) if fault else contextlib.nullcontext():
        Z = model.fit_transform(X)
    del model
    out = {"seed": seed, "program": est.judge(params, X, Z, watch, device, REFERENCE)["numbers"]}
    if control:
        out["control"] = est.judge(params, X, Z, watch, device, CONTROL)["numbers"]
    return out


def summary(lines: list) -> dict:
    prog = [ln["program"] for ln in lines if "fault" not in ln]
    if not prog:
        faults = sorted({ln["fault"] for ln in lines})
        return {name: {f"{f}_min": min(ln["program"][name] for ln in lines if ln["fault"] == f)
                       for f in faults} for name in lines[0]["program"]}
    ctrl = [ln["control"] for ln in lines if "control" in ln]
    return {name: {"program_max": max(p[name] for p in prog),
                   "control_min": min(c[name] for c in ctrl) if ctrl else None}
            for name in prog[0]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="", help=f"of {', '.join(FAULTS)}")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    cell = Cell(args.workload)
    limits = cell.limits()
    faults = [f for f in args.faults.split(",") if f]
    lines = []
    for fault in faults or [None]:
        for seed in seeds:
            line = readings(cell, seed, seed in control and not fault, fault=fault)
            if fault:
                line["fault"] = fault
                line["failed"] = sorted(k for k, v in line["program"].items()
                                        if not v <= limits[k])
            lines.append(line)
            print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
