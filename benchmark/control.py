"""The control: the reference with one guarantee broken, put in the
system's place, and judged as a run judges the system.

    python3 benchmark/control.py --workload <cell> --histories <n> \
        --seeds <s> [<s> ...]

For each seed it draws the cell's traffic as a run with that seed does
(the pool, then histories 0 to n-1), takes the control's verdicts for
them (the reference's ``control``: for the register, session
guarantees without monotone reads), judges them as a run judges the
system's (the reference's ``judge``) and prints one JSON line of the
numbers the run compares, each beside its limit, and whether the run
would read ``correct``. A control that the comparison cannot tell from
the reference would read correct; it must not. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import spec  # noqa: E402
from benchmark.lib.context import Checked  # noqa: E402


def control_run(root: str, cell_name: str, seed: int,
                histories: int) -> dict:
    """The compared numbers of the control on ``histories`` histories
    of the cell's traffic for ``seed``."""
    cell = spec.load(root, cell_name)
    reference = cell.module("reference")
    traffic = cell.traffic(seed)
    memo: dict = {}
    runs = []
    for i in range(histories):
        keys = traffic.history(i)
        runs.append(Checked(keys, 0.0, 0.0, 0.0,
                            reference.control(keys, memo), None))
    wrong, _ = reference.judge(runs)
    return {
        "workload": cell_name, "seed": seed, "histories": histories,
        "correct": all(wrong[n] <= lim
                       for n, lim in reference.LIMITS.items()),
        "compared": {n: {"value": wrong[n], "limit": lim}
                     for n, lim in reference.LIMITS.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--histories", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_run(ROOT, args.workload, seed,
                                     args.histories)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
