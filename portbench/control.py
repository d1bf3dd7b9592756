"""Readings that set the limits of the check that decides ``correct``, at a
cell's own size, in one process (the benchmark's runs never run this).

    python3 portbench/control.py --workload <cell> --sound 11,12,... --control 21,22,23

For each ``--sound`` seed the program proves the seed's first request and
the reference proves it again: the numbers compared are the lower reading.
For each ``--control`` seed the control proves it in the program's place: the
reference itself with one guarantee of the configuration broken (its
``control`` entry: fewer queries); the numbers it gives are the upper
reading.  One JSON line per seed; exits 1 if a sound run or the control
comes out on the wrong side of the limits.  On a machine without a card it
exits 2, as ``run.py`` does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(workload: dict, config: dict, seed: int, device: str, control: bool) -> dict:
    """The numbers compared for one request of ``seed``, proved by the
    program or (``control``) by the control."""
    from portbench.core import spec
    from portbench.core.harness import Device
    from portbench.core.inputs import mix
    from portbench.core.proofcheck import compare_sample
    from portbench.core.traffic import ClosedLoop, Sample

    dev = Device(device)
    cell = spec.adapter(config).Cell(workload, config, seed, device)
    prove = cell.control if control else cell.prove
    sample = Sample(random.Random(mix(seed, "check")))
    requests = ClosedLoop(prove, dev.sync, workload["pool"], seed).stretch(1, sample)
    cell.free()
    dev.release()
    checks = compare_sample(cell, sample)
    checks["failed_proofs"] = {"value": sum(r.error is not None for r in requests), "limit": 0}
    return checks


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--sound", default="", help="seeds the program proves, comma-separated")
    p.add_argument("--control", default="", help="seeds the control proves, comma-separated")
    args = p.parse_args(argv)
    import torch

    from portbench.core import spec

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    workload = spec.workload(args.workload)
    config = spec.config(workload["config"])
    ok = True
    for kind, seeds in (("program", args.sound), ("control", args.control)):
        for s in filter(None, seeds.split(",")):
            t = time.perf_counter()
            checks = readings(workload, config, int(s), "cuda", kind == "control")
            right = correct(checks) == (kind == "program")
            ok &= right
            print(json.dumps({"workload": workload["name"], "seed": int(s), "kind": kind, "correct": correct(checks),
                              "as_expected": right, "seconds": time.perf_counter() - t,
                              "checks": {k: v["value"] for k, v in checks.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
