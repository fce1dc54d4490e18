"""The two readings that the check's limit is set between, on a cell's own
inputs, outside the benchmark's runs:

- the program's: ``hits_differing`` of one call of the program on each
  input against the exact reference (the lower reading);
- the control's: ``hits_differing`` of the reference put in the program's
  place with the upstream's running distance carried in float32, the
  precision below the float64 of exact integers that the configurations
  state (the upper reading); it has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...] [--control-seeds <k>]

prints one JSON line a seed; the control runs on the first ``k`` seeds
(3 by default), the program on all of them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device, work: Path, program: bool = True, control: bool = True) -> dict:
    """``hits_differing`` of the program and of the float32 control against
    the exact reference, over every input of ``cell`` made from ``seed``."""
    from benchmark.harness import genome
    from benchmark.harness.runner import _differing
    from benchmark.reference.fasta import read_fasta

    config = cell.config
    ref_path = str(ROOT / config["ref_set"])
    genes = [seq for _, seq in read_fasta(ref_path)]
    paths, _ = genome.make(cell.traffic, seed, genes, work, device)
    out = {}
    if program:
        import kmergma_tpu_torch as kt

        entry = getattr(kt, config["entry"])
        got = [[(h.description, bytes(h.seq)) for h in entry(str(p), ref_path, device=device, **config["kwargs"])[0]]
               for p in paths]
    reference = importlib.import_module(config["reference"])
    exact = reference.find_hits_many(config["entry"], config["kwargs"], paths, ref_path, device=device)
    out["hit_records"] = sum(len(e) for e in exact)
    if program:
        out["program_hits_differing"] = sum(_differing(g, e) for g, e in zip(got, exact))
    if control:
        lower = reference.find_hits_many(config["entry"], config["kwargs"], paths, ref_path, device=device, precision="float32")
        out["control_hits_differing"] = sum(_differing(c, e) for c, e in zip(lower, exact))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    for i, seed in enumerate(args.seed):
        work = Path(tempfile.mkdtemp(prefix="kmergma-control-"))
        t0 = time.perf_counter()
        try:
            out = readings(cell, seed, args.device, work, control=i < args.control_seeds)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": cell.name, "seed": seed, **out, "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
