"""One cell of BENCHMARK.json at tiny sizes on the CPU, for the harness's tests:
the whole run but the look for a chip, its last line as a run prints it.

    python -m benchmark.tests.dryrun --workload <cell> [--trace 1] [--fault <name>]

Then prints `FOREIGN <json list>`: the loaded modules whose top-level name
is JAX's, a JAX library's or the JAX package's, compared whole.
"""

import argparse
import json

import torch

from benchmark import run
from benchmark.common import ROOT, cell_files, load_json
from benchmark.tests.faults import FAULTS
from benchmark.tests.tiny import tiny


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2 ** 31 + 7)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = cell_files(bench, args.workload)
    cfg, traffic = tiny(cfg, traffic)
    result = run.run_cell(bench, cell, cfg, traffic, args.seed, 0.5, args.trace,
                          torch.device("cpu"), fault=FAULTS.get(args.fault))
    print(json.dumps(result))
    print("FOREIGN " + json.dumps(run.foreign_modules()))


if __name__ == "__main__":
    main()
