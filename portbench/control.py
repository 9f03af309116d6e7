"""The controls of `correct`, run on the card at a cell's own size.

    python3 portbench/control.py --workload <name> --mode tf32 \
        --seeds 1,2,3

The reference is put in the program's place and computed in the nearest
precision below the one the configuration states (`tf32`: float32 with
TF32 on in cuBLAS and cuDNN, where the configuration states it off), or,
for the fine-tuning cell, with half of each batch left out and the loss's
mean taken over the rest (`half_batch`). Each seed's numbers are judged as
a run judges the program's and printed as one JSON line with the cell's
limits beside them: a control has to read above a limit. The benchmark's
own runs do not run this.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, choices=("tf32", "half_batch"))
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(os.path.join(ROOT,
                                                       "BENCHMARK.json")),
                        args.workload)
    limits = cell.traffic["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        numbers = cell.driver(seed, "cuda").control(args.mode)
        failed = [k for k in limits if not numbers[k] <= limits[k]]
        print(json.dumps({"workload": cell.name, "mode": args.mode,
                          "seed": seed, "numbers": numbers,
                          "limits": limits, "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
