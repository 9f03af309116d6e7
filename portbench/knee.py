"""The streaming cell's knee: the highest number of sessions at which the
partials' 95th percentile stays under one frame period with no lateness
that grows through the window. Run once on the card to fix the cell's S:

    python3 portbench/knee.py --workload stream-hub-knee80 --seed 7 \
        --seconds 20 --sessions 32,64,96,112,128

One line per S: partial and final p95, the generator's lateness p95 in the
first and the last third of the window, frames and finals. Not a cell: the
benchmark's runs do not run it.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sessions", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    from portbench.trace import Tracer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for s in (int(x) for x in args.sessions.split(",")):
        cell = harness.Cell(bench, args.workload)
        cell.traffic["params"]["sessions"] = s
        drv = cell.driver(args.seed, "cuda")
        drv.setup(args.seconds)
        drv.window(args.seconds, Tracer(False))
        e2e, ctx = drv.end_to_end(), drv.context()
        ctx["config"] = cell.config
        third = args.seconds / 3
        frames = [c for c in ctx["calls"] if c["kind"] == "frame"]
        early = [c["late_s"] for c in frames if c["due_s"] < third]
        late = [c["late_s"] for c in frames if c["due_s"] >= 2 * third]
        print(json.dumps({
            "sessions": s, **e2e,
            "lateness_p95_ms_first_third": 1e3 * float(np.percentile(early, 95)),
            "lateness_p95_ms_last_third": 1e3 * float(np.percentile(late, 95)),
            "rows_per_tick": harness.read_metric("rows_per_tick", ctx),
            "hub_tick_ms": harness.read_metric("hub_tick_ms", ctx),
            "frames": len(frames), "finals": len(drv.final_s)}), flush=True)
        drv.free()
        del drv
    return 0


if __name__ == "__main__":
    sys.exit(main())
