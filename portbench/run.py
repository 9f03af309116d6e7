"""The benchmark of the PyTorch and CUDA port, one cell once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Builds the cell's program on the card from the
seed, warms every shape its traffic uses, measures for `--seconds`, checks
what the measured window served against the plain reference
(`portbench/reference/`), and prints one JSON object as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and `checks` last (each number compared, with
its limit; they are also the last lines of standard error).

Exits non-zero with no result where there is no CUDA card, fewer cards than
the cell asks for, or where `jax`, `jaxlib`, `flax` or the JAX package are
loaded after the window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
# a run ends within 360 s: past this, every thread's stack goes to standard
# error and the process exits, with no result
DEADLINE_S = 330


def _cache_dirs() -> None:
    """Every kernel and build cache at a fixed path inside the checkout (the
    port's own kernel library builds into its package's `_kernels_build/`)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    _cache_dirs()
    sys.path.insert(0, ROOT)
    from portbench import harness
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    prec = cell.config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = prec["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = prec["cudnn_tf32"]
    print(f"portbench: card {_power_limit()}", file=sys.stderr, flush=True)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START, time.perf_counter)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
