"""Layer: `ops/nn.py::linear` (the products). Device time in
matrix-multiply kernels (cuBLAS / CUTLASS GEMM and GEMV kernels, cuDNN's
implicit-GEMM convolutions) over the device's busy time in the traced span."""

PATTERNS = ("gemm", "gemv", "splitkreduce")


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    mm = sum(s for name, (_, s) in tr["kernels"].items()
             if any(p in name.lower() for p in PATTERNS))
    return 100.0 * mm / tr["busy_s"]
