"""The control's precision: TF32 in cuBLAS and cuDNN, the nearest precision
below float32 with TF32 off, which the configurations state."""
from __future__ import annotations

import torch


class tf32:
    """TF32 on in cuBLAS and cuDNN inside the block (the control's
    precision), restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        m, c = torch.backends.cuda.matmul, torch.backends.cudnn
        self.saved = (m.allow_tf32, c.allow_tf32)
        m.allow_tf32 = c.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = self.saved
