"""The compute device of the port: CUDA unless the CPU is asked for.

`select_device` is the one place that resolves a device argument: the
public builders (`problem.ElasticityProblem` through `Config.device`,
`ops.operator.OperatorFactory`) call it, so that each runs on the GPU
unless the caller names the CPU, and raises when no GPU is present.
"""

from __future__ import annotations

import torch


def select_device(device=None) -> torch.device:
    """Resolve the compute device: the given one, else CUDA, raising when
    no CUDA device is present (the CPU runs only when asked for by name).
    Also turns TF32 off: a TF32 contraction keeps ~3 decimal digits, the
    same hazard that made single-pass bf16 residuals 18x noise on the TPU
    (ceedpetscsolid_tpu/utils/precise.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device (torch.cuda.is_available() is False): "
                "ceedpetscsolid_tpu_torch runs on a GPU unless the CPU is "
                "asked for, by Config(device='cpu') or "
                "OperatorFactory(..., device='cpu') or, for the CLI, "
                "CEEDPETSCSOLID_TORCH_DEVICE=cpu")
        device = "cuda"
    return torch.device(device)


def default_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU (parity path), float32 on CUDA (as the JAX
    package runs float32 on the TPU)."""
    return torch.float64 if device.type == "cpu" else torch.float32
