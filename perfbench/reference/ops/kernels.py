"""The reference launches no kernel: every call site of the copied modules
takes the plain path.  Only the checks the plain paths call are kept."""
from __future__ import annotations

LAUNCHES: dict[str, int] = {}


def launch(name: str, *args, **kwargs) -> None:
    raise RuntimeError(f"the reference launches no CUDA kernel ({name})")


def refuse_autograd(name: str, *tensors) -> None:
    return None


def check_cuda_tensor(t, name: str, dtype, shape=None) -> None:
    return None
