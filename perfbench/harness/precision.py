"""The control's precision: the reference one step below what the
configuration states.

``lower_precision(config)`` is a context in which the reference runs as the
control.  A float32 path with TF32 off (``"float32"``) steps down to TF32:
both TF32 switches are turned on.  Any other stated precision steps down by
rounding the operands and the result of every convolution and matrix
product: float32 operands to bfloat16 (a bfloat16 tensor-core product with
float32 accumulation, its result stored in bfloat16), bfloat16 operands to
float8 e4m3 with a per-tensor scale (an fp8 product).  The rounding is
applied by a dispatch mode, so it reaches every network of the reference
without a change to its code.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

_aten = torch.ops.aten
# the products as the dispatcher shows them: under inference mode the
# composite forms (conv1d, matmul, linear) arrive undecomposed
_PRODUCTS = {
    _aten.convolution.default, _aten._convolution.default,
    _aten.conv1d.default, _aten.conv2d.default,
    _aten.mm.default, _aten.addmm.default, _aten.bmm.default,
    _aten.baddbmm.default, _aten.matmul.default, _aten.linear.default,
    _aten.einsum.default, _aten.gru.input,
    _aten.scaled_dot_product_attention.default,
}
_E4M3_MAX = 448.0


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """e4m3 with a per-tensor scale that maps the largest magnitude to the
    format's largest value, back in the tensor's own dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = _E4M3_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(t.dtype)


class _RoundProducts(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS:
            return func(*args, **kwargs)

        def down(x):
            if not isinstance(x, torch.Tensor) or not x.is_floating_point():
                return x
            if x.dtype == torch.float32:
                return round_bf16(x)
            if x.dtype == torch.bfloat16:
                return round_fp8(x)
            return x

        out = func(*tree_map(down, args), **tree_map(down, kwargs))
        return tree_map(down, out)


@contextlib.contextmanager
def lower_precision(stated: str):
    """Run the block one step below ``stated`` ('float32': TF32 on;
    'mixed_bf16' or 'bfloat16': bfloat16 for float32 products, fp8 for
    bfloat16 ones)."""
    if stated == "float32":
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        return
    if stated not in ("mixed_bf16", "bfloat16"):
        raise ValueError(f"no lower precision known for {stated!r}")
    with _RoundProducts():
        yield
