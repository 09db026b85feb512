"""Dialog / effect / music demixer, the JAX package's ``models/demix.py`` as
an ``nn.Module``: a time-domain U-Net, stereo ``[B, 2, T]`` at 44.1 kHz ->
``[B, 3, 2, T]`` (music, effect, dialog).

Strided conv1d encoder with ReLU then a GLU, a dilated residual conv
bottleneck (tanh-GELU), and a decoder that adds the skips, applies a GLU and
a transposed conv1d (ReLU except at the last level).  Each item is divided
by its population std (plus 1e-6) on the way in and multiplied back on the
way out; the input is zero-padded to :meth:`valid_length` and the output
cut back.  The parameters are direct attributes named as the checkpoint's
flat keys (``enc0_w``, ``mid0_b1``, ``dec3_glu_w`` ...), so
``weights/demix_synthetic.npz`` loads with a strict ``load_state_dict``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

STEMS = ("music", "effect", "dialog")


class DialogDemixer(nn.Module):
    """Separator: [B, 2, T] at 44.1 kHz -> [B, 3, 2, T]."""

    def __init__(self, channels: int = 48, depth: int = 5, kernel: int = 8,
                 stride: int = 4, bottleneck_blocks: int = 2, sources: int = 3,
                 audio_channels: int = 2):
        super().__init__()
        self.c, self.depth, self.k, self.s = channels, depth, kernel, stride
        self.nb, self.sources, self.ac = bottleneck_blocks, sources, audio_channels

        def param(name, *shape):
            self.register_parameter(name, nn.Parameter(torch.zeros(shape),
                                                       requires_grad=False))

        c_in = audio_channels
        for d in range(depth):
            c_out = channels * 2 ** d
            param(f"enc{d}_w", c_out, c_in, kernel)
            param(f"enc{d}_b", c_out)
            param(f"enc{d}_glu_w", 2 * c_out, c_out, 1)
            param(f"enc{d}_glu_b", 2 * c_out)
            c_in = c_out
        for i in range(bottleneck_blocks):
            param(f"mid{i}_w1", c_in, c_in, 3)
            param(f"mid{i}_b1", c_in)
            param(f"mid{i}_w2", c_in, c_in, 3)
            param(f"mid{i}_b2", c_in)
        for d in reversed(range(depth)):
            c_out = audio_channels * sources if d == 0 else channels * 2 ** (d - 1)
            c_cur = channels * 2 ** d
            param(f"dec{d}_glu_w", 2 * c_cur, c_cur, 1)
            param(f"dec{d}_glu_b", 2 * c_cur)
            param(f"dec{d}_w", c_cur, c_out, kernel)   # transposed: [C_in, C_out, K]
            param(f"dec{d}_b", c_out)

    def valid_length(self, t: int) -> int:
        """Smallest length >= t that survives the encoder/decoder round trip."""
        for _ in range(self.depth):
            t = max(-(-(t - self.k) // self.s) + 1, 1)
        for _ in range(self.depth):
            t = (t - 1) * self.s + self.k
        return t

    def _glu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        a, gate = F.conv1d(x, getattr(self, f"{name}_glu_w"),
                           getattr(self, f"{name}_glu_b")).chunk(2, dim=1)
        return a * torch.sigmoid(gate)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        b, _, t = mix.shape
        std = torch.std(mix, dim=(1, 2), keepdim=True, correction=0) + 1e-6
        x = F.pad(mix / std, (0, self.valid_length(t) - t))
        skips = []
        for d in range(self.depth):
            x = torch.relu(F.conv1d(x, getattr(self, f"enc{d}_w"),
                                    getattr(self, f"enc{d}_b"), stride=self.s))
            x = self._glu(x, f"enc{d}")
            skips.append(x)
        for i in range(self.nb):
            dil = 2 ** (i + 1)
            h = F.gelu(F.conv1d(x, getattr(self, f"mid{i}_w1"),
                                getattr(self, f"mid{i}_b1"), padding=dil,
                                dilation=dil), approximate="tanh")
            x = x + F.conv1d(h, getattr(self, f"mid{i}_w2"),
                             getattr(self, f"mid{i}_b2"), padding=1)
        for d in reversed(range(self.depth)):
            x = self._glu(x + skips[d][..., :x.shape[-1]], f"dec{d}")
            x = F.conv_transpose1d(x, getattr(self, f"dec{d}_w"),
                                   getattr(self, f"dec{d}_b"), stride=self.s)
            if d > 0:
                x = torch.relu(x)
        return x[..., :t].reshape(b, self.sources, self.ac, t) * std[:, None]
