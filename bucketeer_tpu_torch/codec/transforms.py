"""Level shift and colour transforms (JPEG 2000 Part 1, Annex G).

- RCT: reversible (integer) colour transform, used with the 5/3 DWT
  (lossless path).
- ICT: irreversible (floating) colour transform, used with the 9/7 DWT
  (lossy path). Written as separate elementwise products and sums, not a
  matrix product: each op then rounds once, the same way on the CPU and
  on the card, so both devices quantize to the same indices.
"""
from __future__ import annotations

import torch


def level_shift_forward(x: torch.Tensor, bitdepth: int) -> torch.Tensor:
    """DC level shift for unsigned samples: subtract 2^(B-1)."""
    return x - (1 << (bitdepth - 1))


def rct_forward(rgb: torch.Tensor) -> torch.Tensor:
    """Reversible colour transform (T.800 G.2). int32 in, int32 out.

    rgb: (..., 3) level-shifted integer samples -> (..., 3) [Y, Cb, Cr].
    """
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    y = (r + 2 * g + b) >> 2          # floor((R + 2G + B) / 4)
    return torch.stack([y, b - g, r - g], dim=-1)


# ICT coefficient matrix (T.800 G.3, the ITU-R BT.601 YCbCr matrix).
_ICT_FWD = ((0.299, 0.587, 0.114),
            (-0.168736, -0.331264, 0.5),
            (0.5, -0.418688, -0.081312))


def ict_forward(rgb: torch.Tensor) -> torch.Tensor:
    """Irreversible colour transform. float in (level-shifted), float32
    out."""
    x = rgb.to(torch.float32)
    chans = [x[..., i] for i in range(3)]
    out = []
    for row in _ICT_FWD:
        acc = chans[0] * row[0]
        acc = acc + chans[1] * row[1]
        acc = acc + chans[2] * row[2]
        out.append(acc)
    return torch.stack(out, dim=-1)
