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


def level_shift_inverse(x: torch.Tensor, bitdepth: int) -> torch.Tensor:
    """Undo the DC level shift: add 2^(B-1)."""
    return x + (1 << (bitdepth - 1))


def rct_forward(rgb: torch.Tensor) -> torch.Tensor:
    """Reversible colour transform (T.800 G.2). int32 in, int32 out.

    rgb: (..., 3) level-shifted integer samples -> (..., 3) [Y, Cb, Cr].
    """
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    y = (r + 2 * g + b) >> 2          # floor((R + 2G + B) / 4)
    return torch.stack([y, b - g, r - g], dim=-1)


def rct_inverse(ycc: torch.Tensor) -> torch.Tensor:
    """Inverse RCT (T.800 G.2): (..., 3) [Y, Cb, Cr] int32 -> (..., 3)
    level-shifted [R, G, B] int32."""
    y, cb, cr = (ycc[..., i].to(torch.int32) for i in range(3))
    g = y - ((cb + cr) >> 2)
    return torch.stack([cr + g, g, cb + g], dim=-1)


# ICT coefficient matrix (T.800 G.3, the ITU-R BT.601 YCbCr matrix).
_ICT_FWD = ((0.299, 0.587, 0.114),
            (-0.168736, -0.331264, 0.5),
            (0.5, -0.418688, -0.081312))

_ICT_INV = ((1.0, 0.0, 1.402),
            (1.0, -0.344136, -0.714136),
            (1.0, 1.772, 0.0))


def _mix(x: torch.Tensor, matrix) -> torch.Tensor:
    """``matrix @ x[..., :]`` as separate elementwise products and sums,
    in the order of each row."""
    chans = [x[..., i] for i in range(3)]
    out = []
    for row in matrix:
        acc = chans[0] * row[0]
        acc = acc + chans[1] * row[1]
        acc = acc + chans[2] * row[2]
        out.append(acc)
    return torch.stack(out, dim=-1)


def ict_forward(rgb: torch.Tensor) -> torch.Tensor:
    """Irreversible colour transform. float in (level-shifted), float32
    out."""
    return _mix(rgb.to(torch.float32), _ICT_FWD)


def ict_inverse(ycc: torch.Tensor) -> torch.Tensor:
    """Inverse ICT: float (..., 3) [Y, Cb, Cr] -> float32 level-shifted
    [R, G, B]."""
    return _mix(ycc.to(torch.float32), _ICT_INV)
