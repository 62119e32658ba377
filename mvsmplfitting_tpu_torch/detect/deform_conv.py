"""Deformable convolution v1/v2 in plain PyTorch (port of
`detect/deform_conv.py`; the reference's CUDA extension
`alphapose/models/layers/dcn/deform_conv.py:12-337`).

JAX computes it in plain `jnp` (no TPU kernel lies on this path), and so
does the port: per output position and kernel tap, the input is sampled
at ``p = p0 + dilation*(i, j) + offset`` by zero-padded bilinear
interpolation, multiplied by the modulation mask (v2), and all taps x
input channels are contracted against the weights in one `torch.matmul`.
The sampling is the reference's `deformable_im2col_bilinear`
(`deform_conv_cuda_kernel.cu:153-183`): a tap is zero unless
``-1 < p < size``, and corners outside the image contribute zero.

Layouts are NCHW as the reference's: offsets (B, dg*kh*kw*2, OH, OW) in
[group][tap][dy, dx] order, masks (B, dg*kh*kw, OH, OW), weights (Cout,
Cin // groups, kh, kw).  Sample positions and bilinear weights are
float32 whatever the input's type (bfloat16 cannot hold pixel
coordinates); the im2col tensor (B, OH*OW, kh*kw*Cin), in the input's
type, is built a chunk of the batch at a time, at most `COL_BYTES` each.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

# Largest im2col chunk (bytes); the four corner gathers add as much again.
COL_BYTES = 512 << 20


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def bilinear_zero_pad(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                      ) -> torch.Tensor:
    """Zero-padded bilinear samples: img (B, H, W, C), y/x (B, P) ->
    (B, P, C); JAX's `_bilinear_zero_pad`, corner by corner in its
    order."""
    B, H, W, C = img.shape
    valid = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = y - y0, x - x0
    big = float(max(H, W) + 2)
    iy0 = y0.clamp(-big, big).long()
    ix0 = x0.clamp(-big, big).long()
    flat = img.reshape(B, H * W, C)
    out = None
    for iy, ix, w in ((iy0, ix0, (1 - ly) * (1 - lx)),
                      (iy0, ix0 + 1, (1 - ly) * lx),
                      (iy0 + 1, ix0, ly * (1 - lx)),
                      (iy0 + 1, ix0 + 1, ly * lx)):
        ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        lin = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        v = torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))
        v = v * (w * ok)[..., None]
        out = v if out is None else out + v
    return out * valid[..., None]


def _columns(x: torch.Tensor, offset: torch.Tensor,
             mask: Optional[torch.Tensor], kh: int, kw: int, stride,
             padding, dilation, dg: int) -> torch.Tensor:
    """The im2col tensor (B, OH*OW, kh*kw*Cin), channels last in
    [tap][channel] order."""
    B, Cin, H, W = x.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    OH, OW = offset.shape[2:]
    K = kh * kw
    dev, dt = x.device, torch.float32
    oy = (torch.arange(OH, device=dev) * sh - ph).to(dt)
    ox = (torch.arange(OW, device=dev) * sw - pw).to(dt)
    ty = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw).to(dt)
    tx = (torch.arange(kw, device=dev) * dw).repeat(kh).to(dt)
    off = offset.float().reshape(B, dg, K, 2, OH, OW).permute(
        0, 1, 4, 5, 2, 3)
    y = oy[:, None, None] + ty + off[..., 0]             # (B, dg, OH, OW, K)
    xs = ox[None, :, None] + tx + off[..., 1]
    cg = Cin // dg
    img = x.float().reshape(B, dg, cg, H, W).permute(0, 1, 3, 4, 2)
    cols = [bilinear_zero_pad(img[:, g], y[:, g].reshape(B, -1),
                              xs[:, g].reshape(B, -1))
            for g in range(dg)]                          # (B, OH*OW*K, cg)
    col = torch.stack(cols, dim=2).reshape(B, OH * OW, K, dg, cg)
    if mask is not None:
        m = mask.reshape(B, dg, K, OH * OW).permute(0, 3, 2, 1)
        col = col * m.float()[..., None]
    return col.reshape(B, OH * OW, K * Cin).to(x.dtype)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, stride=1, padding=0, dilation=1,
                  groups: int = 1, deformable_groups: int = 1,
                  mask: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deformable conv forward (v1; v2 with `mask`).

    x (B, Cin, H, W); offset (B, dg*kh*kw*2, OH, OW); weight (Cout,
    Cin // groups, kh, kw); mask (B, dg*kh*kw, OH, OW); bias (Cout,).
    Returns (B, Cout, OH, OW).
    """
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    stride, padding, dilation = (_pair(stride), _pair(padding),
                                 _pair(dilation))
    OH = (H + 2 * padding[0] - (dilation[0] * (kh - 1) + 1)) // stride[0] + 1
    OW = (W + 2 * padding[1] - (dilation[1] * (kw - 1) + 1)) // stride[1] + 1
    if tuple(offset.shape) != (B, deformable_groups * kh * kw * 2, OH, OW):
        raise ValueError(f"offset shape {tuple(offset.shape)}, expected "
                         f"{(B, deformable_groups * kh * kw * 2, OH, OW)}")
    K = kh * kw
    per_frame = OH * OW * K * Cin * 4
    step = max(1, COL_BYTES // max(per_frame, 1))
    if groups == 1:
        w2 = weight.permute(2, 3, 1, 0).reshape(K * Cin, Cout)
    else:
        cg2, og = Cin // groups, Cout // groups
        w2 = weight.reshape(groups, og, cg2, K).permute(3, 2, 0, 1)
    outs = []
    for b in range(0, B, step):
        sl = slice(b, b + step)
        col = _columns(x[sl], offset[sl], None if mask is None else mask[sl],
                       kh, kw, stride, padding, dilation, deformable_groups)
        if groups == 1:
            out = col @ w2                                # (b, OH*OW, Cout)
        else:
            colg = col.reshape(col.shape[0], OH * OW, K, groups, cg2)
            out = torch.einsum("bpkgc,kcgo->bpgo", colg, w2).reshape(
                col.shape[0], OH * OW, Cout)
        outs.append(out)
    out = torch.cat(outs).permute(0, 2, 1).reshape(B, Cout, OH, OW)
    if bias is not None:
        out = out + bias[:, None, None]
    return out


def dcn_offset_mask_split(conv_out: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A `conv_offset_mask` output (B, 3*dg*K, OH, OW) -> (offset,
    sigmoid mask): the reference's DCNv2 pack layer chunks it into (o1,
    o2, mask) and concatenates offset = (o1, o2)
    (`deform_conv.py:330-337`)."""
    o1, o2, m = torch.chunk(conv_out, 3, dim=1)
    return torch.cat([o1, o2], dim=1), torch.sigmoid(m)


class DeformConv2d(nn.Module):
    """The reference's `DeformConv` / `ModulatedDeformConv` without bias
    (`SE_Resnet.py:90-98`): a weight (Cout, Cin, k, k), offsets and masks
    given by the caller."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1,
                 deformable_groups: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size,
                                               kernel_size))
        nn.init.kaiming_normal_(self.weight)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.stride,
                             self.padding,
                             deformable_groups=self.deformable_groups,
                             mask=mask)
