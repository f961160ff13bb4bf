"""ResNet-20 for CIFAR, the paper's own experimental domain (the port of
``repro.models.resnet_cifar``).

Group norm in place of batch norm, so per-node statistics stay local.  The
parameter tree and the API keep the reference's layouts, so a JAX-built
tree converts leaf for leaf (:mod:`repro_torch.interop`): conv weights
``(kh, kw, cin, cout)`` (HWIO) and images ``(B, H, W, C)`` (NHWC).  Only
:func:`_conv` permutes to torch's OIHW/NCHW, and it pads as XLA's
``"SAME"`` does: at stride 2 a 3x3 conv over an even size pads (0, 1), not
torch's symmetric ``padding=1``, and a 1x1 one pads nothing.

There is no ``--arch`` entry point (the reference has none): the model runs
through :func:`repro_torch.core.reference.run_stacked` with a per-node
gradient function.  On the card, :func:`repro_torch.utils.resolve_device`
must have run: it turns cuDNN's TF32 off (the reference convolves in f32)
and picks deterministic cuDNN algorithms, so a run equals its repeat bit
for bit.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .layers import Initializer

Tree = Any

__all__ = ["resnet20_init", "resnet20_apply", "resnet20_loss"]

_STAGES = (16, 32, 64)
_BLOCKS_PER_STAGE = 3  # ResNet-20 = 6n+2 with n=3


def _conv_init(init: Initializer, k: int, cin: int, cout: int) -> torch.Tensor:
    return init.normal((k, k, cin, cout), math.sqrt(2.0 / (k * k * cin)))


def _gn_init(init: Initializer, c: int) -> Tree:
    return {"scale": init.ones((c,)), "bias": init.zeros((c,))}


def resnet20_init(generator: torch.Generator, n_classes: int = 10) -> Tree:
    """The parameter tree on the generator's device, in the reference's
    draw order (stem, blocks in order: conv1, conv2, proj; head)."""
    init = Initializer(generator)
    p: Tree = {"stem": _conv_init(init, 3, 3, _STAGES[0]),
               "stem_gn": _gn_init(init, _STAGES[0])}
    cin = _STAGES[0]
    for si, c in enumerate(_STAGES):
        for bi in range(_BLOCKS_PER_STAGE):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {
                "conv1": _conv_init(init, 3, cin, c),
                "gn1": _gn_init(init, c),
                "conv2": _conv_init(init, 3, c, c),
                "gn2": _gn_init(init, c),
            }
            if stride != 1 or cin != c:
                blk["proj"] = _conv_init(init, 1, cin, c)
            p[f"s{si}b{bi}"] = blk
            cin = c
    p["head"] = init.normal((cin, n_classes), 1.0 / math.sqrt(cin))
    return p


def _gn(x: torch.Tensor, gp: Tree, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Group norm over NHWC: ``min(groups, c)`` groups, the population
    variance in f32."""
    n, h, w, c = x.shape
    g = min(groups, c)
    xr = x.reshape(n, h, w, g, c // g).to(torch.float32)
    mu = xr.mean(dim=(1, 2, 4), keepdim=True)
    var = xr.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xr = (xr - mu) * torch.rsqrt(var + eps)
    return xr.reshape(n, h, w, c) * gp["scale"] + gp["bias"]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: ceil(size / stride)
    outputs, the odd pad at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, ``"SAME"`` padding as XLA pads it."""
    k = w.shape[0]
    ph, pw = _same_pads(x.shape[1], k, stride), _same_pads(x.shape[2], k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def resnet20_apply(params: Tree, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 32, 32, 3) -> logits (B, n_classes)."""
    x = torch.relu(_gn(_conv(images, params["stem"]), params["stem_gn"]))
    for si in range(len(_STAGES)):
        for bi in range(_BLOCKS_PER_STAGE):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = params[f"s{si}b{bi}"]
            h = torch.relu(_gn(_conv(x, blk["conv1"], stride), blk["gn1"]))
            h = _gn(_conv(h, blk["conv2"]), blk["gn2"])
            sc = _conv(x, blk["proj"], stride) if "proj" in blk else x
            x = torch.relu(h + sc)
    x = x.mean(dim=(1, 2))
    return x @ params["head"]


def resnet20_loss(params: Tree, images: torch.Tensor, labels: torch.Tensor):
    """Mean cross entropy (f32 log-softmax) and ``{"accuracy": ...}``."""
    logits = resnet20_apply(params, images)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, labels.to(torch.long)[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, dim=1) == labels).to(torch.float32))
    return torch.mean(nll), {"accuracy": acc}
