"""ResNet-50 as a torch ``nn.Module`` — the serving flagship.

The port of ``tpurpc/models/resnet.py``: bottleneck-v1.5 (stride 2 on the
3x3), inference-mode BatchNorm (ε = 1e-5), a final Dense. The public input
stays NHWC float32, as in the reference; the model permutes to NCHW inside.

Padding follows flax's ``SAME`` rule, which is not torch's ``padding=1``: a
stride-2 3x3 conv or max-pool on an even input pads (0, 1), not (1, 1). Each
conv and the pool pad explicitly (the pool with −inf); the 7x7 stem pads
(3, 3) as the reference does.

Precision: ``dtype`` is the compute type of the convolutions and batch
norms, as flax's ``dtype``; the parameters stay float32 at rest (flax's
``param_dtype``) and each conv casts its kernel per call. A batch norm takes
its ``dtype`` input with float32 statistics, computes in float32 and rounds
once to ``dtype``, as flax's does; the global average pools in float32 and
rounds to ``dtype``, and the head (``Dense``) computes in float32, as
flax's ``nn.Dense(..., dtype=jnp.float32)``.

A float32 convolution runs through cuDNN in TF32 when
``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default), and the
Dense layer in TF32 when ``torch.backends.cuda.matmul.allow_tf32`` is True
(default False). The module sets neither; a caller that needs full float32
agreement turns both off.

:func:`from_flax` carries the reference's variables across as numpy arrays:
conv kernels HWIO → OIHW, Dense ``(in, out)`` → ``(out, in)``, BatchNorm
``scale``/``bias`` and ``batch_stats`` ``mean``/``var``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-5


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _Conv(nn.Conv2d):
    """Bias-free conv computing in its input's dtype (float32 kernel at
    rest, cast per call)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class _ConvSame(_Conv):
    """Bias-free conv with flax ``SAME`` padding computed per input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        ph = _same_pad(x.shape[2], k, s)
        pw = _same_pad(x.shape[3], k, s)
        if any(ph) or any(pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride)


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=_EPS)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv0 = _ConvSame(cin, filters, 1)
        self.bn0 = _bn(filters)
        self.conv1 = _ConvSame(filters, filters, 3, stride)
        self.bn1 = _bn(filters)
        self.conv2 = _ConvSame(filters, filters * 4, 1)
        self.bn2 = _bn(filters * 4)
        # the reference projects when the residual's shape differs
        self.proj = cin != filters * 4 or stride != 1
        if self.proj:
            self.conv_proj = _ConvSame(cin, filters * 4, 1, stride)
            self.norm_proj = _bn(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """NHWC images → float32 logits (inference mode), computing in
    ``dtype``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv_init = _Conv(3, num_filters, 7, stride=2, padding=3)
        self.bn_init = _bn(num_filters)
        blocks = []
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(BottleneckBlock(cin, filters, stride))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.dense = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view
        x = F.relu(self.bn_init(self.conv_init(x)))
        ph = _same_pad(x.shape[2], 3, 2)
        pw = _same_pad(x.shape[3], 3, 2)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
        x = F.max_pool2d(x, 3, stride=2)
        for block in self.blocks:
            x = block(x)
        pooled = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.dense(pooled.float())


def resnet50(num_classes: int = 1000,
             dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                  dtype=dtype)


def resnet18_thin(num_classes: int = 1000,
                  dtype: torch.dtype = torch.float32) -> ResNet:
    """Small stand-in with the same code path for fast tests."""
    return ResNet(stage_sizes=(1, 1), num_classes=num_classes, num_filters=8,
                  dtype=dtype)


def make_infer_fn(model: ResNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → logits, inference mode (the model in eval mode, no grad)."""
    model.eval()

    def infer(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(images)

    return infer


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1).copy())


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def _bn_state(prefix: str, params: dict, stats: dict) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _vec(params["scale"]),
            f"{prefix}.bias": _vec(params["bias"]),
            f"{prefix}.running_mean": _vec(stats["mean"]),
            f"{prefix}.running_var": _vec(stats["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """The reference's flax variables (``{"params", "batch_stats"}``, as
    numpy-convertible arrays) → this module's ``state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {"conv_init.weight": _conv(params["conv_init"]["kernel"])}
    sd.update(_bn_state("bn_init", params["bn_init"], stats["bn_init"]))
    n_blocks = sum(1 for k in params if k.startswith("BottleneckBlock_"))
    for b in range(n_blocks):
        p, s = params[f"BottleneckBlock_{b}"], stats[f"BottleneckBlock_{b}"]
        pre = f"blocks.{b}"
        for i in range(3):
            sd[f"{pre}.conv{i}.weight"] = _conv(p[f"Conv_{i}"]["kernel"])
            sd.update(_bn_state(f"{pre}.bn{i}", p[f"BatchNorm_{i}"],
                                s[f"BatchNorm_{i}"]))
        if "conv_proj" in p:
            sd[f"{pre}.conv_proj.weight"] = _conv(p["conv_proj"]["kernel"])
            sd.update(_bn_state(f"{pre}.norm_proj", p["norm_proj"],
                                s["norm_proj"]))
    sd["dense.weight"] = _vec(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["dense.bias"] = _vec(params["Dense_0"]["bias"])
    return sd
