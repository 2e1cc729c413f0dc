"""ResNet backbone truncated after layer3, as torch.nn modules.

Port of tinyfaces_tpu/models/resnet.py: torchvision-v1.5 bottlenecks (stride
on the 3x3), explicit padding, and the 3x3/2 max pool with pad 1 whose pad
is -inf. Internally NCHW; the detector converts at its boundary.

Module names follow the reference torch model (conv1/bn1, layer{1,2,3}.{i}
with conv1..3/bn1..3 and downsample.{0,1}) so reference checkpoints and the
JAX weight bridge (utils/convert.py) map by name.

BatchNorm follows flax, not nn.BatchNorm2d: the running variance is updated
with the *biased* batch variance (torch uses the unbiased one), with
momentum 0.1 in torch's convention (= flax momentum 0.9). In one process
the update takes the statistics the normalisation itself took (its saved
mean and 1/sqrt(var + eps)), so each input is read once for both.

`dtype` is the JAX model's mixed-precision knob: the input is cast to it and
activations run in it (bfloat16 for inference) while parameters and BN
statistics stay float32. Convolutions cast their weights to the activation
dtype; batch norm normalises in float32 and rounds its output to the
activation dtype, as flax does. None (the default) keeps the input's dtype,
so `.double()` gives a float64 model.

Under a process group of more than one rank, training-mode batch norm uses
the statistics of the global batch, as XLA computes them over the JAX
package's data axis. Each rank takes its rows' two-pass (count, mean,
variance) per channel in float32, one differentiable all-reduce gathers
every rank's, and they are merged with Chan's parallel formula. flax's fast
form E[x^2] - E[x]^2 cancels in float32 where a channel's mean is large
against its spread, and at ResNet-101's depth that moved one training step
far from one process's two-pass statistics. One process keeps the plain
path.

`remat=True` checkpoints every bottleneck (torch.utils.checkpoint,
non-reentrant), as flax's `nn.remat(Bottleneck)`: its activations are
recomputed in the backward pass instead of stored. The recompute runs each
batch norm's forward a second time, and that pass must neither update the
running statistics again nor, under a process group, issue its all-reduce
again (a collective the other ranks might not be issuing at that moment).
So the first pass records each layer's gathered statistics and the
recompute replays them: the same values, no collective, no update.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tinyfaces_tpu_torch.parallel import distributed

RESNET101_STAGES: Tuple[int, ...] = (3, 4, 23)
RESNET50_STAGES: Tuple[int, ...] = (3, 4, 6)
ARCH_STAGES: dict = {
    "resnet101": RESNET101_STAGES,
    "resnet50": RESNET50_STAGES,
}


class _RematCall:
    """One checkpointed block call: its batch norms' gathered statistics,
    recorded in the forward pass and replayed, in order, by the recompute."""

    def __init__(self) -> None:
        self.replaying = False
        self.rows: list[torch.Tensor] = []
        self._next = 0

    def take(self) -> torch.Tensor:
        rows = self.rows[self._next]
        self._next += 1
        return rows

    @contextlib.contextmanager
    def active(self, replaying: bool) -> Iterator[None]:
        self.replaying, self._next = replaying, 0
        previous, _remat.call = getattr(_remat, "call", None), self
        try:
            yield
        finally:
            _remat.call = previous


_remat = threading.local()  # the block call being run or recomputed on this thread


def _remat_call() -> Optional[_RematCall]:
    return getattr(_remat, "call", None)


def checkpointed(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """block(x) with its activations recomputed in the backward pass (see
    the module docstring). The blocks draw no random numbers, so the RNG
    state is not saved."""
    call = _RematCall()
    return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (call.active(False), call.active(True)))


class BatchNorm2d(nn.Module):
    """Batch norm with flax's statistics update (see module docstring).
    Same parameter and buffer names as nn.BatchNorm2d, without
    num_batches_tracked."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        remat = _remat_call()
        if distributed.world() > 1:
            return self._global_batch_forward(x, remat)
        # Normalize with the biased batch statistics, through the op that
        # F.batch_norm dispatches to (cuDNN or ATen's kernel, the same
        # autograd), and keep the mean and 1/sqrt(var + eps) it saves for the
        # backward pass. The running statistics are updated from those, with
        # the biased variance (flax), not the unbiased one.
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        if remat is not None and remat.replaying:
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(invstd.pow(-2).sub_(self.eps), alpha=m)
        return y

    def _global_batch_forward(self, x: torch.Tensor, remat: Optional[_RematCall]) -> torch.Tensor:
        """Training mode over every rank's rows (see the module docstring)."""
        xf = x.float()
        c = xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        count = torch.full((1,), xf.numel() // c, dtype=torch.float32, device=x.device)
        # Row r of `rows` is rank r's (count, mean, var): an all-gather as an
        # all-reduce SUM of zero-padded rows, differentiable as it stands.
        r, n = distributed.rank(), distributed.world()
        local = F.pad(torch.cat([count, mean, var])[None], (0, 0, r, n - 1 - r))
        replaying = remat is not None and remat.replaying
        if replaying:
            rows = distributed.replayed_all_reduce_sum(local, remat.take())
        else:
            rows = distributed.all_reduce_sum(local)
            if remat is not None:
                remat.rows.append(rows.detach())
        counts, means, variances = rows[:, :1], rows[:, 1:c + 1], rows[:, c + 1:]
        mean = (counts * means).sum(0) / counts.sum()
        var = (counts * (variances + (means - mean) ** 2)).sum(0) / counts.sum()
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        if replaying:
            return y.to(x.dtype)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 weights are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with pad 1; F.max_pool2d pads with -inf."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class Bottleneck(nn.Module):
    """torchvision-v1.5 bottleneck: 1x1 -> 3x3(stride) -> 1x1(4x), residual."""

    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm2d(out_ch),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity)


class ResNetBackbone(nn.Module):
    """Stem + layer1..layer3 on NCHW input; returns (res3, res4).

    res3: stride 8, 512 channels. res4: stride 16, 1024 channels.
    """

    def __init__(self, stage_sizes: Sequence[int] = RESNET101_STAGES,
                 dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for stage_idx, (n_blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256)), start=1):
            blocks = []
            for block_idx in range(n_blocks):
                stride = 2 if (stage_idx > 1 and block_idx == 0) else 1
                blocks.append(Bottleneck(in_ch, width, stride))
                in_ch = width * Bottleneck.expansion
            setattr(self, f"layer{stage_idx}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, stem_precomputed: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """`stem_precomputed`: x is conv1's output (B, 64, H/2, W/2) already,
        as the pyramid's folded 2x stem (ops/stemfold.py) computes it; the
        forward starts at bn1."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        if not stem_precomputed:
            x = self.conv1(x)
        x = max_pool_3x3_s2(F.relu(self.bn1(x)))
        x = self._stage(self.layer1, x)
        res3 = self._stage(self.layer2, x)
        res4 = self._stage(self.layer3, res3)
        return res3, res4

    def _stage(self, layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return layer(x)
        for block in layer:
            x = checkpointed(block, x)
        return x
