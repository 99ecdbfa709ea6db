"""The paper's own models (AlexNet, ResNet18, VGG11, encoder Transformer).

Counterpart of ``repro/models/vision.py``. Each model is a ``VisionModel``:
an ``nn.Module`` with one submodule per layer, so that
``apply_range(x, lo, hi)`` can start and stop at any layer boundary (the
paper's "custom DNN models that run the forward pass between arbitrary
start and end layers", §6). Images and every boundary activation are NHWC,
as in the reference; a conv permutes NHWC to a channels-last NCHW view for
``F.conv2d`` and back, so no copy is made around it.

What the reference's XLA ops fix, and the port keeps:
  * ``"SAME"`` padding is ``total = max((out - 1) * s + k - n, 0)`` with
    ``total // 2`` before and the rest after: asymmetric under a stride
    (AlexNet's conv1 pads (3, 4), ResNet's (2, 3)). ``F.pad`` then
    ``F.conv2d`` with no padding, for every conv and the ResNet downsample.
  * Pools are VALID windows: max pool ``(n - k) // s + 1`` (AlexNet's pool1
    is 27, ResNet's 55), average pool to ``size`` a window of ``n // size``.
  * Flatten is in NHWC order, and the patch embedding's rows are
    ``(py, px, c)``.
  * The ViT block: LayerNorm with the population variance and eps 1e-5,
    attention scaled by ``1 / sqrt(hd)`` with no mask, GELU in its tanh
    form (``jax.nn.gelu``'s default), a head that is the mean over tokens
    times ``w`` with no bias. Its attention goes through
    ``kernels/ops.flash_attention`` (non-causal), the kernel twin of
    attention in this repo; the reference computes the same function as an
    einsum and a softmax.
  * BatchNorm in inference mode: ``mean`` and ``var`` are buffers.

Weights follow the reference's distributions (``normal / sqrt(fan_in)``,
0.02 for the patch and position embeddings, BatchNorm at identity), drawn
from a ``torch.Generator`` (a CPU one seeded 0 unless given), so one seed
gives the same model on every device; a model built on ``device="meta"``
draws nothing (``core.profiler.profile_layered`` needs shapes only).
``convert.vision_params_from_jax`` carries the reference's weights across.

Precision: the reference is float32. On the card, ``apply_range`` runs with
cuDNN's TF32 off, scoped to the call by ``torch.backends.cudnn.flags``
rather than set as a global; the fully connected products and the ViT's
matmuls stay in float32 under PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32`` False).
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

Shape = Tuple[int, ...]


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) of XLA's "SAME" padding of a length-n axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _normal(shape: Shape, std: float, generator: torch.Generator, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * std).to(device)


class Conv(nn.Module):
    """``w`` (O, I, k, k), ``b`` (O,); NHWC in and out, "SAME" padding."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 generator: torch.Generator, device) -> None:
        super().__init__()
        self.stride = stride
        self.w = nn.Parameter(_normal((c_out, c_in, k, k), 1.0 / math.sqrt(k * k * c_in),
                                      generator, device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.w.shape[-1]
        top, bottom = same_padding(x.shape[1], k, self.stride)
        left, right = same_padding(x.shape[2], k, self.stride)
        if top or bottom or left or right:
            x = F.pad(x, (0, 0, left, right, top, bottom))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.w, self.b, stride=self.stride)
        return y.permute(0, 2, 3, 1)


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class MaxPool(nn.Module):
    def __init__(self, k: int, stride: int) -> None:
        super().__init__()
        self.k, self.stride = k, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x.permute(0, 3, 1, 2), self.k, self.stride).permute(0, 2, 3, 1)


class AvgPoolTo(nn.Module):
    def __init__(self, size: int) -> None:
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = x.shape[1] // self.size, x.shape[2] // self.size
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), (kh, kw), (kh, kw))
        return y.permute(0, 2, 3, 1)


class Flatten(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


class FC(nn.Module):
    """``w`` (in, out) as in the reference, ``b`` (out,)."""

    def __init__(self, d: int, out: int, generator: torch.Generator, device) -> None:
        super().__init__()
        self.w = nn.Parameter(_normal((d, out), 1.0 / math.sqrt(d), generator, device))
        self.b = nn.Parameter(torch.zeros(out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class BatchNorm(nn.Module):
    """Inference mode: frozen ``mean`` and ``var`` buffers."""

    def __init__(self, c: int, device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * torch.rsqrt(self.var + 1e-5) * self.scale + self.bias


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        self.c1 = Conv(c_in, c_out, 3, stride, generator, device)
        self.b1 = BatchNorm(c_out, device)
        self.c2 = Conv(c_out, c_out, 3, 1, generator, device)
        self.b2 = BatchNorm(c_out, device)
        self.down = (Conv(c_in, c_out, 1, stride, generator, device)
                     if stride != 1 or c_in != c_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.b1(self.c1(x)))
        y = self.b2(self.c2(y))
        if self.down is not None:
            x = self.down(x)
        return F.relu(y + x)


class PatchEmbed(nn.Module):
    """``w`` (patch * patch * c, d) over rows in (py, px, c) order, ``pos`` (tokens, d)."""

    def __init__(self, in_shape: Shape, patch: int, d: int, generator: torch.Generator,
                 device) -> None:
        super().__init__()
        h, w, c = in_shape
        self.patch = patch
        self.w = nn.Parameter(_normal((patch * patch * c, d), 0.02, generator, device))
        self.pos = nn.Parameter(_normal(((h // patch) * (w // patch), d), 0.02, generator,
                                        device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, -1, p * p * c) @ self.w + self.pos


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


class EncoderBlock(nn.Module):
    """Pre-norm ViT block. ``wq``, ``wk``, ``wv`` are (d, heads * hd) and
    ``wo`` (heads * hd, d): the reference's (d, heads, hd) and (heads, hd, d)
    with the head axes merged."""

    def __init__(self, d: int, heads: int, generator: torch.Generator, device) -> None:
        super().__init__()
        self.heads = heads
        std = 1.0 / math.sqrt(d)
        self.ln1s = nn.Parameter(torch.ones(d, device=device))
        self.ln1b = nn.Parameter(torch.zeros(d, device=device))
        self.wq = nn.Parameter(_normal((d, d), std, generator, device))
        self.wk = nn.Parameter(_normal((d, d), std, generator, device))
        self.wv = nn.Parameter(_normal((d, d), std, generator, device))
        self.wo = nn.Parameter(_normal((d, d), std, generator, device))
        self.ln2s = nn.Parameter(torch.ones(d, device=device))
        self.ln2b = nn.Parameter(torch.zeros(d, device=device))
        self.w1 = nn.Parameter(_normal((d, 4 * d), std, generator, device))
        self.w2 = nn.Parameter(_normal((4 * d, d), 1.0 / math.sqrt(4 * d), generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        heads = (b, s, self.heads, d // self.heads)
        h1 = _layernorm(x, self.ln1s, self.ln1b)
        q, k, v = ((h1 @ w).view(heads) for w in (self.wq, self.wk, self.wv))
        o = ops.flash_attention(q, k, v, causal=False)
        x = x + o.reshape(b, s, d) @ self.wo
        h2 = _layernorm(x, self.ln2s, self.ln2b)
        return x + F.gelu(h2 @ self.w1, approximate="tanh") @ self.w2


class Head(nn.Module):
    """The mean over tokens times ``w`` (d, classes), no bias."""

    def __init__(self, d: int, num_classes: int, generator: torch.Generator, device) -> None:
        super().__init__()
        self.w = nn.Parameter(_normal((d, num_classes), 1.0 / math.sqrt(d), generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=1) @ self.w


class VisionModel(nn.Module):
    """``layers[i]`` is the layer named ``layer_names[i]``; boundary i is the
    activation after layer i - 1 (0 is the image)."""

    def __init__(self, name: str, layer_names: List[str], layers: List[nn.Module],
                 freeze_index: int, input_shape: Shape, num_classes: int) -> None:
        super().__init__()
        self.name = name
        self.layer_names = layer_names
        self.layers = nn.ModuleList(layers)
        self.freeze_index = freeze_index
        self.input_shape = input_shape
        self.num_classes = num_classes

    def apply_range(self, x: torch.Tensor, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
        """Layers [lo, hi) on NHWC ``x``: the activation at boundary hi."""
        hi = len(self.layers) if hi is None else hi
        with _exact_f32(x):
            for i in range(lo, hi):
                x = self.layers[i](x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_range(x)


def _exact_f32(x: torch.Tensor):
    """cuDNN's TF32 off for a call on the card, its other flags as they are."""
    if not x.is_cuda:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


# ---------------------------------------------------------------------------
# The four models: (name, layer) in order, at 224 x 224 x 3.
# ---------------------------------------------------------------------------
def _build(name: str, spec: List[Tuple[str, nn.Module]], num_classes: int,
           freeze_index: int) -> VisionModel:
    return VisionModel(name, [n for n, _ in spec], [m for _, m in spec], freeze_index,
                       (224, 224, 3), num_classes)


def _seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def alexnet(num_classes: int = 1000, *, device="cuda",
            generator: Optional[torch.Generator] = None) -> VisionModel:
    g = _seeded(generator)
    spec = [
        ("conv1", Conv(3, 64, 11, 4, g, device)), ("relu1", ReLU()), ("pool1", MaxPool(3, 2)),
        ("conv2", Conv(64, 192, 5, 1, g, device)), ("relu2", ReLU()), ("pool2", MaxPool(3, 2)),
        ("conv3", Conv(192, 384, 3, 1, g, device)), ("relu3", ReLU()),
        ("conv4", Conv(384, 256, 3, 1, g, device)), ("relu4", ReLU()),
        ("conv5", Conv(256, 256, 3, 1, g, device)), ("relu5", ReLU()),
        ("pool5", MaxPool(3, 2)),
        ("avgpool", AvgPoolTo(6)), ("flatten", Flatten()),
        ("fc1", FC(6 * 6 * 256, 4096, g, device)), ("relu6", ReLU()),
        ("fc2", FC(4096, 4096, g, device)), ("relu7", ReLU()),
        ("fc3", FC(4096, num_classes, g, device)),
    ]
    # paper Table 1: 22 layers, freeze 17 (20 executable ops here; the freeze
    # lands after fc1's relu, the same point).
    return _build("alexnet", spec, num_classes, freeze_index=17)


def resnet18(num_classes: int = 1000, *, device="cuda",
             generator: Optional[torch.Generator] = None) -> VisionModel:
    g = _seeded(generator)
    spec = [("conv1", Conv(3, 64, 7, 2, g, device)), ("bn1", BatchNorm(64, device)),
            ("relu1", ReLU()), ("pool1", MaxPool(3, 2))]
    c_in = 64
    for i, c in enumerate((64, 128, 256, 512)):
        spec.append((f"block{i + 1}a", ResBlock(c_in, c, 1 if i == 0 else 2, g, device)))
        spec.append((f"block{i + 1}b", ResBlock(c, c, 1, g, device)))
        c_in = c
    spec += [("avgpool", AvgPoolTo(1)), ("flatten", Flatten()),
             ("fc", FC(512, num_classes, g, device))]
    # paper Table 1: 14 layers (block granularity), freeze index 11.
    return _build("resnet18", spec, num_classes, freeze_index=11)


def vgg11(num_classes: int = 1000, *, device="cuda",
          generator: Optional[torch.Generator] = None) -> VisionModel:
    g = _seeded(generator)
    spec: List[Tuple[str, nn.Module]] = []
    ci, c_in = 0, 3
    for c in (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"):
        if c == "M":
            spec.append((f"pool{ci}", MaxPool(2, 2)))
        else:
            ci += 1
            spec += [(f"conv{ci}", Conv(c_in, c, 3, 1, g, device)), (f"relu{ci}", ReLU())]
            c_in = c
    spec += [("avgpool", AvgPoolTo(7)), ("flatten", Flatten()),
             ("fc1", FC(7 * 7 * 512, 4096, g, device)), ("relu_fc1", ReLU()),
             ("fc2", FC(4096, 4096, g, device)), ("relu_fc2", ReLU()),
             ("fc3", FC(4096, num_classes, g, device))]
    # paper Table 1: 28 layers, freeze 25.
    return _build("vgg11", spec, num_classes, freeze_index=25)


def tiny_transformer_encoder(num_classes: int = 1000, d: int = 384, n_layers: int = 12,
                             heads: int = 6, patch: int = 16, *, device="cuda",
                             generator: Optional[torch.Generator] = None) -> VisionModel:
    """ViT-style encoder Transformer (the paper's 'Transformer', Table 1:
    19 layers, freeze 17; here patch embed + 12 blocks + head, block
    granularity)."""
    g = _seeded(generator)
    spec = [("patch_embed", PatchEmbed((224, 224, 3), patch, d, g, device))]
    spec += [(f"block{i}", EncoderBlock(d, heads, g, device)) for i in range(n_layers)]
    spec.append(("head", Head(d, num_classes, g, device)))
    return _build("transformer", spec, num_classes, freeze_index=11)


PAPER_MODELS = {
    "alexnet": alexnet,
    "resnet18": resnet18,
    "vgg11": vgg11,
    "transformer": tiny_transformer_encoder,
}
