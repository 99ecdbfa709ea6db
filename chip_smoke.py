#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once) and holds each kernel against its plain PyTorch
version on the card (the flash backward also against SDPA's backward as a
yardstick; each flash case on the route ``fwd_route`` names, checked against
the C side's and printed: ``wgmma`` for bf16, split TF32 for f32 at head
dims 64 and 128, FMA for f32 at 16, 32 and 256), then drives the port's
three paths at full width:

* HAPI's forward pushdown path as a storage tier serving requests: a
  full-width two-block mistral-nemo-12b gives the same loss on the card
  (kernels) and on the CPU (plain versions), then the full 40-block model in
  bf16 answers three requests: the storage tier runs the 30-block prefix over
  COS-batch microbatches and int8-quantizes the boundary, the wire bytes are
  counted, and the compute tier dequantizes and evaluates the 10-block
  suffix's loss without gradients. The full 48-block moonshot-v1-16b-a3b
  (MoE, 64 experts top-6) answers three requests of 2 x 4,096 the same way
  (split 36, COS batch 1).
* The MoE FFN: moonshot-v1-16b-a3b's at full width routes 4 x 512 tokens as
  the CPU does at the published capacity (slots drop), its output agrees,
  and two calls on the card give the same bits.
* Serving (``repro_torch.launch.serve.serve``): at its defaults (the f32
  smoke configs, head dim 16) for mistral-nemo-12b, gemma2-9b, qwen3-32b,
  mamba2-1.3b, moonshot-v1-16b-a3b, grok-1-314b and jamba-v0.1-52b, the
  card's prefill logits and greedy tokens match the CPU's; two-block
  mistral-nemo-12b, two-layer mamba2-1.3b (prompts of 512, 100 and 8 tokens)
  and two-block moonshot-v1-16b-a3b (with the share of routing decisions
  that agree) prefill and decode steps agree between the card and the CPU,
  then the full mistral-nemo-12b (40 blocks), mamba2-1.3b (48 layers) and
  moonshot-v1-16b-a3b (48 blocks), and jamba-v0.1-52b at full width cut to 2
  of its 4 periods (16 layers, through ``generate``, serve()'s loop), each
  prefill 4 prompts of 512 tokens, refill the cache by teacher forcing and
  decode 32 tokens greedily, with exact launch counts and the prefill's
  logits held to the last teacher-forced step's (for the MoE models at a
  capacity where no slot drops).
* Training (``repro_torch.train.steps.build_hapi_train_step``): one step of a
  full-width two-block mistral-nemo-12b, and of a full-width two-layer
  mamba2-1.3b, gives the same loss, gradients and updates on the card and on
  the CPU; ``launch.train.run_training`` passes ``tests/test_e2e_smoke.py``'s
  three scenarios on the card (the smoke configs: the loss falls, a crash
  resumes, the int8 boundary trains) and trains mamba2 there, its SSD scan
  differentiated by the backward kernel; then mistral-nemo-12b at full width
  cut to 8 blocks (split 6: 2 trainable blocks and the head), and
  mamba2-1.3b at full width and depth (48 layers, split 36: 12 trainable
  layers and the head), each take 4 fused-path steps on one repeated
  4 x 4,096 batch, the loss falling, and one coarse-path step, with the
  planner's wire bytes a step (86,507,520 and 34,603,008), exact launch
  counts and the frozen prefix unchanged bit for bit; each step's time is
  split into extract, tune (forward and backward) and AdamW.
* The paper's own workload (``repro_torch.models.vision``): AlexNet, ResNet18,
  VGG11 and the ViT encoder at full width (224 x 224 x 3, 1,000 classes)
  agree card vs CPU at their Alg. 1 split and at the last boundary; each is
  planned (``profile_layered``, Alg. 1 under ``compress_transfer`` with a
  train batch of 1,000, Eq. 4 against the card's memory), and one object of
  1,000 images from the port's ``ObjectStore`` goes through
  ``make_vision_executor`` on the card: the prefix over COS-batch
  microbatches (flash attention in each ViT block) and the boundary
  int8-quantized, with exact launches (the ViT's flash launches all on the
  split-TF32 route) and the measured wire bytes held to the int8 formula;
  per-layer times of AlexNet and ResNet18 at the COS batch; flash attention
  at the ViT block's shape (200, 196, 6 heads of 64, f32, non-causal) held
  to its plain version and timed beside its bound (bytes, or the split-TF32
  route's three TF32 products at the TF32 peak), the bound of its f32
  operations on the CUDA cores and SDPA, on a row of its own in the kernels
  line (``flash_attention_vit``) that takes the vision path's flash
  launches.
* The paper's runtime (``repro_torch.cos``): for each of the four models an
  epoch of 4 objects of 1,000 seeded images through ``HapiClient`` (train
  batch 2,000, ``compress_transfer``, a 1 Gbps link) and ``HapiServer`` (one
  accelerator, Eq. 4 per round) with ``make_vision_executor`` on the card;
  the driver's ``train_fn`` dequantizes each response on the card and runs
  the suffix to a loss. Responses arrive in object order, equal to direct
  executor calls; the wire equals the int8 formula; quantize, flash
  (3xtf32) and dequantize launches are exact. It prints the wall time (per
  epoch, per object, images/s), Eq. 4's COS batches, the virtual epoch time
  beside a timing-only ``BaselineClient`` epoch, and per request the
  compute the simulator charged beside the card's wall time.
* The fleet half of the control plane (``repro_torch.api``,
  ``repro_torch.cos.{fleet,network}``): a ``HapiCluster`` of two replicas
  (one accelerator each) on one 1 Gbps trunk serves two tenants' concurrent
  epochs (``run_epochs``) of the same 4,000 images, AlexNet and the ViT,
  through ``make_vision_executor`` on the card; each tenant's ``train_fn``
  dequantizes and runs its suffix. Each call's COS batch is Eq. 4's, each
  tenant's responses arrive in object order equal to direct calls, the wire
  is the int8 formula, launches are exact, and a rerun on the recorded
  responses logs the same events (card time never reaches the virtual
  clock). It prints each replica's served count, each tenant's split,
  re-splits, virtual job time and bandwidth EWMA, the two epochs' wall time
  and images/s, and each call's charged compute beside its card wall; then
  drives ``launch.serve``'s ``--cos-fleet``, ``--network-trunk`` and
  ``--record``/``--replay`` entry points.

Weights are random, from seeded ``torch.Generator``s. Exits non-zero on any
failure, and without a GPU. It prints each phase's wall time. Its last lines
are the card's name and power limit, one JSON line with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import platform
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import HapiCluster, NetworkSpec, TenantSpec  # noqa: E402
from repro_torch.config import HW, HapiConfig, RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.batch_adapt import AdaptRequest, adapt_batches  # noqa: E402
from repro_torch.core.profiler import profile_layered  # noqa: E402
from repro_torch.core.splitter import choose_split  # noqa: E402
from repro_torch.core.tier_split import (  # noqa: E402
    largest_divisor_leq, make_extract_fn, make_tune_loss_fn, make_vision_executor, plan_tiers,
    wire_bytes)
from repro_torch.cos.client import BaselineClient, HapiClient  # noqa: E402
from repro_torch.cos.clock import Link, Simulator  # noqa: E402
from repro_torch.cos.objectstore import ObjectStore  # noqa: E402
from repro_torch.cos.server import HapiServer  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import int8_transfer, ssd_scan  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_tile_config, flash_attention_bwd_cuda, flash_attention_cuda, fwd_route)
from repro_torch.kernels.int8_cases import INT8_ADVERSARIAL, int8_adversarial  # noqa: E402
from repro_torch.kernels.int8_transfer import (  # noqa: E402
    dequantize_int8_cuda, quantize_int8_cuda)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda  # noqa: E402
from repro_torch.launch.serve import generate, serve  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import KVCache, MoE, moe_apply, moe_route  # noqa: E402
from repro_torch.models.transformer import Sublayer  # noqa: E402
from repro_torch.models.vision import PAPER_MODELS, EncoderBlock  # noqa: E402
from repro_torch.train import steps as train_steps  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    build_decode_step, build_hapi_train_step, build_prefill_step, init_train_state)

ARCH = "mistral-nemo-12b"
BF16_TOL = 2e-2          # tests/test_kernels.py's bf16 tolerance
F32_TOL = 2e-5           # tests/test_kernels.py's f32 tolerance
LOSS_TOL = 2e-2          # card vs CPU loss of the 2-block model, bf16 end to end
DECODE_BF16_TOL = 3e-2   # tests/test_kernels.py's bf16 decode tolerance
SSD_TOL = 2e-3           # tests/test_kernels.py's SSD tolerance
# Card vs CPU, two blocks in bf16 on both: relative L2 error of the logits and
# of the SSM states. Both devices round to bf16 at the same places, so only
# summation order and the kernels' algorithms differ.
SERVE_AGREE_TOL = 2e-2
# Card vs CPU of serve() at its defaults (f32 smoke configs, the same seeded
# weights on both): relative L2 of the prefill's logits. Both sides compute in
# f32 (no TF32), so only summation order and the kernels' algorithms differ:
# about 1e-6; a wrong mask or position decorrelates the logits (near 1).
SMOKE_SERVE_TOL = 1e-4
SMOKE_ARCHS = ("mistral-nemo-12b", "gemma2-9b", "qwen3-32b", "mamba2-1.3b",
               "moonshot-v1-16b-a3b", "grok-1-314b", "jamba-v0.1-52b")
# The prefill's last logits against the last teacher-forced step's, at full
# depth in bf16 (relative L2 over the real vocabulary). The two paths round
# differently: flash vs decode kernel (dense), and for mamba2 the prefill
# rounds each layer's conv output to bf16 where decode keeps it in f32, as the
# JAX model does (about 7% after 48 layers at smoke width on the CPU). A wrong
# position, mask or state decorrelates the logits: relative error near 1.4.
#
# The MoE models (moonshot, jamba) are held at capacity_factor = n_experts /
# top_k, where cap = s and no slot drops: at the published 1.25 the prefill
# (s = 512) drops the late tokens of over-full experts (cap 61 against a mean
# of 48 slots an expert for moonshot, 81 against 64 for jamba) and the decode
# step (s = 1) drops none, so the two cannot agree there, in the reference
# either; that error is logged as a number. moonshot as mistral (attention
# is its only mixer); jamba as mamba2 (its mamba layers round as mamba2's).
CONSISTENCY_TOL = {"mistral-nemo-12b": 0.1, "mamba2-1.3b": 0.25,
                   "moonshot-v1-16b-a3b": 0.1, "jamba-v0.1-52b": 0.25}
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 512, 32
N_REQUESTS = 3
WIRE_BYTES = 83_886_080 + 2_621_440   # int8 codes + f32 scales of (4, 4096, 5120)
KERNELS = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:128"),
    # No TPU kernel: the JAX train step differentiates attention through XLA.
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/train/steps.py:67"),
    "quantize_int8": ("src/repro_torch/csrc/int8_transfer.cu",
                      "src/repro/kernels/int8_transfer.py:52"),
    "dequantize_int8": ("src/repro_torch/csrc/int8_transfer.cu",
                        "src/repro/kernels/int8_transfer.py:86"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:101"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:106"),
    # No TPU kernel: the JAX train step differentiates ssd_chunked through XLA.
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu", "src/repro/models/ssm.py:89"),
}
# The training slice: mistral-nemo-12b at full width, cut to 8 blocks (freeze
# index 6: 2 trainable blocks, final_norm and unembed), a batch of 4 x 4,096.
TRAIN_LAYERS = 8
TRAIN_FUSED_STEPS = 4
TRAIN_LR = 1e-4
# Launches of one train step. Fused (microbatch 2 >= COS batch 2): 2 chunks,
# each 6 prefix forwards, 2 + 2 suffix forwards (remat reruns each block's
# forward in the backward), 2 backwards, 1 quantize, 1 dequantize. Coarse
# (microbatch 1 < COS batch 2): extraction over 2 microbatches (12 prefix
# forwards, 2 quantizes), then 4 chunks of one sample, each 1 dequantize,
# 4 suffix forwards and 2 backwards.
TRAIN_LAUNCHES = {
    "fused": {"flash_attention": 2 * (6 + 4), "flash_attention_bwd": 2 * 2,
              "quantize_int8": 2, "dequantize_int8": 2},
    "coarse": {"flash_attention": 12 + 4 * 4, "flash_attention_bwd": 4 * 2,
               "quantize_int8": 2, "dequantize_int8": 4},
}
# The SSM training slice: mamba2-1.3b at full width and depth (48 layers,
# freeze index 36: 12 trainable layers, final_norm and the tied head), the
# same batch, plan and steps. By the same arithmetic: fused 2 x (36 + 12 + 12)
# SSD forwards and 2 x 12 backwards; coarse 2 x 36 + 4 x (12 + 12) and 4 x 12.
SSM_ARCH = "mamba2-1.3b"
SSM_WIRE_BYTES = 33_554_432 + 1_048_576   # int8 codes + f32 scales of (4, 4096, 2048)
SSM_TRAIN_LAUNCHES = {
    "fused": {"ssd_scan": 120, "ssd_scan_bwd": 24, "quantize_int8": 2, "dequantize_int8": 2},
    "coarse": {"ssd_scan": 168, "ssd_scan_bwd": 48, "quantize_int8": 2, "dequantize_int8": 4},
}


def train_launches(kind: str, n_blocks: int, split: int, fwd: str, bwd: str) -> dict:
    """Launches of one train step of a batch of 4 at COS batch 2: fused
    (microbatch 2), 2 chunks, each the prefix's forwards, each trainable
    block's forward twice (remat) and its backward, 1 quantize and 1
    dequantize; coarse (microbatch 1), extraction over 2 microbatches, then
    4 chunks of one sample, each 1 dequantize."""
    tail = n_blocks - split
    if kind == "fused":
        return {fwd: 2 * (split + 2 * tail), bwd: 2 * tail, "quantize_int8": 2,
                "dequantize_int8": 2}
    return {fwd: 2 * split + 4 * 2 * tail, bwd: 4 * tail, "quantize_int8": 2,
            "dequantize_int8": 4}
# Card vs CPU of one train step of the 2-block full-width model, bf16 on both.
# The loss as LOSS_TOL; the gradient norm and the first moment m (0.1 x the
# clipped gradient) to SERVE_AGREE_TOL relative: bf16 gradients summed in f32
# in another order. The first AdamW update is lr * g / (|g| + eps), about
# lr * sign(g), so the updates are held by the share of elements whose signs
# agree: a gradient element within bf16 noise of zero may flip.
TRAIN_SIGN_AGREE = 0.95
# mamba2's D (the skip y + D x) is held apart from SERVE_AGREE_TOL. Its
# gradient, the sum of dL/dy * x, nearly cancels: the per-head RMSNorm after
# the skip makes dL/dy nearly orthogonal to y, which D x dominates at init,
# so its norm is about 1.6e-5 against 2.5e-5 to 0.07 for the other tensors,
# and bf16 rounding elsewhere in the step moves it by about 13% card vs CPU
# (0.128 on an H100, the same with the plain SSD backward on the card). It
# does not pass through the SSD backward: the step with the kernel and the
# step with the plain backward, both on the card, give it the same bits,
# which is checked. CANCELLING_TOL still catches a wrong gradient (error
# near 1 or above).
CANCELLING = ("mamba.D",)
CANCELLING_TOL = 0.25
# The same card step with the SSD backward kernel and with its plain version
# (ref.ssd_chunked_bwd on the card tensors): the two differ by about 1e-5 in
# f32 (check_ssd_bwd), which the bf16 rounding of the gradients upstream of
# the scan amplifies, per tensor of the first moment, to 2.4e-3 relative L2 at
# worst on an H100 (conv_C_b; the tensor-core backward's bf16 halves). Everything
# else in the two steps is the same computation.
KERNEL_STEP_TOL = 5e-3
# Launches of one serve() call at SERVE_BATCH x SERVE_PROMPT + SERVE_TOKENS:
# a decode-attention launch per attention sublayer per decode step, a flash
# launch per attention sublayer of the prefill, an SSD launch per mamba layer.
# jamba has one attention sublayer in each period of 8: 2 flash launches and
# 14 SSD launches in the prefill of its 2 periods.
SERVE_LAUNCHES = {
    "mistral-nemo-12b": {"flash_attention": 40,
                         "decode_attention": 40 * (SERVE_PROMPT + SERVE_TOKENS)},
    "mamba2-1.3b": {"ssd_scan": 48},
    "moonshot-v1-16b-a3b": {"flash_attention": 48,
                            "decode_attention": 48 * (SERVE_PROMPT + SERVE_TOKENS)},
    "jamba-v0.1-52b": {"flash_attention": 2, "decode_attention": 2 * (SERVE_PROMPT + SERVE_TOKENS),
                       "ssd_scan": 14},
}
# jamba-v0.1-52b is served at its published widths cut to 2 of its 4
# periods (16 of 32 layers): 52.0 GB of bf16 weights, where all 4 need
# 102.9 GB, more than one card holds. serve() takes no depth, so the phase
# drives generate(), serve()'s loop, on the cut model.
SERVE_LAYERS = {"jamba-v0.1-52b": 16}
# The MoE pushdown: moonshot-v1-16b-a3b at 48 blocks, a batch of 2 x 4,096
# (at 4 x 4,096 its f32 logits, taken twice through log_softmax, would need
# about 78 GB beside the 56.1 GB of weights), COS batch 1; split 36, the
# freeze index (token input gives Alg. 1 no candidate).
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_WIRE_BYTES = 16_777_216 + 524_288   # int8 codes + f32 scales of (2, 4096, 2048)
# A MoE layer card vs CPU: 4 x 512 tokens at moonshot's published capacity.
# The router and its input lie on grids (multiples of 1/256, and of 1/64 with
# |x| <= 4, exact in bf16): every product is a multiple of 2**-14 and every
# partial sum of the f32 gate logits is exact in any order, so the two
# devices must route the same tokens; the output then differs by the expert
# products' bf16 rounding, held to BF16_TOL relative L2.
MOE_ROUTER_GRID, MOE_INPUT_GRID = 1 / 256, 1 / 64
# Two full-width moonshot blocks card vs CPU, bf16 on both. bf16 noise
# upstream of a router flips the experts of nearly tied tokens: 98.64% of the
# tokens' top-6 sets agreed on an H100 (prefill and 4 steps, 2 blocks), so
# at least MOE_ROUTE_AGREE must. A flip swaps an expert of weight about 0.12
# (the sixth of six renormalised near-tied probabilities), about 40% of that
# token's MoE output, and moves its logits by several percent, not by a
# rounding; no checked position flipped there and the logits agreed to
# 0.0040-0.0044 relative L2. MOE_AGREE_TOL leaves room for one checked
# position to flip; a wrong mask, position or expert decorrelates the
# logits (near 1).
MOE_AGREE_TOL = 0.1
MOE_ROUTE_AGREE = 0.95
# The paper's vision workload: one object of 1,000 images (the paper's object
# size), each model's Alg. 1 split under compress_transfer at a train batch of
# 1,000 (HapiConfig's other defaults, as tests/test_torch_planner.py holds the
# JAX package to), and the COS batch of Eq. 4 against the card's memory.
VISION_OBJECT = 1000
VISION_TRAIN_BATCH = 1000
VISION_REQUESTS = 2
# Card vs CPU of apply_range on 2 images, relative L2 of a boundary: both sides
# in float32 with cuDNN's TF32 off, so only the order of the convolutions' and
# products' sums differs (about 1e-6); a wrong padding or layout gives near 1.
VISION_TOL = 1e-4
VISION_FIG3 = ("alexnet", "resnet18")   # per-layer times, the paper's Fig. 3
# The paper's runtime serving an epoch: 4 objects of 1,000 images through
# HapiClient -> HapiServer (one accelerator) -> make_vision_executor on the
# card, at a train batch of 2,000 (two POSTs an iteration, two iterations).
# Objects are charged the paper's ~110 KB an image on the wire (ImageNet
# JPEGs, as put_synthetic_dataset charges them); the payload is f32 pixels.
EPOCH_OBJECTS = 4
EPOCH_TRAIN_BATCH = 2000
EPOCH_IMG_BYTES = 110_000
EPOCH_SUFFIX_CHUNK = 200    # the compute tier's suffix forward, images a call
# Two tenants, one a model, on two replicas over one 1 Gbps trunk (the
# paper's Sec. 7.7 testbed, cut to two of each): the epoch's objects again.
FLEET_MODELS = ("alexnet", "transformer")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one eager call, from CUDA events around ``iters`` calls:
    the device time, or the host's time to issue the call where that is
    longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, timed with CUDA events over ``replays`` replays, so the host's
    cost of issuing a call does not count."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(bytes_moved: float, ops_done: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = bytes_moved / HW.hbm_bandwidth
    t_ops = ops_done / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def live_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves live: the work a flash kernel needs."""
    q = np.arange(s)
    lo = np.maximum(q - window, 0) if window is not None else np.zeros(s, np.int64)
    hi = q if causal else np.full(s, s - 1)
    return int((hi - lo + 1).sum())


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in f64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 1: environment
# ---------------------------------------------------------------------------
def environment() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"python {platform.python_version()} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def int8_exact(x: torch.Tensor, what: str) -> str:
    """Quantize x with the kernel, hold q, the scales and both dequantizes
    to the plain versions bit for bit; returns the route it took."""
    before = dict(int8_transfer.quantize_routes)
    q, s = quantize_int8_cuda(x)
    qe, se = ref.quantize_int8(x)
    check(torch.equal(q, qe) and torch.equal(s, se), f"quantize_int8 not bit-exact at {what}")
    for out_dt in (torch.bfloat16, torch.float32):
        check(torch.equal(dequantize_int8_cuda(q, s, out_dt), ref.dequantize_int8(qe, se, out_dt)),
              f"dequantize_int8 not exact at {what} -> {out_dt}")
    return next(r for r, n in int8_transfer.quantize_routes.items() if n > before[r])


def check_int8() -> dict:
    # shape, the route it must take: tiles of 128 (16 or 32 lanes a tile), 16,
    # 8 and 4, ragged rows, D = 97 (tile 1) and tile 4 in bf16 on the scalar route.
    cases = [((2, 4096, 5120), "vector", "vector"), ((3, 1001, 5120), "vector", "vector"),
             ((7, 333, 80), "vector", "vector"), ((37, 8), "vector", "vector"),
             ((37, 12), "scalar", "vector"), ((5, 97), "scalar", "scalar"),
             ((1, 1, 5120), "vector", "vector")]
    for shape, bf16_route, f32_route in cases:
        for dt, want in ((torch.bfloat16, bf16_route), (torch.float32, f32_route)):
            x = randn(shape, dt, seed=shape[-1]) * 3
            route = int8_exact(x, f"{shape} {dt}")
            check(route == want, f"quantize_int8 at {shape} {dt} took the {route} route")
    for case in INT8_ADVERSARIAL:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(int8_adversarial(case)).to("cuda", dt)
            check(int8_exact(x, f"{case} {dt}") == "vector", f"{case}: not the vector route")
    for dt in (torch.bfloat16, torch.float32):
        buf = randn((300 * 5120 + 1,), dt, seed=3) * 3
        view = buf[1:].view(300, 5120)   # 2 or 4 bytes off 16-byte alignment
        check(int8_exact(view, f"unaligned view {dt}") == "scalar", "unaligned view: route")
    log("int8: q, scales and dequantize bit-exact with the plain versions on every route "
        "(vector: D=5120, 80, 8, 12 in f32, ragged rows; scalar: D=97, 12 in bf16, a view "
        "off 16-byte alignment; bf16 and f32) and on adversarial inputs "
        f"({', '.join(INT8_ADVERSARIAL)}), routes {int8_transfer.quantize_routes}")

    # Times at the path's shapes: the storage tier quantizes one (2, 4096, 5120)
    # bf16 microbatch, the compute tier dequantizes (4, 4096, 5120) into bf16.
    x = randn((2, 4096, 5120), torch.bfloat16, seed=1) * 3
    q, s = quantize_int8_cuda(x)
    n = x.numel()
    qb, qby = bound(n * (2 + 1) + s.numel() * 4, 5 * n, HW.peak_flops_f32)
    quant = dict(max_abs_err=float((q.int() - ref.quantize_int8(x)[0].int()).abs().max()),
                 ms=device_ms(lambda: quantize_int8_cuda(x), 20),
                 plain_ms=time_ms(lambda: ref.quantize_int8(x), 10),
                 bound_ms=qb, bound_by=qby, library_ms=None)
    q4 = torch.cat([q, q])
    s4 = torch.cat([s, s])
    n4 = q4.numel()
    db, dby = bound(n4 * (1 + 2) + s4.numel() * 4, n4, HW.peak_flops_f32)
    got, exp = dequantize_int8_cuda(q4, s4), ref.dequantize_int8(q4, s4)
    # One PyTorch call of the same function: the f32 product of the codes and
    # their tile's scale, cast to bf16 on the way out (ref.dequantize_int8's
    # arithmetic, without its intermediate f32 tensor).
    lib_out = torch.empty_like(got)
    tile = q4.shape[-1] // s4.shape[-1]
    lead = (*q4.shape[:-1], s4.shape[-1], tile)

    def library():
        torch.mul(q4.view(lead), s4.unsqueeze(-1), out=lib_out.view(lead))

    library()
    check(torch.equal(lib_out, exp), "the library dequantize differs from the plain version")
    dequant = dict(max_abs_err=float((got.float() - exp.float()).abs().max()),
                   ms=device_ms(lambda: dequantize_int8_cuda(q4, s4), 20),
                   plain_ms=time_ms(lambda: ref.dequantize_int8(q4, s4), 10),
                   bound_ms=db, bound_by=dby, library_ms=device_ms(library, 20))
    for name, r in (("quantize_int8 (8192 x 5120 bf16)", quant),
                    ("dequantize_int8 (16384 x 5120 -> bf16)", dequant)):
        lib = "" if r["library_ms"] is None else \
            f", library (torch.mul into bf16, equal to the plain version) {r['library_ms']:.4f} ms"
        log(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return {"quantize_int8": quant, "dequantize_int8": dequant}


FLASH_CASES = [
    # b, s, h, hkv, hd, causal, window, softcap, dtype, tol
    (2, 4096, 32, 8, 128, True, None, None, torch.bfloat16, BF16_TOL),   # the path's shape
    (1, 4096, 16, 8, 256, True, 1024, 50.0, torch.bfloat16, BF16_TOL),   # gemma2 local
    (1, 2048, 16, 8, 256, True, None, 50.0, torch.bfloat16, BF16_TOL),   # gemma2 global
    (2, 1000, 8, 8, 128, False, None, None, torch.bfloat16, BF16_TOL),   # bidirectional
    (1, 777, 8, 2, 64, False, 100, None, torch.bfloat16, BF16_TOL),      # future keys admitted
    (2, 300, 4, 2, 64, True, None, None, torch.float32, F32_TOL),
    (1, 200, 4, 1, 128, True, 50, 30.0, torch.float32, F32_TOL),
    (1, 129, 2, 2, 256, False, None, None, torch.float32, F32_TOL),
    (1, 100, 4, 4, 64, False, 10, None, torch.float32, F32_TOL),
    (4, 32, 4, 2, 16, True, None, None, torch.float32, F32_TOL),        # the smoke configs
    (4, 300, 4, 2, 16, True, 16, 50.0, torch.float32, F32_TOL),         # gemma2 smoke, local
    (2, 257, 8, 2, 32, True, None, None, torch.float32, F32_TOL),
    (1, 190, 4, 4, 32, False, 30, None, torch.float32, F32_TOL),
    (200, 196, 6, 6, 64, False, None, None, torch.float32, F32_TOL),   # a ViT block, COS batch
    (2, 4096, 16, 16, 128, True, None, None, torch.bfloat16, BF16_TOL),  # moonshot's tune, group 1
]


def kernel_route(hd: int, dt: torch.dtype) -> str:
    """The forward's route of (dtype, head dim) as the C side names it, held
    to fwd_route's."""
    import ctypes
    lib = _build.load("flash_attention", flash._SIGNATURES)
    got = [ctypes.c_int() for _ in range(5)]
    rc = lib.flash_attention_fwd_route(0 if dt == torch.float32 else 1, hd,
                                       *(ctypes.byref(x) for x in got))
    route = flash.FWD_ROUTES[got[0].value]
    check(rc == 0 and (route, *(x.value for x in got[1:])) == fwd_route(hd, dt),
          f"flash_attention_fwd_route {rc} disagrees with fwd_route at hd {hd} {dt}")
    return route


def check_flash() -> dict:
    main = None
    for b, s, h, hkv, hd, causal, window, cap, dt, tol in FLASH_CASES:
        q = randn((b, s, h, hd), dt, seed=1)
        k = randn((b, s, hkv, hd), dt, seed=2)
        v = randn((b, s, hkv, hd), dt, seed=3)
        route = kernel_route(hd, dt)
        before = flash.fwd_routes[route]
        out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap)
        check(flash.fwd_routes[route] == before + 1, f"flash hd {hd} {dt}: not the {route} route")
        kr, vr = ops.repeat_kv(k, h // hkv), ops.repeat_kv(v, h // hkv)
        exp = ref.flash_attention(q, kr, vr, causal=causal, window=window, softcap=cap)
        err = float((out.float() - exp.float()).abs().max())
        torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
        log(f"flash B={b} S={s} H={h} Hkv={hkv} hd={hd} causal={causal} window={window} "
            f"softcap={cap} {str(dt)[6:]}, route {route}: max abs err {err:.3g} (tol {tol:g})")
        if main is None:
            pairs = live_pairs(s, causal, window)
            fb, fby = bound((2 * b * s * h * hd + 2 * b * s * hkv * hd) * q.element_size(),
                            4 * hd * b * h * pairs, HW.peak_flops_bf16)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            main = dict(
                max_abs_err=err,
                ms=device_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), 10),
                plain_ms=time_ms(lambda: ref.flash_attention(q, kr, vr, causal=causal), 3, 1),
                bound_ms=fb, bound_by=fby,
                library_ms=device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                                   10))
            log(f"flash_attention (2 x 4096, 32/8 heads, hd 128, causal, bf16): "
                f"{main['ms']:.4f} ms, plain {main['plain_ms']:.4f} ms, "
                f"bound {main['bound_ms']:.4f} ms ({fby}), "
                f"scaled_dot_product_attention {main['library_ms']:.4f} ms")
        del q, k, v, out, exp, kr, vr
        torch.cuda.empty_cache()
    # The same kernel at the suffix's shape and the serving prefill's, each
    # beside SDPA from this run.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for what, b, s in (("suffix", 4, 4096), ("serving prefill", 4, 512)):
        q = randn((b, s, 32, 128), torch.bfloat16, seed=1)
        k = randn((b, s, 8, 128), torch.bfloat16, seed=2)
        v = randn((b, s, 8, 128), torch.bfloat16, seed=3)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        fb, fby = bound((2 * b * s * 32 * 128 + 2 * b * s * 8 * 128) * 2,
                        4 * 128 * b * 32 * live_pairs(s, True, None), HW.peak_flops_bf16)
        n = 10 if s > 512 else 100
        ms = device_ms(lambda: flash_attention_cuda(q, k, v), n)
        lib_ms = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), n)
        log(f"flash_attention at the {what} shape ({b} x {s}, 32/8 heads, hd 128, causal, "
            f"bf16): {ms:.4f} ms, bound {fb:.4f} ms ({fby}), scaled_dot_product_attention "
            f"{lib_ms:.4f} ms")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return {"flash_attention": main}


FLASH_BWD_CASES = [
    # b, s, h, hkv, hd, causal, window, softcap, dtype, tol
    (2, 4096, 32, 8, 128, True, None, None, torch.bfloat16, BF16_TOL),   # the path's shape
    (1, 1000, 8, 2, 128, True, 100, 50.0, torch.bfloat16, BF16_TOL),     # window + softcap
    (1, 4096, 16, 8, 256, True, 1024, 50.0, torch.bfloat16, BF16_TOL),   # gemma2 local
    (2, 777, 8, 2, 64, False, None, None, torch.bfloat16, BF16_TOL),
    (1, 333, 8, 2, 64, False, 30, None, torch.bfloat16, BF16_TOL),       # future keys admitted
    (4, 32, 4, 2, 16, True, None, None, torch.float32, F32_TOL),        # the smoke configs
    (4, 300, 4, 2, 16, True, 16, 50.0, torch.float32, F32_TOL),         # gemma2 smoke, local
    (2, 257, 8, 2, 32, True, None, None, torch.float32, F32_TOL),
    (1, 200, 4, 1, 128, True, 50, 30.0, torch.float32, F32_TOL),
]


def flash_bwd_bound(b, s, h, hkv, hd, causal, window, itemsize):
    """Bytes: q, k, v, o, dO read and dq, dk, dv written once, the
    log-sum-exp read once; operations: five products of 2 hd FLOP per live
    (query, key) pair and head (S, dP, dV, dK, dQ), at the bf16 peak."""
    nbytes = (5 * b * s * h * hd + 4 * b * s * hkv * hd) * itemsize + 4 * b * h * s
    return bound(nbytes, 10 * hd * b * h * live_pairs(s, causal, window), HW.peak_flops_bf16)


def kernel_ms(fn, calls: int = 5) -> dict:
    """Device ms of each port kernel one call of ``fn`` launches, by the
    kernel's name, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        name = re.search(r"bwd_[a-z0-9_]+", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            rows[name.group(0)] = rows.get(name.group(0), 0.0) + e.device_time_total / 1e3 / calls
    return rows


def check_flash_bwd() -> dict:
    """The backward kernel's dq, dk, dv (and the forward's log-sum-exp)
    against the plain versions, measured as check_flash measures the
    forward, and two calls bit-equal, on the route bwd_tile_config names;
    then its time at the path's shape beside its bound and SDPA's backward
    (SDPA's forward plus backward less its forward, eager, CUDA events), and
    each of its kernels' times (the D pre-pass, dK/dV, dQ)."""
    main = None
    for b, s, h, hkv, hd, causal, window, cap, dt, tol in FLASH_BWD_CASES:
        q = randn((b, s, h, hd), dt, seed=11)
        k = randn((b, s, hkv, hd), dt, seed=12)
        v = randn((b, s, hkv, hd), dt, seed=13)
        do = randn((b, s, h, hd), dt, seed=14)
        mask = dict(causal=causal, window=window, softcap=cap)
        out, lse = flash_attention_cuda(q, k, v, lse=True, **mask)
        rep = h // hkv
        _, exp_lse = ref.flash_attention_lse(q, ops.repeat_kv(k, rep), ops.repeat_kv(v, rep),
                                             **mask)
        torch.testing.assert_close(lse, exp_lse, atol=tol, rtol=tol)
        lse_err = float((lse - exp_lse).abs().max())
        del exp_lse
        grads = flash_attention_bwd_cuda(q, k, v, out, lse, do, **mask)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, do, **mask)
        equal = all(torch.equal(x, y) for x, y in zip(grads, again))
        check(equal, f"flash_attention_bwd: two calls differ (B={b} S={s} hd={hd})")
        del again
        want = ref.flash_attention_bwd(q, k, v, do, **mask)
        errs = []
        for name, got, exp in zip(("dq", "dk", "dv"), grads, want):
            errs.append(float((got.float() - exp.float()).abs().max()))
            torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol,
                                       msg=f"flash_attention_bwd {name}")
        log(f"flash_bwd B={b} S={s} H={h} Hkv={hkv} hd={hd} causal={causal} window={window} "
            f"softcap={cap} {str(dt)[6:]}, route {bwd_tile_config(hd, dt)[0]} (forward "
            f"{fwd_route(hd, dt)[0]}): max abs err dq "
            f"{errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}, lse {lse_err:.3g} (tol {tol:g}); "
            f"two calls bit-equal {equal}")
        del grads, want
        free()
        if main is None:
            fb, fby = flash_bwd_bound(b, s, h, hkv, hd, causal, window, q.element_size())
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                with torch.no_grad():
                    sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                                    (qt, kt, vt), dot)

            lib_fwd = time_ms(sdpa_fwd, 10)
            lib_both = time_ms(sdpa_fwd_bwd, 10)
            main = dict(
                max_abs_err=max(errs),
                ms=device_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do), 10),
                plain_ms=time_ms(lambda: ref.flash_attention_bwd(q, k, v, do), 1, 1),
                bound_ms=fb, bound_by=fby, library_ms=lib_both - lib_fwd)
            parts = kernel_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do))
            log(f"flash_attention_bwd (2 x 4096, 32/8 heads, hd 128, causal, bf16, route "
                f"{bwd_tile_config(hd, dt)[0]}): {main['ms']:.4f} ms, plain "
                f"{main['plain_ms']:.4f} ms, bound {main['bound_ms']:.4f} ms ({fby}), "
                f"scaled_dot_product_attention backward {main['library_ms']:.4f} ms (forward + "
                f"backward {lib_both:.4f} less forward {lib_fwd:.4f}, eager); by kernel "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
            del qt, kt, vt, dot
        del q, k, v, do, out, lse
        free()
    return {"flash_attention_bwd": main}


DECODE_CASES = [
    # b, s, hq, hkv, hd, length(s), window, softcap, dtype (q's, where it differs: q, cache)
    (2, 1024, 8, 2, 64, 700, None, None, torch.float32),     # tests/test_kernels.py
    (2, 768, 16, 8, 64, 100, None, None, torch.bfloat16),
    (1, 300, 8, 8, 64, 300, None, None, torch.float32),
    (3, 64, 4, 2, 128, 1, None, None, torch.bfloat16),       # one live key
    (2, 200, 8, 1, 256, 77, None, 50.0, torch.float32),      # MQA, hd 256, softcap
    (1, 4096, 16, 8, 256, 3000, 1024, 50.0, torch.bfloat16),  # gemma2 local layer
    (2, 100, 4, 4, 64, 90, 0, None, torch.float32),          # window 0
    (4, 544, 32, 8, 128, 544, None, None, torch.float32),
    # the smoke models' decode: an f32 q against the bf16 cache
    (4, 48, 4, 2, 16, (1, 17, 48), None, None, (torch.float32, torch.bfloat16)),
    (4, 48, 4, 2, 16, 48, None, None, torch.bfloat16),
    (4, 48, 4, 2, 16, 33, 16, 50.0, torch.float32),
    (2, 700, 12, 2, 32, 650, None, None, torch.float32),     # group 6, a cluster
    (1, 20000, 6, 1, 16, 19000, None, None, torch.float32),  # group 6, scratch, hd 16
    (2, 20000, 16, 2, 16, 19000, None, None, torch.bfloat16),  # group 8, scratch, hd 16
    (4, 544, 48, 8, 128, 544, None, None, torch.bfloat16),   # grok-1's group of 6
    (4, 544, 16, 16, 128, 544, None, None, torch.bfloat16),  # moonshot's group 1
    (2, 4096, 48, 8, 128, 3000, None, 30.0, torch.bfloat16),
]
# b, cache, length, query heads, kv heads: the served path (mistral's 32/8),
# a long cache, and moonshot's group 1 (a row of its own in the kernels line).
DECODE_SHAPES = {"path": (4, 544, 544, 32, 8), "long": (4, 32768, 32768, 32, 8),
                 "moonshot": (4, 544, 544, 16, 16)}


def decode_bound(b, hq, hkv, hd, length, itemsize):
    """Each live K and V row read once, q read and the output written once;
    4 hd FLOP per (query head, key), on bf16 (or f32) operands."""
    nbytes = (2 * b * length * hkv * hd + 2 * b * hq * hd) * itemsize
    return bound(nbytes, 4 * hd * b * hq * length, HW.peak_flops_bf16)


def check_decode() -> dict:
    for b, s, hq, hkv, hd, lengths, window, cap, dt in DECODE_CASES:
        qdt, dt = dt if isinstance(dt, tuple) else (dt, dt)
        q = randn((b, hq, hd), qdt, seed=4)
        k = randn((b, s, hkv, hd), dt, seed=5)
        v = randn((b, s, hkv, hd), dt, seed=6)
        tol = F32_TOL if dt == torch.float32 else DECODE_BF16_TOL
        for length in lengths if isinstance(lengths, tuple) else (lengths,):
            out = decode_attention_cuda(q, k, v, length, window=window, softcap=cap)
            exp = ref.decode_attention(q, k, v, length, window=window, softcap=cap)
            err = float((out.float() - exp.float()).abs().max())
            torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
            log(f"decode B={b} S={s} Hq={hq} Hkv={hkv} hd={hd} length={length} "
                f"window={window} softcap={cap} q {str(qdt)[6:]} cache {str(dt)[6:]}: "
                f"max abs err {err:.3g} (tol {tol:g})")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, (b, s, length, hq, hkv) in DECODE_SHAPES.items():
        q = randn((b, hq, 128), torch.bfloat16, seed=7)
        k = randn((b, s, hkv, 128), torch.bfloat16, seed=8)
        v = randn((b, s, hkv, 128), torch.bfloat16, seed=9)
        out = decode_attention_cuda(q, k, v, length)
        exp = ref.decode_attention(q, k, v, length)
        err = float((out.float() - exp.float()).abs().max())
        check(err <= DECODE_BF16_TOL, f"decode at the {name} shape: max abs err {err}")
        qs, ks, vs = q[:, :, None], k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2)
        db, dby = decode_bound(b, hq, hkv, 128, length, 2)
        n = 200 if s < 4096 else 50
        rows[name] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: decode_attention_cuda(q, k, v, length), n),
            plain_ms=time_ms(lambda: ref.decode_attention(q, k, v, length), 10),
            bound_ms=db, bound_by=dby,
            library_ms=device_ms(lambda: sdpa(qs, ks, vs, enable_gqa=True), n))
        r = rows[name]
        eager = time_ms(lambda: decode_attention_cuda(q, k, v, length), n)
        eager_lib = time_ms(lambda: sdpa(qs, ks, vs, enable_gqa=True), n)
        log(f"decode_attention at the {name} shape (B={b}, {hq}/{hkv} heads, hd 128, cache {s}, "
            f"length {length}, bf16): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({dby}), scaled_dot_product_attention "
            f"{r['library_ms']:.4f} ms; an eager call {eager:.4f} ms "
            f"(scaled_dot_product_attention {eager_lib:.4f} ms); max abs err {err:.3g}")
        del q, k, v, qs, ks, vs, out, exp
        free()
    return {"decode_attention": rows["path"], "decode_attention_moonshot": rows["moonshot"]}


SSD_CASES = [
    # b, s, h, p, n, chunk, dtype
    (2, 512, 8, 64, 128, 128, torch.float32),    # tests/test_kernels.py
    (1, 256, 4, 32, 64, 64, torch.float32),
    (1, 256, 4, 32, 16, 128, torch.float32),
    (2, 128, 8, 64, 128, 128, torch.float32),
    (2, 48, 3, 16, 16, 16, torch.float32),       # the smoke model's widths
    (2, 48, 3, 16, 16, 16, torch.bfloat16),
    (4, 32, 8, 16, 16, 16, torch.float32),       # the smoke mamba2's prefill in serve()
    (2, 768, 4, 64, 128, 256, torch.bfloat16),   # slow decay (rate exp(-4)), 3 chunks
    (4, 512, 64, 64, 128, 256, torch.bfloat16),  # the path's shape
    (4, 512, 128, 64, 16, 256, torch.bfloat16),  # jamba-v0.1-52b's prefill: 128 heads, N 16
    (4, 8, 64, 64, 128, 256, torch.bfloat16),    # short prompts: chunks padded to 16
    (4, 100, 64, 64, 128, 256, torch.bfloat16),
    (2, 250, 8, 64, 128, 256, torch.bfloat16),
    (2, 64, 8, 64, 128, 8, torch.bfloat16),      # a chunk of 8
    (2, 100, 8, 64, 128, 256, torch.float32),
]
SLOW_DECAY = (2, 768, 4, 64, 128, 256)


def ssd_inputs(b, s, h, p, n, dt, seed=10, a_log=None):
    """Decay rates -exp(0.3 z) per head, or -exp(a_log) (slow where a_log is -4)."""
    x = randn((b, s, h, p), dt, seed)
    dts = torch.nn.functional.softplus(randn((b, s, h), torch.float32, seed + 1))
    a = -torch.exp(randn((h,), torch.float32, seed + 2) * 0.3 if a_log is None
                   else torch.full((h,), a_log, device="cuda"))
    return x, dts * a, dts, randn((b, s, n), dt, seed + 3) * 0.3, \
        randn((b, s, n), dt, seed + 4) * 0.3


def ssd_bound(b, s, h, p, n, q, itemsize):
    """Bytes: x, B, C in their type, dtA and dt in f32 read once; y and the
    state written once in f32. Operations: the least the chunked form needs,
    with the within-chunk products over the lower triangle only: per chunk
    C.B^T once per batch row, and per head the masked (C.B^T * L).(x dt),
    the carried state's C.state and the state update B^T.(x dt). The bf16
    kernel runs them on the tensor cores, so they count at the bf16 peak;
    the f32 FMA bound of earlier runs comes back beside it."""
    nbytes = (b * s * h * p + 2 * b * s * n) * itemsize + 2 * b * s * h * 4 \
        + (b * s * h * p + b * h * n * p) * 4
    tri = q * (q + 1) // 2
    chunks = s // q
    flops = b * chunks * (2 * tri * n + h * (2 * tri * p + 4 * q * n * p))
    return bound(nbytes, flops, HW.peak_flops_bf16), flops, \
        bound(nbytes, flops, HW.peak_flops_f32)[0]


# The rows of the kernels line the SSD kernel gives: its time at mamba2's
# prefill shape, and at jamba's (128 heads, N 16) on its own row.
SSD_ROWS = {(4, 512, 64, 64, 128, 256): "ssd_scan", (4, 512, 128, 64, 16, 256): "ssd_scan_jamba"}


def check_ssd() -> dict:
    rows = {}
    for b, s, h, p, n, chunk, dt in SSD_CASES:
        slow = (b, s, h, p, n, chunk) == SLOW_DECAY
        args = ssd_inputs(b, s, h, p, n, dt, a_log=-4.0 if slow else None)
        y, st = ssd_scan_cuda(*args, chunk=chunk)
        ye, ste = ref.ssd_chunked(*args, chunk=chunk)
        err = max(float((y - ye).abs().max()), float((st - ste).abs().max()))
        torch.testing.assert_close(y, ye, atol=SSD_TOL, rtol=SSD_TOL)
        torch.testing.assert_close(st, ste, atol=SSD_TOL, rtol=SSD_TOL)
        log(f"ssd B={b} S={s} H={h} P={p} N={n} chunk={chunk} {str(dt)[6:]}"
            f"{' slow decay' if slow else ''}: max abs err {err:.3g} (tol {SSD_TOL:g}), "
            f"max |y| {float(ye.abs().max()):.3g}")
        name = SSD_ROWS.get((b, s, h, p, n, chunk)) if dt == torch.bfloat16 else None
        if name:
            (sb, sby), flops, fma_ms = ssd_bound(b, s, h, p, n, chunk, 2)
            row = rows[name] = dict(
                max_abs_err=err, ms=device_ms(lambda: ssd_scan_cuda(*args, chunk=chunk), 20),
                plain_ms=time_ms(lambda: ref.ssd_chunked(*args, chunk=chunk), 5, 1),
                bound_ms=sb, bound_by=sby, library_ms=None)
            log(f"{name} (x {b} x {s} x {h} x {p} bf16, N {n}, chunk {chunk}): "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {sb:.4f} ms ({sby}; "
                f"{flops / 1e9:.3f} GFLOP lower-triangle at the bf16 peak), "
                f"f32 FMA bound {fma_ms:.4f} ms")
        del args, y, st, ye, ste
        free()
    return rows


# The SSD backward against ref.ssd_chunked_bwd, relative L2 per gradient: f32
# to 1e-5 (the FMA kernel, f32 on both sides, another summation order); bf16
# to 1e-2 (the tensor-core route splits every f32 operand into bf16 hi/lo
# halves, about 16 bits; dx, dB and dC are rounded to bf16 on both sides).
# The CUDA-core FMA kernel (commit b3cc6c0; the f32 route today), f32
# products from the bf16 inputs, came to at most 1.06e-4 on these cases;
# each bf16 error is logged beside that.
SSD_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SSD_BWD_FMA_REL = 1.06e-4
# The tensor-core route's per-chunk state gradient (launches (a) and (b)
# alone) against ref.ssd_bwd_chunk_dstates: f32 sums on both sides, C^T dy
# with dy split hi/lo.
SSD_DSTATE_TOL = 1e-5
SSD_BWD_CASES = [
    # b, s, h, p, n, chunk, dtype, a_log (None: rates -exp(0.3 z)), final-state gradient
    (2, 4096, 64, 64, 128, 256, torch.bfloat16, None, False),   # the training path's shape
    (2, 768, 4, 64, 128, 256, torch.bfloat16, -4.0, False),     # slow decay, 3 chunks
    (4, 100, 64, 64, 128, 256, torch.bfloat16, None, False),    # a chunk off 16
    (2, 512, 8, 64, 128, 256, torch.bfloat16, -1.0, True),      # the final state's gradient
    (4, 32, 8, 16, 16, 16, torch.float32, None, False),         # the smoke model's shape
    (2, 192, 3, 64, 128, 64, torch.float32, -1.0, True),
]


def ssd_bwd_bound(b, s, h, p, n, q, itemsize):
    """Bytes: x, B, C in their type, dtA and dt in f32, the states and dy in
    f32 read once; dx, dB, dC in the inputs' type and d dtA, d dt in f32
    written once. Operations: per chunk and batch row C.B^T once over the
    lower triangle; per head the four triangle products (dy.xs^T, (S L)^T.dy,
    (M L).B, (M L)^T.C) and the five with the state (C.h, h.dy, B.dh, dh.xs,
    C^T.dy), at the bf16 tensor-core peak as the forward's bound counts
    them; the f32 FMA bound comes back beside it."""
    chunks = s // q
    nbytes = (2 * b * s * h * p + 4 * b * s * n) * itemsize + 4 * b * s * h * 4 \
        + (b * chunks * h * n * p + b * s * h * p) * 4
    tri = q * (q + 1) // 2
    flops = b * chunks * (2 * tri * n + h * (2 * tri * (2 * p + 2 * n) + 10 * q * n * p))
    return bound(nbytes, flops, HW.peak_flops_bf16), flops, \
        bound(nbytes, flops, HW.peak_flops_f32)[0]


def check_ssd_bwd() -> dict:
    """The forward's states and the backward kernel's five gradients against
    the plain versions (on bf16, also the tensor-core route's per-chunk state
    gradient); two calls are bit-equal; then its time at the training path's
    shape beside its bound."""
    row = None
    for b, s, h, p, n, chunk, dt, a_log, with_ds in SSD_BWD_CASES:
        args = ssd_inputs(b, s, h, p, n, dt, seed=40, a_log=a_log)
        dy = randn((b, s, h, p), torch.float32, 45)
        ds = randn((b, h, n, p), torch.float32, 46) if with_ds else None
        y, st, states = ssd_scan_cuda(*args, chunk=chunk, states=True)
        y0, st0 = ssd_scan_cuda(*args, chunk=chunk)
        check(torch.equal(y, y0) and torch.equal(st, st0), "ssd_scan: states=True changed y")
        want_states = ref.ssd_chunked(*args, chunk=chunk, states=True)[2]
        torch.testing.assert_close(states, want_states, atol=SSD_TOL, rtol=SSD_TOL)
        del y, st, y0, st0, want_states
        dh_note = ""
        if dt == torch.bfloat16:
            dh = ssd_scan.ssd_bwd_chunk_dstates_cuda(args[1], args[4], dy, ds, chunk=chunk)
            want_dh = ref.ssd_bwd_chunk_dstates(*args, dy, ds, chunk=chunk)
            if bool(want_dh.any()):
                dh_err = rel_err(dh, want_dh)
                check(dh_err <= SSD_DSTATE_TOL, f"ssd_scan_bwd per-chunk dh: relative L2 "
                      f"{dh_err:.3g} > {SSD_DSTATE_TOL:g}")
                dh_note = f"; per-chunk dh {dh_err:.3g} (tol {SSD_DSTATE_TOL:g})"
            else:  # one chunk and no final-state gradient: dh is zero
                check(not bool(dh.any()), "ssd_scan_bwd per-chunk dh: not zero")
                dh_note = "; per-chunk dh zero, as the plain version's"
            del dh, want_dh
        grads = ssd_scan_bwd_cuda(*args, states, dy, ds, chunk=chunk)
        want = ref.ssd_chunked_bwd(*args, dy, ds, chunk=chunk, states=states)
        errs = {}
        for name, got, exp, like in zip(("dx", "ddtA", "ddt", "dB", "dC"), grads, want, args):
            check(got.dtype == like.dtype and got.shape == like.shape, f"ssd_scan_bwd {name}")
            check(bool(torch.isfinite(got).all()), f"ssd_scan_bwd {name} not finite")
            errs[name] = rel_err(got, exp)
            check(errs[name] <= SSD_BWD_TOL[dt], f"ssd_scan_bwd {name}: relative L2 "
                  f"{errs[name]:.3g} > {SSD_BWD_TOL[dt]:g}")
        again = ssd_scan_bwd_cuda(*args, states, dy, ds, chunk=chunk)
        check(all(torch.equal(a, b_) for a, b_ in zip(grads, again)),
              "ssd_scan_bwd: two calls differ")
        route = ssd_scan.bwd_route(dt, n, p, min(chunk, s))
        fma = f", the FMA kernel at most {SSD_BWD_FMA_REL:g}" if dt == torch.bfloat16 else ""
        log(f"ssd_bwd B={b} S={s} H={h} P={p} N={n} chunk={chunk} {str(dt)[6:]} ({route})"
            f"{' slow decay' if a_log == -4.0 else ''}{' dstate' if with_ds else ''}: relative "
            f"L2 {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} (tol "
            f"{SSD_BWD_TOL[dt]:g}{fma}){dh_note}; two calls bit-equal")
        if row is None:
            (sb, sby), flops, fma_ms = ssd_bwd_bound(b, s, h, p, n, chunk, 2)
            row = dict(max_abs_err=max(float((g.float() - w.float()).abs().max())
                                       for g, w in zip(grads, want)),
                       ms=device_ms(lambda: ssd_scan_bwd_cuda(*args, states, dy, chunk=chunk), 3),
                       plain_ms=time_ms(lambda: ref.ssd_chunked_bwd(
                           *args, dy, chunk=chunk, states=states), 2, 1),
                       bound_ms=sb, bound_by=sby, library_ms=None)
            fwd_ms = device_ms(lambda: ssd_scan_cuda(*args, chunk=chunk), 10)
            fwd_states_ms = device_ms(lambda: ssd_scan_cuda(*args, chunk=chunk, states=True), 10)
            log(f"ssd_scan_bwd (x {b} x {s} x {h} x {p} bf16, N {n}, chunk {chunk}): "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {sb:.4f} ms ({sby}; "
                f"{flops / 1e9:.3f} GFLOP at the bf16 peak), f32 FMA bound {fma_ms:.4f} ms; "
                f"the forward at this shape {fwd_ms:.4f} ms, with its states "
                f"{fwd_states_ms:.4f} ms")
        del args, dy, ds, states, grads, want, again
        free()
    return {"ssd_scan_bwd": row}


# ---------------------------------------------------------------------------
# Phase 4: full-width agreement, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------
def check_full_width() -> None:
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    shape = ShapeConfig("agree", "train", seq_len=512, global_batch=2)
    plan = plan_tiers(cfg, shape, HapiConfig(compress_transfer=True, cos_batch=2,
                                             cos_batch_min=1))
    check(plan.split == 1, f"2-block plan split {plan.split}")
    lm_gpu = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    lm_cpu = copy.deepcopy(lm_gpu).cpu()
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 512))
    extract, tune = make_extract_fn(plan), make_tune_loss_fn(plan)
    losses, acts = {}, {}
    for dev, lm in (("cuda", lm_gpu), ("cpu", lm_cpu)):
        t = torch.from_numpy(toks).to(dev)
        batch = {"tokens": t, "labels": t}
        frozen, trainable = lm.split_params(plan.split)
        t0 = time.perf_counter()
        with torch.no_grad():
            wire = extract(frozen, batch)
            acts[dev] = ops.dequantize_int8(*wire).float().cpu()
            losses[dev] = float(tune(trainable, wire, batch))
        log(f"full width, 2 blocks, batch 2 x 512 on {dev}: loss {losses[dev]:.6f} "
            f"({time.perf_counter() - t0:.1f} s)")
    diff = abs(losses["cuda"] - losses["cpu"])
    act_err = float((acts["cuda"] - acts["cpu"]).abs().max())
    log(f"full width agreement: |loss card - loss cpu| = {diff:.3g} (tol {LOSS_TOL:g}); "
        f"boundary max abs err {act_err:.3g}")
    check(math.isfinite(losses["cuda"]) and diff <= LOSS_TOL, "card and CPU losses disagree")
    del lm_gpu, lm_cpu
    torch.cuda.empty_cache()


def serving_outputs(lm, toks: torch.Tensor, prompt: int, steps: int) -> dict:
    """The prefill's last logits and per-layer SSM states, then ``steps``
    teacher-forced decode steps after the prompt (the prefill's K/V copied
    into a cache of prompt + steps positions; mamba decodes from the prefill's
    own cache)."""
    prefill, step = build_prefill_step(lm), build_decode_step(lm)
    logits, caches = prefill({"tokens": toks[:, :prompt]})
    out = {"prefill": logits,
           "states": [c["sub0"].ssm for c in caches if hasattr(c["sub0"], "ssm")]}
    cache = lm.init_cache(toks.shape[0], prompt + steps)
    for full, part in zip(cache, caches):
        for name, c in full.items():
            if isinstance(c, KVCache):
                c.k[:, :prompt] = part[name].k
                c.v[:, :prompt] = part[name].v
            else:
                full[name] = part[name]
    for i in range(steps):
        out[f"step {i}"], cache = step(cache, toks[:, prompt + i:prompt + i + 1], prompt + i)
    return out


class RoutingLog:
    """Records, within the block, the ``Routing`` of every MoE FFN of ``lm``
    that runs: a forward hook on each MoE sublayer's ``ln_ffn`` routes that
    norm's output, which is what the sublayer hands ``moe_apply``."""

    def __init__(self, lm: torch.nn.Module):
        self.subs = [m for m in lm.modules() if isinstance(m, Sublayer) and m.ffn == "moe"]

    def __enter__(self):
        self.calls = []

        def hook(sub):
            return lambda _, __, out: self.calls.append(moe_route(sub.moe, out, sub.cfg))

        self.handles = [sub.ln_ffn.register_forward_hook(hook(sub)) for sub in self.subs]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def routing_agreement(card: list, cpu: list) -> tuple:
    """Over paired moe_apply calls: the share of tokens whose top-k expert
    sets agree, and the share of (token, choice) slots kept on both devices
    or dropped on both."""
    check(len(card) == len(cpu), "the devices made different numbers of MoE calls")
    same_set = kept = n_tok = n_slot = 0
    for a, b in zip(card, cpu):
        ea, eb = a.top_e.sort(-1).values.cpu(), b.top_e.sort(-1).values
        same_set += int((ea == eb).all(-1).sum())
        n_tok += ea.shape[0] * ea.shape[1]
        kept += int((a.kept.cpu() == b.kept).sum())
        n_slot += b.kept.numel()
    return same_set / n_tok, kept / n_slot


def check_moe_layer() -> None:
    """moonshot-v1-16b-a3b's MoE at full width (d 2048, 64 experts top-6, f
    1408, bf16) on 4 x 512 tokens at the published capacity 1.25, card vs
    CPU: the same routing (top-k experts and kept slots; see
    MOE_ROUTER_GRID), the output within BF16_TOL relative L2, two calls on
    the card bit-equal."""
    cfg = get_config(MOE_ARCH)
    moe_cpu = MoE(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        moe_cpu.router.copy_(torch.round(moe_cpu.router / MOE_ROUTER_GRID) * MOE_ROUTER_GRID)
    moe_gpu = copy.deepcopy(moe_cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (SERVE_BATCH, SERVE_PROMPT, cfg.d_model), dtype=np.float32))
    x = (torch.round(x / MOE_INPUT_GRID) * MOE_INPUT_GRID).clamp(-4, 4).to(torch.bfloat16)
    xg = x.cuda()
    with torch.no_grad():
        t0 = time.perf_counter()
        want, r_cpu = moe_apply(moe_cpu, x, cfg), moe_route(moe_cpu, x, cfg)
        cpu_s = time.perf_counter() - t0
        got, r_gpu = moe_apply(moe_gpu, xg, cfg), moe_route(moe_gpu, xg, cfg)
        again = moe_apply(moe_gpu, xg, cfg)
        ms = time_ms(lambda: moe_apply(moe_gpu, xg, cfg), 10)
    dropped = int((~r_cpu.kept).sum())
    same = {name: torch.equal(getattr(r_gpu, name).cpu(), getattr(r_cpu, name))
            for name in ("top_e", "rank", "valid")}
    same["buf_tok"] = torch.equal(torch.where(r_gpu.valid, r_gpu.buf_tok, -1).cpu(),
                                  torch.where(r_cpu.valid, r_cpu.buf_tok, -1))
    err = rel_err(got, want)
    log(f"moe layer {MOE_ARCH} (4 x 512 tokens, bf16, capacity {cfg.capacity_factor}, cap "
        f"{r_cpu.cap}, {dropped} of {r_cpu.kept.numel()} slots dropped), card vs cpu: routing "
        f"equal {same}, output relative L2 {err:.3g} (tol {BF16_TOL:g}), two card calls "
        f"bit-equal {torch.equal(got, again)}; moe_apply {ms:.4f} ms a call on the card "
        f"(eager, CUDA events), {1e3 * cpu_s:.1f} ms on the CPU")
    check(dropped > 0, "the published capacity dropped no slot")
    check(all(same.values()), f"card and CPU route differently: {same}")
    check(bool(torch.isfinite(got.float()).all()) and err <= BF16_TOL,
          "card and CPU MoE outputs disagree")
    check(torch.equal(got, again), "two MoE calls on the card differ")
    del moe_cpu, moe_gpu
    free()


# Two full-width blocks (layers) card vs CPU: (arch, prompt).
FULL_WIDTH_SERVING = (("mistral-nemo-12b", 512), ("mamba2-1.3b", 512), ("mamba2-1.3b", 100),
                      ("mamba2-1.3b", 8), (MOE_ARCH, 512))


def check_full_width_serving() -> None:
    for arch, prompt in FULL_WIDTH_SERVING:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        lm_gpu = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
        lm_cpu = copy.deepcopy(lm_gpu).cpu()
        toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, prompt + 4))
        outs, routes = {}, {}
        for dev, lm in (("cuda", lm_gpu), ("cpu", lm_cpu)):
            t0 = time.perf_counter()
            with RoutingLog(lm) as routing:
                outs[dev] = serving_outputs(lm, torch.from_numpy(toks).to(dev), prompt, 4)
            routes[dev] = routing.calls
            log(f"full width serving, {arch} 2 layers, prompt 2 x {prompt} + 4 steps on {dev} "
                f"({time.perf_counter() - t0:.1f} s)")
        tol = SERVE_AGREE_TOL
        if cfg.family == "moe":
            tol = MOE_AGREE_TOL
            sets, kept = routing_agreement(routes["cuda"], routes["cpu"])
            log(f"full width serving agreement, {arch}: routing card vs cpu over "
                f"{len(routes['cpu'])} MoE calls: top-{cfg.top_k} expert sets equal for "
                f"{sets:.4f} of tokens (at least {MOE_ROUTE_AGREE:g}), kept/dropped equal for "
                f"{kept:.4f} of slots")
            check(sets >= MOE_ROUTE_AGREE, f"{arch}: card and CPU route differently")
        v = cfg.vocab_size
        for name, got in outs["cuda"].items():
            pairs = zip(got, outs["cpu"][name]) if name == "states" else \
                [(got[..., :v], outs["cpu"][name][..., :v])]
            for i, (a, b) in enumerate(pairs):
                check(bool(torch.isfinite(a).all()), f"{arch} {name} not finite on the card")
                err = rel_err(a, b)
                log(f"full width serving agreement, {arch} {name}"
                    f"{f' layer {i}' if name == 'states' else ''}: relative L2 card vs cpu "
                    f"{err:.3g} (tol {tol:g}), max abs "
                    f"{float((a.double().cpu() - b.double()).abs().max()):.3g}")
                check(err <= tol, f"{arch} {name}: card and CPU disagree")
        del lm_gpu, lm_cpu, outs, routes
        free()


def greedy_shortfall(arch: str, card: dict, teacher_logits: torch.Tensor) -> float:
    """The card's prompt and greedy tokens fed through the CPU model, which
    serve() draws first from its seed (0) on the CPU: at each greedy step,
    how far the chosen token's CPU logit falls short of that step's CPU
    maximum, over the largest |logit|; the largest such shortfall. 0 where
    every card token is the CPU's argmax. Checks first that the rebuilt model
    gives the CPU run's last teacher-forced logits."""
    lm = build_model(get_smoke_config(arch), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    seq = torch.from_numpy(np.concatenate([card["prompt"], card["tokens"]], axis=1)).long()
    b, prompt = card["prompt"].shape
    steps = seq.shape[1] - 1
    step, cache = build_decode_step(lm), lm.init_cache(b, steps)
    worst = 0.0
    for t in range(steps):
        logits, cache = step(cache, seq[:, t:t + 1], t)
        if t == prompt - 1:
            check(torch.equal(logits, teacher_logits), f"{arch}: the rebuilt CPU model differs")
        if t >= prompt - 1:
            row = logits[:, -1].double()
            chosen = row.gather(-1, seq[:, t + 1:t + 2])[:, 0]
            worst = max(worst, float(((row.max(-1).values - chosen)
                                      / row.abs().max(-1).values).max()))
    return worst


def serve_defaults() -> None:
    """serve() at its defaults (the smoke config: f32, head dim 16, batch 4,
    prompt 32, 16 new tokens, seed 0) on the card and on the CPU: the same
    weights, so the prefill's logits agree to SMOKE_SERVE_TOL. Decode reads
    the bf16 cache and casts P to bf16 on both, so a step's logits agree to
    SERVE_AGREE_TOL, and a near tie may pick another token: the card's greedy
    tokens are held to the CPU model fed those same tokens, each within
    SERVE_AGREE_TOL of that step's CPU maximum (the CPU's argmax where the
    tokens are equal). The launches of each card run are counted from 0: a
    flash launch per attention layer, a decode launch per attention layer and
    step, an SSD launch per mamba layer."""
    for arch in SMOKE_ARCHS:
        ops.reset_launch_counts()
        card = serve(arch)
        counts = ops.launch_counts()
        cpu = serve(arch, device="cpu")
        v = get_smoke_config(arch).vocab_size
        err = rel_err(card["prefill_logits"][..., :v], cpu["prefill_logits"][..., :v])
        tf_err = rel_err(card["teacher_logits"][..., :v], cpu["teacher_logits"][..., :v])
        check(np.array_equal(card["prompt"], cpu["prompt"]), f"{arch}: prompts differ")
        same = float((card["tokens"] == cpu["tokens"]).mean())
        short = greedy_shortfall(arch, card, cpu["teacher_logits"])
        log(f"serve {arch} at its defaults (smoke config, f32, hd 16), card vs cpu: prefill "
            f"logits relative L2 {err:.3g} (tol {SMOKE_SERVE_TOL:g}), last teacher-forced "
            f"{tf_err:.3g} (tol {SERVE_AGREE_TOL:g}), greedy tokens equal in {same:.3f} of "
            f"places, card tokens' shortfall from the CPU's argmax {short:.3g} (tol "
            f"{SERVE_AGREE_TOL:g}), card {card['tokens'][0, :8].tolist()}, cpu "
            f"{cpu['tokens'][0, :8].tolist()}, launches {counts}")
        check(bool(torch.isfinite(card["prefill_logits"]).all()), f"{arch}: logits not finite")
        check(err <= SMOKE_SERVE_TOL, f"{arch}: card and CPU prefill logits disagree")
        check(tf_err <= SERVE_AGREE_TOL, f"{arch}: card and CPU teacher-forced logits disagree")
        check(short <= SERVE_AGREE_TOL, f"{arch}: a card token is not the CPU's greedy choice")
        check(same == 1.0 or short > 0, f"{arch}: tokens differ where the CPU agrees")
        family = get_smoke_config(arch).family
        if family == "ssm":
            check(counts["ssd_scan"] > 0 and counts["flash_attention"] == 0, f"{arch}: launches")
        else:
            steps = card["prompt"].shape[1] + card["tokens"].shape[1] - 1
            check(counts["flash_attention"] > 0
                  and counts["decode_attention"] == counts["flash_attention"] * steps
                  and (counts["ssd_scan"] > 0) == (family == "hybrid"),
                  f"{arch}: launches {counts}")


# ---------------------------------------------------------------------------
# Phase 5: the slices
# ---------------------------------------------------------------------------
# The pushdown requests: (arch, batch, COS batch, split, wire bytes, launches
# a request). A request extracts the split's prefix over batch / COS batch
# microbatches (a flash launch per block and microbatch, a quantize per
# microbatch) and evaluates the suffix on the whole batch (a flash launch per
# block, one dequantize).
PUSHDOWN = (
    (ARCH, 4, 2, 30, WIRE_BYTES,
     {"flash_attention": 30 * 2 + 10, "quantize_int8": 2, "dequantize_int8": 1}),
    (MOE_ARCH, 2, 1, 36, MOE_WIRE_BYTES,
     {"flash_attention": 36 * 2 + 12, "quantize_int8": 2, "dequantize_int8": 1}),
)


def serve_slice(arch: str, batch: int, cos_batch: int, split: int, wire_want: int,
                launches_want: dict) -> dict:
    """N_REQUESTS pushdown requests of ``batch`` x 4,096 tokens on ``arch``
    at full width and depth, planned with COS batch ``cos_batch``; returns
    the launches of each kernel."""
    cfg = get_config(arch)
    shape = ShapeConfig("slice", "train", seq_len=4096, global_batch=batch)
    plan = plan_tiers(cfg, shape, HapiConfig(compress_transfer=True, cos_batch=cos_batch,
                                             cos_batch_min=1))
    log(f"plan {arch}: split {plan.split} of {cfg.n_blocks} blocks, cos_batch "
        f"{plan.cos_batch}, compress {plan.compress}; {plan.decision.reason}")
    check((plan.split, plan.cos_batch, plan.compress) == (split, cos_batch, True),
          "unexpected plan")
    check(plan.decision.wire_bytes_per_iter == wire_want, "Alg. 1's wire bytes")
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"{arch}: {n_params} parameters in bf16, initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    frozen, trainable = lm.split_params(plan.split)
    extract, tune = make_extract_fn(plan), make_tune_loss_fn(plan)
    n_mb = batch // plan.cos_batch
    per_request = {"flash_attention": plan.split * n_mb + cfg.n_blocks - plan.split,
                   "quantize_int8": n_mb, "dequantize_int8": 1}
    check(per_request == launches_want, f"unexpected launches per request {per_request}")
    per_request = {k: per_request.get(k, 0) for k in KERNELS}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for r in range(N_REQUESTS):
        toks = torch.from_numpy(
            np.random.default_rng(100 + r).integers(0, cfg.vocab_size, (batch, 4096))).cuda()
        req = {"tokens": toks, "labels": toks}
        before = ops.launch_counts()
        t0 = time.perf_counter()
        acts = extract(frozen, req)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            loss = float(tune(trainable, acts, req))
        t2 = time.perf_counter()
        rose = {k: v - before[k] for k, v in ops.launch_counts().items()}
        wire = wire_bytes(acts)
        log(f"request {r} ({arch}): extract {1e3 * (t1 - t0):.1f} ms, tune "
            f"{1e3 * (t2 - t1):.1f} ms, wire {wire} bytes, loss {loss:.6f}, launches {rose}")
        check(acts[0].shape == (batch, 4096, cfg.d_model)
              and acts[1].shape == (batch, 4096, cfg.d_model // 128), "boundary shapes")
        check(wire == wire_want, f"wire bytes {wire} != {wire_want}")
        check(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 3.0,
              f"loss {loss} is not near ln(vocab)")
        check(rose == per_request, f"launches rose by {rose}, expected {per_request}")
    routes = dict(int8_transfer.quantize_routes)
    log(f"{arch}: peak device memory {torch.cuda.max_memory_allocated()} bytes; quantize "
        f"routes {routes}")
    check(routes == {"vector": N_REQUESTS * n_mb, "scalar": 0}, f"quantize routes {routes}")
    del lm, frozen, trainable, acts
    free()
    return ops.launch_counts()


def pushdown_requests() -> dict:
    total = dict.fromkeys(KERNELS, 0)
    for args in PUSHDOWN:
        for k, v in serve_slice(*args).items():
            total[k] += v
    return total


def serve_model(arch: str, capacity: Optional[float] = None) -> dict:
    """serve(arch) at full width, or for a cut model (SERVE_LAYERS) or
    another MoE capacity the same loop, generate(), on the model and prompts
    serve() would draw from seed 0 on the card; at another capacity only the
    prefill and the teacher-forced refill, no new tokens."""
    if arch not in SERVE_LAYERS and capacity is None:
        return serve(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, new_tokens=SERVE_TOKENS,
                     smoke=False, seed=0)
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS.get(arch, cfg.n_layers))
    new_tokens = SERVE_TOKENS
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
        new_tokens = 0
    gen = torch.Generator("cuda").manual_seed(0)
    model = build_model(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                           device="cuda")
    return generate(model, tokens, new_tokens)


def serve_models() -> tuple:
    """Each served model at full width (jamba cut to SERVE_LAYERS); returns
    the launches of each kernel summed over the calls, and each model's."""
    total = dict.fromkeys(KERNELS, 0)
    by_arch = {}
    for arch, want in SERVE_LAUNCHES.items():
        free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = serve_model(arch)
        wall = time.perf_counter() - t0
        counts = by_arch[arch] = ops.launch_counts()
        cfg = get_config(arch)
        v = cfg.vocab_size
        pre, tf = out["prefill_logits"][..., :v], out["teacher_logits"][..., :v]
        err = rel_err(tf, pre)
        agree = float((pre.argmax(-1) == tf.argmax(-1)).float().mean())
        blocks = SERVE_LAYERS.get(arch, cfg.n_layers) * cfg.n_blocks // cfg.n_layers
        log(f"serve {arch} (full width, {blocks} blocks, bf16, batch {SERVE_BATCH}, prompt "
            f"{SERVE_PROMPT}, {SERVE_TOKENS} new tokens): prefill {out['prefill_ms']:.1f} ms, "
            f"teacher-forced refill {out['teacher_ms']:.1f} ms "
            f"({out['teacher_ms'] / SERVE_PROMPT:.2f} ms/step), decode "
            f"{out['tok_per_s']:.1f} tok/s, peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes, wall {wall:.1f} s, launches {counts}")
        check(counts == {k: want.get(k, 0) for k in counts},
              f"{arch}: launches {counts}, expected {want}")
        check(bool(torch.isfinite(pre).all() and torch.isfinite(tf).all()),
              f"{arch}: logits not finite")
        check(out["tokens"].shape == (SERVE_BATCH, SERVE_TOKENS + 1), f"{arch}: token shape")
        what = "published capacity" if cfg.n_experts else "prefill"
        log(f"serve {arch}: {what} vs last teacher-forced logits relative L2 {err:.3g}"
            f"{'' if cfg.n_experts else f' (tol {CONSISTENCY_TOL[arch]:g})'}, max abs "
            f"{float((pre - tf).abs().max()):.3g}, argmax agreement {agree:.2f}; "
            f"tokens {out['tokens'][:, :8].tolist()}")
        for k in total:
            total[k] += counts[k]
        if cfg.n_experts:
            # No slot drops at capacity E / k: the prefill and the refill agree.
            del out, pre, tf
            free()
            out = serve_model(arch, capacity=cfg.n_experts / cfg.top_k)
            pre, tf = out["prefill_logits"][..., :v], out["teacher_logits"][..., :v]
            err = rel_err(tf, pre)
            agree = float((pre.argmax(-1) == tf.argmax(-1)).float().mean())
            log(f"serve {arch} at capacity {cfg.n_experts / cfg.top_k:g} (no drops): prefill "
                f"{out['prefill_ms']:.1f} ms, refill {out['teacher_ms']:.1f} ms; prefill vs "
                f"last teacher-forced logits relative L2 {err:.3g} (tol "
                f"{CONSISTENCY_TOL[arch]:g}), max abs {float((pre - tf).abs().max()):.3g}, "
                f"argmax agreement {agree:.2f}")
            check(bool(torch.isfinite(pre).all() and torch.isfinite(tf).all()),
                  f"{arch}: logits not finite")
        check(err <= CONSISTENCY_TOL[arch], f"{arch}: prefill and teacher-forced logits differ")
        del out, pre, tf
    free()
    return total, by_arch


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------
def _train_state(lm, rc: RunConfig, plan):
    state = init_train_state(lm, rc, plan)
    return state, build_hapi_train_step(lm, rc, plan)


class plain_ssd_backward:
    """Within the block, SSDScanFn's backward on the card runs the plain
    version, ref.ssd_chunked_bwd, on the card tensors instead of the kernel."""

    def __enter__(self):
        self.kernel = ssd_scan.ssd_scan_bwd_cuda
        ssd_scan.ssd_scan_bwd_cuda = (
            lambda x, dtA, dt, B_, C_, states, dy, dstate=None, *, chunk=256:
            ref.ssd_chunked_bwd(x, dtA, dt, B_, C_, dy, dstate, chunk=chunk, states=states))
        return self

    def __exit__(self, *exc):
        ssd_scan.ssd_scan_bwd_cuda = self.kernel


def check_full_width_training(arch: str = ARCH, seq: int = 128) -> None:
    """One Hapi train step of a 2-block full-width model in bf16 on the card
    (kernels) and on the CPU (plain versions), from the same weights: loss,
    gradient norm, first moment and the updates agree. For the SSM, the card
    step also runs with the plain SSD backward on the card, which isolates
    the backward kernel: the first moments agree to KERNEL_STEP_TOL."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    shape = ShapeConfig("agree", "train", seq_len=seq, global_batch=2)
    hapi = HapiConfig(compress_transfer=True, cos_batch=1, cos_batch_min=1)
    rc = RunConfig(model=cfg, shape=shape, hapi=hapi,
                   train=TrainConfig(microbatch=2, learning_rate=TRAIN_LR, warmup_steps=1,
                                     total_steps=5))
    plan = plan_tiers(cfg, shape, hapi)
    check((plan.split, plan.cos_batch) == (1, 1), f"2-block train plan {plan}")
    lm_gpu = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    lm_cpu = copy.deepcopy(lm_gpu).cpu()
    runs = [("cuda", lm_gpu), ("cpu", lm_cpu)]
    if cfg.family == "ssm":
        runs.append(("cuda, plain SSD backward", copy.deepcopy(lm_gpu)))
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, seq))
    out = {}
    for dev, lm in runs:
        t = torch.from_numpy(toks).to(dev.split(",")[0])
        state, step = _train_state(lm, rc, plan)
        before = {k: p.detach().float().cpu() for k, p in state.trainable.named_parameters()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if dev == "cuda":
            state, metrics = step(state, {"tokens": t, "labels": t})
        else:
            with plain_ssd_backward():
                state, metrics = step(state, {"tokens": t, "labels": t})
        loss = float(metrics["loss"])
        if dev == "cuda":
            # 2 chunks of one sample (COS batch 1), each one trainable block's backward.
            bwd = "ssd_scan_bwd" if cfg.family == "ssm" else "flash_attention_bwd"
            counts = ops.launch_counts()
            check(counts[bwd] == 2, f"{arch} train step on the card: launches {counts}")
        out[dev] = dict(loss=loss, gnorm=float(metrics["grad_norm"]),
                        m={k: x.float().cpu() for k, x in state.opt.m.items()},
                        delta={k: p.detach().float().cpu() - before[k]
                               for k, p in state.trainable.named_parameters()})
        log(f"full width train step, {arch} 2 blocks, batch 2 x {seq} on {dev}: loss {loss:.6f}, "
            f"grad norm {out[dev]['gnorm']:.6g} ({time.perf_counter() - t0:.1f} s)"
            f"{f', launches {counts}' if dev == 'cuda' else ''}")
        del state, step
    c, h = out["cuda"], out["cpu"]
    loss_diff = abs(c["loss"] - h["loss"])
    gn_err = abs(c["gnorm"] - h["gnorm"]) / h["gnorm"]
    errs = {k: rel_err(c["m"][k], h["m"][k]) for k in h["m"]}
    cancelling = {k: e for k, e in errs.items() if k.endswith(CANCELLING)}
    worst = max((k for k in errs if k not in cancelling), key=errs.get)
    signs = torch.cat([(torch.sign(c["delta"][k]) == torch.sign(h["delta"][k])).flatten()
                       for k in h["delta"]]).float().mean().item()
    log(f"full width train step agreement, {arch}, card vs cpu: |loss| {loss_diff:.3g} (tol "
        f"{LOSS_TOL:g}), grad norm relative {gn_err:.3g} (tol {SERVE_AGREE_TOL:g}), first "
        f"moment relative L2 (worst tensor, {worst}) {errs[worst]:.3g} (tol "
        f"{SERVE_AGREE_TOL:g}){f', cancelling {cancelling} (tol {CANCELLING_TOL:g})' if cancelling else ''}"
        f", update signs agree in {signs:.5f} of elements (at least {TRAIN_SIGN_AGREE:g})")
    check(math.isfinite(c["loss"]) and loss_diff <= LOSS_TOL, "train step: losses disagree")
    check(gn_err <= SERVE_AGREE_TOL, "train step: grad norms disagree")
    check(errs[worst] <= SERVE_AGREE_TOL, "train step: gradients disagree")
    check(all(e <= CANCELLING_TOL for e in cancelling.values()),
          f"train step: cancelling gradients disagree {cancelling}")
    check(signs >= TRAIN_SIGN_AGREE, "train step: updates disagree")
    if cfg.family == "ssm":
        pl = out["cuda, plain SSD backward"]
        kerrs = {k: rel_err(c["m"][k], pl["m"][k]) for k in pl["m"]}
        kworst = max(kerrs, key=kerrs.get)
        log(f"full width train step, {arch} on the card, SSD backward kernel vs its plain "
            f"version: loss {c['loss']:.6f} / {pl['loss']:.6f}, first moment relative L2 "
            f"(worst tensor, {kworst}) {kerrs[kworst]:.3g} (tol {KERNEL_STEP_TOL:g}); "
            f"{', '.join(cancelling)} bit-equal: "
            f"{all(torch.equal(c['m'][k], pl['m'][k]) for k in cancelling)}")
        check(c["loss"] == pl["loss"], "train step: the forward differs between the runs")
        check(kerrs[kworst] <= KERNEL_STEP_TOL, "train step: the SSD backward kernel disagrees "
              "with its plain version")
        check(all(torch.equal(c["m"][k], pl["m"][k]) for k in cancelling),
              "train step: a cancelling gradient depends on the SSD backward")
    del lm_gpu, lm_cpu, out, runs
    free()


class StepClock:
    """Wraps the train step's extract and AdamW (looked up in
    ``repro_torch.train.steps`` at each step) to time them, synchronised, and
    to count the wire bytes extract emits; tune is the rest of the step."""

    def __init__(self):
        self.extract_fn = train_steps.make_extract_fn
        self.adamw = train_steps.adamw_update
        self.reset()

    def reset(self):
        self.extract_s = self.adamw_s = 0.0
        self.wire = 0

    def _timed(self, fn, attr):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)
            if attr == "extract_s":
                self.wire += wire_bytes(out)
            return out
        return run

    def __enter__(self):
        train_steps.make_extract_fn = lambda plan: self._timed(self.extract_fn(plan),
                                                               "extract_s")
        train_steps.adamw_update = self._timed(self.adamw, "adamw_s")
        return self

    def __exit__(self, *exc):
        train_steps.make_extract_fn = self.extract_fn
        train_steps.adamw_update = self.adamw


def train_slice(arch: str = ARCH, layers: int = TRAIN_LAYERS, split: int = 6,
                wire_bytes_want: int = WIRE_BYTES, launches_want=None) -> dict:
    """The training main path at full width: mistral-nemo-12b cut to 8
    blocks (or ``arch`` at ``layers``, split ``split``), bf16, a batch of
    4 x 4,096; 4 fused-path steps on one repeated batch, then 1 coarse-path
    step. Returns the launches of each kernel."""
    launches_want = launches_want or TRAIN_LAUNCHES
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shape = ShapeConfig("train", "train", seq_len=4096, global_batch=4)
    hapi = HapiConfig(compress_transfer=True, cos_batch=2, cos_batch_min=1)
    tc = TrainConfig(microbatch=2, learning_rate=TRAIN_LR, warmup_steps=1, total_steps=5)
    rc = RunConfig(model=cfg, shape=shape, hapi=hapi, train=tc)
    plan = plan_tiers(cfg, shape, hapi)
    log(f"train plan: split {plan.split} of {cfg.n_blocks} blocks, cos_batch {plan.cos_batch}, "
        f"compress {plan.compress}; {plan.decision.reason}")
    check((plan.split, plan.cos_batch, plan.compress) == (split, 2, True),
          "unexpected train plan")
    family = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    for kind in ("fused", "coarse"):
        derived = train_launches(kind, cfg.n_blocks, plan.split, family, f"{family}_bwd")
        check(derived == launches_want[kind], f"{kind} launches {derived}, expected "
              f"{launches_want[kind]}")
    free()
    lm = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    state, step = _train_state(lm, rc, plan)
    n_train = sum(p.numel() for p in state.trainable.parameters())
    frozen0 = {k: v.cpu() for k, v in state.frozen.state_dict().items()}
    toks = torch.from_numpy(
        np.random.default_rng(200).integers(0, cfg.vocab_size, (4, 4096))).cuda()
    batch = {"tokens": toks, "labels": toks}
    log(f"{arch} at {layers} blocks: {n_train} trainable parameters ({layers - plan.split} "
        f"blocks, final_norm, head), {sum(v.numel() for v in frozen0.values())} frozen")
    losses, peaks = [], []
    total = dict.fromkeys(KERNELS, 0)
    ops.reset_launch_counts()
    with StepClock() as clock:
        for i, kind in enumerate(["fused"] * TRAIN_FUSED_STEPS + ["coarse"]):
            if kind == "coarse":
                rc = rc.replace(train=dataclasses.replace(tc, microbatch=1))
                step = build_hapi_train_step(lm, rc, plan)
            clock.reset()
            before = ops.launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            step_s = time.perf_counter() - t0
            rose = {k: v - before[k] for k, v in ops.launch_counts().items()}
            want = {k: launches_want[kind].get(k, 0) for k in rose}
            log(f"train step {i + 1} ({kind}): {1e3 * step_s:.1f} ms (extract "
                f"{1e3 * clock.extract_s:.1f}, tune forward+backward "
                f"{1e3 * (step_s - clock.extract_s - clock.adamw_s):.1f}, AdamW "
                f"{1e3 * clock.adamw_s:.1f}), {arch}, loss {loss:.6f}, grad norm "
                f"{float(metrics['grad_norm']):.4g}, lr {float(metrics['lr']):.3g}, wire "
                f"{clock.wire} bytes, peak device memory {torch.cuda.max_memory_allocated()} "
                f"bytes, launches {rose}")
            peaks.append(torch.cuda.max_memory_allocated())
            check(math.isfinite(loss), f"train step {i + 1}: loss {loss}")
            check(clock.wire == wire_bytes_want, f"train step {i + 1}: wire {clock.wire}")
            check(rose == want, f"train step {i + 1}: launches {rose}, expected {want}")
            losses.append(loss)
    check(losses[TRAIN_FUSED_STEPS - 1] < losses[0], f"loss did not fall: {losses}")
    check(int(state.opt.step) == TRAIN_FUSED_STEPS + 1, "optimizer step count")
    same = all(torch.equal(v.cpu(), frozen0[k]) for k, v in state.frozen.state_dict().items())
    log(f"train {arch}: losses {[round(x, 6) for x in losses]}; peak device memory over "
        f"the steps {max(peaks)} bytes; frozen prefix unchanged bit for bit: {same}")
    check(same, "the frozen prefix changed")
    for k, v in ops.launch_counts().items():
        total[k] += v
    del lm, state, step, frozen0, batch
    free()
    return total


def train_defaults() -> None:
    """tests/test_e2e_smoke.py's three scenarios through run_training on the
    card (the smoke configs: f32, head dim 16); and mamba2, whose suffix
    trains through the SSD backward kernel: the loss falls."""
    out = run_training("qwen3-32b", steps=12, batch=8, seq=32, lr=1e-3, log_every=100)
    first, last = np.mean(out["losses"][:3]), np.mean(out["losses"][-3:])
    log(f"run_training qwen3-32b on the card: losses {[round(x, 4) for x in out['losses']]}")
    check(np.isfinite(out["final_loss"]) and last < first, "qwen3-32b: loss did not fall")
    kw = dict(steps=10, batch=4, seq=32, lr=1e-3, log_every=100)
    ref_run = run_training("gemma2-9b", ckpt_dir="", **kw)
    with tempfile.TemporaryDirectory() as d:
        run_training("gemma2-9b", ckpt_dir=d, ckpt_every=3, kill_at=6, **kw)
        resumed = run_training("gemma2-9b", ckpt_dir=d, ckpt_every=3, **kw)
    gap = abs(resumed["final_loss"] - ref_run["final_loss"])
    log(f"run_training gemma2-9b on the card: crash at 6, resume from step 6: final loss "
        f"{resumed['final_loss']:.6f} against {ref_run['final_loss']:.6f} uninterrupted "
        f"(|gap| {gap:.3g}, tol 0.2)")
    check(gap < 0.2, "gemma2-9b: the resumed run diverged")
    out = run_training("mistral-nemo-12b", steps=8, batch=8, seq=32, compress=True, lr=1e-3,
                       log_every=100)
    log(f"run_training mistral-nemo-12b (int8 boundary) on the card: losses "
        f"{[round(x, 4) for x in out['losses']]}")
    check(np.isfinite(out["final_loss"]) and out["losses"][-1] < out["losses"][0] + 0.05,
          "mistral-nemo-12b: the compressed boundary did not train")
    ops.reset_launch_counts()
    out = run_training("mamba2-1.3b", steps=12, batch=8, seq=32, lr=1e-3, log_every=100)
    counts = ops.launch_counts()
    first, last = np.mean(out["losses"][:3]), np.mean(out["losses"][-3:])
    log(f"run_training mamba2-1.3b on the card: losses {[round(x, 4) for x in out['losses']]}, "
        f"launches {counts}")
    check(np.isfinite(out["final_loss"]) and last < first, "mamba2-1.3b: loss did not fall")
    check(counts["ssd_scan_bwd"] > 0 and counts["ssd_scan"] > counts["ssd_scan_bwd"],
          f"mamba2-1.3b: launches {counts}")
    free()


# ---------------------------------------------------------------------------
# Phase 7: the paper's vision workload
# ---------------------------------------------------------------------------
def vision_plan(vm, name: str):
    """profile_layered -> Alg. 1 (compress_transfer, train batch 1,000) ->
    Eq. 4 against the card's memory -> (profile, decision, COS batch)."""
    hapi = HapiConfig(compress_transfer=True)
    prof = profile_layered(vm)
    dec = choose_split(prof, hapi, VISION_TRAIN_BATCH)
    split = dec.split_index
    check(0 < split <= vm.freeze_index, f"{name}: split {split}")
    req = AdaptRequest(req_id=0, mem_per_sample=prof.act_peak_bytes[split] * (1 + prof.headroom),
                       mem_model=prof.prefix_param_bytes[split],
                       b_max=min(VISION_OBJECT, hapi.cos_batch))
    res = adapt_batches([req], hapi.cos_hbm_budget, b_min=hapi.cos_batch_min)
    cos_batch = largest_divisor_leq(VISION_OBJECT, res.assignments[0].batch)
    return prof, dec, cos_batch


def vision_card_vs_cpu(name: str, vm, split: int) -> None:
    cpu = PAPER_MODELS[name](device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (2, 224, 224, 3), dtype=np.float32))
    for hi in (split, len(vm.layer_names)):
        with torch.no_grad():
            got = vm.apply_range(x.cuda(), 0, hi)
            want = cpu.apply_range(x, 0, hi)
        err = rel_err(got, want)
        log(f"vision {name} card vs CPU at boundary {hi} {tuple(got.shape)}: relative L2 "
            f"{err:.3g} (tol {VISION_TOL:g}), max abs {float((got.cpu() - want).abs().max()):.3g}")
        check(bool(torch.isfinite(got).all()) and err <= VISION_TOL,
              f"{name}: card and CPU disagree at boundary {hi}")
    del cpu


def vision_layer_ms(name: str, vm, images: np.ndarray, cos_batch: int, smi: str) -> None:
    """Each layer's time on a COS-batch microbatch (the paper's Fig. 3), from
    CUDA events around 5 eager calls."""
    x = torch.from_numpy(images[:cos_batch]).cuda()
    parts = []
    with torch.no_grad():
        for i, lname in enumerate(vm.layer_names):
            ms = time_ms(lambda: vm.apply_range(x, i, i + 1), 5)
            parts.append(f"{lname} {ms:.4f}")
            x = vm.apply_range(x, i, i + 1)
    log(f"vision {name} per-layer ms at COS batch {cos_batch} ({smi}): "
        + ", ".join(parts))


def vision_kernel_ms(name: str, vm, images: np.ndarray, split: int, cos_batch: int,
                     smi: str) -> Optional[dict]:
    """The kernels at the executor's shapes: quantize on one COS-batch
    microbatch's float32 boundary, held bit for bit to the plain version and
    timed by CUDA-graph replay beside its bound; for the ViT, flash attention
    at one block's shape (f32, non-causal) on the split-TF32 route, held to
    the plain version and timed beside its bound (the larger of the bytes
    and the three TF32 products the route issues at the TF32 peak), the
    bound of the same f32 operations on the CUDA cores and SDPA on the same
    inputs (returned as its row of the kernels line); and the microbatch's
    copies between host and card, by CUDA events."""
    with torch.no_grad():
        mb = images[:cos_batch]
        x = vm.apply_range(torch.from_numpy(mb).cuda(), 0, split).contiguous()
        route = int8_exact(x, f"vision {name} {tuple(x.shape)}")
        check(route == "vector", f"vision {name}: quantize took the {route} route")
        n = x.numel()
        scales = n // math.gcd(x.shape[-1], 128)
        qb, qby = bound(n * (4 + 1) + scales * 4, 5 * n, HW.peak_flops_f32)
        ms = device_ms(lambda: quantize_int8_cuda(x), 20)
        log(f"vision {name}: quantize_int8 on {tuple(x.shape)} float32 ({route} route, q, "
            f"scales and dequantize bit-exact with the plain versions): {ms:.4f} ms, bound "
            f"{qb:.4f} ms ({qby}); {smi}")
        q, _ = quantize_int8_cuda(x)
        h2d = time_ms(lambda: torch.from_numpy(mb).cuda(), 5)
        d2h = time_ms(lambda: q.cpu(), 5)
        log(f"vision {name}: host to card {mb.nbytes} bytes (pageable numpy) {h2d:.4f} ms, "
            f"card to host {q.numel()} int8 codes {d2h:.4f} ms, a microbatch of {cos_batch}; "
            f"{smi}")
        first = next((i for i, layer in enumerate(vm.layers) if isinstance(layer, EncoderBlock)),
                     None)
        if first is None:
            return None
        block = vm.layers[first]
        b, s, d = vm.apply_range(torch.from_numpy(mb).cuda(), 0, first).shape
        hd = d // block.heads
        q, k, v = (randn((b, s, block.heads, hd), torch.float32, seed=40 + i) for i in range(3))
        flops = 4 * hd * b * block.heads * s * s
        nbytes = 4 * b * s * d * 4
        fb, fby = bound(nbytes, 3 * flops, HW.peak_flops_tf32)
        fma_ms = bound(nbytes, flops, HW.peak_flops_f32)[0]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        route = kernel_route(hd, q.dtype)
        before = flash.fwd_routes["3xtf32"]
        out = flash_attention_cuda(q, k, v, causal=False)
        check(route == "3xtf32" and flash.fwd_routes["3xtf32"] == before + 1,
              f"vision {name}: flash at hd {hd} f32 did not take the 3xtf32 route")
        exp = ref.flash_attention(q, k, v, causal=False)
        torch.testing.assert_close(out, exp, atol=F32_TOL, rtol=F32_TOL)
        row = dict(max_abs_err=float((out - exp).abs().max()),
                   ms=device_ms(lambda: flash_attention_cuda(q, k, v, causal=False), 20),
                   plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, causal=False), 3, 1),
                   bound_ms=fb, bound_by=fby, library_ms=device_ms(lambda: sdpa(qt, kt, vt), 20))
        log(f"vision {name}: flash_attention on ({b}, {s}, {block.heads}, {hd}) float32 "
            f"non-causal, route {route}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {fb:.4f} ms ({fby}; {nbytes / 1e6:.1f} MB, 3 x {flops / 1e9:.2f} GFLOP of "
            f"TF32 products at {HW.peak_flops_tf32 / 1e12:.0f} TFLOP/s), f32 CUDA-core bound "
            f"{fma_ms:.4f} ms (at {HW.peak_flops_f32 / 1e12:.0f} TFLOP/s), "
            f"scaled_dot_product_attention "
            f"{row['library_ms']:.4f} ms, max abs err {row['max_abs_err']:.3g} (tol "
            f"{F32_TOL:g}); {smi}")
        return row


def vision(smi: str) -> tuple:
    """Each paper model at full width: card vs CPU, the plan, then requests of
    one 1,000-image object through make_vision_executor on the card with the
    counts read around each (the ViT's flash launches all on the split-TF32
    route); returns the launches of each kernel and the ViT's flash row."""
    images = np.random.default_rng(30).standard_normal(
        (VISION_OBJECT, 224, 224, 3), dtype=np.float32)
    store = ObjectStore()
    (oname,) = store.put_dataset("images", {"x": images}, object_size=VISION_OBJECT)
    total = dict.fromkeys(KERNELS, 0)
    vit_row = None
    for name, build in PAPER_MODELS.items():
        free()
        vm = build(device="cuda", generator=torch.Generator().manual_seed(0))
        prof, dec, cos_batch = vision_plan(vm, name)
        split = dec.split_index
        log(f"vision {name}: {len(vm.layer_names)} layers, freeze {vm.freeze_index}, "
            f"{prof.model_param_bytes:.0f} weight bytes; split {split} "
            f"{tuple(vm.layer_names[:split][-1:])}, cos_batch {cos_batch}; {dec.reason}")
        vision_card_vs_cpu(name, vm, split)

        obj, _ = store.read(oname, 0.0)
        check(obj.n_samples == VISION_OBJECT and np.array_equal(obj.payload["x"], images),
              "the object store's read")
        execute = make_vision_executor(vm, compress=True)
        n_mb = -(-VISION_OBJECT // cos_batch)
        blocks = sum(isinstance(layer, EncoderBlock) for layer in list(vm.layers)[:split])
        want = dict.fromkeys(KERNELS, 0)
        want.update(quantize_int8=n_mb, flash_attention=blocks * n_mb)
        ops.reset_launch_counts()
        tf32_before = flash.fwd_routes["3xtf32"]
        for r in range(VISION_REQUESTS):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q, scales = execute(obj.payload, split, cos_batch)
            wall = time.perf_counter() - t0
            rose = {k: v - before[k] for k, v in ops.launch_counts().items()}
            d = q.shape[-1]
            rows = q.size // d
            want_wire = rows * d + rows * (d // math.gcd(d, 128)) * 4
            wire = q.nbytes + scales.nbytes
            log(f"vision {name} request {r}: {VISION_OBJECT} images in {1e3 * wall:.1f} ms "
                f"({VISION_OBJECT / wall:.1f} images/s; {smi}), boundary {q.shape} int8, "
                f"wire {wire} bytes measured, int8 formula {want_wire}, Alg. 1 predicted "
                f"{dec.wire_bytes_per_iter:.0f}; launches {rose}")
            check(rose == want, f"{name}: launches {rose}, expected {want}")
            check(wire == want_wire, f"{name}: wire {wire} != {want_wire}")
        tf32 = flash.fwd_routes["3xtf32"] - tf32_before
        check(tf32 == VISION_REQUESTS * want["flash_attention"],
              f"{name}: {tf32} flash launches on the 3xtf32 route, expected "
              f"{VISION_REQUESTS * want['flash_attention']}")
        for k, v in ops.launch_counts().items():
            total[k] += v
        # The wire against the float32 boundary of the same object.
        acts = make_vision_executor(vm, compress=False)(obj.payload, split, cos_batch)
        deq = dequantize_int8_cuda(torch.from_numpy(q).cuda(), torch.from_numpy(scales).cuda(),
                                   torch.float32).cpu().numpy()
        step = np.repeat(scales, d // scales.shape[-1], axis=-1)
        err = np.abs(deq - acts)
        log(f"vision {name}: dequantized wire vs float32 boundary max abs {float(err.max()):.3g}, "
            f"at most {float((err / step).max()):.4f} of a code step (half a step plus the "
            "card's rounding allowed)")
        check(bool(np.isfinite(acts).all()) and bool((err <= 0.5 * step * (1 + 1e-5)
                                                       + 1e-6 * np.abs(acts)).all()),
              f"{name}: the int8 wire is off the float32 boundary")
        row = vision_kernel_ms(name, vm, images, split, cos_batch, smi)
        if row is not None:
            vit_row = row
        if name in VISION_FIG3:
            vision_layer_ms(name, vm, images, cos_batch, smi)
        del vm, execute, acts, deq, q, scales
    free()
    return total, vit_row


# ---------------------------------------------------------------------------
# Phase 8: an epoch through the port's HAPI runtime
# ---------------------------------------------------------------------------
def suffix_loss(vm, q: np.ndarray, scales: np.ndarray, y: np.ndarray, split: int) -> float:
    """The compute tier: one response's wire to the card, dequantized by the
    kernel, the suffix [split, end) forward in chunks and the mean loss,
    without gradients."""
    with torch.no_grad():
        x = ops.dequantize_int8(torch.from_numpy(q).cuda(), torch.from_numpy(scales).cuda(),
                                torch.float32)
        y = torch.from_numpy(y).cuda()
        n_layers = len(vm.layer_names)
        loss = sum(torch.nn.functional.cross_entropy(
            vm.apply_range(x[i:i + EPOCH_SUFFIX_CHUNK], split, n_layers),
            y[i:i + EPOCH_SUFFIX_CHUNK], reduction="sum")
            for i in range(0, len(x), EPOCH_SUFFIX_CHUNK)) / len(x)
    return float(loss)


def same_response(got: tuple, direct: tuple, what: str) -> int:
    """``got`` against a direct executor call's ``direct``: bit-equal, or
    codes within one step with scales to rtol 1e-6 (the card may round a
    value on a code's edge either way between two calls). Returns the
    largest code step apart."""
    (q, scales), (qd, sd) = got, direct
    if np.array_equal(q, qd) and np.array_equal(scales, sd):
        return 0
    worst = int(np.abs(q.astype(np.int32) - qd.astype(np.int32)).max())
    check(worst <= 1 and np.allclose(scales, sd, rtol=1e-6, atol=0),
          f"{what}: the response is not a direct call's ({worst} code steps)")
    return worst


def int8_wire(q: np.ndarray) -> int:
    """Bytes of the int8 wire for codes ``q``: the codes and one f32 scale
    a row and lane tile of gcd(D, 128)."""
    d = q.shape[-1]
    rows = q.size // d
    return rows * d + rows * (d // math.gcd(d, 128)) * 4


def epoch_model(name: str, images: np.ndarray, labels: np.ndarray, smi: str) -> dict:
    """One epoch of ``name`` through HapiClient -> HapiServer ->
    make_vision_executor on the card -> wire -> the driver's train_fn, which
    dequantizes each response on the card and runs the suffix to a loss
    without gradients; checks order, wire and launches, and returns the
    launches of the epoch."""
    vm = PAPER_MODELS[name](device="cuda", generator=torch.Generator().manual_seed(0))
    prof = profile_layered(vm)
    sim = Simulator(seed=0)
    store = ObjectStore().attach_sim(sim)
    names = store.put_dataset("imagenet", {"x": images, "y": labels},
                              object_size=VISION_OBJECT)
    for oname in names:
        store.objects[oname].nbytes = store.objects[oname].n_samples * EPOCH_IMG_BYTES
    server = HapiServer(store, n_accelerators=1, sim=sim)
    execute = make_vision_executor(vm, compress=True)
    calls = []                  # (cos_batch, card wall s) of each executor call

    def timed(payload, split, cos_batch):
        t0 = time.perf_counter()
        out = execute(payload, split, cos_batch)
        calls.append((cos_batch, time.perf_counter() - t0))
        return out

    server.register_executor(name, timed)
    received, losses = [], []

    def train_fn(acts):
        for q, scales in acts:
            y = store.objects[names[len(received)]].payload["y"]
            received.append((q, scales))
            losses.append(suffix_loss(vm, q, scales, y, split))

    hapi = HapiConfig(compress_transfer=True)
    client = HapiClient(server, Link(name="wan0", bandwidth=hapi.network_bandwidth),
                        prof, hapi, name, train_fn=train_fn)
    split = client.choose_split_for(EPOCH_TRAIN_BATCH).split_index
    ops.reset_launch_counts()
    tf32_before = flash.fwd_routes["3xtf32"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = client.run_epoch("imagenet", EPOCH_TRAIN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = ops.launch_counts()
    tf32 = flash.fwd_routes["3xtf32"] - tf32_before
    base = BaselineClient(store, Link(name="wan0-base", bandwidth=hapi.network_bandwidth),
                          prof).run_epoch("imagenet", EPOCH_TRAIN_BATCH)

    batches = [[a.batch for a in r.assignments] for r in server.adapt_results]
    reissued = sum(it.reissued for it in res.iterations)
    n_obj = len(names)
    log(f"epoch {name}: split {split} {tuple(vm.layer_names[split - 1:split])}, "
        f"{res.n_iterations} iterations of {EPOCH_TRAIN_BATCH}, COS batches by round "
        f"{batches}, {reissued} re-issued; {n_obj * VISION_OBJECT} images in "
        f"{1e3 * wall:.1f} ms ({1e3 * wall / n_obj:.1f} ms an object, "
        f"{n_obj * VISION_OBJECT / wall:.1f} images/s; {smi}); virtual epoch "
        f"{res.execution_time!r} s, baseline (raw objects, whole model on the client) "
        f"{base.execution_time!r} s; wire {res.total_wire_bytes:.0f} bytes "
        f"(baseline {base.total_wire_bytes:.0f}); losses {[round(x, 4) for x in losses]}")
    check(not res.oom and res.n_iterations == n_obj * VISION_OBJECT // EPOCH_TRAIN_BATCH,
          f"{name}: epoch {res}")
    check(len(calls) == sum(len(b) for b in batches) == n_obj + reissued,
          f"{name}: {len(calls)} executor calls for rounds {batches}")
    check([b for b, _ in calls] == [b for r in batches for b in r],
          f"{name}: the executor's COS batches differ from Eq. 4's")
    # What the simulator charged each request (compute and model load) beside
    # the card's wall time of its executor call, in execution order.
    spans = sim.tracer.by_name("cos.compute")
    loads = sim.tracer.by_name("model.load")
    check(len(spans) == len(loads) == len(calls), f"{name}: {len(spans)} compute spans")
    log(f"epoch {name} per request, charged compute + load s (virtual) / card wall s: "
        + ", ".join(f"{c.duration:.6g} + {ld.duration:.6g} / {w:.6g}"
                    for c, ld, (_, w) in zip(spans, loads, calls)))

    # Order and content: the i-th response is object i's, equal to a direct
    # executor call on it (run after the counts were read).
    check(len(received) == n_obj and len(losses) == n_obj
          and all(np.isfinite(losses)), f"{name}: train_fn saw {len(received)} responses")
    worst = max(same_response(got_r, execute(store.objects[oname].payload, split, cos_batch),
                              f"{name}: {oname}")
                for oname, got_r, (cos_batch, _) in zip(names, received, calls))
    exact = worst == 0
    want_wire = int8_wire(received[0][0])
    wires = [q.nbytes + s.nbytes for q, s in received]
    check(wires == [want_wire] * n_obj and res.total_wire_bytes == sum(wires),
          f"{name}: wire {wires}, total {res.total_wire_bytes}, int8 formula {want_wire}")
    log(f"epoch {name}: responses in object order, "
        + ("bit-equal to direct executor calls" if exact
           else f"within {worst} code step of direct executor calls")
        + f"; wire {want_wire} bytes a response = the int8 formula, total "
          f"{res.total_wire_bytes:.0f}")

    mbs = sum(-(-VISION_OBJECT // b) for b, _ in calls)
    blocks = [isinstance(layer, EncoderBlock) for layer in vm.layers]
    suffix_calls = n_obj * -(-VISION_OBJECT // EPOCH_SUFFIX_CHUNK)
    want = dict.fromkeys(KERNELS, 0)
    want.update(quantize_int8=mbs, dequantize_int8=n_obj,
                flash_attention=sum(blocks[:split]) * mbs + sum(blocks[split:]) * suffix_calls)
    log(f"epoch {name}: launches {got}, expected {want}, flash on the 3xtf32 route {tf32}")
    check(got == want and tf32 == want["flash_attention"],
          f"{name}: launches {got} (3xtf32 {tf32}), expected {want}")
    return got


def epoch(smi: str) -> tuple:
    """The four paper models, each an epoch of 4,000 seeded images (made on
    the card, one array for all four) through the port's runtime; returns the
    launches of each kernel over the four epochs, and the images and labels."""
    free()
    n = EPOCH_OBJECTS * VISION_OBJECT
    g = torch.Generator(device="cuda").manual_seed(33)
    images = torch.randn((n, 224, 224, 3), generator=g, device="cuda").cpu().numpy()
    labels = torch.randint(0, 1000, (n,), generator=g, device="cuda",
                           dtype=torch.int64).cpu().numpy()
    total = dict.fromkeys(KERNELS, 0)
    for name in PAPER_MODELS:
        free()
        for k, v in epoch_model(name, images, labels, smi).items():
            total[k] += v
    free()
    return total, images, labels


# ---------------------------------------------------------------------------
# Phase 9: two replicas serving two tenants over a shared trunk
# ---------------------------------------------------------------------------
def fleet_cluster(images: np.ndarray, labels: np.ndarray, executors: dict,
                  train_fns: dict) -> tuple:
    """The port's HapiCluster: two HapiServer replicas of one accelerator at
    the H100's figures on one 1 Gbps trunk, the epoch's objects (charged 110
    KB an image on the wire), ``executors`` registered fleet-wide, and one
    tenant a model (``compress_transfer``, each with its ``train_fn``).
    Returns the cluster and the tenants' handles."""
    c = (HapiCluster(seed=0).with_servers(2, n_accelerators=1)
         .with_network(NetworkSpec(trunk_bandwidth=1e9 / 8))
         .with_dataset("imagenet", {"x": images, "y": labels}, object_size=VISION_OBJECT))
    for name, fn in executors.items():
        c.with_executor(name, fn)
    for obj in c.store.objects.values():
        obj.nbytes = obj.n_samples * EPOCH_IMG_BYTES
    hapi = HapiConfig(compress_transfer=True)
    handles = [c.tenant(TenantSpec(model=name, hapi=hapi, train_fn=train_fns[name]))
               for name in FLEET_MODELS]
    return c, handles


def fleet(smi: str, images: np.ndarray, labels: np.ndarray) -> dict:
    """Tenant 0 (AlexNet) and tenant 1 (the ViT) run their epochs of the
    epoch phase's 4,000 images concurrently (``run_epochs``) against two
    replicas that serve through make_vision_executor on the card; each
    tenant's train_fn dequantizes each response and runs its suffix to a
    loss. Checks the epochs, Eq. 4's COS batches, object order, the wire and
    the launches, then reruns the same cluster with executors that return
    the recorded responses: its event log must equal the live run's, so no
    card time reaches the virtual clock. Then the serving driver's fleet
    entry points. Returns the launches of the live run."""
    free()
    models = {name: PAPER_MODELS[name](device="cuda", generator=torch.Generator().manual_seed(0))
              for name in FLEET_MODELS}
    direct = {name: make_vision_executor(vm, compress=True) for name, vm in models.items()}
    # (model, split, cos_batch, card wall s, response, object's images) in call order
    calls = []

    def timed(name):
        def run(payload, split, cos_batch):
            t0 = time.perf_counter()
            out = direct[name](payload, split, cos_batch)
            calls.append((name, split, cos_batch, time.perf_counter() - t0, out, payload["x"]))
            return out
        return run

    received = {name: [] for name in FLEET_MODELS}
    losses = {name: [] for name in FLEET_MODELS}
    handles = {}

    def train_fn(name):
        def run(acts):
            split = handles[name].client.decision.split_index
            for q, scales in acts:
                y = labels[len(received[name]) * VISION_OBJECT:][:VISION_OBJECT]
                received[name].append((q, scales))
                losses[name].append(suffix_loss(models[name], q, scales, y, split))
        return run

    c, hs = fleet_cluster(images, labels, {n: timed(n) for n in FLEET_MODELS},
                          {n: train_fn(n) for n in FLEET_MODELS})
    handles.update(zip(FLEET_MODELS, hs))
    names = c.store.object_names("imagenet")
    ops.reset_launch_counts()
    tf32_before = flash.fwd_routes["3xtf32"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = c.run_epochs([(h, "imagenet", EPOCH_TRAIN_BATCH) for h in hs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = ops.launch_counts()
    tf32 = flash.fwd_routes["3xtf32"] - tf32_before

    n_obj = len(names)
    report = c.report()
    log(f"fleet: 2 replicas, 1 Gbps trunk, tenants {list(FLEET_MODELS)}; served by replica "
        f"{report.served_by_server}, makespan {report.makespan!r} s (virtual), "
        f"{report.reissued} re-issued; both epochs {2 * n_obj * VISION_OBJECT} images in "
        f"{1e3 * wall:.1f} ms ({2 * n_obj * VISION_OBJECT / wall:.1f} images/s; {smi})")
    for name, h, res in zip(FLEET_MODELS, hs, results):
        bw = h.client.observed_bw
        log(f"fleet tenant {h.tenant_id} ({name}): split {res.split}, re-splits "
            f"{res.resplits}, {res.n_iterations} iterations, virtual job time "
            f"{res.execution_time!r} s, observed_bw EWMA "
            f"{'none' if bw is None else f'{bw:.6g} B/s'}, wire {res.total_wire_bytes:.0f} "
            f"bytes, losses {[round(x, 4) for x in losses[name]]}")
        check(not res.oom and res.n_iterations == n_obj * VISION_OBJECT // EPOCH_TRAIN_BATCH,
              f"fleet {name}: epoch {res}")
    check(len(set(report.served_by_server)) == 2 and all(report.served_by_server.values()),
          f"fleet: both replicas must serve, {report.served_by_server}")

    # Eq. 4's COS batch of each request, against the executor's calls: the
    # compute spans run in call order, each under its request's root span.
    assigned = {}
    for r in c.fleet.adapt_results:
        for a in r.assignments:
            check(a.req_id not in assigned, f"fleet: request {a.req_id} assigned twice")
            assigned[a.req_id] = a.batch
    by_span = {req.span_id: req for req in c.fleet._req_by_id.values()}
    spans = c.tracer.by_name("cos.compute")
    loads = {sp.parent_id: sp for sp in c.tracer.by_name("model.load")}
    check(len(spans) == len(calls), f"fleet: {len(spans)} compute spans, {len(calls)} calls")
    for sp, (name, split, cos_batch, *_) in zip(spans, calls):
        req = by_span[sp.parent_id]
        labels_of = dict(sp.labels)
        check((req.model_key, req.split, assigned[req.req_id]) == (name, split, cos_batch)
              and labels_of["batch"] == str(cos_batch),
              f"fleet: call ({name}, {split}, {cos_batch}) against request {req.req_id} "
              f"({req.model_key}, {req.split}), Eq. 4's batch {assigned[req.req_id]}")
    log(f"fleet per call, model: charged compute + load s (virtual) / card wall s: "
        + ", ".join(f"{name} {sp.duration:.6g} + "
                    f"{loads[sp.parent_id].duration if sp.parent_id in loads else 0.0:.6g} "
                    f"/ {w:.6g}" for sp, (name, _, _, w, *_) in zip(spans, calls)))

    # Each tenant's responses: in object order, each a direct call's on its
    # object at the split and COS batch of the call that served it, the int8
    # wire.
    worst = 0
    for name, h, res in zip(FLEET_MODELS, hs, results):
        got_r = received[name]
        check(len(got_r) == n_obj and len(losses[name]) == n_obj
              and all(np.isfinite(losses[name])), f"fleet {name}: {len(got_r)} responses")
        for oname, resp in zip(names, got_r):
            payload = c.store.objects[oname].payload
            split, cos_batch = next((sp, b) for n, sp, b, _, _, x in calls
                                    if n == name and x is payload["x"])
            worst = max(worst, same_response(resp, direct[name](payload, split, cos_batch),
                                             f"fleet {name}: {oname}"))
        wire = int8_wire(got_r[0][0])
        wires = [q.nbytes + sc.nbytes for q, sc in got_r]
        check(wires == [wire] * n_obj and res.total_wire_bytes == sum(wires),
              f"fleet {name}: wire {wires}, int8 formula {wire}")
    log("fleet: each tenant's responses in object order, "
        + ("bit-equal to direct executor calls" if worst == 0
           else f"within {worst} code step of direct executor calls")
        + "; each wire = the int8 formula")

    # Launches: quantize once a microbatch, dequantize once a response, flash
    # on the ViT's prefix blocks a microbatch and suffix blocks a chunk.
    want = dict.fromkeys(KERNELS, 0)
    want["quantize_int8"] = sum(-(-VISION_OBJECT // b) for _, _, b, *_ in calls)
    want["dequantize_int8"] = sum(len(v) for v in received.values())
    for name, res in zip(FLEET_MODELS, results):
        blocks = [isinstance(layer, EncoderBlock) for layer in models[name].layers]
        mbs = sum(-(-VISION_OBJECT // b) for n, _, b, *_ in calls if n == name)
        want["flash_attention"] += (sum(blocks[:res.split]) * mbs + sum(blocks[res.split:])
                                    * len(received[name]) * -(-VISION_OBJECT
                                                               // EPOCH_SUFFIX_CHUNK))
    log(f"fleet: launches {got}, expected {want}, flash on the 3xtf32 route {tf32}")
    check(got == want and tf32 == want["flash_attention"] > 0,
          f"fleet: launches {got} (3xtf32 {tf32}), expected {want}")

    # The same cluster with the recorded responses in place of the card.
    recorded = {name: [out for n, _, _, _, out, _ in calls if n == name]
                for name in FLEET_MODELS}

    def replay(name):
        def run(payload, split, cos_batch):
            return recorded[name].pop(0)
        return run

    c2, hs2 = fleet_cluster(images, labels, {n: replay(n) for n in FLEET_MODELS},
                            dict.fromkeys(FLEET_MODELS, lambda acts: None))
    results2 = c2.run_epochs([(h, "imagenet", EPOCH_TRAIN_BATCH) for h in hs2])
    check(c2.event_digest() == c.event_digest()
          and [r.execution_time for r in results2] == [r.execution_time for r in results]
          and not any(recorded.values()),
          "fleet: the rerun on recorded responses logs another run: card time leaked into "
          "virtual time")
    log(f"fleet: the rerun on the recorded responses gives the same event log "
        f"({len(c.event_digest())} events) and job times")
    del c, c2, models, direct, calls, recorded
    free()

    # The serving driver's fleet half, on the host.
    with tempfile.TemporaryDirectory() as tmp:
        trace = str(Path(tmp) / "fleet.jsonl")
        for argv in (["--cos-fleet", "2", "--tenants", "3"],
                     ["--cos-fleet", "2", "--tenants", "3", "--network-trunk", "1.0"],
                     ["--cos-fleet", "2", "--tenants", "3", "--record", trace],
                     ["--replay", trace]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                serve_main(argv)
            text = out.getvalue()
            log(f"serve {' '.join(argv).replace(tmp, '$TMP')}: "
                + " | ".join(text.strip().splitlines()).replace(tmp, "$TMP"))
            check(("replayed 24 requests" if argv[0] == "--replay" else
                   "3 tenants:" if "--network-trunk" in argv else "served 24 POSTs") in text,
                  f"serve {argv}: {text!r}")
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = environment()
    log(f"build: {_build.build():.1f} s ({', '.join(_build.SOURCES)})")
    phases = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        phases[name] = round(time.perf_counter() - t0, 1)
        return out

    kernels = {}
    for name, fn in (("flash", check_flash), ("flash_bwd", check_flash_bwd), ("int8", check_int8),
                     ("decode", check_decode), ("ssd", check_ssd), ("ssd_bwd", check_ssd_bwd)):
        kernels.update(phase(name, fn))
    phase("full_width", check_full_width)
    phase("full_width_training", check_full_width_training)
    phase("full_width_training_ssm", lambda: check_full_width_training(SSM_ARCH, 512))
    phase("moe_layer", check_moe_layer)
    phase("full_width_serving", check_full_width_serving)
    phase("serve_defaults", serve_defaults)
    phase("train_defaults", train_defaults)
    pushdown = phase("pushdown", pushdown_requests)
    free()
    served, served_by_arch = phase("serving", serve_models)
    trained = phase("training", train_slice)
    trained_ssm = phase("training_ssm", lambda: train_slice(
        SSM_ARCH, get_config(SSM_ARCH).n_layers, 36, SSM_WIRE_BYTES, SSM_TRAIN_LAUNCHES))
    seen, kernels["flash_attention_vit"] = phase("vision", lambda: vision(smi))
    epoch_seen, images, labels = phase("epoch", lambda: epoch(smi))
    fleet_seen = phase("fleet", lambda: fleet(smi, images, labels))
    del images, labels
    launches = {name: pushdown[name] + served[name] + trained[name] + trained_ssm[name]
                + seen[name] + epoch_seen[name] + fleet_seen[name] for name in KERNELS}
    log(f"launches: pushdown {pushdown}, serving {served}, training {trained}, "
        f"SSM training {trained_ssm}, vision {seen}, epoch {epoch_seen}, fleet {fleet_seen}")
    log(f"phase wall seconds {phases}; total {time.perf_counter() - t_start:.1f} s")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main paths")
    # Rows of their own, timed at another path's shape: that path's launches
    # go there and are taken out of the kernel's main row.
    own_rows = [("ssd_scan", "ssd_scan_jamba", served_by_arch["jamba-v0.1-52b"]["ssd_scan"],
                 "jamba-v0.1-52b's prefill (4 x 512, 128 heads of 64, N 16)"),
                ("decode_attention", "decode_attention_moonshot",
                 served_by_arch["moonshot-v1-16b-a3b"]["decode_attention"],
                 "moonshot-v1-16b-a3b's decode (4 x 544, 16/16 heads, hd 128, bf16)"),
                ("flash_attention", "flash_attention_vit",
                 seen["flash_attention"] + epoch_seen["flash_attention"]
                 + fleet_seen["flash_attention"],
                 "the ViT's blocks at the COS batch (200 x 196, 6 heads of 64, f32, "
                 "non-causal; route 3xtf32)")]
    main_launches = dict(launches)
    for kernel, _, n, _ in own_rows:
        main_launches[kernel] -= n
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": main_launches[name], **kernels[name]}
            for name, (src, rep) in KERNELS.items()]
    line += [{"name": row, "shape": shape, "route": "cuda", "source": KERNELS[kernel][0],
              "replaces": KERNELS[kernel][1], "launches": n, **kernels[row]}
             for kernel, row, n, shape in own_rows]
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
