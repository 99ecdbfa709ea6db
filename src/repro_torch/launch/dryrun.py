"""Multi-pod dry-run: run and count every (arch x shape x mesh) cell on meta.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 256 or 512 fake host devices. The port has no compiler that
partitions a program; its counterpart of XLA SPMD is DTensor on a
``DeviceMesh``. So each cell's step runs once, for real, as one rank of a
fake process group of the mesh's world size, on meta DTensors placed by the
sharding rules, under ``activation_sharding`` and the step's ``constrain``
hook. Nothing is allocated and no kernel is launched: each kernel entry
point records its work (``kernels/work.py``), and ``launch/cost_analysis``
counts the rank's FLOPs, HBM bytes, collective bytes by kind and peak live
bytes while the step runs. Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]

A cell that cannot run is a fault of the port: it prints ``[FAIL]`` and the
exit code is 1. long_500k is a documented ``[skip]`` for the archs whose
decode is quadratic.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Any, Dict, Iterable, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import (
    HW,
    SHAPES,
    HapiConfig,
    MeshSpec,
    RunConfig,
    TrainConfig,
    cell_is_runnable,
)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.profiler import profile_lm
from repro_torch.core.splitter import choose_split
from repro_torch.core.tier_split import TierPlan, largest_divisor_leq
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.distributed.elastic import distribute_module
from repro_torch.distributed.sharding import (
    Sharder,
    Spec,
    batch_pspecs,
    cache_pspecs,
    opt_state_pspecs,
    param_pspecs,
    placements,
)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.cost_analysis import Cost, count_cost
from repro_torch.launch.specs import META, decode_specs, input_specs, meta_model
from repro_torch.models.module import REMAT_POLICIES, dtype_of
from repro_torch.optim.adamw import OptState
from repro_torch.train.steps import (
    TrainState,
    build_decode_step,
    build_hapi_train_step,
    build_prefill_step,
)


# ---------------------------------------------------------------------------
# Roofline terms (the counting lives in cost_analysis.py)
# ---------------------------------------------------------------------------
def link_bandwidth(ranks: Sequence[int]) -> float:
    """The rate of the slowest link a group of ``ranks`` crosses: NVLink
    within one node of ``HW.cards_per_node`` consecutive ranks (the model
    axis innermost), InfiniBand between nodes."""
    nodes = {r // HW.cards_per_node for r in ranks}
    return HW.nvlink_bandwidth if len(nodes) <= 1 else HW.ib_bandwidth


def roofline_terms(flops: float, hbm_bytes: float,
                   collectives: Iterable[Tuple[float, Sequence[int]]]) -> Dict[str, float]:
    """Seconds at the card's peaks: FLOPs at the bf16 tensor-core rate, HBM
    bytes at the memory rate, each collective's bytes over the slowest link
    its group crosses."""
    return {
        "compute_s": flops / HW.peak_flops_bf16,
        "memory_s": hbm_bytes / HW.hbm_bandwidth,
        "collective_s": sum(b / link_bandwidth(r) for b, r in collectives),
    }


# ---------------------------------------------------------------------------
# Per-arch perf configs (the JAX package's hillclimb winners); --baseline
# runs without them.
# ---------------------------------------------------------------------------
PERF_OVERRIDES = {
    "moonshot-v1-16b-a3b": {"train": {"fsdp": False}, "prefill": {"fsdp": False}},
    "whisper-small": {"train": {"fsdp": False}},
    "grok-1-314b": {"train": {"microbatch_div": 16, "cos_batch": 4}},
}


def perf_overrides(arch: str, kind: str) -> dict:
    per = PERF_OVERRIDES.get(arch, {})
    out = dict(per.get(None, {}))
    out.update(per.get(kind, {}))
    return out


# ---------------------------------------------------------------------------
# The fake process group
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of ``world``
    ranks (collectives return without moving data). An existing group of
    another size or rank is replaced for the duration."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    prev = None
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world and \
                dist.get_rank() == rank:
            yield
            return
        prev = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
        if prev[2] != "fake":
            raise RuntimeError(f"a {prev[2]} process group is initialised; the dry-run "
                               "needs a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if prev is not None:
            dist.init_process_group("fake", store=FakeStore(), rank=prev[1],
                                    world_size=prev[0])


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------
def plan_for_mesh(cfg, shape, hapi: HapiConfig, ms: MeshSpec) -> TierPlan:
    prof = profile_lm(cfg, shape.seq_len, hapi.memory_headroom)
    decision = choose_split(prof, hapi, shape.global_batch)
    split = decision.split_index
    sh = Sharder(ms)
    local_b = max(1, shape.global_batch // sh.data_size)
    # COS batch: HBM-budget-driven per data shard (conservative: activations
    # counted undivided by the model axis — the paper's over-estimation).
    per_sample = prof.act_peak_bytes[split] * (1 + prof.headroom)
    fit = int(max(1, (hapi.cos_hbm_budget * 0.5) / max(per_sample, 1.0)))
    local_cos = largest_divisor_leq(local_b, min(fit, local_b, hapi.cos_batch))
    return TierPlan(split=split, cos_batch=local_cos * sh.data_size,
                    compress=hapi.compress_transfer, decision=decision)


def _meta_dtensors(tensors: Dict[str, torch.Tensor], specs: Dict[str, Spec], mesh,
                   dtype=None) -> Dict[str, DTensor]:
    return {k: distribute_tensor(torch.empty(t.shape, dtype=dtype or t.dtype, device=META),
                                 mesh, placements(specs[k], mesh))
            for k, t in tensors.items()}


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return type(tree)(_tree_map(fn, v) for v in tree)


def _tree_map2(fn, tree, specs):
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map2(fn, v, s) for v, s in zip(tree, specs)))
    return type(tree)(_tree_map2(fn, v, s) for v, s in zip(tree, specs))


def _local_bytes(tensors: Iterable[torch.Tensor]) -> float:
    total = 0.0
    for t in tensors:
        t = t._local_tensor if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def make_constrain(mesh, ms: MeshSpec, dp, grad_specs: Dict[str, Spec]):
    """The step's ``constrain(tree, kind)``: boundary activations batch over
    data ("acts"), gradients as their ZeRO specs ("grads")."""
    def acts(x):
        return x.redistribute(mesh, placements(Spec(dp, *([None] * (x.dim() - 1))), mesh))

    def constrain(tree, kind):
        if kind == "acts":
            return tuple(acts(x) for x in tree) if isinstance(tree, tuple) else acts(tree)
        return {k: v.redistribute(mesh, placements(grad_specs[k], mesh))
                for k, v in tree.items()}

    return constrain


def sharded_train_state(model, plan: TierPlan, tc: TrainConfig, ms: MeshSpec, mesh, *,
                        fsdp: bool = True) -> TrainState:
    """The meta model's TrainState on ``mesh``: the frozen and trainable
    parts placed by ``param_pspecs``, the moments (zeros on meta) by
    ``opt_state_pspecs``, the step replicated."""
    frozen, trainable = model.split_params(plan.split)
    frozen.requires_grad_(False)
    distribute_module(frozen, param_pspecs(frozen, ms, fsdp), mesh)
    distribute_module(trainable, param_pspecs(trainable, ms, fsdp), mesh)
    params = dict(trainable.named_parameters())
    sdt = dtype_of(tc.opt_state_dtype)
    ospec = opt_state_pspecs(params, ms)
    opt = OptState(m=_meta_dtensors(params, ospec, mesh, sdt),
                   v=_meta_dtensors(params, ospec, mesh, sdt),
                   step=distribute_tensor(torch.empty((), dtype=torch.int32, device=META),
                                          mesh, [Replicate()] * mesh.ndim))
    return TrainState(frozen, trainable, opt)


def count_train_step(model, rc: RunConfig, plan: TierPlan, mesh, *, fsdp: bool = True) -> Cost:
    """The Hapi train step of ``rc`` (``model`` on meta) counted on ``mesh``
    (a ``DeviceMesh`` of ``rc.mesh``'s shape): the state and the batch placed
    by the rules, the step under ``activation_sharding`` and its
    ``constrain`` hook; what it holds before the step is the baseline of the
    peak."""
    cfg, shape, ms = rc.model, rc.shape, rc.mesh
    dp = Sharder(ms).dp(shape.global_batch)
    state = sharded_train_state(model, plan, rc.train, ms, mesh, fsdp=fsdp)
    batch = _meta_dtensors(input_specs(cfg, shape), batch_pspecs(cfg, shape, ms), mesh)
    constrain = make_constrain(mesh, ms, dp, opt_state_pspecs(state.trainable, ms))
    step = build_hapi_train_step(model, rc, plan, constrain=constrain)
    held = [*state.frozen.parameters(), *state.trainable.parameters(),
            *state.opt.m.values(), *state.opt.v.values(), *batch.values()]
    with activation_sharding(dp, model_size=ms.axis_size("model"), mesh=mesh), \
            count_cost(_local_bytes(held)) as cost:
        step(state, batch)
    return cost


def _model_flops(cfg, shape, extra) -> Tuple[float, float]:
    """MODEL_FLOPS: 6ND train / 2ND prefill / 2NB decode (N active for MoE);
    the step-aware variant separates the forward-only frozen prefix."""
    n_act = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * (shape.seq_len if cfg.family != "encdec"
                                       else shape.seq_len + cfg.dec_seq)
        fz = extra.get("split", 0) / max(cfg.n_blocks, 1)
        return 6.0 * n_act * tokens, (2.0 + 4.0 * (1 - fz)) * n_act * tokens
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    return 2.0 * n_act * tokens, 2.0 * n_act * tokens


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    fsdp: bool = True,
    compress: bool = False,
    microbatch_div: int = 8,
    cfg_override=None,
    remat: str = "block",
    cos_batch: int = 0,
    mesh_spec: MeshSpec = None,
) -> Dict[str, Any]:
    """Run one cell's step on meta DTensors as rank 0 of a fake group of the
    mesh's world size, and report what ``repro/launch/dryrun.lower_cell``
    does: per-device FLOPs, bytes and collective bytes by kind, the roofline
    terms and the dominant one, per-device peak bytes against
    ``HW.hbm_capacity``, ``model_flops_6nd``, ``model_flops_step`` and the
    useful ratios. ``mesh_spec`` replaces the production mesh (tests)."""
    cfg = cfg_override or get_config(arch)
    if cfg.is_mla:
        raise NotImplementedError(f"{arch}: latent attention and the dropless MoE are not "
                                  "sharded in the port; the dry-run takes the other "
                                  "architectures")
    shape = SHAPES[shape_name]
    if not cell_is_runnable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": "long-context decode requires sub-quadratic arch"}
    ms = mesh_spec or meshlib.mesh_spec(multi_pod=multi_pod)
    with fake_world(ms.n_devices):
        t0 = time.time()
        mesh = meshlib.make_mesh(ms, "cpu")
        cost, extra = _run_cell(cfg, shape, ms, mesh, fsdp=fsdp, compress=compress,
                                microbatch_div=microbatch_div, remat=remat,
                                cos_batch=cos_batch, arch=arch)
        t1 = time.time()
    return cell_result(arch, shape_name, cfg, shape, ms, cost, extra, t1 - t0, fsdp)


def cell_result(arch, shape_name, cfg, shape, ms, cost: Cost, extra, seconds, fsdp):
    terms = roofline_terms(cost.flops, cost.bytes, cost.collectives)
    dominant = max(terms, key=terms.get)
    model_flops, model_flops_step = _model_flops(cfg, shape, extra)
    global_flops = cost.flops * ms.n_devices
    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": "x".join(map(str, ms.shape)),
        "n_devices": ms.n_devices,
        "run_s": round(seconds, 1),
        "flops_per_device": cost.flops,
        "hbm_bytes_per_device": cost.bytes,
        "collective_bytes_per_device": cost.coll_bytes,
        "collectives": cost.coll_by_kind,
        "kernel_flops": cost.kernel_flops,
        "roofline": terms,
        "dominant": dominant,
        "peak_bytes_per_device": cost.peak_bytes,
        "fits_hbm": cost.peak_bytes <= HW.hbm_capacity,
        "model_flops_6nd": model_flops,
        "model_flops_step": model_flops_step,
        "useful_ratio_6nd": model_flops / global_flops if global_flops else 0.0,
        "useful_ratio_step": model_flops_step / global_flops if global_flops else 0.0,
        "fsdp": fsdp,
        **extra,
    }


def _run_cell(cfg, shape, ms: MeshSpec, mesh, *, fsdp, compress, microbatch_div, remat,
              cos_batch, arch) -> Tuple[Cost, dict]:
    model = meta_model(cfg)
    hapi = HapiConfig(compress_transfer=compress,
                      **({"cos_batch": cos_batch} if cos_batch else {}))
    sh = Sharder(ms)
    dp = sh.dp(shape.global_batch)
    shard_acts = activation_sharding(dp, model_size=ms.axis_size("model"), mesh=mesh)

    if shape.kind == "train":
        micro = largest_divisor_leq(shape.global_batch,
                                    max(1, shape.global_batch // microbatch_div))
        if not cos_batch:
            # Fused extract+accumulate path (one chunk of activations live):
            # cap the COS batch at the accumulation chunk. An explicit
            # --cos-batch opts into the coarse-extraction path (grok).
            hapi = HapiConfig(compress_transfer=compress,
                              cos_batch=max(1, micro // sh.data_size))
        plan = plan_for_mesh(cfg, shape, hapi, ms)
        tc = TrainConfig(microbatch=micro, remat=remat,
                         opt_state_dtype="bfloat16" if "grok" in arch else "float32")
        rc = RunConfig(model=cfg, shape=shape, mesh=ms, hapi=hapi, train=tc)
        cost = count_train_step(model, rc, plan, mesh, fsdp=fsdp)
        extra = {"split": plan.split, "cos_batch": plan.cos_batch, "microbatch": micro,
                 "n_blocks": cfg.n_blocks}
        return cost, extra

    distribute_module(model, param_pspecs(model, ms, fsdp), mesh)
    held = list(model.parameters())
    if shape.kind == "prefill":
        batch = _meta_dtensors(input_specs(cfg, shape), batch_pspecs(cfg, shape, ms), mesh)
        held += list(batch.values())
        step = build_prefill_step(model)
        with shard_acts, implicit_replication(), count_cost(_local_bytes(held)) as cost:
            step(batch)
    else:
        cache, token, pos = decode_specs(model, cfg, shape)
        cspec = cache_pspecs(cache, cfg, shape.global_batch, ms)
        cache = _tree_map2(lambda t, s: distribute_tensor(t, mesh, placements(s, mesh)),
                           cache, cspec)
        token = distribute_tensor(token, mesh, placements(Spec(dp) if dp else Spec(), mesh))
        held += _leaves(cache) + [token]
        step = build_decode_step(model)
        with shard_acts, implicit_replication(), count_cost(_local_bytes(held)) as cost:
            step(cache, token, pos)
    return cost, {"n_blocks": cfg.n_blocks}


# ---------------------------------------------------------------------------
def _print(r: dict) -> None:
    arch, shape_name, tag = r["arch"], r["shape"], r["status"]
    if tag == "ok":
        t = r["roofline"]
        print(f"[{tag}] {arch:24s} {shape_name:12s} mesh={r['mesh']:9s} "
              f"run={r['run_s']:6.1f}s flops/dev={r['flops_per_device']:.3e} "
              f"comp={t['compute_s']:.4f}s mem={t['memory_s']:.4f}s "
              f"coll={t['collective_s']:.4f}s dom={r['dominant']} "
              f"peak/dev={r['peak_bytes_per_device'] / 1e9:.2f}GB "
              f"useful={r['useful_ratio_step']:.2f}")
    elif tag == "skip":
        print(f"[{tag}] {arch:24s} {shape_name:12s} — {r['reason']}")
    else:
        print(f"[{tag}] {arch:24s} {shape_name:12s} — {r['error']}")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--remat", default="block", choices=REMAT_POLICIES)
    ap.add_argument("--microbatch-div", type=int, default=8)
    ap.add_argument("--cos-batch", type=int, default=0)
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful defaults (no per-arch perf overrides)")
    ap.add_argument("--perf", action="store_true", help="apply PERF_OVERRIDES")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    results = []
    t_all = time.time()
    for arch, shape_name in cells:
        try:
            kw = dict(fsdp=not args.no_fsdp, compress=args.compress,
                      remat=args.remat, microbatch_div=args.microbatch_div,
                      cos_batch=args.cos_batch)
            if args.perf:
                kw.update(perf_overrides(arch, SHAPES[shape_name].kind))
            r = lower_cell(arch, shape_name, multi_pod=args.multi_pod, **kw)
        except Exception as e:  # a failing cell is a bug in the system
            r = {"arch": arch, "shape": shape_name, "status": "FAIL",
                 "error": f"{type(e).__name__}: {e}",
                 "trace": traceback.format_exc()[-2000:]}
        results.append(r)
        _print(r)
    print(f"{len(results)} cells in {time.time() - t_all:.1f} s")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    n_fail = sum(1 for r in results if r["status"] == "FAIL")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
