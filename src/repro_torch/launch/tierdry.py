"""Two-mesh tier dry-run: the paper's client and server as separate programs.

Counterpart of ``repro/launch/tierdry.py``. A fake world of 512 ranks holds
two 16 x 16 meshes (``launch/mesh.make_tier_meshes``): ranks 0-255 are the
storage (COS) mesh, which runs ``extract_step``; ranks 256-511 the compute
mesh, which runs ``tune_step``. Each tier's step is counted on a rank of its
own mesh (rank 0, then rank 256: the process re-joins the fake group as the
other rank), on meta DTensors as ``launch/dryrun.py`` counts a cell. The
split-boundary activations cross between the tiers (int8 with
``--compress``); ``wire_s`` puts them over ``N_CROSS_LINKS`` InfiniBand
ports.

    PYTHONPATH=src python -m repro_torch.launch.tierdry --arch qwen3-32b [--compress]
    PYTHONPATH=src python -m repro_torch.launch.tierdry --all --json out.json
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import HW, SHAPES, HapiConfig, RunConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.distributed.elastic import distribute_module
from repro_torch.distributed.sharding import Sharder, Spec, batch_pspecs, opt_state_pspecs
from repro_torch.distributed.sharding import param_pspecs
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.cost_analysis import count_cost
from repro_torch.launch.dryrun import (
    _local_bytes,
    _meta_dtensors,
    fake_world,
    make_constrain,
    plan_for_mesh,
    roofline_terms,
    sharded_train_state,
)
from repro_torch.launch.specs import input_specs, meta_model
from repro_torch.train.steps import build_tier_steps

# The boundary leaves each storage card over its own 400 Gb/s InfiniBand
# port (HW.ib_bandwidth), one a card as in a DGX H100: 256 ports a tier.
N_CROSS_LINKS = 256
WORLD = 512
STORAGE_RANK, COMPUTE_RANK = 0, 256


def _global_bytes(acts) -> int:
    leaves = acts if isinstance(acts, tuple) else (acts,)
    return sum(x.numel() * x.element_size() for x in leaves)


def lower_tier_cell(arch: str, compress: bool = False, microbatch_div: int = 8,
                    cfg_override=None):
    cfg = cfg_override or get_config(arch)
    if cfg.is_mla:
        raise NotImplementedError(f"{arch}: latent attention and the dropless MoE are not "
                                  "sharded in the port; the dry-run takes the other "
                                  "architectures")
    shape = SHAPES["train_4k"]
    ms = meshlib.mesh_spec(multi_pod=False)   # each tier is one 16 x 16 pod
    hapi = HapiConfig(compress_transfer=compress)
    plan = plan_for_mesh(cfg, shape, hapi, ms)
    micro = max(1, shape.global_batch // microbatch_div)
    tc = TrainConfig(microbatch=micro,
                     opt_state_dtype="bfloat16" if "grok" in arch else "float32")
    rc = RunConfig(model=cfg, shape=shape, mesh=ms, hapi=hapi, train=tc)
    dp = Sharder(ms).dp(shape.global_batch)
    t0 = time.time()

    # --- storage side, as a rank of the storage mesh ----------------------
    with fake_world(WORLD, STORAGE_RANK):
        storage_mesh, _ = meshlib.make_tier_meshes("cpu")
        model = meta_model(cfg)
        frozen, _ = model.split_params(plan.split)
        frozen.requires_grad_(False)
        distribute_module(frozen, param_pspecs(frozen, ms, fsdp=True), storage_mesh)
        batch = _meta_dtensors(input_specs(cfg, shape), batch_pspecs(cfg, shape, ms),
                               storage_mesh)
        extract_step, _ = build_tier_steps(model, rc, plan)
        held = [*frozen.parameters(), *batch.values()]
        with activation_sharding(dp, model_size=16, mesh=storage_mesh), \
                implicit_replication(), count_cost(_local_bytes(held)) as cx:
            acts = extract_step(frozen, batch)
        wire_bytes = _global_bytes(acts)
        acts_meta = tuple((x.shape, x.dtype) for x in (acts if isinstance(acts, tuple)
                                                        else (acts,)))
        del model, frozen, batch, acts

    # --- compute side, as a rank of the compute mesh ----------------------
    with fake_world(WORLD, COMPUTE_RANK):
        _, compute_mesh = meshlib.make_tier_meshes("cpu")
        model = meta_model(cfg)
        state = sharded_train_state(model, plan, tc, ms, compute_mesh, fsdp=True)
        batch = _meta_dtensors(input_specs(cfg, shape), batch_pspecs(cfg, shape, ms),
                               compute_mesh)
        acts = tuple(_meta_dtensors({"a": torch.empty(s, dtype=d, device="meta")},
                                    {"a": Spec(dp, *([None] * (len(s) - 1)))},
                                    compute_mesh)["a"] for s, d in acts_meta)
        acts = acts if compress else acts[0]
        constrain = make_constrain(compute_mesh, ms, dp, opt_state_pspecs(state.trainable, ms))
        _, tune_step = build_tier_steps(model, rc, plan, constrain=constrain)
        held = [*state.trainable.parameters(), *state.opt.m.values(), *state.opt.v.values(),
                *batch.values(), *(acts if isinstance(acts, tuple) else (acts,))]
        with activation_sharding(dp, model_size=16, mesh=compute_mesh), \
                count_cost(_local_bytes(held)) as ct:
            tune_step(state.trainable, state.opt, acts, batch)
        del model, state, batch, acts
    t1 = time.time()

    ex_terms = roofline_terms(cx.flops, cx.bytes, cx.collectives)
    tu_terms = roofline_terms(ct.flops, ct.bytes, ct.collectives)
    wire_s = wire_bytes / (N_CROSS_LINKS * HW.ib_bandwidth)
    pipe = {
        "storage_s": max(ex_terms.values()),
        "wire_s": wire_s,
        "compute_s_total": max(tu_terms.values()),
    }
    return {
        "arch": arch, "status": "ok", "mode": "tier",
        "split": plan.split, "cos_batch": plan.cos_batch,
        "compress": compress,
        "run_s": round(t1 - t0, 1),
        "wire_bytes_per_step": wire_bytes,
        "wire_s": wire_s,
        "storage": {"roofline": ex_terms, "peak_bytes_per_device": cx.peak_bytes,
                    "flops_per_device": cx.flops},
        "compute": {"roofline": tu_terms, "peak_bytes_per_device": ct.peak_bytes,
                    "flops_per_device": ct.flops},
        "pipelined_step_s": max(pipe.values()),   # steady-state pipelined tiers
        "bottleneck": max(pipe, key=pipe.get),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all else [args.arch]
    results = []
    for arch in archs:
        for compress in ([False, True] if args.all else [args.compress]):
            try:
                r = lower_tier_cell(arch, compress=compress)
            except Exception as e:
                r = {"arch": arch, "status": "FAIL", "compress": compress,
                     "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-1500:]}
            results.append(r)
            if r["status"] == "ok":
                print(f"[ok] tier {arch:24s} compress={str(compress):5s} "
                      f"split={r['split']:2d} wire={r['wire_bytes_per_step'] / 1e9:6.2f}GB "
                      f"wire_s={r['wire_s']:.3f} storage_s={r['storage']['roofline']} "
                      f"compute_s={r['compute']['roofline']} bottleneck={r['bottleneck']}",
                      flush=True)
            else:
                print(f"[FAIL] tier {arch} — {r['error']}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    return 1 if any(r["status"] == "FAIL" for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
