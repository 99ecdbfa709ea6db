"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b --device cpu \\
        --steps 12 --batch 8 --seq 32

Counterpart of ``repro/launch/train.py``. It wires the port's layers
together: object store -> resumable data pipeline -> Hapi tier plan (Alg. 1
split + Eq. 4 COS batch) -> Hapi train step -> AdamW -> atomic sharded
checkpoints. ``--kill-at`` demonstrates fault tolerance (crash, then resume
from the last checkpoint and the pipeline's cursor). It runs on the card
unless ``device="cpu"``; the smoke config is the default (``--full`` takes the
published one). Weights come from a ``torch.Generator`` seeded with the train
config's seed: on the CPU for the smoke config, then moved, so that a seed
gives one model on every device; on the device for the published config.
The batches are numpy arrays from the pipeline, moved to the device each
step: tokens (their own labels) for the LM families, frames, tokens and
labels for the encoder-decoder (``seq`` frames, ``dec_seq`` tokens), patch
embeddings, tokens and labels for the VLM (``seq`` counts the
``n_patches`` patches and the text after them).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.config import HapiConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.tier_split import plan_tiers
from repro_torch.cos.objectstore import ObjectStore
from repro_torch.data.pipeline import COSDataPipeline, PipelineState, synthetic_dataset
from repro_torch.models.api import build_model
from repro_torch.obs.program import TRACER, count_copy, format_summary, summary, tracing
from repro_torch.train.steps import build_hapi_train_step, init_train_state


def to_device(batch: dict, device: torch.device) -> dict:
    """A numpy batch as tensors on ``device``; integer columns as int64.
    Traced, a ``data.to_device`` span; the host arrays' bytes count in
    ``h2d_bytes_total`` where ``device`` is a card."""
    tr = TRACER
    with tr.span("data.to_device", batch, device):
        out = {k: torch.from_numpy(v).to(device=device, dtype=torch.long
                                         if np.issubdtype(v.dtype, np.integer) else None)
               for k, v in batch.items()}
    if tr.enabled and torch.device(device).type == "cuda":
        count_copy("h2d_bytes_total", batch.values())
    return out


def run_training(
    arch: str,
    *,
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    smoke: bool = True,
    ckpt_dir: str = "",
    ckpt_every: int = 20,
    kill_at: int = 0,
    compress: bool = False,
    lr: float = 3e-4,
    log_every: int = 5,
    object_size: int = 0,
    dataset_batches: int = 4,
    device="cuda",
):
    device = torch.device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.family == "vlm" and seq <= cfg.n_patches:
        raise ValueError(f"{arch}: seq {seq} leaves no text after its {cfg.n_patches} patches")
    shape = ShapeConfig("custom", "train", seq, batch)
    hapi = HapiConfig(compress_transfer=compress, cos_batch_min=1)
    tc = TrainConfig(learning_rate=lr, total_steps=steps, warmup_steps=max(2, steps // 10))
    rc = RunConfig(model=cfg, shape=shape, hapi=hapi, train=tc)

    plan = plan_tiers(cfg, shape, hapi, local_batch=batch)
    print(f"[plan] split={plan.split}/{cfg.n_blocks} cos_batch={plan.cos_batch} "
          f"compress={plan.compress} ({plan.decision.reason})")

    # Dataset lives in the object store as fixed-size objects.
    store = ObjectStore()
    data = synthetic_dataset(cfg, shape, n_samples=batch * dataset_batches, seed=tc.seed)
    store.put_dataset("train", data, object_size=object_size or batch)
    pstate = PipelineState()

    init = torch.device("cpu") if smoke else device
    model = build_model(cfg, device=init,
                        generator=torch.Generator(device=init).manual_seed(tc.seed)).to(device)
    state = init_train_state(model, rc, plan)
    start_step = 0
    if ckpt_dir:
        restored, extra, at = restore_checkpoint(ckpt_dir, state)
        if restored is not None:
            state, start_step = restored, at
            pstate = PipelineState.from_dict(extra.get("pipeline", {}))
            print(f"[resume] restored step {at}, object cursor {pstate.next_object}")

    step_fn = build_hapi_train_step(model, rc, plan)

    pipe = COSDataPipeline(store, "train", global_batch=batch, state=pstate)
    it = iter(pipe)
    losses = []
    i = start_step
    # The program's spans and counters over the run; each log line prints
    # their summary (per-step medians of the spans' host, stream and self
    # times, reading which waits for the device).
    with tracing():
        while i < steps:
            try:
                raw = next(it)
            except StopIteration:
                it = iter(pipe)
                continue
            state, metrics = step_fn(state, to_device(raw, device))
            losses.append(float(metrics["loss"]))
            i += 1
            if i % log_every == 0 or i == steps:
                print(f"step {i:5d}  loss {losses[-1]:.4f}  lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}\n{format_summary(summary())}")
            if ckpt_dir and (i % ckpt_every == 0 or i == steps):
                save_checkpoint(ckpt_dir, i, state,
                                extra={"pipeline": pipe.state.to_dict(),
                                       "arch": arch, "loss": losses[-1]})
            if kill_at and i == kill_at:
                print(f"[kill] simulating crash at step {i}")
                return {"killed_at": i, "losses": losses}

    return {"final_loss": losses[-1], "losses": losses, "steps": i}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--kill-at", type=int, default=0)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_training(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        smoke=args.smoke, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        kill_at=args.kill_at, compress=args.compress, lr=args.lr, device=args.device,
    )
    print({k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in out.items() if k != "losses"})


if __name__ == "__main__":
    main()
