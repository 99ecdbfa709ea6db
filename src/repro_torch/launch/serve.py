"""Serving entry point: prefill a batch of prompts, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b --full \\
        --prompt-len 512 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --device cpu

Counterpart of the ``--arch`` path of ``repro/launch/serve.py``, for the LM
families the port has: dense (mistral-nemo-12b, gemma2-9b, qwen3-32b,
qwen1.5-110b), moe (moonshot-v1-16b-a3b, grok-1-314b), ssm (mamba2-1.3b) and
hybrid (jamba-v0.1-52b). The loop (``generate``) is the JAX launcher's: the
prompt is prefilled and that cache is discarded; a fixed-size cache of
``prompt_len + new_tokens`` positions is refilled by teacher-forcing the
prompt one token at a time; the first new token is the argmax of the last
teacher-forced step's logits, and ``new_tokens`` greedy steps follow.
``tok_per_s`` counts the greedy loop only. Weights and prompt tokens come
from one ``torch.Generator`` seeded with ``seed``: on the CPU for the smoke
config, so that a seed gives the same model and prompts on every device,
and on the device for the published config, whose weights are too large to
draw on the host. It runs on the card unless ``device="cpu"``; the smoke
config (f32, head dim 16) is the default, ``--full`` the published one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.models.transformer import LM
from repro_torch.train.steps import build_decode_step, build_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, new_tokens: int = 16,
          smoke: bool = True, seed: int = 0, device="cuda") -> dict:
    """``generate`` on the model of ``arch`` and a batch of random prompts."""
    device = torch.device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    init = torch.device("cpu") if smoke else device
    gen = torch.Generator(device=init).manual_seed(seed)
    model = build_model(cfg, device=init, generator=gen).to(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device=init).to(device)
    return generate(model, tokens, new_tokens)


def generate(model: LM, tokens: torch.Tensor, new_tokens: int) -> dict:
    """Serves the prompts ``tokens`` (B, prompt_len) on ``model``'s device.
    Returns the prompt and the greedy tokens (B, new_tokens + 1) as numpy,
    ``tok_per_s``, the wall times of the prefill and of the teacher-forced
    refill in ms, and the logits (B, 1, padded_vocab) of the prefill's last
    position and of the last teacher-forced step, which see the same
    prompt."""
    device = tokens.device
    batch, prompt_len = tokens.shape
    prefill, step = build_prefill_step(model), build_decode_step(model)

    _sync(device)
    t0 = time.perf_counter()
    prefill_logits, _ = prefill({"tokens": tokens})
    _sync(device)
    t1 = time.perf_counter()
    cache = model.init_cache(batch, prompt_len + new_tokens)
    logits = None
    for t in range(prompt_len):
        logits, cache = step(cache, tokens[:, t:t + 1], t)
    _sync(device)
    t2 = time.perf_counter()
    teacher_logits = logits

    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for i in range(new_tokens):
        logits, cache = step(cache, tok, prompt_len + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t2
    return {"prompt": tokens.cpu().numpy().astype(np.int32),
            "tokens": torch.cat(out, dim=1).cpu().numpy().astype(np.int32),
            "tok_per_s": batch * new_tokens / dt,
            "prefill_ms": 1e3 * (t1 - t0), "teacher_ms": 1e3 * (t2 - t1),
            "prefill_logits": prefill_logits, "teacher_logits": teacher_logits}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="a dense, moe, ssm or hybrid arch, e.g. moonshot-v1-16b-a3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="the published config, not the smoke one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.tokens, smoke=not args.full, seed=args.seed,
                device=args.device)
    print(f"prefill {out['prefill_ms']:.1f} ms, teacher-forced refill "
          f"{out['teacher_ms']:.1f} ms")
    print(f"decoded {out['tokens'].shape} @ {out['tok_per_s']:.1f} tok/s")
    print(out["tokens"][:, :12])


if __name__ == "__main__":
    main()
