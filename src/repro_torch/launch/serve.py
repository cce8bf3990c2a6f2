# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Serving launcher (port of ``repro/launch/serve.py``): batched greedy
generation for ``--arch <id> [--reduced]``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --batch 4 --prompt-len 16 --new-tokens 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --batch 8 --prompt-len 2000 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --batch 8 --prompt-len 512 \
        --new-tokens 32

``--arch`` takes every id of the registry (``configs.all_archs()``).

``--device`` defaults to ``cuda`` (and fails without a card); parameters
come from the port's seeded init (``--seed``).  Full-sequence attention
(Whisper's encoder) takes the flash-attention route
(``use_pallas_attention=True``) and Mamba's prefill the SSD route
(``models.mamba``): the CUDA kernels on the card, their plain versions
on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import all_archs, get_config
from repro_torch.models import Model
from repro_torch.serve import ServeDriver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced,
                     use_pallas_attention=True)
    model = Model(cfg, device=args.device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen)

    max_seq = args.max_seq or (
        args.prompt_len + args.new_tokens + (cfg.n_prefix or 0) + 8)
    driver = ServeDriver(model=model, max_seq=max_seq, batch=args.batch)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    frontend = {}
    if cfg.encoder is not None:
        frontend["frames"] = torch.zeros(
            (args.batch, cfg.encoder.n_frames, cfg.d_model),
            dtype=cfg.activation_dtype, device=dev)
    if cfg.n_prefix:
        frontend["prefix"] = torch.zeros(
            (args.batch, cfg.n_prefix, cfg.d_model),
            dtype=cfg.activation_dtype, device=dev)

    t0 = time.perf_counter()
    out = driver.generate(params, prompts, args.new_tokens,
                          frontend=frontend or None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"[serve] {args.arch} on {dev}: generated {tuple(out.shape)} in "
          f"{dt:.2f}s ({tps:.1f} tok/s batched greedy)")
    print(out[0, -args.new_tokens:].tolist())
    return out


if __name__ == "__main__":
    main()
