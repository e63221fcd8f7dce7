"""End-to-end training launcher of the port.

Checked against ``repro/launch/train.py`` (its flags ``--arch --steps
--batch --seq --lr --micro --ckpt-dir --ckpt-every --resume`` and its
pieces: AdamW with weight decay 0.01 on a cosine schedule with 10 warmup
steps, a ``Prefetcher`` over ``lm_batches`` with the stub frontends
(vision patches, audio frames), ``Heartbeat``, ``StragglerDetector``, a
``CheckpointManager`` keeping 2, resume from the latest checkpoint).
The port's own flags: the size flags of ``launch/compile.py``
(``--small``, the 2-layer, 128-wide config of the CPU tests; dims;
``--n-layers``), ``--seed`` for the numpy init and ``--device`` (the card
unless ``--device cpu``).  Full width by default, where the reference
always trains its smoke config.  Checkpoints hold ``{"params": ...,
"opt": {"m": ..., "v": ...}}`` in the reference's layout
(``convert.to_reference``), so either package resumes the other's; the
heartbeat goes beside them (the temp directory without ``--ckpt-dir``).

    PYTHONPATH=src python -m repro_torch.launch.train --small --device cpu \\
        --steps 20 --batch 4 --seq 32 [--micro 2] \\
        [--ckpt-dir build/ckpt --ckpt-every 10] [--resume]

``main(argv)`` returns the run: the config, model API, final params and
optimizer state, and the losses by step.
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.convert import from_reference, to_reference
from repro_torch.core.integrate import to_torch
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.launch.compile import add_scale_args, scaled_config
from repro_torch.models.model import build_model, init_params
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import make_train_step
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore, wait_for_async)
from repro_torch.train.fault import Heartbeat, StragglerDetector
from repro_torch.tree import tree_leaves


def frontend_of(cfg, seq: int):
    """``lm_batches``' stub frontend for ``cfg`` (None for text only)."""
    if cfg.frontend == "vision_stub":
        return {"kind": "vision_stub", "n": cfg.n_frontend_tokens,
                "d": cfg.d_model}
    if cfg.n_enc_layers:
        return {"kind": "audio_stub", "src": seq, "d": cfg.d_model}
    return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    add_scale_args(ap)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = scaled_config(args)
    api = build_model(cfg, device=args.device)
    n_slots = 1 if cfg.n_enc_layers else len(cfg.pattern)
    params = to_torch(init_params(cfg, np.random.default_rng(args.seed)),
                      api.device)
    print(f"{cfg.name}: {sum(p.numel() for p in tree_leaves(params)):,} "
          f"params on {api.device}", flush=True)

    opt = adamw(cosine_schedule(args.lr, 10, args.steps), weight_decay=0.01)
    opt_state = opt.init(params)

    def state_tree(params, opt_state):
        """The checkpoint tree, in the reference's layout."""
        return {"params": to_reference(params, n_slots),
                "opt": {k: to_reference(v, n_slots)
                        for k, v in opt_state.items()}}

    step0 = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=2)
        if args.resume and latest_step(args.ckpt_dir) is not None:
            wait_for_async()
            state = restore(args.ckpt_dir, None,
                            state_tree(params, opt_state))
            params = from_reference(state["params"], api.device)
            opt_state = {k: from_reference(v, api.device)
                         for k, v in state["opt"].items()}
            step0 = latest_step(args.ckpt_dir) + 1
            print(f"resumed from step {step0 - 1}", flush=True)

    it = Prefetcher(lm_batches(cfg.vocab, args.batch, args.seq,
                               frontend=frontend_of(cfg, args.seq)), depth=2)
    step_fn = make_train_step(api.train_loss, opt, args.micro)
    hb = Heartbeat(pathlib.Path(args.ckpt_dir or tempfile.gettempdir())
                   / f"{cfg.name}.heartbeat")
    det = StragglerDetector()
    losses = {}
    t0 = time.time()
    try:
        for i in range(step0, args.steps):
            batch = next(it)
            ts = time.time()
            params, opt_state, loss = step_fn(params, opt_state, i, batch)
            losses[i] = float(loss)          # waits for the step
            det.observe(i, time.time() - ts)
            hb.beat(i)
            if mgr and i % mgr.every == 0:
                mgr.maybe_save(i, state_tree(params, opt_state))
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {losses[i]:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
    finally:
        it.close()
        if mgr:
            wait_for_async()
    print("done", flush=True)
    return {"cfg": cfg, "api": api, "params": params, "opt_state": opt_state,
            "losses": losses, "step0": step0, "n_slots": n_slots,
            "state_tree": state_tree}


if __name__ == "__main__":
    main()
