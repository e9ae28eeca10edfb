"""End-to-end training driver: the port of ``repro/launch/train.py``, on
one device (the CUDA card unless ``--device`` names another) or, when a
process group of more than one rank is up, on the host mesh of its ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ...

Microbatched gradient accumulation in bfloat16, 8-bit AdamW, the cosine
schedule, remat where the config sets it, async atomic checkpointing with
restart-on-failure (``FaultTolerantLoop``), the straggler watchdog and
deterministic step-indexed data.  Weights come from ``init_params`` with a
``torch.Generator`` seeded ``--seed`` on the device.  On a mesh (``(n,
1)`` over ``("data", "model")``, ``launch/mesh.py``; ``torchrun``'s
environment starts the group) every rank draws the same weights and
places them by the train step's specs; checkpoints are written by rank 0.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import ARCHS, get_config
from ..core.device import resolve_device
from ..data.pipeline import SyntheticLM
from ..distributed.sharding import shard_tree
from ..launch.mesh import launcher_mesh
from ..launch.steps import make_train_step
from ..models.transformer import init_params, validate_config
from ..optim.adamw import OptState, adamw_init
from ..runtime.fault import FaultTolerantLoop, StragglerWatchdog


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--opt-state", default="int8", choices=("int8", "f32"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the device to train on (the CUDA card unless "
                         "given; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    validate_config(cfg)
    device = resolve_device(args.device)
    mesh = launcher_mesh(device)
    where = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else device
    print(f"[train] arch={cfg.name} params≈{cfg.n_params()/1e6:.1f}M "
          f"{'mesh' if mesh else 'device'}={where}")

    train_step, specs = make_train_step(
        cfg, mesh, num_microbatches=args.microbatches,
        peak_lr=args.lr, warmup=min(20, args.steps // 5 + 1),
        total_steps=args.steps, opt_state_dtype=args.opt_state, device=device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    opt_state = adamw_init(params, state_dtype=args.opt_state)
    if mesh is not None:
        params = shard_tree(params, specs["params"], mesh)
        opt_state = OptState(
            opt_state.step, shard_tree(opt_state.m, specs["opt"].m, mesh),
            shard_tree(opt_state.v, specs["opt"].v, mesh))
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    watchdog = StragglerWatchdog(
        on_straggler=lambda s, d: print(f"[watchdog] step {s} straggled "
                                        f"({d*1e3:.0f} ms)"))
    loop = FaultTolerantLoop(ckpt, save_every=args.save_every,
                             watchdog=watchdog)
    losses = []

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        return (params, opt_state)

    def on_step(step, state, dt):
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)

    t0 = time.time()
    loop.run((params, opt_state), step_fn, data.batch_at, args.steps,
             on_step=on_step)
    dt = time.time() - t0
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not np.isfinite(losses[-1]):
        raise RuntimeError("training diverged")
    if len(losses) > 20:
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise RuntimeError("loss did not improve")
        print("[train] loss improved ✓")


if __name__ == "__main__":
    main()
