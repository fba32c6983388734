"""End-to-end training: straggler-aware data-parallel training.

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 200 --batch 8 --seq 128
    python -m repro_torch.launch.train --reduced --device cpu --steps 20 --checkpoint-dir /tmp/ckpt
    python -m repro_torch.launch.train --full --steps 30 --seq 512          # on the card

Counterpart of `repro.launch.train`, with its flags and its lines, plus
`--device` (default: the card).  It runs the train step (model zoo +
AdamW) under the straggler-aware executor: per-shard completion telemetry
feeds Algorithm 1, which re-tunes the single-fork policy online; node
failures and checkpoint/restart are exercised along the way.  `--reduced`
(the default, as in the reference) shrinks the model for the CPU; `--full`
takes the published config.  The model trains through attention's
"chunked" route and the SSM's "jnp" route, the reference's defaults: the
CUDA kernels have no backward pass.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import tree
from ..configs import ARCH_IDS, get_config, get_reduced
from ..core import Pareto, ShiftedExp
from ..data import SyntheticTokenPipeline
from ..device import resolve_device
from ..models.lm import build_model
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..runtime import SimCluster, StragglerAwareTrainer, TrainerConfig
from .steps import value_and_grad


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--n-tasks", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--dist", choices=["shifted-exp", "pareto"], default="pareto")
    ap.add_argument("--slow-fraction", type=float, default=0.15)
    ap.add_argument("--crash-prob", type=float, default=0.01)
    ap.add_argument("--node-loss-prob", type=float, default=0.002)
    ap.add_argument("--no-adapt", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device; default the card")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What one run did, for callers that check it."""

    trainer: StragglerAwareTrainer
    pipeline: SyntheticTokenPipeline
    n_params: int
    resumed: int | None
    reports: list  # StepReport of each step this run took
    step_ms: list  # per step taken: wall ms, the step's work finished on the device
    step_device_ms: list | None  # per step: CUDA-event ms from its start to its end (None on the CPU)
    wall_s: float


def run(args: argparse.Namespace, log=print) -> TrainRun:
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    # the reference's defaults; the port's kernel routes have no backward
    cfg = cfg.replace(attn_impl="chunked", ssm_impl="jnp")
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    n_params = sum(p.numel() for p in tree.leaves(params))
    log(f"arch={cfg.arch_id} ({'reduced' if args.reduced else 'full'}) params={n_params/1e6:.1f}M")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps)
    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}
    loss_and_grad = value_and_grad(model.loss)

    def grad_fn(params, batch):
        (loss, _), grads = loss_and_grad(params, batch)
        return loss, grads

    def update_fn(state, grads):
        p, o, _ = adamw_update(opt_cfg, state["params"], grads, state["opt"], state["step"])
        return {"params": p, "opt": o, "step": state["step"] + 1}

    dist = ShiftedExp(1.0, 1.0) if args.dist == "shifted-exp" else Pareto(2.0, 1.0)
    cluster = SimCluster(
        int(args.n_tasks * 2), dist, seed=args.seed,
        slow_fraction=args.slow_fraction, slow_factor=4.0,
        crash_prob=args.crash_prob, node_loss_prob=args.node_loss_prob,
    )
    trainer = StragglerAwareTrainer(
        cluster, grad_fn, update_fn, state,
        TrainerConfig(
            n_tasks=args.n_tasks,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            adapt_policy=not args.no_adapt,
            seed=args.seed,
        ),
        device=dev,
    )
    resumed = trainer.maybe_restore()
    if resumed:
        log(f"resumed from checkpoint at step {resumed}")

    pipe = SyntheticTokenPipeline(cfg, batch_size=args.batch, seq_len=args.seq, seed=args.seed, device=dev)
    cuda = dev.type == "cuda"
    reports, step_ms, device_ms = [], [], [] if cuda else None
    t0 = time.time()
    sim_time = sim_cost = 0.0
    for step in range(trainer.step, args.steps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        ts = time.perf_counter()
        rep = trainer.train_step(pipe.batch(step))
        if cuda:
            end.record()
            torch.cuda.synchronize(dev)
            device_ms.append(start.elapsed_time(end))
        step_ms.append((time.perf_counter() - ts) * 1e3)
        reports.append(rep)
        sim_time += rep.latency
        sim_cost += rep.cost
        if rep.step % args.log_every == 0 or rep.step == args.steps:
            log(
                f"step {rep.step:4d} loss {rep.loss:7.4f} step-latency {rep.latency:7.2f}s "
                f"cost {rep.cost:6.2f} policy {rep.policy} "
                f"replicas {rep.n_replicas} lost {rep.lost_workers}"
            )
    wall = time.time() - t0
    log(
        f"done: {args.steps} steps in {wall:.1f}s wall; simulated cluster time "
        f"{sim_time:.1f}s, mean cost {sim_cost / max(args.steps - (resumed or 0), 1):.2f} "
        f"machine-seconds/task; final policy {trainer.policy.label()}"
    )
    return TrainRun(trainer, pipe, n_params, resumed, reports, step_ms, device_ms, wall)


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
