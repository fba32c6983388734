"""Serving entry point: hedged batched decoding with online policy adaptation.

    python -m repro_torch.launch.serve                       # full Zamba2-1.2B on the card
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b
    python -m repro_torch.launch.serve --arch whisper-small --reduced --device cpu

Counterpart of `repro.launch.serve`.  Each request is a prefill of its
prompt plus greedy decoding of a `models.lm` model with seeded random
weights; the requests of a batch run under `HedgedServer`, whose simulated
cluster times them and whose controller re-plans the hedging policy
(p, r, keep|kill) through Algorithm 1.  `--arch` takes any of the ten
configs and defaults to zamba2-1.2b, at its full published width on the
card, where prefill runs the CUDA flash-attention (and, for the ssm and
hybrid families, SSD-scan) kernels; `--reduced` takes the reference's
reduced config.  A vlm request carries vision patch embeddings and an
encdec request encoder frame embeddings, drawn per request from the run's
numpy generator as the reference draws them.  The loop runs eagerly.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_reduced
from ..core import Pareto, ShiftedExp, SingleForkPolicy
from ..device import resolve_device
from ..models.lm import build_model
from ..runtime import HedgedServer, SimCluster


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="zamba2-1.2b")
    ap.add_argument("--reduced", action="store_true", help="the reference's reduced config")
    ap.add_argument("--device", default=None, help="torch device; default the card")
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--dist", choices=["pareto", "shifted-exp"], default="pareto")
    ap.add_argument("--no-adapt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class ServeRun:
    """What one run served, for callers that check it."""

    model: object
    params: dict
    server: HedgedServer
    requests: list
    outputs: list  # per batch: one (steps,) array of tokens per request
    stats: list  # per batch: ServeStats
    prefill_s: list  # per request served: prefill wall seconds
    decode_s: list  # per request served: wall seconds of its decode steps
    logits_finite: bool  # every prefill and decode logit of every request


class RequestFn:
    """The function that serves one request on `model` with `params`: the
    prefill of a `prompt`-token prompt, then greedy decoding to `steps`
    new tokens; returns the (steps,) tokens as numpy.  A vlm model's
    request also carries (1, vision_patches, d_model) patch embeddings and
    an encdec model's (1, enc_positions, d_model) frame embeddings, drawn
    at each call from `rng` (standard normal, rounded to bfloat16, as the
    reference's `extras()` draws them); the vlm's decode positions count
    the patches first.  It keeps, per request served, the prefill's wall
    seconds (`prefill_s`) and those of its decode steps (`decode_s`), and
    counts non-finite logits on the device (`logits_finite`).
    `HedgedServer` and `FleetHedgedServer` take it as their `serve_fn`."""

    def __init__(self, model, params, prompt: int, steps: int, device, rng=None):
        cfg = model.config
        if rng is None and cfg.family in ("vlm", "encdec"):
            raise ValueError(f"the {cfg.family} family's requests draw their inputs from rng")
        self.model, self.params = model, params
        self.prompt, self.steps = prompt, steps
        self.device = torch.device(device)
        self.rng = rng
        # decode positions start after the prompt (and a vlm's patches)
        self.offset = prompt + (cfg.vision_patches if cfg.family == "vlm" else 0)
        self.prefill_s: list = []
        self.decode_s: list = []
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)  # summed on the device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def logits_finite(self) -> bool:
        return int(self._nonfinite) == 0

    def extras(self) -> dict:
        """The request's vision or encoder inputs, drawn from `rng`."""
        cfg = self.model.config
        shape = {"vlm": ("vision_embeds", cfg.vision_patches), "encdec": ("enc_embeds", cfg.enc_positions)}
        if cfg.family not in shape:
            return {}
        key, n = shape[cfg.family]
        draw = torch.from_numpy(self.rng.standard_normal((1, n, cfg.d_model)))
        return {key: draw.to(torch.bfloat16).to(self.device)}

    def __call__(self, prompt_tokens) -> np.ndarray:
        model, params = self.model, self.params
        tokens = torch.as_tensor(prompt_tokens, dtype=torch.int32, device=self.device)[None, :]
        batch = {"tokens": tokens, **self.extras()}
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch)
        self._nonfinite.add_((~torch.isfinite(logits)).sum())
        cache = model.grow_cache(cache, self.offset + self.steps)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        for i in range(self.steps - 1):
            logits, cache = model.decode_step(params, cache, tok, self.offset + i)
            self._nonfinite.add_((~torch.isfinite(logits)).sum())
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        result = torch.stack(out, dim=1)[0].cpu().numpy()
        self.prefill_s.append(t1 - t0)
        self.decode_s.append(time.perf_counter() - t1)
        return result


def run(args: argparse.Namespace, log=print) -> ServeRun:
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    # the prompts first, then each request's vision or encoder inputs as it
    # is served, from one generator, as the reference draws them
    rng = np.random.default_rng(args.seed)
    requests = [rng.integers(0, cfg.vocab, size=args.prompt) for _ in range(args.requests)]
    serve_request = RequestFn(model, params, args.prompt, args.steps, dev, rng)

    dist = Pareto(alpha=1.7, xm=0.040) if args.dist == "pareto" else ShiftedExp(0.04, 20.0)
    server = HedgedServer(
        SimCluster(4 * args.requests, dist, seed=args.seed, slow_fraction=0.08, slow_factor=12.0),
        serve_request,
        adapt=not args.no_adapt,
        policy=SingleForkPolicy(0.05, 1, True),
        device=dev,
    )
    width = "reduced" if args.reduced else "full"
    log(f"arch={cfg.arch_id} ({width}) on {dev}  {args.requests} req/batch x {args.batches} batches")
    log("batch  policy                          latency     p50     p99    cost")
    outputs, stats = [], []
    for b in range(args.batches):
        outs, st = server.serve_batch(requests)
        if not all(len(o) == args.steps for o in outs):
            raise RuntimeError(f"batch {b}: a request returned other than {args.steps} tokens")
        outputs.append(outs)
        stats.append(st)
        log(f"{b:5d}  {st.policy:30s} {st.latency:7.3f} {st.p50:7.3f} {st.p99:7.3f} {st.cost:7.3f}")
    return ServeRun(
        model, params, server, requests, outputs, stats, serve_request.prefill_s,
        serve_request.decode_s, serve_request.logits_finite,
    )


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
