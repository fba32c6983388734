"""Hedged decoding on the PyTorch port: serve batched generation requests
with single-fork request hedging; the policy adapts online from measured
latencies.

    PYTHONPATH=src python examples/torch_hedged_serving.py [--quick]               # on the card
    PYTHONPATH=src python examples/torch_hedged_serving.py --quick --device cpu

The port's counterpart of ``examples/hedged_serving.py``: real model decode
(reduced qwen2-0.5b with seed-0 random weights, bfloat16: a prefill of 12
prompt tokens, then 8 greedy tokens, through `launch.serve.RequestFn`)
under simulated per-replica server latency (Pareto tail, 8% of workers 12×
slow), through `runtime.HedgedServer` on a `runtime.SimCluster`.  It shows
p50/p99 and cost against the no-hedging baseline, and the policy the
controller converges to; asserted: every request returns its 8 tokens
with finite logits, and on the card every prefill's attention ran the
CUDA flash-attention kernel (the config's attention route is the
kernel's).  Without ``--device`` the model runs on the card (it raises
where there is none).  `--quick` serves 2 batches of 8 requests a server,
not 3 of 24.
"""

import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.core import Pareto, SingleForkPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.serve import RequestFn
from repro_torch.models.lm import build_model
from repro_torch.runtime import HedgedServer, SimCluster

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--quick", action="store_true", help="2 batches of 8 requests a server")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()
DEVICE = resolve_device(args.device)
PROMPT, STEPS = 12, 8
N_REQUESTS, N_BATCHES = (8, 2) if args.quick else (24, 3)

cfg = get_reduced("qwen2-0.5b")
model = build_model(cfg)
params = model.init(seed=0, device=DEVICE)
serve_request = RequestFn(model, params, PROMPT, STEPS, DEVICE)

latency_dist = Pareto(alpha=1.7, xm=0.040)  # 40 ms floor, heavy tail
rng = np.random.default_rng(0)
requests = [rng.integers(0, cfg.vocab, size=PROMPT) for _ in range(N_REQUESTS)]

print(f"reduced {cfg.arch_id} ({cfg.n_layers} layers, d_model {cfg.d_model}, attention {cfg.attn_impl!r}) "
      f"on {DEVICE}; {N_REQUESTS} requests a batch")
print("batch     policy                        latency    p50     p99    cost")
launches = ops.flash_attention.launches
for label, adapt, policy in (("plain", False, SingleForkPolicy(0.0, 0, True)),
                             ("hedged", True, SingleForkPolicy(0.05, 1, True))):
    server = HedgedServer(SimCluster(96, latency_dist, seed=7, slow_fraction=0.08, slow_factor=12.0),
                          serve_request, adapt=adapt, policy=policy, device=DEVICE)
    for i in range(N_BATCHES):
        outs, stats = server.serve_batch(requests)
        print(f"{label}-{i}  {stats.policy:28s} {stats.latency:7.3f} {stats.p50:7.3f} {stats.p99:7.3f} "
              f"{stats.cost:7.3f}")
        assert all(len(o) == STEPS for o in outs)
assert serve_request.logits_finite, "every prefill and decode logit must be finite"
prefills = len(serve_request.prefill_s)
launched = ops.flash_attention.launches - launches
if DEVICE.type == "cuda" and cfg.attn_impl == "kernel":
    assert launched == cfg.n_layers * prefills, (launched, cfg.n_layers, prefills)
print(f"\n{prefills} requests served (a hedged request may run twice); flash-attention kernel launches: "
      f"{launched}{'' if DEVICE.type == 'cuda' else ' (the CPU runs its plain version)'}; prefill "
      f"median {1e3 * float(np.median(serve_request.prefill_s)):.1f} ms, decode median "
      f"{1e3 * float(np.median(serve_request.decode_s)):.1f} ms for {STEPS - 1} steps")
