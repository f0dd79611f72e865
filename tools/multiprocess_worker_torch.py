#!/usr/bin/env python3
"""One rank of a ray-sharded training job of simplenerf_torch.

Launched once per rank with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); the parallel tests
(tests/test_torch_port_parallel.py) launch it on the CPU with gloo and
chip_smoke.py's phase `parallel` on the card. Imports torch and the port
only. Each rank joins through `parallel.initialize_distributed`, builds
`parallel.make_mesh()` and trains up to `--steps` through
`runner.start_training(cfg, db, <out>/rank<r>, mesh=mesh)`, the entry
point a user calls; where the config resumes, it goes on from the
checkpoint under <out>/rank<r> (a test starts from given parameters by
writing one there at iteration 0).

With `--steps-per-call k` the run goes in chunks of k steps, logged at
each chunk's end; on a card, in a world of one, each chunk replays one
CUDA graph of the step (`Trainer.train_many`).

Every rank writes `<dump>.rank<r>.npz`: the flat parameters, Adam's mu,
nu and count after the last step, step 1's flat gradient (summed over the
ranks), the logged steps (`iters`) and their loss values (`names`,
`values`), each step's host stage on the host clock (`t`), and the four
kernels' launch counters over the run.

    RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python tools/multiprocess_worker_torch.py --config cfg.json --db DB \\
        --out OUT --steps 6 --dump OUT/run
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from simplenerf_torch import parallel  # noqa: E402
from simplenerf_torch.drivers import runner  # noqa: E402
from simplenerf_torch.ops import fused_mlp  # noqa: E402
from simplenerf_torch.training import trainer as trainer_lib  # noqa: E402

COUNTERS = ("fused_apply_ensemble", "fused_ens_bwd", "fused_apply", "fused_bwd", "pe_operands")


def record_trainer(rec: dict):
    """Keep, from this process's Trainer, step 1's flat gradient (step 1
    runs eagerly in either path), the Trainer itself and each step's host
    stage time."""
    gradient, stage, train = (trainer_lib.FlatAdam.gradient, trainer_lib.Trainer.stage,
                              trainer_lib.Trainer.train)

    def recorded_gradient(self, leaves):
        g = gradient(self, leaves)
        if "grad1" not in rec:
            rec["grad1"] = g.detach().cpu().numpy().copy()
        return g

    def recorded_stage(self, iter_num):
        rec.setdefault("t", []).append(time.perf_counter())
        return stage(self, iter_num)

    def recorded_train(self, *args, **kwargs):
        rec["trainer"] = self
        return train(self, *args, **kwargs)

    trainer_lib.FlatAdam.gradient = recorded_gradient
    trainer_lib.Trainer.stage = recorded_stage
    trainer_lib.Trainer.train = recorded_train


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=Path, required=True, help="the run's config (JSON)")
    ap.add_argument("--db", type=Path, required=True, help="the scene database")
    ap.add_argument("--out", type=Path, required=True, help="ranks train into <out>/rank<r>")
    ap.add_argument("--steps", type=int, required=True, help="train up to this iteration")
    ap.add_argument("--dump", type=Path, required=True, help="writes <dump>.rank<r>.npz")
    ap.add_argument("--device", default=None, help="cpu, cuda or cuda:<i> (default: the card)")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="train in chunks of this many steps, logged at each chunk's end")
    args = ap.parse_args()

    device = parallel.initialize_distributed(args.device, backend=args.backend)
    if device is None:
        raise SystemExit("no torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    mesh = parallel.make_mesh()
    cfg = json.loads(args.config.read_text())
    out = args.out / f"rank{mesh.rank}"
    rec: dict = {}
    record_trainer(rec)
    before = fused_mlp.launch_counts()

    cfg["num_iterations"] = args.steps
    cfg["steps_per_call"] = cfg["log_interval"] = args.steps_per_call
    run_dir = runner.start_training(cfg, args.db, out, mesh=mesh)
    (log,) = run_dir.glob("*/logs/scalars.jsonl")  # one scene
    rows = [r for r in map(json.loads, log.read_text().splitlines()) if "TotalLoss" in r]
    names = [k for k in rows[0]  # the loss values: no bookkeeping, no device spans
             if k not in ("iter", "time", "lr", "rays_per_s") and not k.startswith("device_ms/")]
    values = [[r[k] for k in names] for r in rows]

    if device.type == "cuda":
        torch.cuda.synchronize()
    trainer = rec["trainer"]
    state = trainer.opt_state
    np.savez(
        f"{args.dump}.rank{mesh.rank}.npz",
        params=torch.cat([p.detach().reshape(-1) for p in trainer.leaves]).cpu().numpy(),
        mu=state["mu"].cpu().numpy(), nu=state["nu"].cpu().numpy(), count=state["count"],
        grad1=rec.get("grad1", np.zeros(0, np.float32)), names=np.array(names),
        iters=np.array([r["iter"] for r in rows]), values=np.array(values, np.float64),
        t=np.array(rec["t"]),
        launches=json.dumps({n: c - before[n] for n, c in fused_mlp.launch_counts().items()
                             if n in COUNTERS}),
        world_size=mesh.world_size,
    )
    torch.distributed.destroy_process_group()
    print(f"RANK {mesh.rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
