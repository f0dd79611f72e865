"""Training harness: one train step per iteration, driven by a host loop.

Port of simplenerf_tpu/training/trainer.py. Per iteration the host draws
ray indices and the loss-schedule weights; the device runs gather ->
render (all MLPs, the coarse trio through the ensemble kernels and the
fine MLP through the single-MLP kernels) -> the loss stack -> backward ->
Adam. Adam runs over ONE flat float32 vector of all parameters in
`jax.flatten_util.ravel_pytree` order, with optax's semantics, so its
state checkpoints in the JAX package's layout.

Each step draws its randomness (jitter, importance uniforms, sigma noise)
from a generator on the device seeded from (seed, iteration), and the
host-side samplers are replayed on resume, so a resumed run equals an
uninterrupted one. Validation renders, CUDA-graph multi-step calls and
profiler traces are not ported yet.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from simplenerf_torch import config as config_lib
from simplenerf_torch.data.preprocessor import ScenePreprocessor, gather_batch
from simplenerf_torch.losses import LossComputer, LossContext
from simplenerf_torch.render import renderer
from simplenerf_torch.training import checkpoints
from simplenerf_torch.training.logger import TrainLogger
from simplenerf_torch.training.lr_decay import make_lr_schedule
from simplenerf_torch.utils import profiling


def loss_context_from_configs(configs: dict) -> LossContext:
    model = configs["model"]
    return LossContext(
        points_aug_fine="fine_mlp" in model.get("points_augmentation", {}),
        views_aug_fine="fine_mlp" in model.get("views_augmentation", {}),
        sparse_depth_enabled="sparse_depth" in configs["data_loader"],
    )


class FlatAdam:
    """optax.adam over one flat vector of every parameter.

    b1/b2 from the config, eps 1e-8, eps_root 0; moments
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu; bias correction
    with count + 1; the step is -lr(count) * mu_hat / (sqrt(nu_hat) + eps)
    with lr taken before the count is incremented. Parameters are updated
    in place.
    """

    def __init__(self, lr_schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr_schedule, self.b1, self.b2, self.eps = lr_schedule, b1, b2, eps

    def init(self, leaves: list) -> dict:
        size = sum(p.numel() for p in leaves)
        dev = leaves[0].device
        return {"count": 0, "mu": torch.zeros(size, device=dev), "nu": torch.zeros(size, device=dev)}

    @torch.no_grad()
    def step(self, leaves: list, state: dict) -> dict:
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in leaves])
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * torch.square(g) + b2 * state["nu"]
        count = state["count"] + 1
        mu_hat = mu / (1 - b1**count)
        nu_hat = nu / (1 - b2**count)
        update = -self.lr_schedule(state["count"]) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        pos = 0
        for p in leaves:
            p.add_(update[pos : pos + p.numel()].view_as(p))
            pos += p.numel()
        return {"count": count, "mu": mu, "nu": nu}


def _leaf_params(tree):
    """The params tree with every tensor a float32 leaf that requires grad."""
    if isinstance(tree, dict):
        return {k: _leaf_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaf_params(v) for v in tree]
    return tree.detach().float().clone().requires_grad_()


class Trainer:
    def __init__(
        self,
        configs: dict,
        output_dir: Path,
        train_pp: ScenePreprocessor,
        val_pp: Optional[ScenePreprocessor] = None,
        compute_dtype: Optional[str] = None,
    ):
        if configs.get("validation_interval", 0):
            raise NotImplementedError("validation renders are not ported yet; "
                                      "set validation_interval to 0")
        self.configs = configs
        self.output_dir = Path(output_dir)
        self.train_pp = train_pp
        self.val_pp = val_pp
        self.device = train_pp.device

        self.render_cfg = config_lib.render_config_from_dict(configs, compute_dtype)
        self.loss_computer = LossComputer(configs["losses"], loss_context_from_configs(configs))
        opt_cfg = configs["optimizer"]
        self.lr_schedule = make_lr_schedule(opt_cfg, configs.get("num_iterations", 0))
        self.opt = FlatAdam(self.lr_schedule, opt_cfg.get("beta1", 0.9), opt_cfg.get("beta2", 0.999))

        self.seed = int(configs.get("seed", 0))
        init = renderer.init(torch.Generator().manual_seed(self.seed), self.render_cfg, self.device)
        self.set_params(init)
        self.start_iter = 0
        if configs.get("resume_training", True):
            latest = checkpoints.latest_checkpoint(self.output_dir / "saved_models")
            if latest is not None:
                self.start_iter, params, raw_opt = checkpoints.load_checkpoint(
                    latest, self.params, self.device
                )
                self.set_params(params)
                if raw_opt is not None:
                    opt = checkpoints.opt_state_from_state(raw_opt, self.params, self.device)
                    if opt is not None:  # else fresh state (warned)
                        self.opt_state = opt
                # Replay the host-side sampler streams: the resumed run draws
                # the batches an uninterrupted run would.
                self.train_pp.fast_forward(self.start_iter)

        self.logger = TrainLogger(self.output_dir / "logs")
        self.steps_per_call = int(configs.get("steps_per_call", 1))
        self._consts = self.train_pp.batch_constants()
        self._layout = getattr(self.train_pp, "packed_layout", ())

    def set_params(self, params):
        """Take `params` (a canonical tree) as the trained parameters, with a
        fresh optimizer state."""
        self.params = _leaf_params(params)
        self.leaves = checkpoints.flat_leaves(self.params)
        self.opt_state = self.opt.init(self.leaves)

    # ------------------------------------------------------------------
    def step_generator(self, iter_num: int) -> torch.Generator:
        """The step's generator on the device, seeded from (seed, iteration)."""
        return torch.Generator(device=self.device).manual_seed(self.seed * 2**32 + int(iter_num))

    def batch(self, indices, mask_nerf, mask_sd) -> dict:
        pp = self.train_pp
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        return gather_batch(pp.cache, pp.common, self._consts, t(indices), t(mask_nerf),
                            t(mask_sd), packed_layout=self._layout)

    def loss(self, batch: dict, iter_num: int, **draws):
        """Render the batch in train mode and apply the loss stack: (total,
        values). `draws` go to `render_rays` (generator or explicit draws)."""
        outputs = renderer.render_rays(self.params, self.render_cfg, batch, train=True, **draws)
        weights = self.loss_computer.weights_vector(iter_num).tolist()
        return self.loss_computer.compute(batch, outputs, weights)

    def step(self, iter_num: int, indices, mask_nerf, mask_sd, **draws) -> dict:
        """One train step on the given ray indices; returns the loss values
        (device tensors). Draws default to the step's generator."""
        if not draws:
            draws = {"generator": self.step_generator(iter_num)}
        for p in self.leaves:
            p.grad = None
        total, values = self.loss(self.batch(indices, mask_nerf, mask_sd), iter_num, **draws)
        total.backward()
        self.opt_state = self.opt.step(self.leaves, self.opt_state)
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in values.items()}

    def train_one_iter(self, iter_num: int) -> dict:
        return self.step(iter_num, *self.train_pp.next_indices(iter_num))

    def train_many(self, start_iter: int, k: int) -> dict:
        """k steps in a plain loop; returns the last step's loss values."""
        values = {}
        for j in range(k):
            values = self.train_one_iter(start_iter + j)
        return values

    def _next_boundary(self, it: int, num_iterations: int) -> int:
        """Largest chunk from `it` that crosses no log/val/save boundary."""
        nxt = num_iterations
        for interval in (
            self.configs.get("log_interval", 100),
            self.configs.get("validation_interval", 0),
            self.configs.get("model_save_interval", 10000),
        ):
            if interval:
                nxt = min(nxt, ((it // interval) + 1) * interval)
        return nxt

    def train(self, num_iterations: Optional[int] = None) -> dict:
        num_iterations = num_iterations or self.configs["num_iterations"]
        save_interval = self.configs.get("model_save_interval", 10000)
        log_interval = self.configs.get("log_interval", 100)
        values: dict = {}
        t_last = time.time()
        iters_since_log = 0
        pp = self.train_pp
        rays_per_iter = pp.num_rays + getattr(pp, "num_rays_sparse_depth", 0)
        timer = profiling.StepTimer(rays_per_step=rays_per_iter)
        timer.tick(0)
        it = self.start_iter
        while it < num_iterations:
            chunk = max(1, min(self.steps_per_call, self._next_boundary(it, num_iterations) - it))
            values = self.train_many(it, chunk)
            it += chunk
            iters_since_log += chunk
            if it % log_interval == 0 or it == num_iterations:
                values = {k: float(v) for k, v in values.items()}  # synchronizes
                dt = time.time() - t_last
                timer.tick(iters_since_log)
                scalars = dict(values)
                scalars["lr"] = float(self.lr_schedule(it - 1))
                scalars["rays_per_s"] = rays_per_iter * iters_since_log / max(dt, 1e-9)
                self.logger.log_scalars(it, scalars)
                t_last = time.time()
                iters_since_log = 0
            if it % save_interval == 0 or it == num_iterations:
                self.save_checkpoint(it)
        if timer.stats():
            timer.dump(self.output_dir / "logs/step_timing.json")
        return values

    def save_checkpoint(self, iteration: int):
        checkpoints.save_checkpoint(
            self.output_dir / "saved_models", iteration, self.params, self.opt_state
        )


RAY_KEYS = (
    "rays_o", "rays_d", "view_dirs", "near", "far",
    "rays_o_ndc", "rays_d_ndc", "near_ndc", "far_ndc", "rays_o2",
)


def build_eval_renderer(render_cfg: renderer.RenderConfig, sec_views_vis: bool = False):
    """Deterministic eval render of one ray chunk: (params, rays) -> outputs."""

    def render_chunk(params, ray_chunk: dict) -> dict:
        return renderer.render_rays(
            params, render_cfg, ray_chunk, train=False, keep_per_sample=False,
            sec_views_vis=sec_views_vis,
        )

    return render_chunk


def render_in_chunks(eval_step, params, ray_batch: dict, chunk: int) -> dict:
    """Full-image render: pad the rays to a chunk multiple (repeating the last
    ray), render chunk by chunk under no_grad, concatenate, trim."""
    rays = {k: v for k, v in ray_batch.items() if k in RAY_KEYS}
    nr = rays["rays_o"].shape[0]
    chunk = min(chunk, max(-(-nr // 256) * 256, 256))
    num_chunks = -(-nr // chunk)
    padded = num_chunks * chunk
    if padded != nr:
        rays = {
            k: torch.cat([v, v[-1:].expand(padded - nr, *v.shape[1:])]) for k, v in rays.items()
        }
    parts: dict = {}
    with torch.no_grad():
        for i in range(num_chunks):
            chunk_rays = {k: v[i * chunk : (i + 1) * chunk] for k, v in rays.items()}
            for k, v in eval_step(params, chunk_rays).items():
                parts.setdefault(k, []).append(v)
    return {k: torch.cat(v)[:nr] for k, v in parts.items()}
