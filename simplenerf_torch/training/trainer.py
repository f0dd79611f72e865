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
uninterrupted one. At `validation_interval` the trainer renders every
train (and validation) frame in eval mode and saves frames, depths, loss
maps and scalars under <run>/samples and the log; a `profiling`
{start_iter, num_iters} block traces that window of steps into
<run>/profile. Steps run one launch sequence each: there is no CUDA-graph
counterpart of the JAX package's multi-step scan.

With a `mesh` (parallel.make_mesh) the step is ray-sharded over the job's
processes, as the JAX Trainer's is over its mesh: every rank draws the
global indices and the global draws, renders its rows
(`parallel.process_local_rows`), divides its loss sums by the whole
batch's counts, and one all-reduce SUM of the flat gradient (FlatAdam)
gives each rank the one-process gradient; the loss values are summed the
same way. Parameters and Adam state are broadcast from rank 0 after init
or resume. Each process runs the same Trainer on an output directory of
its own (checkpoints, logs); processes must not share one.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from simplenerf_torch import config as config_lib
from simplenerf_torch.data import io
from simplenerf_torch.data.preprocessor import ScenePreprocessor, gather_batch
from simplenerf_torch.losses import LossComputer, LossContext
from simplenerf_torch.parallel import mesh as mesh_lib
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
    in place. With a `mesh`, the flat gradient is summed over its ranks
    first (the JAX step's gradient psum): each rank's loss is its share of
    the global loss, so the sum, not the mean, is the global gradient.
    """

    def __init__(self, lr_schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.lr_schedule, self.b1, self.b2, self.eps = lr_schedule, b1, b2, eps
        self.mesh = mesh

    def init(self, leaves: list) -> dict:
        size = sum(p.numel() for p in leaves)
        dev = leaves[0].device
        return {"count": 0, "mu": torch.zeros(size, device=dev), "nu": torch.zeros(size, device=dev)}

    @torch.no_grad()
    def gradient(self, leaves: list) -> torch.Tensor:
        """The step's flat gradient, summed over the mesh's ranks."""
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in leaves])
        return mesh_lib.all_reduce_sum(self.mesh, g)

    @torch.no_grad()
    def step(self, leaves: list, state: dict) -> dict:
        g = self.gradient(leaves)
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
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        self.configs = configs
        self.output_dir = Path(output_dir)
        self.train_pp = train_pp
        self.val_pp = val_pp
        self.device = train_pp.device
        self.mesh = mesh

        self.render_cfg = config_lib.render_config_from_dict(configs, compute_dtype)
        self.loss_computer = LossComputer(configs["losses"], loss_context_from_configs(configs))
        opt_cfg = configs["optimizer"]
        self.lr_schedule = make_lr_schedule(opt_cfg, configs.get("num_iterations", 0))
        self.opt = FlatAdam(self.lr_schedule, opt_cfg.get("beta1", 0.9), opt_cfg.get("beta2", 0.999),
                            mesh=mesh)

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
        # Every rank goes on from rank 0's iteration, parameters and Adam
        # state, whatever its own directory held.
        self.start_iter = mesh_lib.replicate(mesh, self.start_iter)
        mesh_lib.replicate(mesh, self.leaves)
        self.opt_state = mesh_lib.replicate(mesh, self.opt_state)
        # Replay the host-side sampler streams: the resumed run draws the
        # batches an uninterrupted run would.
        self.train_pp.fast_forward(self.start_iter)

        self.logger = TrainLogger(self.output_dir / "logs")
        self.steps_per_call = int(configs.get("steps_per_call", 1))
        self._consts = self.train_pp.batch_constants()
        self._layout = getattr(self.train_pp, "packed_layout", ())
        self._eval_step = build_eval_renderer(self.render_cfg)
        # Train frames are validated with sec_views_vis, like the
        # reference's `self.model(..., sec_views_vis=train_data)`; only a
        # visibility head makes that a different render.
        self._eval_step_vis = (
            build_eval_renderer(self.render_cfg, sec_views_vis=True)
            if self.render_cfg.predict_visibility
            else self._eval_step
        )

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
        """One train step on the given (global) ray indices; returns the
        loss values (device tensors). Draws default to the step's
        generator, drawn for the whole batch. The rank renders its rows of
        the batch and of the draws, divides by the whole batch's counts, and
        the loss values are summed over the ranks: without a mesh, or in a
        world of one, the rows are the batch and the sums are no-ops."""
        if not draws:
            draws = {"generator": self.step_generator(iter_num)}
        for p in self.leaves:
            p.grad = None
        counts = {"rows": len(indices), "indices_mask_nerf": int(mask_nerf.sum()),
                  "indices_mask_sparse_depth": int(mask_sd.sum())}
        generator = draws.pop("generator", None)
        if generator is not None:
            draws = renderer.step_draws(self.render_cfg, len(indices), generator, self.device, **draws)
        indices, mask_nerf, mask_sd, draws = mesh_lib.shard_ray_batch(
            self.mesh, (indices, mask_nerf, mask_sd, draws))
        batch = self.batch(indices, mask_nerf, mask_sd)
        batch["global_counts"] = counts
        total, values = self.loss(batch, iter_num, **draws)
        total.backward()
        self.opt_state = self.opt.step(self.leaves, self.opt_state)
        stacked = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device).detach()
                               for v in values.values()])
        return dict(zip(values, mesh_lib.all_reduce_sum(self.mesh, stacked).unbind()))

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
        val_interval = self.configs.get("validation_interval", 0)
        save_interval = self.configs.get("model_save_interval", 10000)
        log_interval = self.configs.get("log_interval", 100)
        # Optional trace window {"start_iter": N, "num_iters": K}: steps
        # N..N+K-1 under torch.profiler, written to <run>/profile.
        prof_cfg = self.configs.get("profiling") or {}
        prof_start = int(prof_cfg.get("start_iter", -1))
        prof_iters = int(prof_cfg.get("num_iters", 0))
        prof_ctx = None
        values: dict = {}
        t_last = time.time()
        iters_since_log = 0
        pp = self.train_pp
        rays_per_iter = pp.num_rays + getattr(pp, "num_rays_sparse_depth", 0)
        timer = profiling.StepTimer(rays_per_step=rays_per_iter)
        timer.tick(0)
        it = self.start_iter
        try:
            while it < num_iterations:
                if prof_iters and it == prof_start and prof_ctx is None:
                    prof_ctx = profiling.trace(self.output_dir / "profile", self.device)
                    prof_ctx.__enter__()
                chunk = max(1, min(self.steps_per_call, self._next_boundary(it, num_iterations) - it))
                if prof_ctx is not None:
                    chunk = max(1, min(chunk, prof_start + prof_iters - it))
                values = self.train_many(it, chunk)
                it += chunk
                iters_since_log += chunk
                if prof_ctx is not None and it >= prof_start + prof_iters:
                    prof_ctx.__exit__(None, None, None)
                    prof_ctx = None
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
                if val_interval and it % val_interval == 0:
                    self.run_validation(it)
                if it % save_interval == 0 or it == num_iterations:
                    self.save_checkpoint(it)
        finally:
            if prof_ctx is not None:  # the run ended inside the trace window
                prof_ctx.__exit__(None, None, None)
        if timer.stats():
            timer.dump(self.output_dir / "logs/step_timing.json")
        return values

    def save_checkpoint(self, iteration: int):
        checkpoints.save_checkpoint(
            self.output_dir / "saved_models", iteration, self.params, self.opt_state
        )

    @torch.no_grad()
    def run_validation(self, iteration: int):
        """Reference-style validation, as the JAX Trainer's `run_validation`.

        Renders every frame of the train preprocessor (and of `val_pp`) in
        eval mode, computes the full configured loss set on each rendered
        frame (losses whose inputs exist only in training batches give 0),
        saves per-level frames, depths and depth variances (and their NDC
        variants) under <run>/samples, the predicted visibilities when a
        visibility head exists, and with `validation_save_loss_maps` every
        per-ray loss map as (h, w) npy + png under samples/Losses. Logs the
        per-loss means over frames as validation/{train,val}_images/<loss>
        and the mean of the per-frame PSNRs as .../psnr."""
        chunk = self.configs.get("validation_chunk_size", 64 * 1024)
        save_loss_maps = bool(self.configs.get("validation_save_loss_maps", False))
        weights = self.loss_computer.weights_vector(iteration).tolist()
        samples_dir = self.output_dir / "samples"
        jobs = [("train_images", self.train_pp, True)]
        if self.val_pp is not None:
            jobs.append(("val_images", self.val_pp, False))

        def host(t):
            return t.detach().float().cpu().numpy()

        for tag, pp, is_train_data in jobs:
            h, w = pp.resolution
            eval_step = self._eval_step_vis if is_train_data else self._eval_step
            frame_nums = [int(f) for f in pp.frame_nums]
            totals: dict = {}
            psnr_sum = 0.0
            for frame_num in frame_nums:
                indices, mask_nerf, _ = pp.next_indices(0, image_num=frame_num)
                batch = gather_batch(
                    pp.cache, pp.common, pp.batch_constants(),
                    torch.as_tensor(indices, device=pp.device),
                    torch.as_tensor(mask_nerf, device=pp.device), None,
                )
                outputs = render_in_chunks(eval_step, self.params, batch, chunk)
                maps: dict = {}
                if save_loss_maps:
                    _, values, maps = self.loss_computer.compute(
                        batch, outputs, weights, return_loss_maps=True)
                else:
                    _, values = self.loss_computer.compute(batch, outputs, weights)
                for name, v in values.items():
                    totals[name] = totals.get(name, 0.0) + float(v)
                finest = "fine" if "rgb_fine" in outputs else "coarse"
                target = pp.images[np.where(pp.frame_nums == frame_num)[0].item()]
                pred = host(outputs[f"rgb_{finest}"]).reshape(h, w, 3)
                frame_mse = float(np.mean((pred - target) ** 2))
                # Mean of per-frame PSNRs (the QA suite's aggregation), not
                # the PSNR of the mean MSE.
                psnr_sum += -10.0 * np.log10(max(frame_mse, 1e-12))

                stem = f"{frame_num:04}_{{}}_Iter{iteration:05}"
                for mode in ("coarse", "fine"):
                    if f"rgb_{mode}" not in outputs:
                        continue
                    name = stem.format(mode)
                    pred = host(outputs[f"rgb_{mode}"]).reshape(h, w, 3)
                    io.write_image(samples_dir / f"predicted_frames/{name}.png",
                                   np.round(np.clip(pred, 0, 1) * 255).astype(np.uint8))
                    io.write_depth(samples_dir / f"predicted_depths/{name}",
                                   host(outputs[f"depth_{mode}"]).reshape(h, w))
                    io.write_depth(samples_dir / f"predicted_depths_variance/{name}",
                                   host(outputs[f"depth_var_{mode}"]).reshape(h, w))
                    for ndc_key, sub in ((f"depth_ndc_{mode}", "predicted_depths"),
                                         (f"depth_var_ndc_{mode}", "predicted_depths_variance")):
                        if ndc_key in outputs:
                            io.write_depth(samples_dir / f"{sub}/{stem.format(mode + '_ndc')}",
                                           host(outputs[ndc_key]).reshape(h, w))
                    vis2_key = f"visibility2_{mode}"
                    if vis2_key in outputs:
                        vis2 = host(outputs[vis2_key])
                        others = [f for f in frame_nums if f != frame_num]
                        for j, sec in enumerate(others[: vis2.shape[1]]):
                            io.write_depth(
                                samples_dir / f"predicted_visibilities/"
                                f"{frame_num:04}_{sec:04}_{mode}_Iter{iteration:05}",
                                vis2[:, j].reshape(h, w),
                            )
                for map_name, loss_map in maps.items():
                    io.write_depth(samples_dir / f"Losses/{map_name}_{frame_num:04}_Iter{iteration:05}",
                                   host(loss_map).reshape(h, w))

            n = max(len(frame_nums), 1)
            scalars = {f"validation/{tag}/{k}": v / n for k, v in totals.items()}
            scalars[f"validation/{tag}/psnr"] = psnr_sum / n
            self.logger.log_scalars(iteration, scalars)


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
