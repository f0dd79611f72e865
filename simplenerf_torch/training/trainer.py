"""Training harness: train steps driven by a host loop or replayed as one CUDA graph.

Port of simplenerf_tpu/training/trainer.py. A step is two parts. The host
stage (`Trainer.stage`) draws the ray indices and masks, the loss-schedule
weights, Adam's scalars and the step's render draws and writes them into
persistent tensors on the device (`StepInputs`); the device body
(`Trainer.body`) reads only those and runs gather -> render (all MLPs, the
coarse trio through the ensemble kernels and the fine MLP through the
single-MLP kernels) -> the loss stack -> backward -> Adam. Adam runs over
ONE flat float32 vector of all parameters in `jax.flatten_util.ravel_pytree`
order, with optax's semantics, in place, so its state checkpoints in the
JAX package's layout.

`train_one_iter` runs a stage and the body eagerly. On a card,
`train_many(start, k)` with k > 1 replays one CUDA graph of the body, the
counterpart of the JAX package's multi-step scan (`StepGraph`; the rules
are in its docstring). Both run the one body on the same inputs.

Each step draws its randomness (jitter, importance uniforms, sigma noise)
from a generator on the device seeded from (seed, iteration), and the
host-side samplers are replayed on resume, so a resumed run equals an
uninterrupted one. At `validation_interval` the trainer renders every
train (and validation) frame in eval mode and saves frames, depths, loss
maps and scalars under <run>/samples and the log; a `profiling`
{start_iter, num_iters} block traces that window of steps into
<run>/profile.

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
from simplenerf_torch.ops import fused_mlp
from simplenerf_torch.parallel import mesh as mesh_lib
from simplenerf_torch.render import mip, renderer
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
    with lr taken before the count is incremented. The host computes a
    step's lr and bias corrections (`scalars`) and advances the count, a
    host int; `step` reads the scalars from a device tensor and updates the
    moments and the parameters in place, so a captured step replays with
    each step's values. With a `mesh`, the flat gradient is summed over its
    ranks first (the JAX step's gradient psum): each rank's loss is its
    share of the global loss, so the sum, not the mean, is the global
    gradient.
    """

    def __init__(self, lr_schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.lr_schedule, self.b1, self.b2, self.eps = lr_schedule, b1, b2, eps
        self.mesh = mesh

    def init(self, leaves: list) -> dict:
        size = sum(p.numel() for p in leaves)
        dev = leaves[0].device
        return {"count": 0, "mu": torch.zeros(size, device=dev), "nu": torch.zeros(size, device=dev)}

    def scalars(self, count: int) -> np.ndarray:
        """The step after `count` steps: [lr(count), 1 - b1**(count + 1),
        1 - b2**(count + 1)], computed in float64 and stored as float32."""
        c = count + 1
        return np.array([self.lr_schedule(count), 1 - self.b1**c, 1 - self.b2**c]).astype(np.float32)

    @torch.no_grad()
    def gradient(self, leaves: list) -> torch.Tensor:
        """The step's flat gradient, summed over the mesh's ranks."""
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in leaves])
        return mesh_lib.all_reduce_sum(self.mesh, g)

    @torch.no_grad()
    def step(self, leaves: list, state: dict, scalars: torch.Tensor):
        """One step in place on `state`'s moments and the parameters, with
        `scalars` the device tensor of this step's `scalars(count)`. The
        count is the host stage's (`Trainer.stage`)."""
        g = self.gradient(leaves)
        b1, b2 = self.b1, self.b2
        mu, nu = state["mu"], state["nu"]
        lr, bc1, bc2 = scalars.unbind()
        torch.add((1 - b1) * g, b1 * mu, out=mu)
        torch.add((1 - b2) * torch.square(g), b2 * nu, out=nu)
        update = -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
        pos = 0
        for p in leaves:
            p.add_(update[pos : pos + p.numel()].view_as(p))
            pos += p.numel()


def _leaf_params(tree):
    """The params tree with every tensor a float32 leaf that requires grad."""
    if isinstance(tree, dict):
        return {k: _leaf_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaf_params(v) for v in tree]
    return tree.detach().float().clone().requires_grad_()


def _clone_draws(draws):
    """A copy of render_rays' draws {u_coarse, u_fine, noise: {...}} (None kept)."""
    if isinstance(draws, dict):
        return {k: _clone_draws(v) for k, v in draws.items()}
    return None if draws is None else draws.clone()


def _copy_draws(dst, src):
    """Copy the draws `src` into the buffers `dst` of the same structure."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_draws(dst[k], src[k])
    elif dst is not None:
        dst.copy_(src)


class StepInputs:
    """One train step's inputs in persistent tensors on the step's device.

    The host stage (`Trainer.stage`) writes them before each step and the
    step body (`Trainer.body`) reads them, so the loop and a CUDA graph of
    the body run one body on the same inputs. The ray indices (int32) and
    their masks (bool), the loss weights and Adam's scalars (float32) share
    one byte buffer that one copy fills, non-blocking from pinned memory on
    a card, and so do FreeNeRF's frequency masks (`freq_mask`, n_mask
    float32, None without); the render draws have a buffer each. `counts`
    are the host ints the loss stack branches on
    (`losses.common.global_count`).
    """

    def __init__(self, nr: int, n_losses: int, draws: dict, device: torch.device, n_mask: int = 0):
        self.nr, self.n_losses, self.n_mask = nr, n_losses, n_mask
        nbytes = 4 * (nr + n_losses + 3 + n_mask) + 2 * nr
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.host = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     if self.dev.is_cuda else self.dev)
        self._copied = None  # an event after the last copy out of `host`
        (self.indices, self.weights, self.adam, self.mask_nerf, self.mask_sd,
         freq) = self._views(self.dev)
        self.freq_mask = freq if n_mask else None
        self.draws = _clone_draws(draws)
        self.counts: dict = {}

    def _views(self, buf: torch.Tensor) -> tuple:
        a, b, c = 4 * self.nr, 4 * (self.nr + self.n_losses), 4 * (self.nr + self.n_losses + 3)
        m = c + 4 * self.n_mask
        return (buf[:a].view(torch.int32), buf[a:b].view(torch.float32),
                buf[b:c].view(torch.float32), buf[m : m + self.nr].view(torch.bool),
                buf[m + self.nr :].view(torch.bool), buf[c:m].view(torch.float32))

    def write(self, indices, mask_nerf, mask_sd, weights, adam, draws: dict, counts: dict,
              freq_mask=None):
        """Write a step's numpy arrays and its draws (tensors shaped as the
        buffers) in stream order: the previous copy out of the pinned
        buffer is waited for before the host overwrites it."""
        if self._copied is not None:
            with profiling.span("train.stage.wait"):
                self._copied.synchronize()
        arrays = (indices, weights, adam, mask_nerf, mask_sd, freq_mask)
        for view, a in zip(self._views(self.host), arrays[: 5 + bool(self.n_mask)]):
            view.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        if self.host is not self.dev:
            self.dev.copy_(self.host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        _copy_draws(self.draws, draws)
        self.counts = counts


def graph_capable(device: torch.device, mesh: Optional[mesh_lib.Mesh]) -> bool:
    """Whether `Trainer.train_many` may replay a CUDA graph of the step:
    on a card, without a mesh or on a mesh of one rank (see train_many)."""
    return device.type == "cuda" and (mesh is None or mesh.world_size == 1)


class StepGraph:
    """A train step's device body as one CUDA graph.

    Runs `fn` once eagerly on a side stream, as the step it was staged for
    (the warm-up: it builds the kernels, caches their plans and those
    plans' one-time copies, sets the kernels' shared-memory limits and
    gives cuBLAS its workspace on that stream), then captures `fn` on the
    same stream into the graph's private memory pool. `replay` runs the
    captured body on the current stream; `out` is the body's output,
    which each replay overwrites. The capture launches nothing, so the
    kernels' launch counters (`fused_mlp.launch_counts`) are set back
    after it and gain what it counted at each replay. The body's device
    spans become the graph's markers (`profiling.capturing`), timed again
    by every replay (`profiling.replay_ms`). `capture_s`: the capture's
    host-clock seconds (its span, `train.capture`). A capture that fails
    raises.
    """

    def __init__(self, fn, device: torch.device):
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn()
        self.graph = torch.cuda.CUDAGraph()
        before = fused_mlp.launch_counts()
        with profiling.capturing() as self.markers:
            with profiling.span("train.capture") as captured, torch.cuda.graph(self.graph,
                                                                                 stream=stream):
                self.out = fn()
        self.capture_s = captured.seconds
        self.launches = {k: n - before[k] for k, n in fused_mlp.launch_counts().items()}
        fused_mlp.add_launches({k: -n for k, n in self.launches.items()})

    def replay(self):
        with profiling.span("train.replay"):
            self.graph.replay()
        fused_mlp.add_launches(self.launches)
        profiling.replayed(self.markers)


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
        self.use_graph = graph_capable(self.device, mesh)
        self._graph: Optional[StepGraph] = None
        self._graph_counts: dict = {}
        self._inputs: Optional[StepInputs] = None

        self.render_cfg = config_lib.render_config_from_dict(configs, compute_dtype)
        # ViP-NeRF's prior: the step renders each ray's secondary views
        # (`rays_o2`, its frame's other train cameras) so that
        # VisibilityPriorLoss01 trains; off, the step renders none.
        self.train_sec_views = bool(configs["model"].get("train_secondary_views", False))
        # FreeNeRF: the points and views frequency masks of each step, all
        # ones from `freq_reg_end` on (`render.mip.step_masks`).
        self.freq_reg_end = configs["model"].get("freq_reg_end")
        # The last step's secondary visibility by output name
        # (`visibility2_coarse`, `visibility2_fine`: (rows, k)), detached;
        # under a CUDA graph the graph's buffers, which each replay rewrites.
        self.step_visibility2: dict = {}
        # mip-NeRF's step: its per-interval densities and IPE operands by
        # output name (`density_coarse`, `density_fine`: (rows, intervals);
        # `ipe_coarse`, `ipe_fine`: (rows x intervals, channels)), as above.
        self.step_mip: dict = {}
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
                        self.opt_state["count"] = opt["count"]
                        self.opt_state["mu"].copy_(opt["mu"])
                        self.opt_state["nu"].copy_(opt["nu"])
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
        fresh optimizer state; drops a captured step (`StepGraph`), which
        holds the old tensors."""
        self._graph = None
        self.params = _leaf_params(params)
        self.leaves = checkpoints.flat_leaves(self.params)
        self.opt_state = self.opt.init(self.leaves)

    # ------------------------------------------------------------------
    def step_generator(self, iter_num: int) -> torch.Generator:
        """The step's generator on the device, seeded from (seed, iteration)."""
        return torch.Generator(device=self.device).manual_seed(self.seed * 2**32 + int(iter_num))

    def freq_mask(self, iter_num: int):
        """The step's frequency masks (numpy float32), or None without."""
        mcfg = self.render_cfg.shared_mlp
        if mcfg is None or self.freq_reg_end is None:
            return None
        return mip.step_masks(mcfg, iter_num, int(self.freq_reg_end))

    def batch(self, indices, mask_nerf, mask_sd) -> dict:
        pp = self.train_pp
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        return gather_batch(pp.cache, pp.common, self._consts, t(indices), t(mask_nerf),
                            t(mask_sd), packed_layout=self._layout)

    def loss(self, batch: dict, iter_num: int, **draws):
        """Render the batch in train mode and apply the loss stack with the
        weights of `iter_num`: (total, values). `draws` go to `render_rays`
        (generator or explicit draws)."""
        weights = torch.as_tensor(self.loss_computer.weights_vector(iter_num), device=self.device)
        freq = self.freq_mask(iter_num)
        if freq is not None:
            draws["freq_mask"] = torch.as_tensor(freq, device=self.device)
        outputs = renderer.render_rays(self.params, self.render_cfg, batch, train=True,
                                       sec_views_vis=self.train_sec_views, **draws)
        return self.loss_computer.compute(batch, outputs, weights)

    def stage(self, iter_num: int) -> StepInputs:
        """The host stage of step `iter_num`: its global ray indices and
        masks (`next_indices`), its loss weights, Adam's scalars at the
        current count (then the count advances), its counts, its draws
        from the step's generator, drawn for the whole batch, and its
        frequency masks where the model has them, written into the step's
        inputs."""
        with profiling.span("train.stage"):
            with profiling.span("train.stage.indices"):
                indices, mask_nerf, mask_sd = self.train_pp.next_indices(iter_num)
            counts = {"rows": len(indices), "indices_mask_nerf": int(mask_nerf.sum()),
                      "indices_mask_sparse_depth": int(mask_sd.sum())}
            adam = self.opt.scalars(self.opt_state["count"])
            self.opt_state["count"] += 1
            with profiling.span("train.stage.draws"):
                draws = renderer.step_draws(self.render_cfg, len(indices),
                                            self.step_generator(iter_num), self.device)
            freq = self.freq_mask(iter_num)
            n_mask = 0 if freq is None else len(freq)
            if self._inputs is None or self._inputs.nr != len(indices):
                self._inputs = StepInputs(len(indices), len(self.loss_computer.specs), draws,
                                          self.device, n_mask)
            self._inputs.write(indices, mask_nerf, mask_sd,
                               self.loss_computer.weights_vector(iter_num), adam, draws, counts,
                               freq)
            return self._inputs

    def body(self, inputs: StepInputs) -> dict:
        """The device part of a step, read from `inputs` alone: gather ->
        render -> the loss stack -> backward -> Adam, with no host read of
        a device value, so that a CUDA graph can hold it. Returns the loss
        values (0-dim device tensors, one stacked buffer). The rank renders
        its rows of the batch and of the draws, divides by the whole
        batch's counts, and the loss values are summed over the ranks:
        without a mesh, or in a world of one, the rows are the batch and
        the sums are no-ops. Four device spans cover it, one after another:
        `step.forward` (gather and render), `step.losses`, `step.backward`
        and `step.adam` (Adam and the stacked loss values). The render's
        secondary visibility, where it has any, stays in `step_visibility2`,
        and mip-NeRF's per-interval densities and IPE operands in
        `step_mip`."""
        dev = self.device
        with profiling.span("step.forward", device=dev):
            for p in self.leaves:
                p.grad = None
            indices, mask_nerf, mask_sd, draws = mesh_lib.shard_ray_batch(
                self.mesh, (inputs.indices, inputs.mask_nerf, inputs.mask_sd, inputs.draws))
            batch = self.batch(indices, mask_nerf, mask_sd)
            batch["global_counts"] = inputs.counts
            if inputs.freq_mask is not None:
                draws = dict(draws, freq_mask=inputs.freq_mask)
            outputs = renderer.render_rays(self.params, self.render_cfg, batch, train=True,
                                           sec_views_vis=self.train_sec_views, **draws)
            self.step_visibility2 = {k: v.detach() for k, v in outputs.items()
                                     if k.startswith("visibility2_")}
            self.step_mip = {k: v.detach() for k, v in outputs.items()
                             if k.startswith(("density_", "ipe_"))}
        with profiling.span("step.losses", device=dev):
            total, values = self.loss_computer.compute(batch, outputs, inputs.weights)
        with profiling.span("step.backward", device=dev):
            total.backward()
        with profiling.span("step.adam", device=dev):
            self.opt.step(self.leaves, self.opt_state, inputs.adam)
            stacked = torch.stack([
                (v if torch.is_tensor(v) else torch.full((), v, device=dev)).detach().float()
                for v in values.values()])
            return dict(zip(values, mesh_lib.all_reduce_sum(self.mesh, stacked).unbind()))

    def train_one_iter(self, iter_num: int) -> dict:
        """One step: its host stage, then its body, eagerly; returns the loss values."""
        return self.body(self.stage(iter_num))

    def train_many(self, start_iter: int, k: int) -> dict:
        """k steps from `start_iter`; returns the last step's loss values.

        Where `graph_capable` holds (a card; no mesh, or a mesh of one
        rank) and k > 1, the steps replay one CUDA graph of the step body,
        the counterpart of the JAX Trainer's multi-step scan: the first such
        call stages its first step and runs it as the capture's warm-up,
        then captures the body (`StepGraph`); every other step, in this
        call and in later ones, is a host stage and a replay, until
        `set_params` drops the graph. A replay whose counts differ from the
        capture's raises. The values returned are copies. The loop of
        `train_one_iter` runs instead on the CPU, which has no graphs; for
        k == 1, as the JAX Trainer runs a chunk of one through
        `train_one_iter`; and on a mesh of more than one rank: gloo's
        collectives cannot be captured, and NCCL's across ranks in a graph
        need a card per rank. A capture or replay that fails raises: it
        never falls back to the loop.
        """
        if k == 1 or not self.use_graph:
            values = {}
            for j in range(k):
                values = self.train_one_iter(start_iter + j)
            return values
        first = start_iter
        if self._graph is None:
            inputs = self.stage(first)
            self._graph = StepGraph(lambda: self.body(inputs), self.device)
            self._graph_counts = dict(inputs.counts)
            first += 1
        for it in range(first, start_iter + k):
            counts = self.stage(it).counts
            if counts != self._graph_counts:
                raise RuntimeError(f"step {it}: counts {counts} differ from the captured "
                                   f"step's {self._graph_counts}")
            self._graph.replay()
        return {name: v.clone() for name, v in self._graph.out.items()}

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
                    scalars = dict(values)
                    scalars["lr"] = float(self.lr_schedule(it - 1))
                    scalars["rays_per_s"] = rays_per_iter * iters_since_log / max(dt, 1e-9)
                    # The step body's device spans: of the last graph replay,
                    # or of the last step timed eagerly (tracing on), since
                    # the last log.
                    for name, ms in profiling.device_ms("step.", clear=True).items():
                        scalars[f"device_ms/{name}"] = ms
                    self.logger.log_scalars(it, scalars)
                    t_last = time.time()
                    iters_since_log = 0
                if val_interval and it % val_interval == 0:
                    with profiling.span("train.validate"):
                        self.run_validation(it)
                if it % save_interval == 0 or it == num_iterations:
                    with profiling.span("train.save"):
                        self.save_checkpoint(it)
        finally:
            if prof_ctx is not None:  # the run ended inside the trace window
                prof_ctx.__exit__(None, None, None)
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
    with torch.no_grad(), profiling.span("frame.chunks"):
        for i in range(num_chunks):
            chunk_rays = {k: v[i * chunk : (i + 1) * chunk] for k, v in rays.items()}
            for k, v in eval_step(params, chunk_rays).items():
                parts.setdefault(k, []).append(v)
    with profiling.span("frame.join", device=rays["rays_o"].device):
        return {k: torch.cat(v)[:nr] for k, v in parts.items()}
