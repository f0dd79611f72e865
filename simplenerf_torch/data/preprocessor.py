"""Scene preprocessing: pose normalization, the device-resident ray cache,
epoch-permutation batch sampling, the scene digest (ModelConfigs),
test-time ray batches and output reshaping.

Port of simplenerf_tpu/data/preprocessor.py (reference DataPreprocessor01:
preprocess_poses, create_cache, the sparse-depth raster and its NDC
conversion, the batch sampler, create_test_data, the model-configs digest).
"train" mode builds the whole-scene per-pixel ray cache on the device as
flat (n*h*w, .) tensors; each iteration the host draws 2048 + 2048 indices
from two epoch permutations (NeRF pool + sparse-depth pool, numpy streams
identical to the JAX package's for the same seed) and `gather_batch`
gathers the batch on the device. "validation" mode builds the same ray
cache for the validation frames, with their poses normalized by the train
scene's digest (`model_configs`), and is read whole frame by whole frame.
"test" mode builds full-image ray batches for any pose from a stored
digest. The train cache also holds the dense-depth planes, the
visibility-prior masks and weights and the mip-NeRF radii where the
configuration asks for them.

As in the JAX package, the epoch sampler wraps into the next permutation
at an epoch boundary instead of emitting a short batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from simplenerf_torch.device import resolve_device
from simplenerf_torch.geometry import poses as pose_lib
from simplenerf_torch.geometry import projection
from simplenerf_torch.geometry import rays as ray_lib
from simplenerf_torch.utils import profiling


class EpochSampler:
    """Shuffled-permutation index stream with wrap-around (host-side)."""

    def __init__(self, pool: np.ndarray, rng: np.random.Generator):
        self.pool = np.asarray(pool)
        self.rng = rng
        self.perm = self.rng.permutation(self.pool)
        self.cursor = 0

    def reset_pool(self, pool: np.ndarray):
        self.pool = np.asarray(pool)
        self.perm = self.rng.permutation(self.pool)
        self.cursor = 0

    def next(self, count: int) -> np.ndarray:
        out = []
        remaining = count
        while remaining > 0:
            take = min(remaining, len(self.perm) - self.cursor)
            out.append(self.perm[self.cursor : self.cursor + take])
            self.cursor += take
            remaining -= take
            if self.cursor >= len(self.perm):
                self.perm = self.rng.permutation(self.pool)
                self.cursor = 0
        return np.concatenate(out)

    def skip(self, count: int):
        """Advance the stream `count` draws without materializing them;
        consumes the rng exactly as `next(count)` does."""
        while count > 0:
            take = min(count, len(self.perm) - self.cursor)
            self.cursor += take
            count -= take
            if self.cursor >= len(self.perm):
                self.perm = self.rng.permutation(self.pool)
                self.cursor = 0


def _build_ray_cache(images, intrinsics, c2ws, near: float, h: int, w: int, ndc: bool) -> dict:
    """Per-pixel rays of every frame, flattened to (n*h*w, .) tensors on the
    inputs' device."""
    n = intrinsics.shape[0]
    frames: dict = {}
    for i in range(n):
        rays_o, rays_d = ray_lib.get_rays(h, w, intrinsics[i], c2ws[i])
        x, y = ray_lib.pixel_grid(h, w, device=images.device)
        out = {"rays_o": rays_o, "rays_d": rays_d,
               "pixel_id": torch.stack([torch.full_like(x, float(i)), x, y], dim=-1)}
        if ndc:
            out["rays_o_ndc"], out["rays_d_ndc"] = ray_lib.ndc_rays(
                rays_o, rays_d, h, w, intrinsics[i, 0, 0], intrinsics[i, 1, 1], near
            )
        for k, v in out.items():
            frames.setdefault(k, []).append(v.reshape(h * w, v.shape[-1]))
    cache = {k: torch.cat(v) for k, v in frames.items()}
    cache["view_dirs"] = ray_lib.get_view_dirs(cache["rays_d"])
    cache["pixel_id"] = cache["pixel_id"].to(torch.int32)
    cache["target_rgb"] = images.reshape(n * h * w, 3)
    return cache


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) area-resize weights along one axis, as OpenCV's INTER_AREA
    tables them for a shrink (computeResizeAreaTab): output cell d covers
    source span [d*s, (d+1)*s), s = src/dst, each source pixel weighted by
    its covered fraction over the cell's width, the weights float32."""
    scale = src / dst
    tab = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            tab[d, s1 - 1] = np.float32((s1 - f1) / cell)
        tab[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            tab[d, s2] = np.float32(min(f2 - s2, 1.0, cell) / cell)
    return tab


def area_downsample(images: np.ndarray, h: int, w: int) -> np.ndarray:
    """(n, H, W, c) float images shrunk to (n, h, w, c) by area averaging:
    OpenCV's INTER_AREA, which the JAX package calls, for integer and
    non-integer ratios alike (separable fractional-coverage weights)."""
    wy = _area_weights(images.shape[1], h)
    wx = _area_weights(images.shape[2], w)
    out = np.einsum("yY,nYXc,xX->nyxc", wy, images.astype(np.float64), wx, optimize=True)
    return out.astype(np.float32)


class ScenePreprocessor:
    """Per-scene data pipeline; `device` is where the ray cache and test
    batches live."""

    def __init__(
        self,
        configs: dict,
        mode: str,
        raw_data: Optional[dict] = None,
        model_configs: Optional[dict] = None,
        device=None,
        seed: int = 0,
    ):
        self.configs = configs
        self.mode = mode.lower()
        dl = configs["data_loader"]
        self.ndc = dl["ndc"]
        self.bd_factor = dl.get("bd_factor")
        self.downsampling_factor = dl.get("downsampling_factor", 1)
        self.num_rays = dl.get("num_rays", 2048)
        self.sparse_depth_needed = "sparse_depth" in dl
        self.dense_depth_needed = "dense_depth" in dl
        self.visibility_prior_needed = "visibility_prior" in dl
        self.mip_nerf_needed = "mip_nerf" in dl
        self.white_bkgd = configs.get("model", {}).get("white_bkgd", False)
        self.rng = np.random.default_rng(seed)
        self.model_configs = model_configs
        self.device = resolve_device(device)

        if self.mode in ("train", "validation"):
            if raw_data is None:
                raise ValueError(f"{self.mode} mode needs the scene's raw data")
            if self.mode == "validation" and model_configs is None:
                raise ValueError("validation mode needs the train scene's model_configs")
            self._preprocess(raw_data)
            if self.mode == "train":
                self.model_configs = self._create_model_configs()
        elif self.mode != "test":
            raise ValueError(f"unknown preprocessor mode {mode!r}: train, validation or test")

    # ------------------------------------------------------------------
    def _preprocess(self, raw: dict):
        """Images, normalized poses, bounds, near/far, the ray cache and the
        batch samplers of the mode's frames."""
        nerf = raw["nerf_data"]
        self.frame_nums = np.asarray(raw["frame_nums"])
        images = self._preprocess_images(nerf["images"])
        intrinsics = nerf["intrinsics"].astype(np.float32).copy()
        h, w = nerf["resolution"]
        if self.downsampling_factor > 1:
            f = self.downsampling_factor
            h, w = h // f, w // f
            images = area_downsample(images, h, w)
            intrinsics[:, :2] /= f
        self.resolution = (int(h), int(w))
        self.images = images.astype(np.float32)

        spherify = self.configs["data_loader"].get("spherify", False)
        if self.mode == "train":
            pp = pose_lib.preprocess_poses(
                nerf["extrinsics"],
                bounds=nerf["bounds"],
                bd_factor=self.bd_factor,
                recenter=self.configs["data_loader"].get("recenter_camera_poses", True),
                train_mode=True,
                spherify=spherify,
            )
            self.sc = pp["sc"]
            self.average_pose = pp["average_pose"]
        else:  # validation: the train scene's normalization
            mc = self.model_configs
            pp = pose_lib.preprocess_poses(
                nerf["extrinsics"],
                bounds=nerf["bounds"],
                translation_scale=mc["translation_scale"],
                avg_pose=np.array(mc["average_pose"]),
                train_mode=False,
                spherify=spherify,
                spherify_transform=mc.get("spherify_transform"),
            )
            self.sc = mc["translation_scale"]
            self.average_pose = np.array(mc["average_pose"])
        self.spherify_transform = pp.get("spherify_transform")
        self.render_poses = pp.get("render_poses")
        self.poses = pp["poses"]
        self.intrinsics = intrinsics
        self.bounds = np.asarray(pp["bounds"])

        if not self.ndc:
            self.near = float(self.bounds[0] * 0.9)
            self.far = float(self.bounds[1])
        else:
            bd = self.bd_factor if self.bd_factor is not None else 1.0
            self.near = float(self.bounds[0] * bd)
            self.far = float(self.bounds[1])
            self.near_ndc, self.far_ndc = 0.0, 1.0

        # Device-resident ray cache and the scene's common data.
        dev = self.device
        tensor = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        self.common = {
            "images": tensor(self.images),
            "poses": tensor(self.poses),
            "intrinsics": tensor(self.intrinsics),
        }
        self.cache = _build_ray_cache(
            self.common["images"], self.common["intrinsics"], self.common["poses"], self.near,
            *self.resolution, ndc=self.ndc,
        )
        n = self.num_frames = len(self.images)
        if self.mip_nerf_needed:
            # Mip-NeRF pixel cone radii, cached like every per-pixel field
            # (reference preprocess_mip_nerf_data).
            h, w = self.resolution
            rd = self.cache["rays_d"].reshape(n, h, w, 3)
            self.cache["radii"] = ray_lib.get_radii(rd).reshape(n * h * w, 1)
            if self.ndc:
                ro = self.cache["rays_o_ndc"].reshape(n, h, w, 3)
                self.cache["radii_ndc"] = ray_lib.get_radii_ndc(ro).reshape(n * h * w, 1)
        self.sampler = EpochSampler(self._nerf_index_pool(iter_num=0), self.rng)
        if self.mode == "train":
            if self.sparse_depth_needed:
                self._preprocess_sparse_depth(raw)
            if self.dense_depth_needed:
                self._preprocess_dense_depth(raw)
            if self.visibility_prior_needed:
                self._preprocess_visibility_prior(raw)
            self._pack_cache()
        else:  # read whole frames only; no packed copy of the cache
            self.packed_layout = ()

    def _preprocess_images(self, images: np.ndarray) -> np.ndarray:
        images = images.astype(np.float32) / 255.0
        if self.white_bkgd and images.shape[-1] == 4:
            images = images[..., :3] * images[..., 3:] + (1.0 - images[..., 3:])
        return images[..., :3]

    def _pack_cache(self):
        """Pack the f32 (N, C) cache planes into one `_packed` (N, sum C)
        tensor, so `gather_batch` gathers a batch's rows once; the layout
        is `packed_layout`, ((key, start, width), ...) in sorted key order.
        The unpacked entries stay for the full-frame paths."""
        keys = sorted(k for k, v in self.cache.items() if v.dtype == torch.float32 and v.ndim == 2)
        layout, start = [], 0
        for k in keys:
            width = int(self.cache[k].shape[1])
            layout.append((k, start, width))
            start += width
        self.packed_layout = tuple(layout)
        if keys:
            self.cache["_packed"] = torch.cat([self.cache[k] for k in keys], dim=1)

    def _nerf_index_pool(self, iter_num: int) -> np.ndarray:
        """All-pixel index pool, centre-cropped early in training (precrop,
        DataPreprocessor01.generate_indices)."""
        n = len(self.images)
        h, w = self.resolution
        dl = self.configs["data_loader"]
        frac = dl.get("precrop_fraction", 1)
        pc_iters = dl.get("precrop_iterations", -1)
        indices = np.arange(n * h * w)
        if frac < 1 and iter_num < pc_iters:
            h1 = int(round(h / 2 * (1 - frac)))
            h2 = int(round(h / 2 * (1 + frac)))
            w1 = int(round(w / 2 * (1 - frac)))
            w2 = int(round(w / 2 * (1 + frac)))
            indices = indices.reshape(n, h, w)[:, h1:h2, w1:w2].ravel()
        return indices

    def _preprocess_sparse_depth(self, raw: dict):
        """Per-pixel sparse-depth rasters (-1 where no point) and their pool."""
        h, w = self.resolution
        depths, errors = [], []
        for fn in self.frame_nums:
            depth = -np.ones((h, w), np.float32)
            err = -np.ones((h, w), np.float32)
            frame = raw.get("sparse_depth_data", {}).get(int(fn))
            if frame is not None:
                x = np.asarray(frame["x"]) / self.downsampling_factor
                y = np.asarray(frame["y"]) / self.downsampling_factor
                xi = np.clip(np.round(x), 0, w - 1).astype(int)
                yi = np.clip(np.round(y), 0, h - 1).astype(int)
                depth[yi, xi] = np.asarray(frame["depth"]) * self.sc
                err[yi, xi] = np.asarray(frame["reprojection_error"])
            depths.append(depth)
            errors.append(err)
        depths = np.stack(depths).reshape(-1, 1)
        errors = np.stack(errors).reshape(-1, 1)
        dev = self.device
        self.cache["sparse_depth_values"] = torch.as_tensor(depths, device=dev)
        self.cache["sparse_depth_errors"] = torch.as_tensor(errors, device=dev)
        if self.ndc:
            d = self.cache["sparse_depth_values"]
            d_ndc = projection.depth_to_ndc(d, self.cache["rays_o"], self.cache["rays_d"], near=1.0)
            self.cache["sparse_depth_values_ndc"] = torch.where(d == -1, -1.0, d_ndc)

        sd_cfg = self.configs["data_loader"]["sparse_depth"]
        self.num_rays_sparse_depth = sd_cfg.get("num_rays", 2048)
        self.sparse_sampler = EpochSampler(np.where(depths[:, 0] > 0)[0], self.rng)

    def _preprocess_dense_depth(self, raw: dict):
        """Per-pixel dense depths (scaled into the normalized frame), their
        weights, and in NDC scenes the NDC depths with -1 kept."""
        dd = raw["dense_depth_data"]
        dev = self.device
        depths = (dd["depth_values"] * self.sc).astype(np.float32).reshape(-1, 1)
        weights = dd["depth_weights"].astype(np.float32).reshape(-1, 1)
        d = self.cache["dense_depth_values"] = torch.as_tensor(depths, device=dev)
        self.cache["dense_depth_weights"] = torch.as_tensor(weights, device=dev)
        if self.ndc:
            d_ndc = projection.depth_to_ndc(d, self.cache["rays_o"], self.cache["rays_d"], near=self.near)
            self.cache["dense_depth_values_ndc"] = torch.where(d == -1, -1.0, d_ndc)

    def _preprocess_visibility_prior(self, raw: dict):
        """Prior masks and weights (n, n-1, h, w) laid out per ray as
        (n*h*w, n-1): column j of a ray is its frame's j-th other frame.
        Where the model trains secondary views (`train_secondary_views`),
        each ray also gets those frames' camera centres in the same column
        order, `rays_o2` (n*h*w, 3 (n-1)), which `gather_batch` hands out
        as (nr, n-1, 3)."""
        vp = raw["visibility_prior_data"]
        n = self.num_frames
        for key in ("masks", "weights"):
            if key in vp:
                plane = np.transpose(vp[key].astype(np.float32), (0, 2, 3, 1)).reshape(-1, n - 1)
                self.cache[f"visibility_prior_{key}"] = torch.as_tensor(
                    np.ascontiguousarray(plane), device=self.device)
        if self.configs.get("model", {}).get("train_secondary_views", False):
            h, w = self.resolution
            centres = self.common["poses"][:, :3, 3]  # the normalised poses' camera centres
            others = torch.stack([torch.cat([centres[:f], centres[f + 1 :]]).reshape(-1)
                                  for f in range(n)])  # (n, 3 (n-1)): frame f's others in order
            self.cache["rays_o2"] = others.repeat_interleave(h * w, dim=0).contiguous()

    def _create_model_configs(self) -> dict:
        cfg = {
            "resolution": list(self.resolution),
            "bounds": np.asarray(self.bounds).tolist(),
            "translation_scale": float(self.sc),
            f"{self.mode}_frame_nums": np.asarray(self.frame_nums).tolist(),
            "intrinsic": np.mean(self.intrinsics, axis=0).tolist(),
            "average_pose": np.asarray(self.average_pose).tolist(),
            "near": self.near,
            "far": self.far,
        }
        if self.ndc:
            cfg["near_ndc"] = self.near_ndc
            cfg["far_ndc"] = self.far_ndc
        if self.spherify_transform is not None:
            cfg["spherify_transform"] = self.spherify_transform
        return cfg

    def get_model_configs(self) -> dict:
        return self.model_configs

    # ------------------------------------------------------------------
    def next_indices(self, iter_num: int, image_num: Optional[int] = None):
        """Host-side index draw: (indices, mask_nerf, mask_sd) numpy arrays.

        With image_num set, yields every pixel of that frame."""
        dl = self.configs["data_loader"]
        if image_num is not None:
            h, w = self.resolution
            idx = np.where(self.frame_nums == image_num)[0].item()
            indices = np.arange(h * w) + idx * h * w
            mask_nerf = np.ones(len(indices), bool)
            return indices.astype(np.int32), mask_nerf, np.zeros(len(indices), bool)

        if iter_num == dl.get("precrop_iterations", -1):
            self.sampler.reset_pool(self._nerf_index_pool(iter_num))
        indices = self.sampler.next(self.num_rays)
        n_nerf = len(indices)
        if self.sparse_depth_needed and self.mode == "train":
            indices = np.concatenate([indices, self.sparse_sampler.next(self.num_rays_sparse_depth)])
        mask_nerf = np.zeros(len(indices), bool)
        mask_nerf[:n_nerf] = True
        return indices.astype(np.int32), mask_nerf, ~mask_nerf

    def fast_forward(self, num_iters: int):
        """Advance the batch samplers past `num_iters` training draws, so a
        resumed run draws the batches an uninterrupted one would. The two
        samplers share one rng, so the replay keeps next_indices' order."""
        if self.mode != "train" or num_iters <= 0:
            return
        precrop_it = self.configs["data_loader"].get("precrop_iterations", -1)
        for it in range(num_iters):
            if it == precrop_it:
                self.sampler.reset_pool(self._nerf_index_pool(it))
            self.sampler.skip(self.num_rays)
            if self.sparse_depth_needed:
                self.sparse_sampler.skip(self.num_rays_sparse_depth)

    def batch_constants(self) -> dict:
        """Static per-scene scalars the gather step broadcasts per ray."""
        consts = {"near": self.near, "far": self.far}
        if self.ndc:
            consts["near_ndc"] = self.near_ndc
            consts["far_ndc"] = self.far_ndc
        return consts

    # ------------------------------------------------------------------
    def create_test_data(
        self,
        pose: np.ndarray,
        view_pose: Optional[np.ndarray] = None,
        secondary_poses: Optional[list] = None,
        preprocess_pose: bool = True,
        intrinsic: Optional[np.ndarray] = None,
        view_intrinsic: Optional[np.ndarray] = None,
    ) -> dict:
        """Full-image ray batch for an arbitrary camera pose, on `self.device`.

        view_pose decouples the shading view-direction camera from the ray
        camera; secondary_poses supply the origins for expected
        secondary-view visibility.
        """
        mc = self.model_configs
        h, w = mc["resolution"]
        dev = self.device

        def norm(p):
            return pose_lib.preprocess_poses(
                np.asarray(p),
                translation_scale=mc["translation_scale"],
                avg_pose=np.array(mc["average_pose"]),
                train_mode=False,
                spherify="spherify_transform" in mc,
                spherify_transform=mc.get("spherify_transform"),
            )["poses"]

        def tensor(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        proc = norm(pose[None])[0] if preprocess_pose else pose.astype(np.float32)
        K = np.asarray(intrinsic if intrinsic is not None else mc["intrinsic"], np.float32)
        rays_o, rays_d = ray_lib.get_rays(h, w, tensor(K), tensor(proc))
        if view_pose is not None:
            vproc = norm(view_pose[None])[0]
            vK = np.asarray(view_intrinsic if view_intrinsic is not None else mc["intrinsic"], np.float32)
            _, v_rays_d = ray_lib.get_rays(h, w, tensor(vK), tensor(vproc))
            view_dirs = ray_lib.get_view_dirs(v_rays_d)
        else:
            view_dirs = ray_lib.get_view_dirs(rays_d)

        nr = h * w

        def full(v):
            return torch.full((nr, 1), float(v), dtype=torch.float32, device=dev)

        batch = {
            "rays_o": rays_o.reshape(nr, 3),
            "rays_d": rays_d.reshape(nr, 3),
            "view_dirs": view_dirs.reshape(nr, 3),
            "near": full(mc["near"]),
            "far": full(mc["far"]),
        }
        if self.ndc:
            # float32 focal lengths, as the ray cache and the JAX package
            # take them: a train frame's test rays equal its cached rays.
            tK = tensor(K)
            o_ndc, d_ndc = ray_lib.ndc_rays(
                batch["rays_o"], batch["rays_d"], h, w, tK[0, 0], tK[1, 1], mc["near"]
            )
            batch["rays_o_ndc"] = o_ndc
            batch["rays_d_ndc"] = d_ndc
            batch["near_ndc"] = full(mc["near_ndc"])
            batch["far_ndc"] = full(mc["far_ndc"])
        if self.mip_nerf_needed:
            # Both radii keys, as the JAX package emits (docs/PARITY.md).
            batch["radii"] = ray_lib.get_radii(rays_d[None]).reshape(nr, 1)
            if self.ndc:
                batch["radii_ndc"] = ray_lib.get_radii_ndc(
                    batch["rays_o_ndc"].reshape(1, h, w, 3)
                ).reshape(nr, 1)
        if secondary_poses is not None:
            sec = norm(np.stack(secondary_poses))
            origins = [
                ray_lib.get_rays(h, w, tensor(K), tensor(sp))[0].reshape(nr, 3) for sp in sec
            ]
            batch["rays_o2"] = torch.stack(origins, dim=1)  # (nr, k, 3)
        return batch

    def retrieve_inference_outputs(self, outputs: dict) -> dict:
        """Reshape eval render outputs into host images (fine level if present)."""
        h, w = self.model_configs["resolution"]
        suffix = "_fine" if any(k.endswith("_fine") for k in outputs) else "_coarse"

        def host(key):
            return outputs[key].detach().float().cpu().numpy()

        def img(key, ch=None):
            return host(f"{key}{suffix}").reshape((h, w, ch) if ch else (h, w))

        with profiling.span("frame.fetch.wait"):
            rgb = img("rgb", 3)  # the first read waits for the frame's device work
        out = {
            "image": np.clip(np.round(np.clip(rgb, 0, 1) * 255), 0, 255).astype(np.uint8),
            "depth": np.clip(img("depth"), 0, np.inf),
            "depth_var": np.clip(img("depth_var"), 0, np.inf),
        }
        if self.ndc:
            out["depth_ndc"] = np.clip(img("depth_ndc"), 0, np.inf)
            out["depth_var_ndc"] = np.clip(img("depth_var_ndc"), 0, np.inf)
        key = f"visibility2{suffix}"
        if key in outputs:
            vis = host(key).reshape(h, w, -1).transpose(2, 0, 1)
            out["visibility2"] = vis.astype(np.float32)
        return out


def gather_batch(cache: dict, common: dict, consts: dict, indices, mask_nerf, mask_sd,
                 packed_layout: tuple = ()) -> dict:
    """Device-side gather of a training batch from the ray cache.

    indices (nr,) int tensor on the cache's device. With `packed_layout`
    (the preprocessor's) the f32 fields come from one gather of the
    `_packed` rows, sliced per field; the other entries are gathered one by
    one. Adds the per-ray constants, the masks and the scene's common data.
    """
    cache = dict(cache)
    packed = cache.pop("_packed", None)
    idx = indices.long()
    batch = {}
    if packed is not None and packed_layout:
        rows = packed.index_select(0, idx)
        for k, start, width in packed_layout:
            batch[k] = rows[:, start : start + width]
            cache.pop(k, None)
    batch.update({k: v.index_select(0, idx) for k, v in cache.items()})
    nr = idx.shape[0]
    for key in ("radii", "radii_ndc"):
        # Radii exist only for NeRF rays; sparse-depth rows carry the
        # reference's -1 fill (load_mip_nerf_cached_batch).
        if key in batch:
            batch[key] = torch.where(mask_nerf[:, None], batch[key], -1.0)
    if "rays_o2" in batch:  # the other frames' camera centres, (nr, n-1, 3)
        batch["rays_o2"] = batch["rays_o2"].unflatten(1, (-1, 3))
    for name, value in consts.items():
        batch[name] = torch.full((nr, 1), float(value), dtype=torch.float32, device=idx.device)
    batch["indices_mask_nerf"] = mask_nerf
    if mask_sd is not None:
        batch["indices_mask_sparse_depth"] = mask_sd
    batch["common"] = common
    return batch
