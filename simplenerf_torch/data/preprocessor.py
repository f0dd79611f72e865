"""Scene preprocessing for serving: pose normalization, the scene digest
(ModelConfigs), test-time ray batches and output reshaping.

Port of the serving part of simplenerf_tpu/data/preprocessor.py
(reference DataPreprocessor01: preprocess_poses, create_test_data, the
model-configs digest). "test" mode builds full-image ray batches for any
pose from a stored digest. "train" mode here runs only the pose, bounds and
near/far preprocessing, so that `get_model_configs()` writes the same
ModelConfigs.json as the JAX package; the ray cache, batch samplers and
sparse-depth rasters come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from simplenerf_torch.device import resolve_device
from simplenerf_torch.geometry import poses as pose_lib
from simplenerf_torch.geometry import rays as ray_lib


class ScenePreprocessor:
    """Per-scene data pipeline; `device` is where test batches are built."""

    def __init__(
        self,
        configs: dict,
        mode: str,
        raw_data: Optional[dict] = None,
        model_configs: Optional[dict] = None,
        device=None,
    ):
        self.configs = configs
        self.mode = mode.lower()
        dl = configs["data_loader"]
        self.ndc = dl["ndc"]
        self.bd_factor = dl.get("bd_factor")
        self.downsampling_factor = dl.get("downsampling_factor", 1)
        self.mip_nerf_needed = "mip_nerf" in dl
        self.model_configs = model_configs
        self.device = resolve_device(device)

        if self.mode == "train":
            if raw_data is None:
                raise ValueError("train mode needs the scene's raw data")
            self._preprocess(raw_data)
            self.model_configs = self._create_model_configs()
        elif self.mode != "test":
            raise NotImplementedError(f"{mode!r} mode comes with the training slice")

    # ------------------------------------------------------------------
    def _preprocess(self, raw: dict):
        """Resolution, normalized poses, bounds and near/far of the train frames."""
        nerf = raw["nerf_data"]
        self.frame_nums = np.asarray(raw["frame_nums"])
        intrinsics = nerf["intrinsics"].astype(np.float32).copy()
        h, w = nerf["resolution"]
        if self.downsampling_factor > 1:
            # Only the resolution and intrinsics enter the digest; the
            # images themselves are resized with the training slice's cache.
            f = self.downsampling_factor
            h, w = h // f, w // f
            intrinsics[:, :2] /= f
        self.resolution = (int(h), int(w))

        spherify = self.configs["data_loader"].get("spherify", False)
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
            o_ndc, d_ndc = ray_lib.ndc_rays(
                batch["rays_o"], batch["rays_d"], h, w, float(K[0, 0]), float(K[1, 1]), mc["near"]
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

        out = {
            "image": np.clip(np.round(np.clip(img("rgb", 3), 0, 1) * 255), 0, 255).astype(np.uint8),
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
