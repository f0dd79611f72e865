"""Inference harness: checkpointed model -> full-frame renders on disk.

The reference NerfTester contract, as in simplenerf_tpu/training/tester.py:
loads the train run's Configs.json + per-scene ModelConfigs.json, rebuilds
test-time rays from the scene digest, renders frames in eval mode, and
saves predicted_frames/NNNN.png, predicted_depths (npy + png), depth
variance, NDC variants and per-train-frame visibility maps. Every output is
skip-if-exists, so testing is idempotent and resumable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from simplenerf_torch import config as config_lib
from simplenerf_torch.data import io
from simplenerf_torch.data.preprocessor import ScenePreprocessor
from simplenerf_torch.device import resolve_device
from simplenerf_torch.render import renderer
from simplenerf_torch.training import checkpoints
from simplenerf_torch.training.trainer import build_eval_renderer, render_in_chunks
from simplenerf_torch.utils import profiling

# Rays per eval chunk. A 64k-ray chunk of the published model is 12.6M fine
# samples, whose encodings and planes take a few GB of device memory: far
# inside an 80 GB card in either dtype, and large enough that one LLFF
# 756x1008 frame is 12 chunks, i.e. 24 kernel launches.
DEFAULT_CHUNK = 64 * 1024


class Tester:
    def __init__(
        self,
        train_configs: dict,
        model_configs: dict,
        compute_dtype: Optional[str] = None,
        chunk: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.train_configs = train_configs
        self.model_configs = model_configs
        self.render_cfg = config_lib.render_config_from_dict(train_configs, compute_dtype)
        self.chunk = DEFAULT_CHUNK if chunk is None else chunk
        self.preprocessor = ScenePreprocessor(
            train_configs, "test", model_configs=model_configs, device=self.device
        )
        self.params = None
        self._eval_step = build_eval_renderer(self.render_cfg)

    def load_model(self, checkpoint_path: Path):
        target = renderer.init(torch.Generator().manual_seed(0), self.render_cfg)
        _, self.params, _ = checkpoints.load_checkpoint(checkpoint_path, target, self.device)

    def predict_frame(
        self,
        pose: np.ndarray,
        view_pose: Optional[np.ndarray] = None,
        secondary_poses: Optional[list] = None,
        intrinsic: Optional[np.ndarray] = None,
        view_intrinsic: Optional[np.ndarray] = None,
    ) -> dict:
        """One frame's host arrays, in a span `frame`: its rays
        (`frame.rays`), the chunks' renders and their join (`frame.chunks`,
        `frame.join`) and the read back to the host (`frame.fetch`)."""
        if self.params is None:
            raise RuntimeError("call load_model first")
        with profiling.span("frame"):
            with profiling.span("frame.rays"):
                batch = self.preprocessor.create_test_data(
                    pose,
                    view_pose=view_pose,
                    secondary_poses=secondary_poses,
                    intrinsic=intrinsic,
                    view_intrinsic=view_intrinsic,
                )
            outputs = render_in_chunks(self._eval_step, self.params, batch, self.chunk)
            with profiling.span("frame.fetch"):
                return self.preprocessor.retrieve_inference_outputs(outputs)

    # ------------------------------------------------------------------
    def save_frame_outputs(self, output_dir: Path, frame_num: int, prediction: dict):
        output_dir = Path(output_dir)
        io.write_image(output_dir / f"predicted_frames/{frame_num:04}.png", prediction["image"])
        io.write_depth(output_dir / f"predicted_depths/{frame_num:04}", prediction["depth"])
        io.write_depth(
            output_dir / f"predicted_depths_variance/{frame_num:04}", prediction["depth_var"]
        )
        if "depth_ndc" in prediction:
            io.write_depth(output_dir / f"predicted_depths_ndc/{frame_num:04}", prediction["depth_ndc"])
            io.write_depth(
                output_dir / f"predicted_depths_variance_ndc/{frame_num:04}",
                prediction["depth_var_ndc"],
            )
        if "visibility2" in prediction:
            for k, vis in enumerate(prediction["visibility2"]):
                io.write_image(
                    output_dir / f"predicted_visibilities/{frame_num:04}_{k:02}.png",
                    np.round(np.clip(vis, 0, 1) * 255).astype(np.uint8),
                )

    def frame_done(self, output_dir: Path, frame_num: int) -> bool:
        return (Path(output_dir) / f"predicted_frames/{frame_num:04}.png").exists()

    def test_scene(self, output_dir: Path, frames_data: dict):
        """Render every frame of a scene. frames_data: {frame_num: dict with
        'extrinsic' (4x4 w2c), optional 'intrinsic', optional
        'secondary_poses' (list of train-frame extrinsics for visibility)}."""
        for frame_num, frame in sorted(frames_data.items()):
            if self.frame_done(output_dir, frame_num):
                continue
            pred = self.predict_frame(
                np.asarray(frame["extrinsic"]),
                view_pose=frame.get("view_pose"),
                secondary_poses=frame.get("secondary_poses"),
                intrinsic=frame.get("intrinsic"),
            )
            self.save_frame_outputs(output_dir, frame_num, pred)

    def render_video_poses(self, poses: np.ndarray, view_poses: Optional[np.ndarray] = None) -> np.ndarray:
        """Render a pose path to an (n, h, w, 3) uint8 stack."""
        frames = []
        for i, pose in enumerate(poses):
            vp = view_poses[i] if view_poses is not None else None
            frames.append(self.predict_frame(np.asarray(pose), view_pose=vp)["image"])
        return np.stack(frames)
