"""QA runner: the 14 metric families -> frame-wise CSVs + QA_Scores.json.

Port of simplenerf_tpu/qa/runner.py (the reference's AllMetrics runner and
SceneWiseGrouper), with the port's csv helpers in place of pandas: each
metric appends per-frame rows to QA_Scores/<Metric>_FrameWise.csv under
the prediction directory (frames already scored there are not scored
again), writes the per-scene means to <Metric>_SceneWise.csv, and the
overall means roll up into QA_Scores.json. A family that yields no score
is listed with its reason under "skipped" there.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from simplenerf_torch.data import io
from simplenerf_torch.qa import metrics as M
from simplenerf_torch.qa.masks import load_visibility_mask

FRAME_METRICS = {
    "RMSE": M.rmse,
    "PSNR": M.psnr,
    "SSIM": M.ssim,
    "LPIPS": M.lpips,
}
MASKED_FRAME_METRICS = {
    "MaskedRMSE": M.masked_rmse,
    "MaskedPSNR": M.masked_psnr,
    "MaskedSSIM": M.masked_ssim,
    "MaskedLPIPS": M.masked_lpips,
}
DEPTH_METRICS = {
    "DepthRMSE": M.depth_rmse,
    "DepthMAE": M.depth_mae,
    "DepthSROCC": M.depth_srocc,
}
MASKED_DEPTH_METRICS = {
    "MaskedDepthRMSE": M.masked_depth_rmse,
    "MaskedDepthMAE": M.masked_depth_mae,
    "MaskedDepthSROCC": M.masked_depth_srocc,
}
ALL_METRICS = {**FRAME_METRICS, **MASKED_FRAME_METRICS, **DEPTH_METRICS, **MASKED_DEPTH_METRICS}


class QARunner:
    """Evaluate one test run directory against ground truth.

    database_dirpath: scene database root (LLFF layout).
    pred_dirpath: directory holding <scene>/predicted_frames/ (and
    predicted_depths/).
    gt_depth_dirpath: directory with pseudo-GT depths <scene>/{frame:04}.npy.
    depth_scale: predicted-depth -> world-unit factor; a float, or a
    {scene_name: float} dict when scenes have different translation scales.
    database_subdir: "all" in the LLFF layout, "test" in RealEstate10K's.
    """

    def __init__(
        self,
        database_dirpath: Path,
        pred_dirpath: Path,
        scene_names: list[str],
        train_frames: dict,
        test_frames: dict,
        resolution_suffix: str = "_down4",
        masks_dirname: Optional[str] = None,
        gt_depth_dirpath: Optional[Path] = None,
        depth_scale: float = 1.0,
        database_subdir: str = "all",
    ):
        self.database_dirpath = Path(database_dirpath)
        self.pred_dirpath = Path(pred_dirpath)
        self.scene_names = scene_names
        self.train_frames = train_frames  # {scene: [frame_nums]}
        self.test_frames = test_frames  # {scene: [frame_nums]}
        self.resolution_suffix = resolution_suffix
        self.masks_dirname = masks_dirname
        self.database_subdir = database_subdir
        self.gt_depth_dirpath = Path(gt_depth_dirpath) if gt_depth_dirpath else None
        self.depth_scale = depth_scale
        self.qa_dirpath = self.pred_dirpath / "QA_Scores"

    # ------------------------------------------------------------------
    def _gt_frame(self, scene: str, frame_num: int) -> np.ndarray:
        path = (
            self.database_dirpath
            / f"{self.database_subdir}/database_data/{scene}/rgb{self.resolution_suffix}/{frame_num:04}.png"
        )
        return io.read_image(path)

    def _pred_frame(self, scene: str, frame_num: int) -> Optional[np.ndarray]:
        path = self.pred_dirpath / scene / f"predicted_frames/{frame_num:04}.png"
        return io.read_image(path) if path.exists() else None

    def _gt_depth(self, scene: str, frame_num: int) -> Optional[np.ndarray]:
        if self.gt_depth_dirpath is None:
            return None
        path = self.gt_depth_dirpath / scene / f"{frame_num:04}.npy"
        return np.load(path) if path.exists() else None

    def _pred_depth(self, scene: str, frame_num: int) -> Optional[np.ndarray]:
        path = self.pred_dirpath / scene / f"predicted_depths/{frame_num:04}.npy"
        if not path.exists():
            return None
        # Normalized frame -> world units, per scene when scales differ.
        scale = self.depth_scale[scene] if isinstance(self.depth_scale, dict) else self.depth_scale
        return np.load(path) * scale

    def _mask(self, scene: str, frame_num: int) -> Optional[np.ndarray]:
        if self.masks_dirname is None:
            return None
        return load_visibility_mask(
            self.database_dirpath, self.masks_dirname, scene, frame_num,
            self.train_frames[scene], database_subdir=self.database_subdir,
        )

    # ------------------------------------------------------------------
    def _run_metric(self, name: str, fn, needs_mask: bool, needs_depth: bool):
        """Score the frames not yet in <name>_FrameWise.csv; write both CSVs.
        Returns (mean over all frames rounded to 4 places, None) or (None,
        the reason there is no score)."""
        csv_path = self.qa_dirpath / f"{name}_FrameWise.csv"
        scenes, frames, scores = [], [], []
        if csv_path.exists():
            old = io.read_csv(csv_path)
            scenes = list(old["scene_name"])
            frames = [int(f) for f in old["pred_frame_num"]]
            scores = [float(v) for v in old[name]]
        done = set(zip(scenes, frames))
        for scene in self.scene_names:
            for frame_num in self.test_frames[scene]:
                if (str(scene), int(frame_num)) in done:
                    continue
                if needs_depth:
                    gt = self._gt_depth(scene, frame_num)
                    pred = self._pred_depth(scene, frame_num)
                else:
                    gt = self._gt_frame(scene, frame_num)
                    pred = self._pred_frame(scene, frame_num)
                if gt is None or pred is None:
                    continue
                args = [gt, pred]
                if needs_mask:
                    mask = self._mask(scene, frame_num)
                    if mask is None:
                        continue
                    args.append(mask)
                score = fn(*args)
                if score is None:
                    return None, "metric unavailable (backing package not importable)"
                scenes.append(str(scene))
                frames.append(int(frame_num))
                scores.append(round(score, 4))
        if not scores:
            return None, "no (gt, pred) frame pairs found"
        self.qa_dirpath.mkdir(parents=True, exist_ok=True)
        io.write_csv(csv_path, {"scene_name": scenes, "pred_frame_num": frames, name: scores})
        values = np.asarray(scores, np.float64)
        by_scene = sorted(set(scenes))
        # np.round, as pandas rounds the scene means (Python's round differs at ties).
        io.write_csv(self.qa_dirpath / f"{name}_SceneWise.csv", {
            "scene_name": by_scene,
            name: [float(np.round(values[[s == k for s in scenes]].mean(), 4)) for k in by_scene],
        })
        return round(float(values.mean()), 4), None

    def run(self) -> dict:
        """Run all 14 families; returns {family: score}. Skips are loud:
        every family without a score is recorded with its reason under the
        "skipped" key of QA_Scores.json."""
        scores: dict = {}
        skipped: dict = {}

        def attempt(name, fn, needs_mask, needs_depth):
            value, why = self._run_metric(name, fn, needs_mask=needs_mask, needs_depth=needs_depth)
            if value is not None:
                scores[name] = value
            else:
                skipped[name] = why

        for name, fn in FRAME_METRICS.items():
            attempt(name, fn, False, False)
        if self.masks_dirname is not None:
            for name, fn in MASKED_FRAME_METRICS.items():
                attempt(name, fn, True, False)
        else:
            for name in MASKED_FRAME_METRICS:
                skipped[name] = "skipped (no masks_dirname configured)"
        if self.gt_depth_dirpath is not None:
            for name, fn in DEPTH_METRICS.items():
                attempt(name, fn, False, True)
            if self.masks_dirname is not None:
                for name, fn in MASKED_DEPTH_METRICS.items():
                    attempt(name, fn, True, True)
            else:
                for name in MASKED_DEPTH_METRICS:
                    skipped[name] = "skipped (no masks_dirname configured)"
        else:
            for name in {**DEPTH_METRICS, **MASKED_DEPTH_METRICS}:
                skipped[name] = "skipped (no gt_depth_dirpath configured)"

        json_path = self.pred_dirpath / "QA_Scores.json"
        existing = json.loads(json_path.read_text()) if json_path.exists() else {}
        existing.pop("skipped", None)
        existing.update(scores)
        still_skipped = {k: v for k, v in skipped.items() if k not in existing}
        if still_skipped:
            existing["skipped"] = still_skipped
        json_path.write_text(json.dumps(existing, indent=2))
        return scores
