"""Config handling: reference-schema dicts -> static configs, run persistence.

Experiments are driven by nested dicts in the reference's key schema
(src/NerfLlffTrainerTester01.py). This module converts them into the
frozen dataclasses the render path reads, persists runs as JSON, and guards
config drift on resume and re-test.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

from simplenerf_torch.fields.mlp import MLPConfig
from simplenerf_torch.render.renderer import RenderConfig


def mlp_config_from_dict(d: dict, default_num_samples: int = 0) -> MLPConfig:
    return MLPConfig(
        points_net_depth=d["points_net_depth"],
        views_net_depth=d["views_net_depth"],
        points_net_width=d["points_net_width"],
        views_net_width=d["views_net_width"],
        points_pe_degree=d["points_positional_encoding_degree"],
        views_pe_degree=d.get("views_positional_encoding_degree", 4),
        points_sigma_pe_degree=d.get("points_sigma_positional_encoding_degree"),
        use_view_dirs=d["use_view_dirs"],
        view_dependent_rgb=d["view_dependent_rgb"],
        predict_visibility=d.get("predict_visibility", False),
        num_samples=d.get("num_samples", default_num_samples),
    )


def render_config_from_dict(configs: dict, compute_dtype: Optional[str] = None) -> RenderConfig:
    """Build the static RenderConfig from a reference-schema config dict."""
    model = configs["model"]

    def maybe(d: Optional[dict], default_ns: int = 0) -> Optional[MLPConfig]:
        return mlp_config_from_dict(d, default_ns) if d is not None else None

    if "mlp" in model:  # mip-NeRF (FreeNeRF): one MLP at both levels
        return RenderConfig(
            coarse_mlp=None, shared_mlp=mlp_config_from_dict(model["mlp"]),
            ndc=configs["data_loader"]["ndc"], perturb=bool(model.get("perturb", True)),
            raw_noise_std=float(model.get("raw_noise_std", 0.0)),
            white_bkgd=bool(model.get("white_bkgd", False)),
            compute_dtype=compute_dtype or model.get("compute_dtype", "float32"),
            fused_mlp=model.get("fused_mlp", "auto"),
        )
    pts_aug = model.get("points_augmentation", {})
    views_aug = model.get("views_augmentation", {})
    coarse = model.get("coarse_mlp")
    fine = model.get("fine_mlp")
    return RenderConfig(
        coarse_mlp=maybe(coarse),
        fine_mlp=maybe(fine),
        points_aug_coarse_mlp=maybe(pts_aug.get("coarse_mlp"), coarse["num_samples"] if coarse else 0),
        points_aug_fine_mlp=maybe(pts_aug.get("fine_mlp"), fine["num_samples"] if fine else 0),
        views_aug_coarse_mlp=maybe(views_aug.get("coarse_mlp"), coarse["num_samples"] if coarse else 0),
        views_aug_fine_mlp=maybe(views_aug.get("fine_mlp"), fine["num_samples"] if fine else 0),
        ndc=configs["data_loader"]["ndc"],
        lindisp=model.get("lindisp", False),
        perturb=bool(model.get("perturb", True)),
        raw_noise_std=float(model.get("raw_noise_std", 0.0)),
        white_bkgd=bool(model.get("white_bkgd", False)),
        compute_dtype=compute_dtype or model.get("compute_dtype", "float32"),
        fused_mlp=model.get("fused_mlp", "auto"),
    )


def dict_diff(a: Any, b: Any, path: str = "") -> list[str]:
    """Recursive structural diff for the drift guards."""
    diffs: list[str] = []
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            p = f"{path}.{k}" if path else str(k)
            if k not in a:
                diffs.append(f"added {p}")
            elif k not in b:
                diffs.append(f"removed {p}")
            else:
                diffs.extend(dict_diff(a[k], b[k], p))
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if list(a) != list(b):
            diffs.append(f"changed {path}: {a} != {b}")
    elif a != b:
        diffs.append(f"changed {path}: {a} != {b}")
    return diffs


def save_configs(output_dir: Path, configs: dict, filename: str = "Configs.json") -> None:
    """Persist run configs; on resume, allow only scene growth and iteration
    extension, raising on any other drift."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    path = output_dir / filename
    configs = json.loads(json.dumps(configs, default=str))  # normalize
    if path.exists():
        old = json.loads(path.read_text())
        old_f, new_f = json.loads(json.dumps(old)), json.loads(json.dumps(configs))
        # Scene sets may grow across resumes; iterations may extend.
        old_scenes = old_f.get("data_loader", {}).pop("scene_names", None)
        new_scenes = new_f.get("data_loader", {}).pop("scene_names", None)
        if old_scenes is not None and new_scenes is not None:
            merged = sorted(set(map(str, old_scenes)) | set(map(str, new_scenes)))
            configs["data_loader"]["scene_names"] = merged
        old_iters = old_f.pop("num_iterations", None)
        new_iters = new_f.pop("num_iterations", None)
        if old_iters is not None and new_iters is not None:
            configs["num_iterations"] = max(old_iters, new_iters)
        old_f.pop("device", None), new_f.pop("device", None)
        old_f.pop("seed", None), new_f.pop("seed", None)
        diffs = dict_diff(old_f, new_f)
        if diffs:
            raise RuntimeError(f"Config drift on resume: {diffs}")
    path.write_text(json.dumps(configs, indent=2, default=str))


def save_test_configs(output_dir: Path, configs: dict, filename: str = "Configs.json") -> None:
    """Test-side drift guard: re-testing with changed configs raises instead
    of silently overwriting. Top-level scene lists merge, keys missing from
    the new configs are inherited from the saved ones, device/seed ignored."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    path = output_dir / filename
    configs = json.loads(json.dumps(configs, default=str))
    if path.exists():
        old = json.loads(path.read_text())
        for k, v in old.items():
            configs.setdefault(k, v)
        old_f, new_f = json.loads(json.dumps(old)), json.loads(json.dumps(configs))
        old_scenes = old_f.pop("scene_names", None)
        new_scenes = new_f.pop("scene_names", None)
        if old_scenes is not None or new_scenes is not None:
            configs["scene_names"] = sorted(
                set(map(str, old_scenes or [])) | set(map(str, new_scenes or []))
            )
        for volatile in ("device", "seed"):
            old_f.pop(volatile, None), new_f.pop(volatile, None)
        diffs = dict_diff(old_f, new_f)
        if diffs:
            raise RuntimeError(f"Config drift on re-test: {diffs}")
    path.write_text(json.dumps(configs, indent=2, default=str))


def load_configs(path: Path) -> dict:
    return json.loads(Path(path).read_text())
