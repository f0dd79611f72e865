"""NeRF-LLFF experiment driver (CLI): train -> test + QA -> spiral video ->
static-camera video, per scene.

Port of simplenerf_tpu/drivers/llff.py. --views 2/3/4 are the published
2/3/4-input-view SimpleNeRF experiments: the full model with points and
views augmentations, COLMAP sparse-depth priors, the nine-loss stack and
100k iterations, then testing with the QA suite and the two videos.
--model vipnerf trains ViP-NeRF instead (`presets.with_vip_prior`: no
augmentations, visibility heads, the visibility prior's masks from
all/visibility_prior/VW02/<scene>/visibility_masks and its two losses);
--model freenerf trains FreeNeRF (`presets.freenerf_config`: mip-NeRF's
model with FreeNeRF's frequency masks and occlusion loss, no sparse depth,
the train set's views only, `--iters` its schedule's steps).

Usage:
  python -m simplenerf_torch.drivers.llff --database-dir <path to NeRF_LLFF/data>
      --output-dir runs/ --views 3 [--scenes fern flower] [--iters 100000]
      [--compute-dtype bfloat16] [--model simplenerf|vipnerf|freenerf] [--device cpu]

Runs on the CUDA device unless --device names another.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from simplenerf_torch.drivers import runner
from simplenerf_torch.drivers.presets import freenerf_config, simplenerf_config, with_vip_prior

# view count -> (train_set_num, run numbering), as the reference's runs.
VIEWS_TO_SET = {2: (2, 1011), 3: (3, 1021), 4: (4, 1031)}


def build_configs(views: int, scenes, iters: int, compute_dtype: str, seed: int,
                  model: str = "simplenerf"):
    """(train_configs, test_configs) of one published experiment; `model`
    "simplenerf", "vipnerf" or "freenerf"."""
    if model not in ("simplenerf", "vipnerf", "freenerf"):
        raise ValueError(f"unknown model {model!r}: simplenerf, vipnerf or freenerf")
    set_num, run_num = VIEWS_TO_SET[views]
    if model == "freenerf":
        train_configs = freenerf_config(database="NeRF_LLFF", data_loader_name="NerfLlffDataLoader01",
                                        train_set_num=set_num, num_iterations=iters,
                                        compute_dtype=compute_dtype, seed=seed)
    else:
        train_configs = simplenerf_config(
            database="NeRF_LLFF",
            data_loader_name="NerfLlffDataLoader01",
            train_set_num=set_num,
            num_iterations=iters,
            compute_dtype=compute_dtype,
            seed=seed,
            with_augmentations=model == "simplenerf",
        )
    if model == "vipnerf":
        train_configs = with_vip_prior(train_configs)
    train_configs["train_num"] = run_num
    train_configs["data_loader"]["scene_names"] = scenes or []
    test_configs = {
        "test_num": run_num,
        "train_num": run_num,
        "test_set_num": set_num,
        "qa_masks_dirname": "VM02",
        "scene_names": scenes or None,
    }
    return train_configs, test_configs


def run(train_configs: dict, test_configs: dict, database_dir: Path, output_dir: Path,
        gt_depth_dir=None, skip_training: bool = False, skip_videos: bool = False,
        device=None) -> dict:
    """The experiment's stages in order; returns the QA scores."""
    if not skip_training:
        runner.start_training(train_configs, database_dir, output_dir, device=device)
    scores = runner.start_testing(
        test_configs, database_dir, output_dir, gt_depth_dirpath=gt_depth_dir, device=device
    )
    if not skip_videos:
        runner.start_testing_videos(test_configs, database_dir, output_dir, device=device)
        runner.start_testing_videos(
            test_configs, database_dir, output_dir, static_camera=True, device=device
        )
    return scores


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--database-dir", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("runs"))
    parser.add_argument("--views", type=int, default=2, choices=(2, 3, 4))
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--iters", type=int, default=100000)
    parser.add_argument("--compute-dtype", default="bfloat16")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model", default="simplenerf", choices=("simplenerf", "vipnerf", "freenerf"))
    parser.add_argument("--skip-training", action="store_true")
    parser.add_argument("--skip-videos", action="store_true")
    parser.add_argument("--gt-depth-dir", type=Path, default=None,
                        help="dense-NeRF pseudo-GT depths for the depth metrics")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' runs on the host)")
    args = parser.parse_args(argv)

    train_configs, test_configs = build_configs(
        args.views, args.scenes, args.iters, args.compute_dtype, args.seed, args.model
    )
    scores = run(train_configs, test_configs, args.database_dir, args.output_dir,
                 gt_depth_dir=args.gt_depth_dir, skip_training=args.skip_training,
                 skip_videos=args.skip_videos, device=args.device)
    print(scores)
    return scores


if __name__ == "__main__":
    main()
