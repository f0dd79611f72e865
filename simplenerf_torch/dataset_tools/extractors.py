"""Dataset extractors: original releases -> this repo's scene layout.

Port of simplenerf_tpu/dataset_tools/extractors.py without OpenCV: the
downsampled copies go through the preprocessor's area resize (OpenCV's
INTER_AREA, rounded to uint8), PNG sources through the port's PNG codec,
and JPEG sources and video frames through the `ffmpeg` binary, which must
then be on PATH.

LLFF: converts an original `nerf_llff_data` scene (COLMAP sparse/0 binary
model + images + poses_bounds.npy) into the CSV/png layout the loaders read
(reference nerf_llff DataExtractor01). The COLMAP binary model is parsed
with a small struct-based reader.

RealEstate10K: parses the RE10K camera file (timestamp, intrinsics, 3x4
pose rows) and extracts the listed frames from a locally downloaded clip
(reference real_estate DataExtractor01; downloading the videos is out of
scope).
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from simplenerf_torch.data import io, png
from simplenerf_torch.data.preprocessor import area_downsample


# ------------------------------------------------------ COLMAP binary model


def _read(fmt: str, f):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: Path) -> dict:
    """{camera_id: dict(model_id, width, height, params)}"""
    cameras = {}
    num_params_by_model = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12}
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        for _ in range(num):
            cam_id, model_id, width, height = _read("<iiQQ", f)
            params = np.array(_read(f"<{num_params_by_model[model_id]}d", f))
            cameras[cam_id] = {
                "model_id": model_id, "width": width, "height": height, "params": params
            }
    return cameras


def read_images_binary(path: Path) -> dict:
    """{image_id: dict(qvec, tvec, camera_id, name, xys, point3d_ids)}"""
    images = {}
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        for _ in range(num):
            image_id = _read("<i", f)[0]
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            camera_id = _read("<i", f)[0]
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (num_points,) = _read("<Q", f)
            data = np.array(_read(f"<{num_points * 3}d", f)).reshape(num_points, 3)
            images[image_id] = {
                "qvec": qvec, "tvec": tvec, "camera_id": camera_id,
                "name": name.decode(), "xys": data[:, :2],
                "point3d_ids": data[:, 2].astype(np.int64),
            }
    return images


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


# ------------------------------------------------------------ image decode


def _ffmpeg_frame(src: Path, seek_seconds: Optional[float] = None) -> np.ndarray:
    """One RGB frame of an image or video file, decoded by the ffmpeg binary."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"ffmpeg binary not found on PATH; it decodes {Path(src).name} "
                           "(PNG sources need no decoder)")
    args = ["ffmpeg", "-v", "error"]
    if seek_seconds is not None:
        args += ["-ss", f"{seek_seconds:.6f}"]
    args += ["-i", str(src), "-frames:v", "1", "-f", "image2pipe", "-vcodec", "png",
             "-pix_fmt", "rgb24", "-"]
    result = subprocess.run(args, capture_output=True)
    if result.returncode != 0 or not result.stdout:
        where = "" if seek_seconds is None else f" at {seek_seconds} s"
        raise RuntimeError(f"failed to read a frame{where} from {src}: "
                           f"{result.stderr.decode(errors='replace')[-2000:]}")
    return png.decode(result.stdout)


def _shrink(image: np.ndarray, factor: int) -> np.ndarray:
    """uint8 (h, w, c) image area-resized to (h // f, w // f), rounded."""
    h, w = image.shape[0] // factor, image.shape[1] // factor
    out = area_downsample(image[None].astype(np.float32), h, w)[0]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- LLFF extract


def extract_llff_scene(scene_dirpath: Path, downsample_suffixes=("", "_down4", "_down8")) -> None:
    """Convert one original nerf_llff_data scene in place to the repo layout."""
    scene_dirpath = Path(scene_dirpath)
    cameras = read_cameras_binary(scene_dirpath / "sparse/0/cameras.bin")
    images = read_images_binary(scene_dirpath / "sparse/0/images.bin")
    bounds = np.load(scene_dirpath / "poses_bounds.npy")[:, 15:17]

    # COLMAP images are unordered; sort by name for a stable frame order.
    ordered = sorted(images.values(), key=lambda im: im["name"])

    intrinsics, extrinsics, bds = [], [], []
    for frame_num, im in enumerate(ordered):
        cam = cameras[im["camera_id"]]
        f = cam["params"][0]
        k = np.array([[f, 0, cam["width"] / 2], [0, f, cam["height"] / 2], [0, 0, 1.0]])
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(im["qvec"])
        w2c[:3, 3] = im["tvec"]
        intrinsics.append(k)
        extrinsics.append(w2c)
        bds.append(bounds[frame_num])

        src = next(scene_dirpath.glob(f"images/{Path(im['name']).stem}.*"))
        image = io.read_image(src) if src.suffix == ".png" else _ffmpeg_frame(src)
        for suffix in downsample_suffixes:
            factor = 1 if suffix == "" else int(suffix.replace("_down", ""))
            io.write_image(scene_dirpath / f"rgb{suffix}/{frame_num:04}.png",
                           image if factor == 1 else _shrink(image, factor))

    intrinsics = np.stack(intrinsics)
    extrinsics = np.stack(extrinsics)
    np.savetxt(scene_dirpath / "CameraExtrinsics.csv", extrinsics.reshape(-1, 16), delimiter=",")
    np.savetxt(scene_dirpath / "DepthBounds.csv", np.stack(bds), delimiter=",")
    for suffix in downsample_suffixes:
        factor = 1 if suffix == "" else int(suffix.replace("_down", ""))
        k = intrinsics.copy()
        k[:, :2] /= factor
        np.savetxt(scene_dirpath / f"CameraIntrinsics{suffix}.csv", k.reshape(-1, 9), delimiter=",")


# --------------------------------------------------------- RE10K extract


def parse_re10k_camera_file(path: Path):
    """(timestamps, intrinsics (n,3,3), w2c extrinsics (n,4,4)) from an
    RE10K camera txt (url line + one row per frame)."""
    timestamps, intrinsics, extrinsics = [], [], []
    for line in Path(path).read_text().splitlines()[1:]:
        parts = line.split()
        if len(parts) < 19:
            continue
        timestamps.append(int(parts[0]))
        fx, fy, cx, cy = map(float, parts[1:5])
        intrinsics.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))
        w2c = np.eye(4)
        w2c[:3] = np.array(list(map(float, parts[7:19]))).reshape(3, 4)
        extrinsics.append(w2c)
    return np.array(timestamps), np.stack(intrinsics), np.stack(extrinsics)


def extract_re10k_scene(
    video_path: Path,
    camera_file: Path,
    output_dirpath: Path,
    scene_num: int,
    num_frames: int = 50,
    start_index: int = 0,
) -> None:
    """Extract frames + camera CSVs for one RE10K clip from a local video
    (timestamps in microseconds)."""
    timestamps, intrinsics, extrinsics = parse_re10k_camera_file(camera_file)
    sel = slice(start_index, start_index + num_frames)
    timestamps, intrinsics, extrinsics = timestamps[sel], intrinsics[sel], extrinsics[sel]

    out = Path(output_dirpath) / f"test/database_data/{scene_num:05}"
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    for i, ts in enumerate(timestamps):
        io.write_image(out / f"rgb/{i:04}.png", _ffmpeg_frame(video_path, seek_seconds=ts / 1e6))

    h, w = io.read_image(out / "rgb/0000.png").shape[:2]
    k = intrinsics.copy()
    # RE10K intrinsics are normalized by resolution.
    k[:, 0] *= w
    k[:, 1] *= h
    np.savetxt(out / "CameraIntrinsics.csv", k.reshape(-1, 9), delimiter=",")
    np.savetxt(out / "CameraExtrinsics.csv", extrinsics.reshape(-1, 16), delimiter=",")
