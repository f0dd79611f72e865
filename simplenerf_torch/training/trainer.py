"""Full-image evaluation rendering (the serving part of the trainer module).

`build_eval_renderer` and `render_in_chunks` of
simplenerf_tpu/training/trainer.py. The `Trainer` class comes with the
training slice.
"""

from __future__ import annotations

import torch

from simplenerf_torch.render import renderer

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
