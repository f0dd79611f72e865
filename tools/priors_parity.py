#!/usr/bin/env python3
"""Readings behind the CPU parity test of training with visibility heads
and the prior losses (tests/test_torch_port_priors.py), against the JAX
Trainer, on the CPU.

On the 24x32 synthetic scene with written priors and the tiny preset with
`presets.with_visibility_priors`, from one initialization:
- each of the three steps' gradients at the JAX run's parameters of that
  step: the largest, and the largest difference port - JAX;
- at step 2, the same for each loss alone (its weight 1, the others 0);
- after three free-running steps, the largest parameter difference and
  how many of the parameters differ by more than 1e-4.

Run from the repository root: JAX_PLATFORMS=cpu python tools/priors_parity.py
(about a minute). Prints one JSON line.
"""

from __future__ import annotations

import copy
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from simplenerf_tpu.data import get_data_loader as jget_data_loader  # noqa: E402
from simplenerf_tpu.data import preprocessor as jpre  # noqa: E402
from simplenerf_tpu.render import renderer as jrenderer  # noqa: E402
from simplenerf_tpu.training import trainer as jtrainer  # noqa: E402
from simplenerf_torch import convert  # noqa: E402
from simplenerf_torch.data import preprocessor as pre  # noqa: E402
from simplenerf_torch.data.factory import get_data_loader  # noqa: E402
from simplenerf_torch.data.synthetic import generate_scene, write_scene_priors  # noqa: E402
from simplenerf_torch.drivers import presets  # noqa: E402
from simplenerf_torch.training import trainer  # noqa: E402

STEPS = 3


def main() -> None:
    work = Path(tempfile.mkdtemp())
    root = work / "db"
    gt = generate_scene(root, num_frames=5, h=24, w=32, num_train=3, seed=3)
    write_scene_priors(root, "blobs", gt["train_frames"], gt["images"], gt["depths"],
                       gt["extrinsics"], gt["intrinsic"])
    cfg = presets.tiny_synthetic_config(num_rays=64, sparse_depth_rays=32, consistency_start_iter=1,
                                        raw_noise_std=0.0)
    cfg["model"]["perturb"] = False
    cfg["resume_training"] = False
    cfg = presets.with_visibility_priors(cfg)
    names = [spec["name"] for spec in cfg["losses"]]

    jpp = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(), seed=0)
    jt = jtrainer.Trainer(cfg, work / "jax", jpp)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    pcfg = copy.deepcopy(cfg)
    pcfg["model"]["fused_mlp"] = "auto"

    def port_trainer(out):
        raw = get_data_loader(pcfg, root, "train").load_data()
        return trainer.Trainer(pcfg, out, pre.ScenePreprocessor(pcfg, "train", raw, device="cpu", seed=0))

    g = port_trainer(work / "grads")
    shadow = jpre.ScenePreprocessor(cfg, "train", jget_data_loader(cfg, root, "train").load_data(), seed=0)
    out = {"steps": [], "losses_at_step_2": {}}
    for it in range(STEPS):
        params = jax.device_get(jt.params)
        idx, m_nerf, m_sd = shadow.next_indices(it)
        pidx = g.train_pp.next_indices(it)
        batch = jpre.gather_batch(shadow.cache, shadow.common, shadow.batch_constants(),
                                  jnp.asarray(idx), jnp.asarray(m_nerf), jnp.asarray(m_sd),
                                  packed_layout=shadow.packed_layout)
        key = jax.random.fold_in(jt.base_key, it)
        cases = [("all", jt.loss_computer.weights_vector(it))]
        if it == 2:
            cases += [(n, np.eye(len(names), dtype=np.float32)[i]) for i, n in enumerate(names)]
        for name, w in cases:
            def loss_fn(p, w=w):
                o = jrenderer.render_rays(p, jt.render_cfg, batch, key, train=True)
                return jt.loss_computer.compute(batch, o, jnp.asarray(w))[0]

            want = np.asarray(jax.flatten_util.ravel_pytree(jax.grad(loss_fn)(params))[0])
            g.set_params(convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
            total, _ = g.loss_computer.compute(
                g.batch(*pidx),
                trainer.renderer.render_rays(g.params, g.render_cfg, g.batch(*pidx), train=True,
                                             generator=g.step_generator(it)),
                w.tolist())
            if not getattr(total, "requires_grad", False):
                continue
            total.backward()
            got = np.concatenate([p.grad.numpy().reshape(-1) for p in g.leaves])
            row = {"max_abs_grad": float(np.abs(want).max()),
                   "max_abs_diff": float(np.abs(got - want).max())}
            if name == "all":
                out["steps"].append(row)
            else:
                out["losses_at_step_2"][name] = row
        jt.train_one_iter(it)

    t = port_trainer(work / "run")
    t.set_params(convert.params_from_numpy(init))
    for it in range(STEPS):
        t.train_one_iter(it)
    got = np.concatenate([p.detach().numpy().reshape(-1) for p in t.leaves])
    want = np.concatenate([np.asarray(leaf).reshape(-1)
                           for leaf in jax.tree_util.tree_leaves(jax.device_get(jt.params))])
    d = np.abs(got - want)
    out["params_after_3_steps"] = {"max_abs_diff": float(d.max()), "n_over_1e-4": int((d > 1e-4).sum()),
                                   "n_params": int(d.size)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
