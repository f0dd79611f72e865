"""simplenerf_torch: SimpleNeRF served with PyTorch and hand-written CUDA kernels.

The PyTorch port of `simplenerf_tpu`, which stays beside it as the
reference. Each module keeps the name and place of its JAX counterpart
(`fields/`, `ops/`, `render/`, `geometry/`, `data/`, `training/`,
`drivers/`, `config.py`) and computes the same function, tested against it.

This slice serves: test-time rendering of a trained model
(`drivers.runner.start_testing` -> `training.tester.Tester.predict_frame`
-> `render.renderer.render_rays(train=False)`), with the field MLP forward
running in the CUDA kernel of `ops/csrc/fused_mlp_fwd.cu`. Training comes
in a later slice.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"
