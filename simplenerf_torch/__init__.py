"""simplenerf_torch: SimpleNeRF trained and served with PyTorch and hand-written CUDA kernels.

The PyTorch port of `simplenerf_tpu`, which stays beside it as the
reference. Each module keeps the name and place of its JAX counterpart
(`fields/`, `ops/`, `render/`, `geometry/`, `data/`, `training/`,
`drivers/`, `qa/`, `dataset_tools/`, `config.py`) and computes the same
function, tested against it.

Ported so far: training with validation renders, traces and plots
(`drivers.runner.start_training` -> `training.trainer.Trainer` ->
`render.renderer.render_rays(train=True)`, `losses/`, flat Adam), test-time
rendering with QA (`drivers.runner.start_testing` ->
`training.tester.Tester.predict_frame`, `qa.runner.QARunner`), videos
(`drivers.runner.start_testing_videos`) and the LLFF experiment driver
(`python -m simplenerf_torch.drivers.llff`). The field MLPs run in CUDA
kernels: forward and ensemble forward in `ops/csrc/fused_mlp_fwd.cu`, their
backward in `ops/csrc/fused_mlp_bwd.cu`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"
