"""The bf16 forward kernel's output planes on the published programs, saved
from one checkout and compared bit for bit with another's: whether two
builds of the forward (this checkout's and an earlier commit's) compute
the same bits.

    python3 tools/fwd_bits.py --save A.pt                # this checkout's kernel
    python3 tools/fwd_bits.py --save B.pt --parent DIR   # DIR's package and kernel
    python3 tools/fwd_bits.py --compare A.pt B.pt        # one JSON line

Needs one CUDA card. The programs, on chip_smoke.py's seeded operands: the
main MLP at the render's chunks (65,536 rays x 192 fine and x 64 coarse)
and at a ragged 1037 x 64, the coarse trio at the training step's 4096 x
64, and ViP-NeRF's MLP (visibility head) with two secondary views a point
(the forward's kPre instance) at its training step's 4096 x 192. With
--parent DIR the package comes from DIR (unpack `git archive <commit>`
into a gitignored directory such as build/parent); the operands are made
by the same seeded calls on both sides. --compare prints, for each program
and plane, whether the two files hold the same bits and, where not, the
count of elements that differ and their largest difference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CHUNK, STEP = 65536, 4096


def planes() -> dict:
    """name -> the forward's planes (float32, on the CPU) of each program."""
    import torch

    import chip_smoke
    from simplenerf_torch.fields import mlp
    from simplenerf_torch.ops import fused_mlp

    bf = torch.bfloat16
    out = {}
    for name, nr, ns in (("fine chunk", CHUNK, 192), ("coarse chunk", CHUNK, 64), ("ragged", 1037, 64)):
        ops = chip_smoke.kernel_operands(mlp.MLPConfig(), nr, ns, bf, seed=ns)
        out[name] = torch.stack(fused_mlp.fused_apply(*ops)).cpu()
    ens, kps, lo, hvxs = chip_smoke.ensemble_operands(STEP, 64, bf, seed=5)
    out["trio step"] = torch.stack(fused_mlp.fused_apply_ensemble(ens, kps, lo, hvxs)).cpu()
    cfg = mlp.MLPConfig(predict_visibility=True)
    g = torch.Generator().manual_seed(7)
    params = mlp.init(g, cfg, device="cuda")
    pts = (torch.rand((STEP * 192, 3), generator=g) * 2 - 1).cuda()
    dirs = torch.nn.functional.normalize(torch.randn((STEP, 3), generator=g), dim=-1).cuda()
    dirs2 = torch.nn.functional.normalize(torch.randn((STEP * 192, 2, 3), generator=g), dim=-1).cuda()
    ops = mlp.fused_operands(params, cfg, pts, dirs, 192, bf)
    sec = mlp.secondary_operands(params, cfg, dirs2, bf)
    out["vipnerf step (kPre)"] = torch.stack(fused_mlp.fused_apply(*ops, sec=sec)).cpu()
    torch.cuda.synchronize()
    return out


def compare(a: dict, b: dict) -> dict:
    import torch

    out = {}
    for name in a:
        for j, (x, y) in enumerate(zip(a[name], b[name])):
            differ = int((x != y).sum())  # NaN differs from itself: counted
            out[f"{name} plane {j}"] = {"equal": torch.equal(x, y), "differ": differ,
                                        "max_abs_diff": float((x - y).abs().max()) if differ else 0.0}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", type=Path, help="write this (or --parent's) kernel's planes here")
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit whose package to run")
    ap.add_argument("--compare", type=Path, nargs=2, help="two files written by --save")
    args = ap.parse_args()
    import torch

    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        if list(a) != list(b) or any(a[k].shape != b[k].shape for k in a):
            raise SystemExit("the two files hold other programs or shapes")
        res = compare(a, b)
        print(json.dumps({"bits_equal": all(r["equal"] for r in res.values()), "planes": res}))
        return 0
    import chip_smoke  # this checkout's: its helpers import the package lazily

    if args.parent:  # the package, its kernel sources and wrappers from the other checkout
        sys.path.insert(0, str(args.parent.resolve()))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from simplenerf_torch.ops import build

    print(f"{chip_smoke.card_line()}; kernel sources {build.CSRC}", flush=True)
    args.save.parent.mkdir(parents=True, exist_ok=True)
    torch.save(planes(), args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
