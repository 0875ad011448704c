"""Image warping example (the reference's examples/image_warping): ARAP
2-D mesh warp driven by point constraints, solved with GN and LM,
emitting finalCosts.json / perf.json like the reference's combined-solver
driver.  With --image it runs at the real image's resolution (mask from
--mask if given) and writes the forward-warped image, the analog of the
reference example's result rendering.

    python -m thallo_tpu_torch.examples.image_warping [--size N] [--device cpu]
"""
import argparse

import numpy as np

from ..models import image_warping
from ..utils.harness import run_solvers
from . import unknown


def _warp_render(img, offset):
    """Forward-splat img through the solved per-pixel warp positions
    (the reference renders the deformed grid; this is the numpy
    equivalent good enough for a result artifact)."""
    W, H = offset.shape[:2]
    out = np.zeros_like(img, dtype=np.float64)
    wsum = np.zeros(img.shape[:2], np.float64)
    tx = np.clip(np.round(offset[..., 0]).astype(np.int64), 0, W - 1)
    ty = np.clip(np.round(offset[..., 1]).astype(np.int64), 0, H - 1)
    flat = tx * H + ty
    np.add.at(wsum.reshape(-1), flat.reshape(-1), 1.0)
    if img.ndim == 2:
        np.add.at(out.reshape(-1), flat.reshape(-1), img.reshape(-1))
    else:
        for c in range(img.shape[2]):
            np.add.at(out.reshape(-1, img.shape[2])[:, c], flat.reshape(-1),
                      img[..., c].reshape(-1))
    w = np.maximum(wsum, 1e-9)
    return (out / (w[..., None] if img.ndim == 3 else w)).astype(img.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128,
                    help="synthetic grid size (ignored with --image)")
    ap.add_argument("--image", default=None, help="input image file")
    ap.add_argument("--mask", default=None,
                    help="mask image (nonzero pixels excluded, as the "
                         "reference's mask semantics)")
    ap.add_argument("--out-image", default=None,
                    help="write the warped image here (with --image)")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--liters", type=int, default=20)
    ap.add_argument("--out", default="results/image_warping")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.image:
        from ..io import load_image

        img = load_image(args.image)
        H_img, W_img = img.shape[:2]
        # unknown grid indexed [x, y] == [col-major of the image]
        inputs = image_warping.synthetic_inputs(W_img, H_img)
        if args.mask:
            m = load_image(args.mask)
            if m.ndim == 3:
                m = m[..., 0]
            inputs["Mask"] = (m.T > 0.5).astype(np.float32)
        sizes = {"W": W_img, "H": H_img}
        make_inputs = lambda: inputs  # noqa: E731
    else:
        sizes = {"W": args.size, "H": args.size}
        make_inputs = lambda: image_warping.synthetic_inputs(  # noqa: E731
            args.size, args.size)

    results = run_solvers(image_warping.make_spec, make_inputs, sizes,
                          nonlinear_iters=args.iters, linear_iters=args.liters,
                          out_dir=args.out, plan_options={"device": args.device})
    for solver, r in results.items():
        print(f"{solver}: {r['initial_cost']:.4f} -> {r['final_cost']:.6f} "
              f"({r['solve_time_s']:.2f}s)")

    if args.image and args.out_image:
        from ..io import save_image

        best = results.get("gauss_newton") or next(iter(results.values()))
        offset = unknown(best["plan"], "Offset")
        warped = _warp_render(np.asarray(img.T if img.ndim == 2
                                         else np.transpose(img, (1, 0, 2))), offset)
        warped = warped.T if warped.ndim == 2 else np.transpose(warped, (1, 0, 2))
        save_image(args.out_image, warped)
        print(f"warped image -> {args.out_image}")
    return results


if __name__ == "__main__":
    main()
