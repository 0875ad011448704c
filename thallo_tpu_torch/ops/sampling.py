"""Bilinear sampling of images, image arrays and conditional image arrays,
with optional user derivative images (counterpart of
``thallo_tpu/ops/sampling.py``).

An image is ``[W, H, C]`` (an array ``[W, H, T, C]``); coordinates are
float tensors of any common shape, clamped at the border; the result is
``[..., C]``.  Sampling is a gather and a lerp in plain torch, so both AD
modes differentiate it through the lerp weights.
``sample_with_deriv_images`` replaces the coordinate derivative by the
user's dx/dy images (JAX's ``jax.custom_jvp``): a
``torch.autograd.Function`` with a ``jvp`` and its transpose as
``backward``, and a generated vmap rule, so ``torch.func.jvp``, ``vjp``
and ``vmap`` (the point Jacobians of ``lower.py``) all go through it.
The slice index of the array samples is not differentiated.
"""
from __future__ import annotations

import torch


def _gather2(img, ix, iy):
    """img [W, H, C] at int coords (clamped) -> [..., C]."""
    W, H = img.shape[0], img.shape[1]
    return img[ix.clamp(0, W - 1), iy.clamp(0, H - 1)]


def _corners(x, y):
    x0, y0 = torch.floor(x), torch.floor(y)
    return (x - x0)[..., None], (y - y0)[..., None], x0.long(), y0.long()


def bilinear_sample(img, x, y):
    """Bilinear interpolation of img ([W, H, C]) at float coords (x, y),
    clamped at the border.  Returns [..., C]."""
    fx, fy, i0, j0 = _corners(x, y)
    return (_gather2(img, i0, j0) * (1 - fx) * (1 - fy)
            + _gather2(img, i0 + 1, j0) * fx * (1 - fy)
            + _gather2(img, i0, j0 + 1) * (1 - fx) * fy
            + _gather2(img, i0 + 1, j0 + 1) * fx * fy)


class _SampleWithDerivImages(torch.autograd.Function):
    """bilinear_sample whose coordinate derivative is sampled from the
    derivative images: tangent dx(x, y)·tx + dy(x, y)·ty; backward is its
    transpose; the three images get no derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(img, dximg, dyimg, x, y):
        return bilinear_sample(img, x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, dximg, dyimg, x, y = inputs
        ctx.save_for_backward(dximg, dyimg, x, y)
        ctx.save_for_forward(dximg, dyimg, x, y)

    @staticmethod
    def jvp(ctx, t_img, t_dx, t_dy, tx, ty):
        dximg, dyimg, x, y = ctx.saved_tensors
        out = None
        for img, t in ((dximg, tx), (dyimg, ty)):
            if t is not None:
                term = bilinear_sample(img, x, y) * t[..., None]
                out = term if out is None else out + term
        if out is None:
            out = torch.zeros(x.shape + (dximg.shape[-1],), dtype=dximg.dtype,
                              device=dximg.device)
        return out

    @staticmethod
    def backward(ctx, g):
        dximg, dyimg, x, y = ctx.saved_tensors
        gx = (bilinear_sample(dximg, x, y) * g).sum(-1) if ctx.needs_input_grad[3] else None
        gy = (bilinear_sample(dyimg, x, y) * g).sum(-1) if ctx.needs_input_grad[4] else None
        return None, None, None, gx, gy


def sample_with_deriv_images(img, dximg, dyimg, x, y):
    """Bilinear sample whose coordinate derivative is taken from the
    user-provided derivative images instead of the lerp derivative."""
    return _SampleWithDerivImages.apply(img, dximg, dyimg, x, y)


def _slice(t, T):
    """The slice index round(t), clamped to [0, T), not differentiated."""
    return torch.round(t.detach()).long().clamp(0, T - 1)


def array_bilinear_sample(img, x, y, t):
    """Per-slice bilinear sampling of an image array [W, H, T, C] at float
    coords (x, y) in slice round(t), clamped at the border."""
    W, H, T = img.shape[0], img.shape[1], img.shape[2]
    ti = _slice(t, T)
    fx, fy, i0, j0 = _corners(x, y)

    def g(ix, iy):
        return img[ix.clamp(0, W - 1), iy.clamp(0, H - 1), ti]

    return (g(i0, j0) * (1 - fx) * (1 - fy) + g(i0 + 1, j0) * fx * (1 - fy)
            + g(i0, j0 + 1) * (1 - fx) * fy + g(i0 + 1, j0 + 1) * fx * fy)


def conditional_array_sample(img, x, y, t):
    """The conditional per-slice bilinear sample of an image array: corners
    out of bounds or holding the invalid sentinel (first channel -inf) are
    dropped and the remaining weights renormalized, first along each row,
    then across the two rows; where every corner is invalid the sample is
    the sentinel.  Every division is by where(w > 0, w, 1), so the
    sentinel's lanes carry no NaN into a derivative."""
    W, H, T = img.shape[0], img.shape[1], img.shape[2]
    ti = _slice(t, T)
    ax, by, i0, j0 = _corners(x, y)
    neg_inf = torch.tensor(float("-inf"), dtype=img.dtype, device=img.device)

    def corner(ix, iy):
        inb = (ix >= 0) & (iy >= 0) & (ix < W) & (iy < H)
        v = img[ix.clamp(0, W - 1), iy.clamp(0, H - 1), ti]
        valid = (inb & (v[..., 0] != neg_inf))[..., None]
        return torch.where(valid, v, torch.zeros_like(v)), valid.to(img.dtype)

    def row(iy, beta_w):
        v0, m0 = corner(i0, iy)
        v1, m1 = corner(i0 + 1, iy)
        srow = v0 * (1 - ax) * m0 + v1 * ax * m1
        wrow = (1 - ax) * m0 + ax * m1
        p = srow / torch.where(wrow > 0, wrow, torch.ones_like(wrow))
        has = (wrow > 0).to(img.dtype)
        return p * beta_w * has, beta_w * has

    s0, w0 = row(j0, 1 - by)
    s1, w1 = row(j0 + 1, by)
    ss, ww = s0 + s1, w0 + w1
    out = ss / torch.where(ww > 0, ww, torch.ones_like(ww))
    return torch.where(ww > 0, out, neg_inf)
