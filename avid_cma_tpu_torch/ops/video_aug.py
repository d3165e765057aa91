"""Video augmentation on device: the train and eval paths of
``msc+color`` and ``crop+color`` (counterpart of
avid_cma_tpu/ops/video_aug.py).

Random-resized crop with one box per clip on the integer grid (or, for
``crop+color``, an exact resize and then an integer-grid crop), bilinear
resize equal to ``jax.image.scale_and_translate(method="bilinear")``
(which antialiases when it downscales), horizontal flip, colour jitter in
the canonical brightness -> contrast -> saturation -> hue order or in a
per-clip permutation of it, ImageNet normalization; for eval, the same
resize over the whole frame, then a centre crop. Every op takes its
random draws as arguments; the caller draws them (``data/pipelines.py``),
so tests can hand the JAX ops and these the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CROP_ATTEMPTS = 10


def uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Map u ~ U[0, 1) onto [lo, hi) with the f32 arithmetic of
    ``jax.random.uniform`` (u * (hi - lo) + lo, floored at lo), so equal
    u give equal draws on both sides."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def sample_crop_box(
    u_area: torch.Tensor,
    u_logratio: torch.Tensor,
    u_top: torch.Tensor,
    u_left: torch.Tensor,
    h: int,
    w: int,
    scale: Tuple[float, float],
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[torch.Tensor, ...]:
    """RandomResizedCrop box per clip from uniform draws in [0, 1):
    u_area, u_logratio (B, attempts); u_top, u_left (B,). The first
    attempt whose rounded box fits is used, else a max-area centre crop;
    the position is drawn on the integer grid, randint(0, im - crop)
    inclusive. Returns (top, left, crop_h, crop_w), integer-valued f32
    tensors of shape (B,)."""
    target_area = h * w * uniform(u_area, scale[0], scale[1])
    log_ratio = uniform(u_logratio, np.log(np.float32(ratio[0])),
                        np.log(np.float32(ratio[1])))
    aspect = torch.exp(log_ratio)
    # round-half-even, as python round() and jnp.round
    crop_w = torch.round(torch.sqrt(target_area * aspect))
    crop_h = torch.round(torch.sqrt(target_area / aspect))
    valid = (crop_w <= w) & (crop_h <= h)
    first = torch.argmax(valid.to(torch.uint8), dim=1, keepdim=True)
    any_valid = valid.any(dim=1)

    in_ratio = w / h
    if in_ratio < ratio[0]:
        fb_w, fb_h = float(w), float(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        fb_w, fb_h = float(round(h * ratio[1])), float(h)
    else:
        fb_w, fb_h = float(w), float(h)
    c_w = torch.where(any_valid, crop_w.gather(1, first)[:, 0], fb_w)
    c_h = torch.where(any_valid, crop_h.gather(1, first)[:, 0], fb_h)

    top = torch.where(
        any_valid,
        torch.minimum(torch.floor(u_top * (h - c_h + 1.0)), h - c_h),
        torch.floor((h - c_h) / 2.0),
    )
    left = torch.where(
        any_valid,
        torch.minimum(torch.floor(u_left * (w - c_w + 1.0)), w - c_w),
        torch.floor((w - c_w) / 2.0),
    )
    return top, left, c_h, c_w


def resize_weights(in_size: int, out_size: int, scale: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """Per-clip bilinear resampling matrices (B, out_size, in_size), the
    weights ``jax.image.scale_and_translate`` builds
    (jax/_src/image/scale.py compute_weight_mat, antialias=True): the
    triangle kernel widens by 1/scale when downscaling, columns are
    normalized, and samples outside the input are zeroed."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (
        (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)[None] * inv_scale
        - translation[:, None] * inv_scale - 0.5
    )  # (B, out)
    x = torch.abs(
        sample_f[:, :, None] - torch.arange(in_size, dtype=torch.float32, device=dev)
    ) / kernel_scale[:, :, None]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=2, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        torch.abs(total) > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, 0.0)


def crop_resize(frames: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
                crop_h: torch.Tensor, crop_w: torch.Tensor,
                out_size: Tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """Bilinear crop+resize of (B, T, H, W, C) to (B, T, oh, ow, C) in
    ``dtype``: two batched products with per-clip weight matrices. The
    geometry stays f32; only the image and the weights are cast."""
    _, _, h, w, _ = frames.shape
    oh, ow = out_size
    scale_y = oh / crop_h
    scale_x = ow / crop_w
    wy = resize_weights(h, oh, scale_y, -top * scale_y).to(dtype)
    wx = resize_weights(w, ow, scale_x, -left * scale_x).to(dtype)
    x = frames.to(dtype)
    x = torch.einsum("boh,bthwc->btowc", wy, x)
    return torch.einsum("bpw,btowc->btopc", wx, x)


def flip(clips: torch.Tensor, do_flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the clips (B, T, H, W, C) where do_flip (B,)."""
    return torch.where(do_flip[:, None, None, None, None], clips.flip(3), clips)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(
        maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    sectors = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))
    out = []
    for ch in range(3):
        val = torch.zeros_like(v)
        for k in reversed(range(6)):
            val = torch.where(i == k, sectors[k][ch], val)
        out.append(val)
    return torch.stack(out, dim=-1)


def _jitter_ops(f_b, f_c, f_s, f_h, dtype):
    """The four jitter ops (brightness, contrast, saturation, hue) with
    their (B,) factors cast to ``dtype``; None for a skipped op."""
    def bc(f):
        return f.to(dtype)[:, None, None, None, None]

    def brightness(x):
        return torch.clamp(x * bc(f_b), 0.0, 1.0)

    def contrast(x):
        # per-FRAME mean luminance (PIL / torchvision adjust_contrast)
        lum = _gray(x).mean(dim=(-2, -1), keepdim=True)[..., None]
        return torch.clamp((x - lum) * bc(f_c) + lum, 0.0, 1.0)

    def saturation(x):
        gray = _gray(x)[..., None]
        return torch.clamp((x - gray) * bc(f_s) + gray, 0.0, 1.0)

    def hue(x):
        hsv = _rgb_to_hsv(x)
        shifted = torch.remainder(hsv[..., 0] + bc(f_h)[..., 0], 1.0)
        return _hsv_to_rgb(torch.stack([shifted, hsv[..., 1], hsv[..., 2]], dim=-1))

    return [op if f is not None else None
            for op, f in zip((brightness, contrast, saturation, hue), (f_b, f_c, f_s, f_h))]


def color_jitter(clips: torch.Tensor, f_b: torch.Tensor, f_c: torch.Tensor,
                 f_s: torch.Tensor, f_h: torch.Tensor,
                 perm: torch.Tensor | None = None) -> torch.Tensor:
    """Clip-consistent colour jitter of float RGB in [0, 1]. Factors are
    (B,) tensors (cast to the clips' dtype); a None factor skips its op
    (strength 0). ``perm`` None applies the canonical brightness ->
    contrast -> saturation -> hue order; else ``perm`` (B, 4), each row a
    permutation of the op ids 0-3, gives each clip its own order, skipped
    ops passed over (``order="random"`` of the JAX op). Like the JAX op
    under vmap, each position of the order evaluates every active op on
    the whole batch and selects per clip."""
    ops = _jitter_ops(f_b, f_c, f_s, f_h, clips.dtype)
    active = [k for k, op in enumerate(ops) if op is not None]
    if perm is None or len(active) <= 1:
        for k in active:
            clips = ops[k](clips)
        return clips
    # drop the skipped ops from each row, keeping the order of the rest:
    # rank every op by its position in the row, skipped ops last
    pos = torch.argsort(perm, dim=1)
    skipped = torch.tensor([op is None for op in ops], device=perm.device)
    pos = torch.where(skipped, pos + len(ops), pos)
    order = torch.argsort(pos, dim=1)[:, :len(active)]
    x = clips
    for pos in range(len(active)):
        out = x
        for k in active:
            sel = (order[:, pos] == k)[:, None, None, None, None]
            out = torch.where(sel, ops[k](x), out)
        x = out
    return x


def normalize_clip(clips: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of float RGB in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=clips.dtype, device=clips.device)
    std = torch.tensor(IMAGENET_STD, dtype=clips.dtype, device=clips.device)
    return (clips - mean) / std


def jitter_factors(u: torch.Tensor, strengths: Tuple[float, ...]):
    """Map uniform draws u (B, 4) to the (brightness, contrast, saturation,
    hue) factors; a strength of 0 gives None (op skipped)."""
    out = [
        uniform(u[:, j], max(0.0, 1.0 - s), 1.0 + s) if s > 0 else None
        for j, s in enumerate(strengths[:3])
    ]
    hue = strengths[3]
    out.append(uniform(u[:, 3], -hue, hue) if hue > 0 else None)
    return tuple(out)


def _resize_center_crop(frames: torch.Tensor, size: Tuple[int, int], crop_size: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """``jax.image.resize(method="bilinear")`` of uint8 (B, T, H, W, C) to
    ``size`` (the whole frame as the crop box of ``crop_resize``), then a
    centre crop and ImageNet normalization."""
    b, _, h, w, _ = frames.shape
    rh, rw = size
    zero = torch.zeros(b, device=frames.device)
    out = crop_resize(frames, zero, zero, torch.full_like(zero, float(h)),
                      torch.full_like(zero, float(w)), size, dtype)
    top = (rh - crop_size) // 2
    left = (rw - crop_size) // 2
    out = out[:, :, top:top + crop_size, left:left + crop_size, :]
    return normalize_clip(out / 255.0)


def crop_augment_clips_eval(frames: torch.Tensor, crop_size: int = 224,
                            resize: Tuple[int, int] = (256, 256),
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Eval path of ``crop+color``: an exact (aspect-distorting)
    Resize(resize), then a centre crop and normalize."""
    return _resize_center_crop(frames, tuple(resize), crop_size, dtype)


def crop_augment_clips_train(frames: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
                             do_flip: torch.Tensor, jitter_u: torch.Tensor,
                             perm: torch.Tensor | None, crop_size: int = 224,
                             resize: Tuple[int, int] = (256, 256),
                             color: Tuple[float, ...] = (0.4, 0.4, 0.4, 0.2),
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Train path of ``crop+color``: an exact (aspect-distorting)
    Resize(resize) of uint8 (B, T, H, W, 3), then a crop_size^2 crop at
    the integer origin (top, left) (B,) int, drawn by the caller as
    randint(0, r - crop_size + 1), then flip where ``do_flip`` (B,), the
    jitter from uniform draws ``jitter_u`` (B, 4) in the order ``perm``,
    and normalize."""
    b, _, h, w, _ = frames.shape
    rh, rw = resize
    if rh < crop_size or rw < crop_size:
        raise ValueError(f"resize {tuple(resize)} smaller than crop {crop_size}")
    zero = torch.zeros(b, device=frames.device)
    resized = crop_resize(frames, zero, zero, torch.full_like(zero, float(h)),
                          torch.full_like(zero, float(w)), (rh, rw), dtype)
    offs = torch.arange(crop_size, device=frames.device)
    rows = (top.long()[:, None] + offs)[:, :, None]   # (B, S, 1)
    cols = (left.long()[:, None] + offs)[:, None, :]  # (B, 1, S)
    bi = torch.arange(b, device=frames.device)[:, None, None]
    # advanced indices around a slice put their (B, S, S) first
    out = resized[bi, :, rows, cols].permute(0, 3, 1, 2, 4)
    out = flip(out / 255.0, do_flip)
    out = color_jitter(out, *jitter_factors(jitter_u, color), perm=perm)
    return normalize_clip(out)


def augment_clips_eval(frames: torch.Tensor, crop_size: int = 224,
                       resize: int | None = None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Eval path of ``msc+color``: short-side Resize(int(crop/0.875)) with
    the reference's truncation of the long side, int(size * long / short),
    then a centre crop and normalize."""
    _, _, h, w, _ = frames.shape
    resize = resize if resize is not None else int(crop_size / 0.875)
    if w < h:
        size = (int(resize * h / w), resize)
    else:
        size = (resize, int(resize * w / h))
    return _resize_center_crop(frames, size, crop_size, dtype)
