"""Port video/audio preprocessing (avid_cma_tpu_torch/ops/video_aug.py,
data/pipelines.py) against the JAX ops fed the same random draws: the
uniform numbers JAX draws from its keys are recomputed here and handed to
the port. Crop boxes exactly; crop-resize (a crop larger than the output
and one smaller), flip, jitter with given factors, normalize, the whole
msc+color train path, the crop+color train path, jitter in a random
per-clip order (non-identity permutations), and the volume gain within
1e-4 (f32, values in [0, 1] or normalized). Both eval paths (msc+color's short-side resize,
crop+color's exact resize; each then a centre crop) on non-square raw
frames, one case downscaling and one upscaling, and ``preprocess_batch``
with ``train=False`` against the JAX one, within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avid_cma_tpu.data import pipelines as jax_pipelines
from avid_cma_tpu.ops import video_aug as jax_aug
from avid_cma_tpu_torch.data.pipelines import (
    PreprocessConfig,
    augment_clips_train,
    preprocess_batch,
)
from avid_cma_tpu_torch.ops import video_aug as port_aug
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

TOL = 1e-4


def _u(key, shape=()):
    return np.asarray(jax.random.uniform(key, shape))


def _box_draws(key):
    k_area, k_ratio, k_top, k_left = jax.random.split(key, 4)
    return _u(k_area, (10,)), _u(k_ratio, (10,)), _u(k_top), _u(k_left)


def _jitter_draws(key):
    kb, kc, ks, kh, _ = jax.random.split(key, 5)
    return np.array([_u(k) for k in (kb, kc, ks, kh)], np.float32)


@pytest.mark.parametrize("hw,scale", [((40, 48), (0.08, 1.0)), ((256, 320), (0.08, 1.0)),
                                      ((20, 200), (0.9, 1.0))],
                         ids=["small", "kinetics-raw", "fallback"])
def test_crop_box_matches(hw, scale):
    h, w = hw
    keys = jax.random.split(jax.random.key(3), 16)
    draws = [_box_draws(k) for k in keys]
    got = port_aug.sample_crop_box(
        *(torch.from_numpy(np.stack([d[i] for d in draws])) for i in range(4)),
        h, w, scale)
    for i, k in enumerate(keys):
        ref = jax_aug._sample_crop_box(k, h, w, scale)
        assert [float(g[i]) for g in got] == [float(r) for r in ref]


@pytest.mark.parametrize("box", [(3.0, 5.0, 30.0, 36.0), (10.0, 2.0, 12.0, 9.0)],
                         ids=["downscale", "upscale"])
def test_crop_resize_matches(box):
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, (3, 40, 48, 3)).astype(np.float32)
    top, left, ch, cw = box
    ref = jax_aug._crop_resize_clip(jnp.asarray(clip), jnp.float32(top), jnp.float32(left),
                                    jnp.float32(ch), jnp.float32(cw), (24, 24))
    got = port_aug.crop_resize(torch.from_numpy(clip)[None], *(
        torch.tensor([v]) for v in box), (24, 24), torch.float32)[0]
    np.testing.assert_allclose(got.numpy() / 255.0, np.asarray(ref) / 255.0, atol=TOL)


def test_flip_jitter_normalize_match():
    rng = np.random.default_rng(1)
    clips = rng.uniform(size=(3, 2, 8, 8, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), 3)
    u = np.stack([_jitter_draws(k) for k in keys])
    factors = port_aug.jitter_factors(torch.from_numpy(u), (0.4, 0.4, 0.4, 0.2))
    got = port_aug.color_jitter(torch.from_numpy(clips), *factors)
    ref = jax.jit(jax.vmap(lambda k, c: jax_aug.color_jitter_clip(k, c, 0.4, 0.4, 0.4, 0.2)))(
        keys, jnp.asarray(clips))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    flipped = port_aug.flip(torch.from_numpy(clips), torch.tensor([True, False, True]))
    np.testing.assert_array_equal(flipped[0].numpy(), clips[0][:, :, ::-1])
    np.testing.assert_array_equal(flipped[1].numpy(), clips[1])
    np.testing.assert_allclose(port_aug.normalize_clip(torch.from_numpy(clips)).numpy(),
                               np.asarray(jax_aug.normalize_clip(jnp.asarray(clips))),
                               atol=TOL)


def test_train_path_matches_augment_clips_train():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (3, 2, 40, 48, 3)).astype(np.uint8)
    key = jax.random.key(7)
    ref = jax.jit(lambda k, f: jax_aug.augment_clips_train(k, f, crop_size=32))(
        key, jnp.asarray(frames))
    rows = []
    for k in jax.random.split(key, 3):
        k_box, k_flip, k_jit = jax.random.split(k, 3)
        area, ratio, top, left = _box_draws(k_box)
        rows.append(np.concatenate([area, ratio, [top, left, _u(k_flip)],
                                    _jitter_draws(k_jit)]))
    u = torch.from_numpy(np.stack(rows).astype(np.float32))
    got = augment_clips_train(torch.from_numpy(frames), u,
                              PreprocessConfig(crop_size=32), torch.float32)
    assert got.shape == (3, 2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def _perm_draws(key, n_ops=4):
    return np.asarray(jax.random.permutation(jax.random.split(key, 5)[4], n_ops))


@pytest.mark.parametrize("color", [(0.4, 0.4, 0.4, 0.2), (0.4, 0.0, 0.4, 0.2)],
                         ids=["all-ops", "contrast-off"])
def test_random_jitter_order_matches(color):
    rng = np.random.default_rng(6)
    clips = rng.uniform(size=(6, 2, 8, 8, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), 6)
    u = np.stack([_jitter_draws(k) for k in keys])
    active = [k for k, s in enumerate(color) if s > 0]
    # JAX permutes the active ops; the port takes a permutation of the op
    # ids 0-3 and passes over the skipped ones
    perms, jax_perms = [], [list(_perm_draws(k, len(active))) for k in keys]
    for p in jax_perms:
        order = [active[i] for i in p]
        perms.append(order + [k for k in range(4) if k not in order])
    perm = torch.tensor(perms)
    assert any(p != sorted(p) for p in jax_perms)
    factors = port_aug.jitter_factors(torch.from_numpy(u), color)
    got = port_aug.color_jitter(torch.from_numpy(clips), *factors, perm=perm)
    ref = jax.jit(jax.vmap(lambda k, c: jax_aug.color_jitter_clip(k, c, *color, order="random")))(
        keys, jnp.asarray(clips))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    canonical = port_aug.color_jitter(torch.from_numpy(clips), *factors)
    assert not np.allclose(got.numpy(), canonical.numpy(), atol=TOL)


@pytest.mark.parametrize("order", ["canonical", "random"])
def test_crop_color_train_path_matches(order):
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (4, 2, 30, 40, 3)).astype(np.uint8)
    key = jax.random.key(13)
    resize, crop = (27, 32), 24
    ref = jax.jit(lambda k, f: jax_aug.crop_augment_clips_train(
        k, f, crop_size=crop, resize=resize, jitter_order=order))(key, jnp.asarray(frames))
    tops, lefts, flips, jit_u, perms = [], [], [], [], []
    for k in jax.random.split(key, 4):
        k_top, k_left, k_flip, k_jit = jax.random.split(k, 4)
        tops.append(int(jax.random.randint(k_top, (), 0, resize[0] - crop + 1)))
        lefts.append(int(jax.random.randint(k_left, (), 0, resize[1] - crop + 1)))
        flips.append(_u(k_flip) < 0.5)
        jit_u.append(_jitter_draws(k_jit))
        perms.append(_perm_draws(k_jit))
    perm = torch.tensor(np.stack(perms)) if order == "random" else None
    if perm is not None:
        assert (perm != torch.arange(4)).any()
    got = port_aug.crop_augment_clips_train(
        torch.from_numpy(frames), torch.tensor(tops), torch.tensor(lefts),
        torch.tensor(flips), torch.from_numpy(np.stack(jit_u)), perm, crop, resize)
    assert got.shape == (4, 2, crop, crop, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_msc_color_train_path_random_order_matches():
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (4, 2, 40, 48, 3)).astype(np.uint8)
    key = jax.random.key(17)
    ref = jax.jit(lambda k, f: jax_aug.augment_clips_train(
        k, f, crop_size=32, jitter_order="random"))(key, jnp.asarray(frames))
    rows, perms = [], []
    for k in jax.random.split(key, 4):
        k_box, k_flip, k_jit = jax.random.split(k, 3)
        area, ratio, top, left = _box_draws(k_box)
        rows.append(np.concatenate([area, ratio, [top, left, _u(k_flip)],
                                    _jitter_draws(k_jit)]))
        perms.append(_perm_draws(k_jit))
    perm = torch.tensor(np.stack(perms))
    assert (perm != torch.arange(4)).any()
    u = torch.from_numpy(np.stack(rows).astype(np.float32))
    got = augment_clips_train(torch.from_numpy(frames), u,
                              PreprocessConfig(crop_size=32, jitter_order="random"),
                              torch.float32, perm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_volume_gain_matches():
    k_vol = jax.random.split(jax.random.key(9))[1]
    ref = jax.random.uniform(k_vol, (4, 1), minval=0.9, maxval=1.1)
    got = port_aug.uniform(torch.from_numpy(_u(k_vol, (4, 1)).copy()), 0.9, 1.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


# (40, 30) -> 36 x 27: portrait, downscaled; (20, 26) -> 27 x 35: landscape,
# upscaled (crop 24: short side int(24 / 0.875) = 27)
@pytest.mark.parametrize("hw", [(40, 30), (20, 26)], ids=["down", "up"])
@pytest.mark.parametrize("path", ["msc+color", "crop+color"])
def test_eval_paths_match(path, hw):
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 2, *hw, 3)).astype(np.uint8)
    if path == "msc+color":
        ref = jax_aug.augment_clips_eval(jnp.asarray(frames), crop_size=24)
        got = port_aug.augment_clips_eval(torch.from_numpy(frames), crop_size=24)
    else:
        ref = jax_aug.crop_augment_clips_eval(jnp.asarray(frames), 24, (27, 32))
        got = port_aug.crop_augment_clips_eval(torch.from_numpy(frames), 24, (27, 32))
    assert got.shape == (2, 2, 24, 24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("transform", ["msc+color", "crop+color"])
def test_preprocess_batch_eval_matches(transform):
    rng = np.random.default_rng(5)
    batch = {"frames": rng.integers(0, 256, (2, 2, 30, 40, 3)).astype(np.uint8),
             "audio": rng.standard_normal((2, 4800)).astype(np.float32),
             "index": np.array([3, 1])}
    kw = dict(transform=transform, crop_size=24, resize=(27, 32), audio_clip_duration=0.2)
    ref = jax_pipelines.preprocess_batch(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()},
        jax_pipelines.PreprocessConfig(**kw), train=False)
    got = preprocess_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                           PreprocessConfig(**kw), train=False)
    for k in ("frames", "audio"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=TOL, err_msg=k)


def test_config_raises_only_for_what_is_not_ported():
    with pytest.raises(ValueError, match="unknown transform"):
        PreprocessConfig(transform="msc")
    with pytest.raises(ValueError, match="jitter order"):
        PreprocessConfig(jitter_order="shuffled")
    # every transform and jitter order has a train path: each draws from
    # the generator and is reproducible from its seed
    frames = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, 2, 30, 40, 3)).astype(np.uint8))
    for transform in ("msc+color", "crop+color"):
        for order in ("canonical", "random"):
            cfg = PreprocessConfig(transform=transform, crop_size=24, resize=(27, 32),
                                   jitter_order=order)
            a, b = (preprocess_batch({"frames": frames}, cfg,
                                     torch.Generator().manual_seed(1))["frames"]
                    for _ in range(2))
            assert a.shape == (2, 2, 24, 24, 3)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
