"""Port backbones + AV wrapper (avid_cma_tpu_torch/models/) against the JAX
models at a small size: AVWrapper(R2Plus1D-10, Conv2D-10, [512, 512, 128])
at 4 frames x 32^2, with the same random weights carried over by
``flax_to_port_state`` (strict load). Eval-mode forward within 1e-4;
train-mode forwards (batch statistics, the stem through the port's
scale_relu_pool) within 1e-4 and the BatchNorm running stats after two
of them within 1e-4; parameter counts of depths 10/18/34 equal.

Batch 4: at 32^2 the conv5x BatchNorm normalizes over B*T*H*W = B values
per channel, and with B = 2 the f32 fast variance of two nearly equal
values is ill-conditioned (errors up to ~5e-3 after normalization, on
either side); four values make it well-conditioned."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avid_cma_tpu.models import av_wrapper as jax_av_wrapper
from avid_cma_tpu.models.video import R2Plus1D as JaxR2Plus1D
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.models.video import R2Plus1D
from avid_cma_tpu_torch.train.checkpoint import flax_to_port_state

TOL = 1e-4
VIDEO = (4, 4, 32, 32, 3)
AUDIO = (4, 24, 33, 1)


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    """torch's CPU threads for the module's tests: under pytest-xdist,
    this worker's share of the cores (each worker would otherwise start a
    thread a core, and the workers' spinning threads starve each other);
    in a serial run, as they were. Restored after the module; the port's
    test modules import it (an autouse fixture applies where it is
    imported)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)


def random_variables(model, seed, *inputs):
    """Random flax variables of the model's structure (jax.eval_shape: no
    init compile), with non-trivial BN scale/bias/stats."""
    shapes = jax.eval_shape(
        lambda *x: model.init(jax.random.key(0), *x, train=False), *inputs)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / math.sqrt(math.prod(s.shape[:-1]))
            v = rng.normal(0.0, std, s.shape)
        elif name in ("scale", "var"):
            v = 1.0 + 0.2 * rng.uniform(size=s.shape)
        else:  # bias, BN mean
            v = 0.1 * rng.normal(size=s.shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models():
    jm = jax_av_wrapper(video_backbone="R2Plus1D", video_backbone_args={"depth": 10},
                        audio_backbone="Conv2D", audio_backbone_args={"depth": 10},
                        proj_dim=[512, 512, 128])
    pm = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                    proj_dim=[512, 512, 128], device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    video = rng.standard_normal(VIDEO).astype(np.float32)
    audio = rng.standard_normal(AUDIO).astype(np.float32)
    jm, pm = _models()
    variables = random_variables(jm, 1, jnp.asarray(video), jnp.asarray(audio))
    pm.load_state_dict(flax_to_port_state(variables), strict=True)
    return jm, pm, variables, video, audio


def test_state_dict_keys_are_reference_keys(setup):
    _, pm, _, _, _ = setup
    keys = set(pm.state_dict())
    for k in ("video_model.conv1.0.weight", "video_model.conv1.1.running_var",
              "video_model.conv2x.spt_conv1.weight", "video_model.conv5x.res_conv.weight",
              "audio_model.block1.conv1.weight", "audio_model.conv1.1.weight",
              "video_proj.projection.0.weight", "audio_proj.projection.4.bias"):
        assert k in keys, k
    assert not any("num_batches_tracked" in k for k in keys)


def test_eval_forward_matches(setup):
    jm, pm, variables, video, audio = setup
    rv, ra = jax.jit(lambda var, v, a: jm.apply(var, v, a, train=False))(
        variables, jnp.asarray(video), jnp.asarray(audio))
    pm.eval()
    with torch.no_grad():
        pv, pa = pm(torch.from_numpy(video), torch.from_numpy(audio))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ra), rtol=TOL, atol=TOL)


def test_taps_match(setup):
    jm, pm, variables, video, audio = setup
    ref = jax.jit(lambda var, v, a: jm.apply(var, v, a, train=False,
                                             method="embeddings"))(
        variables, jnp.asarray(video), jnp.asarray(audio))
    pm.eval()
    with torch.no_grad():
        got = pm.embeddings(torch.from_numpy(video), torch.from_numpy(audio))
    for tower, names in (("video", ("conv1", "conv2x", "conv3x", "conv4x", "conv5x", "pool")),
                         ("audio", ("conv2x", "conv3x", "conv4x", "conv5x", "pool"))):
        assert set(got[tower]) == set(ref[tower]) == set(names)
        for name in names:  # (B, T, H, W, C) / (B, T, F, C) layouts, as in JAX
            np.testing.assert_allclose(got[tower][name].numpy(), np.asarray(ref[tower][name]),
                                       rtol=TOL, atol=TOL, err_msg=f"{tower}.{name}")


def test_train_forward_and_batch_stats_after_two_steps(setup):
    jm, pm, variables, video, audio = setup
    fwd = jax.jit(lambda var, v, a: jm.apply(var, v, a, train=True,
                                             mutable=["batch_stats"]))
    params, stats = variables["params"], variables["batch_stats"]
    pm.load_state_dict(flax_to_port_state(variables), strict=True)
    pm.train()
    for step in range(2):
        v, a = video * (1 + step), audio - step
        (rv, ra), mut = fwd({"params": params, "batch_stats": stats},
                            jnp.asarray(v), jnp.asarray(a))
        stats = mut["batch_stats"]
        with torch.no_grad():
            pv, pa = pm(torch.from_numpy(v), torch.from_numpy(a))
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pa.numpy(), np.asarray(ra), rtol=TOL, atol=TOL)
    ref = flax_to_port_state({"params": params, "batch_stats": stats})
    got = pm.state_dict()
    stat_keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * 26  # 17 video + 9 audio BatchNorms
    for k in stat_keys:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("depth", [10, 18, 34])
def test_parameter_counts_match(depth):
    shapes = jax.eval_shape(
        lambda x: JaxR2Plus1D(depth=depth).init(jax.random.key(0), x, train=False),
        jax.ShapeDtypeStruct((1, 4, 32, 32, 3), jnp.float32))
    n_jax = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes["params"]))
    n_port = sum(p.numel() for p in R2Plus1D(depth=depth).parameters())
    assert n_port == n_jax
