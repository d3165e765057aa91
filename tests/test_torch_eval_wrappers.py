"""The port's eval wrappers (avid_cma_tpu_torch/models/eval_wrappers.py,
ops/pooling.py) against the JAX package's on the CPU, at R2Plus1D-10,
4 frames x 32^2, 8 clips, a few classes, with the same random weights
carried over by ``flax_eval_to_port_state`` (strict load):

- pooling equals ``apply_pooling_op`` exactly for every spec of the
  Kinetics linear YAML, on maps whose sizes do and do not divide evenly;
- ``ClassificationWrapper`` (with and without a pooling op) and
  ``MOSTModel`` (four taps; ``l2_norm`` None, a bool or a list; with and
  without BN) forward within 1e-4 in train and eval mode, the heads' BN
  running stats after a train forward within 1e-4;
- ``MOSTModel.train()`` leaves the extractor in eval mode, and a train
  forward leaves the extractor's parameters and stats as they were;
- ``tap_shapes`` (the heads' sizes, from one forward of a zero clip)
  gives the JAX backbone's tap shapes and leaves the backbone's mode,
  parameters and BN running stats as they were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avid_cma_tpu import config as jax_config
from avid_cma_tpu.models import eval_wrappers as jax_ew
from avid_cma_tpu.models.video import R2Plus1D as JaxR2Plus1D
from avid_cma_tpu.ops.pooling import apply_pooling_op as jax_apply_pooling_op
from avid_cma_tpu_torch.models.av_wrapper import init_params
from avid_cma_tpu_torch.models.eval_wrappers import ClassificationWrapper, MOSTModel, tap_shapes
from avid_cma_tpu_torch.models.video import R2Plus1D
from avid_cma_tpu_torch.ops.pooling import apply_pooling_op, parse_pooling_op, pooled_shape
from avid_cma_tpu_torch.train.checkpoint import flax_eval_to_port_state
from tests.test_torch_models import (  # noqa: F401  (autouse fixture)
    random_variables,
    torch_threads_per_worker,
)

TOL = 1e-4
CLIP = (8, 4, 32, 32, 3)
NCLS = 7
LINEAR_YAML = "configs/benchmark/kinetics/8x224x224-linear.yaml"
# four taps at 4 x 32^2: conv2x (4, 8, 8, 64), conv3x (2, 4, 4, 128),
# conv4x (1, 2, 2, 256), conv5x (1, 1, 1, 512); pooled unevenly where the
# map allows it (8 -> 3, 4 -> 3)
TAPS = ["conv2x", "conv3x", "conv4x", "conv5x"]
TAP_POOLS = ["AdaptiveMaxPool3d((1, 3, 3))", "AdaptiveMaxPool3d((1, 3, 3))",
             "AdaptiveMaxPool3d((1, 2, 2))", None]


def _clips(seed=0):
    return np.random.default_rng(seed).standard_normal(CLIP).astype(np.float32)


def _linear_specs():
    return list(jax_config.load(LINEAR_YAML).model["args"]["pooling_ops"])


@pytest.mark.parametrize("spec", _linear_specs() + [
    "AdaptiveMaxPool3d((2, 5, 3))", "AdaptiveMaxPool2d((3, 4))", None])
@pytest.mark.parametrize("shape", [(2, 8, 24, 24, 16), (2, 3, 13, 17, 8)], ids=["even", "uneven"])
def test_pooling_equals_jax_exactly(spec, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    if spec is not None and parse_pooling_op(spec)[0] == 2:
        x = x[:, 0]  # a 2d op takes (B, H, W, C)
    want = np.asarray(jax_apply_pooling_op(jnp.asarray(x), spec))
    got = apply_pooling_op(torch.from_numpy(x), spec)
    assert tuple(got.shape) == want.shape == (x.shape[0], *pooled_shape(x.shape[1:], spec))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", ["MaxPool3d((1, 2, 2))", "AdaptiveAvgPool3d((1, 1, 1))",
                                  "AdaptiveMaxPool3d((1, 2))"])
def test_pooling_rejects_unknown_specs(spec):
    with pytest.raises(ValueError):
        parse_pooling_op(spec)


def _port(model, variables):
    model.load_state_dict(flax_eval_to_port_state(variables), strict=True)
    return model


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_tap_shapes():
    """The JAX backbone's tap shapes at CLIP, once for every case (traced
    with ``jax.eval_shape``: the shapes ``apply`` gives, without running it)."""
    x = jnp.asarray(_clips(4))
    jm = JaxR2Plus1D(depth=10)
    taps = jax.eval_shape(lambda v: jm.apply(v, x, train=False, return_embs=True),
                          random_variables(jm, 6, x))
    return {k: tuple(v.shape[1:]) for k, v in taps.items()}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_tap_shapes_match_jax_and_leave_the_backbone_as_it_was(train, jax_tap_shapes):
    net = R2Plus1D(10).train(train)
    init_params(net, torch.Generator().manual_seed(0))
    before = _state(net)
    assert tap_shapes(net, CLIP[1:4]) == jax_tap_shapes
    assert net.training == train
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


@pytest.mark.parametrize("feat_name,pooling_op", [
    ("pool", None), ("conv3x", "AdaptiveMaxPool3d((1, 3, 3))")])
def test_classification_wrapper_matches_jax(feat_name, pooling_op):
    x = _clips()
    jm = jax_ew.ClassificationWrapper(feature_extractor=JaxR2Plus1D(depth=10), n_classes=NCLS,
                                      feat_name=feat_name, pooling_op=pooling_op)
    variables = random_variables(jm, 2, jnp.asarray(x))
    pm = _port(ClassificationWrapper(R2Plus1D(10), NCLS, CLIP[1:4], feat_name=feat_name,
                                     pooling_op=pooling_op), variables)
    assert pm.classifier.in_features == variables["params"]["classifier"]["kernel"].shape[0]

    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    want, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    after = flax_eval_to_port_state({"params": variables["params"], **mut})
    sd = pm.state_dict()
    for k in (k for k in sd if "running_" in k):
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("l2_norm,use_bn", [(None, True), (True, False),
                                            ([False, True, False, True], True)])
def test_most_model_matches_jax(l2_norm, use_bn):
    x = _clips(3)
    jm = jax_ew.MOSTModel(feature_extractor=JaxR2Plus1D(depth=10), n_classes=NCLS,
                          feat_names=TAPS, pooling_ops=TAP_POOLS, l2_norm=l2_norm,
                          use_bn=use_bn)
    variables = random_variables(jm, 4, jnp.asarray(x))
    pm = _port(MOSTModel(R2Plus1D(10), NCLS, TAPS, TAP_POOLS, CLIP[1:4], l2_norm=l2_norm,
                         use_bn=use_bn), variables)
    extractor = _state(pm.feature_extractor)

    for train in (False, True):
        out = jm.apply(variables, jnp.asarray(x), train=train,
                       mutable=["batch_stats"] if train else False)
        want, mut = out if train else (out, None)
        pm.train(train)
        assert not pm.feature_extractor.training
        assert all(not m.training for m in pm.feature_extractor.modules())
        got = pm(torch.from_numpy(x))
        assert list(got) == TAPS
        for ft in TAPS:
            np.testing.assert_allclose(got[ft].detach().numpy(), np.asarray(want[ft]),
                                       atol=TOL, rtol=TOL, err_msg=f"{ft} train={train}")
    after = flax_eval_to_port_state({"params": variables["params"], **mut})
    sd = pm.state_dict()
    for k in (k for k in sd if "running_" in k and k.startswith("classifier_")):
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=k)
    for k, v in pm.feature_extractor.state_dict().items():
        assert torch.equal(v, extractor[k]), k
    assert all(not p.requires_grad for p in pm.feature_extractor.parameters())


def test_flax_eval_to_port_state_keys():
    """The converter's keys are exactly the port modules' state-dict keys
    (strict load), and the head kernels arrive transposed."""
    x = jnp.asarray(_clips())
    jm = jax_ew.MOSTModel(feature_extractor=JaxR2Plus1D(depth=10), n_classes=NCLS,
                          feat_names=["conv5x", "pool"], pooling_ops=[None, None], use_bn=True)
    variables = random_variables(jm, 5, x)
    sd = flax_eval_to_port_state(variables)
    pm = MOSTModel(R2Plus1D(10), NCLS, ["conv5x", "pool"], [None, None], CLIP[1:4], use_bn=True)
    assert set(sd) == set(pm.state_dict())
    kernel = np.asarray(variables["params"]["classifier_pool"]["classifier"]["kernel"])
    np.testing.assert_array_equal(sd["classifier_pool.classifier.weight"].numpy(), kernel.T)
    np.testing.assert_array_equal(
        sd["classifier_conv5x.bn.running_var"].numpy(),
        np.asarray(variables["batch_stats"]["classifier_conv5x"]["bn"]["var"]))
