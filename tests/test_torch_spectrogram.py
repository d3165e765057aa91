"""Port K1 plain version (avid_cma_tpu_torch/ops/stft.py) against the JAX
audio frontend: the XLA ``log_spectrogram`` and the Pallas kernel
``log_spectrogram_pallas`` in interpret mode, at the Kinetics audio shape
(2 s at 24 kHz, 100 frames/s, n_fft 512). One sample is a loud tone over
near-silence, so the per-sample top_db clamp bites. Tolerance: max abs
1e-4 on the normalized output (f32 DFT, different summation order).

Both signals carry a small DC offset and broadband noise under the tone.
The dB of a bin whose power nearly cancels (a pure tone's far sidelobes,
or a zero-mean frame's DC bin) is ill-conditioned in f32: any two f32
DFTs disagree there by up to ~1e-3 (measured against an f64 DFT, both the
JAX and the port side err by that much), which is why the JAX package's
own kernel test allows atol 1e-3. The offset and the noise floor keep
every bin above the clamp well-conditioned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avid_cma_tpu.ops.pallas.spectrogram import log_spectrogram_pallas
from avid_cma_tpu.ops.stft import log_spectrogram as jax_log_spectrogram
from avid_cma_tpu_torch.ops import stft as port_stft
from avid_cma_tpu_torch.ops.kernels.spectrogram import log_spectrogram_kernel, packed_basis
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

KW = dict(sample_rate=24000, n_fft=512, hop_size=0.01, duration=2.0)
TOL = 1e-4


def _signal() -> np.ndarray:
    rng = np.random.default_rng(0)
    n = 48000
    noise = 0.1 * rng.standard_normal(n) + 0.05
    t = np.arange(n) / 24000.0
    loud = np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n) + 0.05
    tone = np.where(t < 1.0, loud, 1e-7 * rng.standard_normal(n))
    return np.stack([noise, tone]).astype(np.float32)


@pytest.fixture(scope="module")
def port_out():
    return port_stft.log_spectrogram(torch.from_numpy(_signal()), **KW).numpy()


def test_plain_matches_jax_xla(port_out):
    ref = np.asarray(jax_log_spectrogram(jnp.asarray(_signal()), **KW))
    assert port_out.shape == ref.shape == (2, 200, 257, 1)
    assert np.abs(port_out - ref).max() < TOL


def test_plain_matches_pallas_interpret(port_out):
    ref = np.asarray(log_spectrogram_pallas(jnp.asarray(_signal()), **KW,
                                            interpret=True))
    assert np.abs(port_out - ref).max() < TOL


def test_top_db_clamp_bites():
    db = port_stft.log_spectrogram(torch.from_numpy(_signal()), **KW,
                                   normalize=False)[1, ..., 0]
    floor = db.max() - 100.0
    assert float(db.min()) == pytest.approx(float(floor), abs=1e-4)
    assert int((db <= floor + 1e-4).sum()) > 1000  # the silent half
    ref = np.asarray(jax_log_spectrogram(jnp.asarray(_signal()), **KW,
                                         normalize=False))[1, ..., 0]
    # dB before normalization: the same 1e-4 bound in normalized units
    # (every per-bin std of the stats is >= 17.36 dB)
    assert np.abs(db.numpy() - ref).max() < TOL * 17.0


def test_frame_count_truncation():
    # int(duration * (1/hop)) is the reference order; 0.47 s at 5 ms hops
    # keeps 94 frames where int(0.47 / 0.005) would keep 93
    assert port_stft.num_frames(24000, 120, 0.47, 0.005) == 94
    assert port_stft.num_frames(48000, 240, 2.0, 0.01) == 200


def test_wrapper_takes_plain_version_on_cpu(port_out):
    out = log_spectrogram_kernel(torch.from_numpy(_signal()), **KW)
    np.testing.assert_array_equal(out.numpy(), port_out)


def _kernel_algorithm(sig: torch.Tensor, top_db=100.0, normalize=True) -> torch.Tensor:
    """K1's arithmetic written out in torch (csrc/spectrogram.cu): frames
    times the packed basis in f32, each group of four columns folded into
    one bin (the last group's fourth column is bin 0 and its third the
    Nyquist bin, whose sin is zero), dB, the per-sample clamp, normalize."""
    frame_len, hop = 1024, 240
    frames = port_stft.frame_signal(sig, frame_len, hop)[:, :200]
    v = torch.matmul(frames, torch.from_numpy(packed_basis(frame_len)))
    v = v.reshape(*v.shape[:-1], frame_len // 4, 4)
    p1 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    p2 = v[..., 2] * v[..., 2] + v[..., 3] * v[..., 3]
    p2[..., -1] = v[..., -1, 2] * v[..., -1, 2]
    fold = torch.cat([v[..., -1:, 3] * v[..., -1:, 3], (p1 + p2) * 0.5], dim=-1)
    db = 10.0 * torch.log10(torch.clamp(fold, min=1e-10))
    if top_db is not None:
        db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - top_db)
    if normalize:
        mean, std = port_stft.load_norm_stats(512, 24000)
        db = (db - torch.from_numpy(mean)) / (torch.from_numpy(std) + 1e-5)
    return db[..., None]


@pytest.mark.parametrize("normalize,top_db", [(True, 100.0), (False, None)])
def test_packed_basis_and_fold_match_plain(port_out, normalize, top_db):
    """The kernel's packed basis and epilogue, run on the CPU, give the
    plain version's output: 1e-4 normalized, 1e-4 * 17 dB un-normalized."""
    sig = torch.from_numpy(_signal())
    got = _kernel_algorithm(sig, top_db, normalize).numpy()
    ref = port_stft.log_spectrogram(sig, **KW, normalize=normalize, top_db=top_db).numpy()
    assert got.shape == ref.shape == (2, 200, 257, 1)
    assert np.abs(got - ref).max() < (TOL if normalize else TOL * 17.0)
