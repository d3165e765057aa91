"""The port's host data layer (avid_cma_tpu_torch/data/: decode, video_db,
datasets, learnable, loader; native/) against the JAX package's: for one
seed and config, the loaders of both give the same batches (equal uint8
frames, f32 audio, indices and labels) across two epochs and after
``set_start_batch``, for the threaded, cached and native loader kinds on
the synthetic Kinetics and the learnable dataset; each rank's shard of a
multi-process run equals the JAX ``ShardedBatchSampler``'s; plus the
device prefetch on the CPU and the native ring's build failure."""

import numpy as np
import pytest
import torch

from avid_cma_tpu.config import from_dict as jax_from_dict
from avid_cma_tpu.data.loader import ShardedBatchSampler as JaxSampler
from avid_cma_tpu.train import builders as jax_builders
from avid_cma_tpu_torch import native
from avid_cma_tpu_torch.config import from_dict
from avid_cma_tpu_torch.data import decode
from avid_cma_tpu_torch.data.loader import ShardedBatchSampler
from avid_cma_tpu_torch.data.prefetch import device_prefetch
from avid_cma_tpu_torch.train import builders
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)


def _db(name):
    db = {"name": name, "backend": "synthetic", "synthetic_size": 16, "batch_size": 8,
          "video_clip_duration": 0.5, "video_fps": 8.0, "audio_clip_duration": 0.25,
          "audio_fps": 24000, "decode_size": [24, 32],
          "train": {"split": "train", "use_augmentation": True, "drop_last": True,
                    "clips_per_video": 2},
          "test": {"split": "val", "use_augmentation": False, "drop_last": True}}
    if name == "synthetic_av":
        db["num_classes"] = 4
    return db


def _batches(loader, epoch, start=0):
    loader.set_epoch(epoch)
    if start:
        loader.set_start_batch(start)
    return list(loader)


def _assert_same(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches) > 0
    for p, j in zip(port_batches, jax_batches):
        assert sorted(p) == sorted(j)
        for k in j:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.mark.parametrize("kind", ["threaded", "cached", "native"])
@pytest.mark.parametrize("name", ["kinetics", "synthetic_av"])
def test_loaders_match_jax(name, kind):
    db = _db(name)
    labels = name == "synthetic_av"
    loaders = []
    for mod, wrap in ((builders, from_dict), (jax_builders, jax_from_dict)):
        cfg = wrap(db)
        ds = mod.build_dataset(cfg, cfg.train, mode="clip", return_labels=labels)
        loaders.append(mod.build_dataloader(ds, cfg, cfg.train, num_workers=2, seed=3,
                                            kind=kind))
    port, ref = loaders
    assert len(port) == len(ref) == 4
    first = _batches(port, 0)
    _assert_same(first, _batches(ref, 0))
    assert first[0]["frames"].shape == (8, 4, 24, 32, 3)
    assert first[0]["audio"].shape == (8, 6000) and first[0]["audio"].dtype == np.float32
    _assert_same(_batches(port, 1), _batches(ref, 1))
    _assert_same(_batches(port, 1, start=3), _batches(ref, 1, start=3))
    if kind != "cached":  # the cache replays the epoch it filled
        assert not np.array_equal(first[0]["index"], _batches(port, 1)[0]["index"])


@pytest.mark.parametrize("n,shards", [(17, 2), (16, 4), (3, 4)])
def test_rank_shards_match_jax_sampler(n, shards):
    """The loop's per-rank loader shard (num_shards = world, shard_index =
    rank) against JAX's sampler: the same batches every epoch, equal
    counts on every rank (the padding repeats rows when the world
    outgrows the data), and together every row."""
    for shuffle, drop_last in ((True, True), (False, False)):
        seen = []
        for rank in range(shards):
            kw = dict(batch_size=2, shuffle=shuffle, drop_last=drop_last, num_shards=shards,
                      shard_index=rank, seed=3)
            mine, theirs = ShardedBatchSampler(n, **kw), JaxSampler(n, **kw)
            for epoch in (0, 1):
                mine.set_epoch(epoch)
                theirs.set_epoch(epoch)
                got = [b.tolist() for b in mine]
                assert got == [b.tolist() for b in theirs] and len(got) == len(mine)
                if epoch == 0:
                    seen += [i for b in got for i in b]
            assert len(mine) == len(ShardedBatchSampler(n, **{**kw, "shard_index": 0}))
        if not drop_last:
            assert set(seen) == set(range(n))


def test_datasets_and_backends_match_jax():
    from avid_cma_tpu.data import datasets as jax_datasets
    from avid_cma_tpu_torch.data import datasets

    for cls, kw in (("UCF", {}), ("HMDB", {}), ("AudioSet", {"return_audio": True})):
        port = getattr(datasets, cls)("train", backend="synthetic", synthetic_size=4,
                                      decode_size=(16, 20), **kw)
        ref = getattr(jax_datasets, cls)("train", backend="synthetic", synthetic_size=4,
                                         decode_size=(16, 20), **kw)
        assert list(port.video_fns) == list(ref.video_fns)
        for k, v in ref[1].items():
            np.testing.assert_array_equal(port[1][k], v, err_msg=f"{cls} {k}")
    with pytest.raises(RuntimeError, match="real decoder"):
        datasets._guard_real_listing(decode.SyntheticBackend(), "auto")
    with pytest.raises(ValueError, match="unknown decode backend"):
        decode.make_backend("nope")
    assert len(datasets.AudioSetClasses()) == 527


def test_device_prefetch_on_the_cpu_passes_batches_through():
    batches = [{"frames": np.full((2, 3), i, np.uint8), "index": np.arange(2) + i}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", depth=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert b["frames"].dtype == torch.uint8 and int(b["frames"][0, 0]) == i
        assert torch.equal(b["index"], torch.arange(2) + i)
    with pytest.raises(ValueError, match="depth"):
        next(device_prefetch(iter(batches), "cpu", depth=0))


def test_native_build_failure_raises_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", ["g++", "-O2", "-shared", "-fPIC", "--no-such-option-xyz"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build()
    monkeypatch.setattr(native, "CXX", ["no-such-compiler-xyz"])
    with pytest.raises(RuntimeError, match="cannot run"):
        native._build()
