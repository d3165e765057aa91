"""Action-recognition evaluation: the full finetune and the multi-tap
linear probe (counterpart of avid_cma_tpu/train/eval_loop.py, one
device).

Capability reference:
  * eval-action-recg.py:29-185: the UCF/HMDB full finetune: a warmup
    training the classifier only (:74-84), the epoch loop with a clip test
    after every epoch, the final clip test at 25 clips a video, then the
    dense video eval, the softmax averaged over a video's clips
    (:100-110, 154-157);
  * eval-action-recg-linear.py:29-195: the Kinetics linear probe over
    several frozen taps, the per-tap losses summed into one backward
    (:142-163).

The warmup trains the classifier's parameters only: the backbone's take no
update (weight decay included) and, held with ``requires_grad`` off,
build no backward (no K3 on the card); it still runs in training mode, so
its BN running stats move, as the JAX warmup's ``train=True`` forward.
The finetune then starts a fresh optimizer and schedule, whose
milestones count finetune epochs only.

Every random draw of a train step is seeded by the step: the
preprocessing from (123 for the finetune, 7 for the probe, step), the
dropout masks from (the eval config's seed, step), so a resumed run
repeats the straight run bit for bit. The multi-process lockstep of the
JAX loop (``sync_any``, ``sync_counts``) is ROADMAP A6b.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.config import Config
from avid_cma_tpu_torch.data.loader import DataLoader
from avid_cma_tpu_torch.data.pipelines import PreprocessConfig, preprocess_batch
from avid_cma_tpu_torch.data.prefetch import device_prefetch
from avid_cma_tpu_torch.device import compute_dtype, prepare_device
from avid_cma_tpu_torch.models.av_wrapper import BACKBONES, init_params
from avid_cma_tpu_torch.models.eval_wrappers import (
    ClassificationWrapper,
    MOSTModel,
    classifier_parameters,
)
from avid_cma_tpu_torch.train import builders
from avid_cma_tpu_torch.train.checkpoint import (
    CheckpointManager,
    import_model_pth_tar,
    import_model_run,
)
from avid_cma_tpu_torch.train.optim import build_from_config
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import evaluating
from avid_cma_tpu_torch.utils.logger import AverageMeter, Logger, ProgressMeter

Logits = Union[torch.Tensor, Dict[str, torch.Tensor]]
FINETUNE_SEED, PROBE_SEED = 123, 7  # the preprocessing's seeds (eval_loop.py:538, :899)
PRINT_FREQ = 50


def _mix(seed: int, step: int) -> int:
    return (int(seed) + 1) * 1_000_003 + int(step)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_supervised_train_step(multi_output: bool = False, seed: int = 0
                               ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                             Tuple[Dict[str, torch.Tensor], Logits]]:
    """step(state, frames, labels) -> (metrics, logits): the cross-entropy
    finetune or probe step (eval_loop.py:79-133) on preprocessed frames,
    the model in training mode; for ``multi_output`` (``MOSTModel``) the
    per-tap losses are summed into one backward, and metrics holds each
    tap's loss beside the sum. The dropout masks come from the state's
    generator, seeded from (seed, step). Updates ``state`` in place."""

    def step(state: TrainState, frames: torch.Tensor, labels: torch.Tensor):
        model = state.model
        model.train()
        state.generator.manual_seed(_mix(seed + 1, state.step))
        out = model(frames, generator=state.generator)
        labels = labels.long()
        if multi_output:
            losses = {ft: F.cross_entropy(logits, labels) for ft, logits in out.items()}
            loss = sum(losses.values())
        else:
            losses = {}
            loss = F.cross_entropy(out, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        metrics = {**{k: v.detach() for k, v in losses.items()}, "loss": loss.detach()}
        logits = ({k: v.detach() for k, v in out.items()} if multi_output else out.detach())
        return metrics, logits

    return step


def make_fused_supervised_step(pp_cfg: PreprocessConfig, pp_seed: int,
                               multi_output: bool = False, seed: int = 0
                               ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                             Tuple[Dict[str, torch.Tensor], Logits]]:
    """fused(state, raw_frames, labels): the train preprocessing of raw
    uint8 frames (B, T, H, W, 3) on their device, its draws from a
    generator seeded from (``pp_seed``, step), then
    ``make_supervised_train_step``'s step."""
    inner = make_supervised_train_step(multi_output, seed)
    gens: Dict[torch.device, torch.Generator] = {}

    def fused(state: TrainState, raw_frames: torch.Tensor, labels: torch.Tensor):
        gen = gens.setdefault(raw_frames.device, torch.Generator(device=raw_frames.device))
        gen.manual_seed(_mix(pp_seed, state.step))
        frames = preprocess_batch({"frames": raw_frames}, pp_cfg, gen, train=True)["frames"]
        return inner(state, frames, labels)

    return fused


def make_logits_fn(model: torch.nn.Module) -> Callable[[torch.Tensor], Logits]:
    """fn(frames) -> f32 logits (or a dict of them per tap) of the model in
    eval mode under ``torch.inference_mode``; the model's mode is kept."""

    def fn(frames: torch.Tensor) -> Logits:
        with evaluating(model):
            return model(frames)

    return fn


@contextlib.contextmanager
def frozen(module: torch.nn.Module) -> Iterator[None]:
    """``requires_grad`` off for ``module``'s parameters inside the block
    (the warmup's backbone: no update, no backward), as it was after."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(module.parameters(), flags):
            p.requires_grad_(flag)


def _topk_counts(logits: np.ndarray, labels: np.ndarray, maxk: int = 5) -> np.ndarray:
    """[correct@1, correct@maxk, total] (eval_loop.py:195-207)."""
    pred = np.argsort(-np.asarray(logits), axis=1)[:, :maxk]
    labels = np.asarray(labels)
    correct = pred == labels[:, None]
    return np.asarray([correct[:, :1].any(axis=1).sum(), correct.any(axis=1).sum(),
                       labels.shape[0]], np.int64)


def _rates(counts: np.ndarray) -> Tuple[float, float]:
    n = max(int(counts[2]), 1)
    return 100.0 * int(counts[0]) / n, 100.0 * int(counts[1]) / n


def _taps(out: Logits) -> Dict[Optional[str], torch.Tensor]:
    return dict(out) if isinstance(out, dict) else {None: out}


def _untap(results: Dict[Optional[str], Tuple[float, float]]):
    return results[None] if list(results) == [None] else results


def _eval_frames(frames: torch.Tensor, pp_cfg: PreprocessConfig) -> torch.Tensor:
    with torch.inference_mode():
        return preprocess_batch({"frames": frames}, pp_cfg, train=False)["frames"]


def _clip_eval(logits_fn: Callable[[torch.Tensor], Logits], loader, pp_cfg: PreprocessConfig,
               device: torch.device, max_batches: Optional[int] = None):
    """Clip-level (top-1, top-5) in percent (eval_loop.py:637-662), or
    {tap: (top-1, top-5)} for a multi-tap model."""
    counts: Dict[Optional[str], np.ndarray] = {}
    for it, batch in enumerate(device_prefetch(loader, device)):
        labels = batch["label"].cpu().numpy()
        for tap, logits in _taps(logits_fn(_eval_frames(batch["frames"], pp_cfg))).items():
            counts[tap] = counts.get(tap, np.zeros(3, np.int64)) + _topk_counts(
                logits.float().cpu().numpy(), labels)
        if max_batches is not None and it + 1 >= max_batches:
            break
    return _untap({tap: _rates(c) for tap, c in (counts or {None: np.zeros(3)}).items()})


def _dense_eval(logits_fn: Callable[[torch.Tensor], Logits], dense_ds, pp_cfg: PreprocessConfig,
                batch_clips: int, device: torch.device, workers: int = 1,
                max_videos: Optional[int] = None):
    """Dense video eval (eval_loop.py:665-802): the f32 softmax of every
    clip of a video, averaged per video, then (top-1, top-5) in percent
    (or {tap: ...}). The (video, clip) rows are flattened into one queue
    that feeds batches of a fixed ``batch_clips`` rows, the last padded by
    repeating its last row, so every forward has one shape."""
    total = len(dense_ds) if max_videos is None else min(max_videos, len(dense_ds))
    loader = DataLoader(dense_ds, batch_size=1, shuffle=False, drop_last=False,
                        num_workers=max(workers, 1))
    rows_per_flush = max(int(batch_clips), 1)
    prob_sum: list = []  # per video: tap -> running sum of probabilities
    clip_cnt: list = []
    labels: list = []

    def row_gen():
        for vi, sample in enumerate(loader):
            if vi >= total:
                break
            frames = np.asarray(sample["frames"][0])  # (clips, T, H, W, 3)
            slot = len(labels)
            labels.append(np.asarray(sample["label"])[0])
            prob_sum.append({})
            clip_cnt.append(0)
            for c in range(frames.shape[0]):
                yield slot, frames[c]

    gen = row_gen()
    taps = [None]
    while True:
        rows, slots = [], []
        for slot, row in gen:
            rows.append(row)
            slots.append(slot)
            if len(rows) == rows_per_flush:
                break
        if not rows:
            break
        k = len(rows)
        arr = np.stack(rows + [rows[-1]] * (rows_per_flush - k))
        out = _taps(logits_fn(_eval_frames(torch.from_numpy(arr).to(device), pp_cfg)))
        taps = list(out)
        for tap, logits in out.items():
            probs = torch.softmax(logits[:k].float(), dim=-1).cpu().numpy()
            for s, p in zip(slots, probs):
                prob_sum[s][tap] = prob_sum[s].get(tap, 0.0) + p
        for s in slots:
            clip_cnt[s] += 1

    results = {}
    for tap in taps:
        counts = (_topk_counts(np.stack([ps[tap] / c for ps, c in zip(prob_sum, clip_cnt)]),
                               np.asarray(labels))
                  if labels else np.zeros(3, np.int64))
        results[tap] = _rates(counts)
    return _untap(results)


def _train_epochs(state: TrainState, fused_step: Callable, loader, epochs: int,
                  logger: Logger, phase: str, debug: bool, device: torch.device,
                  start_epoch: int = 0,
                  on_epoch_end: Optional[Callable[[TrainState, int], None]] = None,
                  track_accuracy: bool = True) -> TrainState:
    """The epoch loop of the finetune, warmup and probe phases
    (eval_loop.py:536-624): ``fused_step`` (``make_fused_supervised_step``)
    on each raw batch on the device, the schedule stepped once an epoch,
    then ``on_epoch_end(state, epoch)``. Losses (and correct counts) stay
    on the device until a print point drains them."""
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        loss_m = AverageMeter("Loss", ":.4e")
        acc_m = AverageMeter("Acc@1", ":6.2f")
        progress = ProgressMeter(len(loader), [loss_m, acc_m] if track_accuracy else [loss_m],
                                 phase=phase, epoch=epoch, logger=logger)
        pending = []  # (loss, correct@1, rows) on the device until the next drain

        def drain():
            if not pending:
                return
            vals = torch.stack([torch.stack([v.float(), c.float()])
                                for v, c, _ in pending]).tolist()
            for (loss, correct), (_, _, n) in zip(vals, pending):
                loss_m.update(loss, n=n)
                if track_accuracy:
                    acc_m.update(100.0 * correct / n, n=n)
            pending.clear()

        for it, batch in enumerate(device_prefetch(loader, device)):
            labels = batch["label"].long()
            metrics, logits = fused_step(state, batch["frames"], labels)
            correct = ((logits.argmax(dim=1) == labels).sum() if track_accuracy
                       else metrics["loss"])
            pending.append((metrics["loss"], correct, int(labels.shape[0])))
            if it % PRINT_FREQ == 0 or it == len(loader) - 1:
                drain()
                progress.display(it)
            if debug and it >= 2:
                break
        drain()
        state.scheduler.step()  # MultiStepLR: once an epoch
        state.epoch = epoch + 1
        if on_epoch_end is not None:
            on_epoch_end(state, epoch)
    return state


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def pretrained_state(model_cfg: Config) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                                  Optional[str]]:
    """The model state_dict of the pretraining run ``<model_dir>/<name>``
    and where it came from: its ``checkpoint.pth.tar`` if it exists, else
    the newest checkpoint of the port's run there, else (None, None)."""
    base = os.path.join(model_cfg["model_dir"], model_cfg["name"])
    pth = os.path.join(base, "checkpoint.pth.tar")
    if os.path.isfile(pth):
        return import_model_pth_tar(pth), pth
    if os.path.isdir(base):
        try:
            return import_model_run(base), base
        except FileNotFoundError:
            pass
    return None, None


def video_backbone(model_cfg: Config, device: torch.device) -> torch.nn.Module:
    """The model config's video backbone (on the CPU, random weights from
    its seed), computing in the dtype of its ``model.dtype`` on
    ``device`` (``compute_dtype``: by default bf16 on the card, f32 on
    the CPU)."""
    args = model_cfg["args"]
    backbone = BACKBONES[args["video_backbone"]](
        **dict(args.get("video_backbone_args", {})),
        dtype=compute_dtype(device, model_cfg.get("dtype")))
    init_params(backbone, torch.Generator().manual_seed(int(model_cfg.get("seed", 0))))
    return backbone


def load_backbone(model_cfg: Config, device: torch.device, which: str = "video_model"
                   ) -> Tuple[torch.nn.Module, Optional[str]]:
    """The pretrained video backbone on ``device`` and where its weights
    came from (eval_loop.py:214-253): ``pretrained_state``'s, else None
    (random weights from the model config's seed; the caller warns)."""
    backbone = video_backbone(model_cfg, device)
    full, source = pretrained_state(model_cfg)
    if full is not None:
        prefix = which + "."
        backbone.load_state_dict({k[len(prefix):]: v for k, v in full.items()
                                  if k.startswith(prefix)}, strict=True)
    return backbone.to(device), source


def _setup(eval_cfg: Config, model_cfg: Config, fold: int, debug: bool, device
           ) -> Tuple[torch.device, Config, str, Logger]:
    """Device, the dataset section (batch 4 under ``debug``), the run's
    directory ``<model_dir>/<name>/eval-<benchmark>/fold-NN`` with the
    eval config written into it, and its logger."""
    dev = prepare_device(device)
    db = eval_cfg.dataset
    if debug:  # tiny batches, as the JAX loop's max(2 * devices, 4)
        db = Config(dict(db))
        db["batch_size"] = 4
    eval_dir = os.path.join(model_cfg["model_dir"], model_cfg["name"],
                            f"eval-{eval_cfg.benchmark['name']}", f"fold-{fold:02d}")
    os.makedirs(eval_dir, exist_ok=True)
    logger = Logger(path=os.path.join(eval_dir, "eval.log"), quiet=bool(eval_cfg.get("quiet")))
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.add_line(f"eval fold {fold} -> {eval_dir}; device={dev} ({card})")
    config_lib.dump(eval_cfg, os.path.join(eval_dir, "config.yaml"))
    logger.log_config(eval_cfg)
    return dev, db, eval_dir, logger


def _clip_shape(train_ds, pp_cfg: PreprocessConfig) -> Tuple[int, int, int]:
    """(T, H, W) of the model's input: one decoded item's frame count and
    the crop (the JAX loop's shape probe, eval_loop.py:284-291)."""
    return int(np.asarray(train_ds[0]["frames"]).shape[0]), pp_cfg.crop_size, pp_cfg.crop_size


def run_action_recognition(eval_cfg: Config, model_cfg: Config, fold: Optional[int] = None,
                           debug: bool = False, device: str | torch.device = "cuda"
                           ) -> Dict[str, float]:
    """The full finetune benchmark (eval_loop.py:294-533; reference
    eval-action-recg.py) on ``device`` (raises when it names CUDA and no
    card is present): {clip@1, clip@5[, video@1, video@5]}."""
    db = eval_cfg.dataset
    fold = fold if fold is not None else int(db.get("fold", 1))
    dev, db, eval_dir, logger = _setup(eval_cfg, model_cfg, fold, debug, device)
    seed = int(eval_cfg.get("seed", 0))

    train_ds = builders.build_dataset(db, db.train, return_audio=False, return_labels=True,
                                      fold=fold)
    test_ds = builders.build_dataset(db, db.test, return_audio=False, return_labels=True,
                                     fold=fold)
    dense_ds = None
    if "test_dense" in db:
        dense_ds = builders.build_dataset(db, db.test_dense, mode="video", return_audio=False,
                                          return_labels=True, fold=fold)
    workers = 1 if debug else int(eval_cfg.get("num_workers", 4))
    train_loader = builders.build_dataloader(train_ds, db, db.train, workers)
    test_loader = builders.build_dataloader(test_ds, db, db.test, workers)
    pp_cfg = builders.build_preprocess_config(db, model_cfg.get("dtype"))

    backbone, source = load_backbone(model_cfg, dev)
    margs = eval_cfg.model["args"]
    model = ClassificationWrapper(
        backbone, int(margs["n_classes"]), _clip_shape(train_ds, pp_cfg),
        feat_name=margs.get("feat_name", "pool"), pooling_op=margs.get("pooling_op"),
        use_dropout=bool(margs.get("use_dropout", False)),
        dropout=float(margs.get("dropout", 0.5)), seed=seed).to(dev)
    logger.add_line(f"loaded pretrained backbone from {source}" if source else
                    "warning: no pretrain checkpoint found; random backbone")

    opt_cfg = eval_cfg.optimizer
    num_epochs = 1 if debug else int(opt_cfg["num_epochs"])
    state = TrainState(model=model, optimizer=None, scheduler=None, bank=None,
                       generator=torch.Generator(device=dev))
    step_fn = make_fused_supervised_step(pp_cfg, FINETUNE_SEED, seed=seed)
    logits_fn = make_logits_fn(model)

    def clip_test(epoch: int, phase: str) -> float:
        t1, t5 = _clip_eval(logits_fn, test_loader, pp_cfg, dev,
                            max_batches=2 if debug else None)
        logger.add_line(f"{phase}-test[{epoch}] Acc@1 {t1:6.2f} Acc@5 {t5:6.2f}")
        return t1

    ckpt = CheckpointManager(os.path.join(eval_dir, "checkpoints"))
    best_ckpt = CheckpointManager(os.path.join(eval_dir, "checkpoints_best"), max_to_keep=1)
    best_path = os.path.join(eval_dir, "best.json")
    best = {"top1": -1.0, "step": -1}
    if os.path.isfile(best_path):
        with open(best_path) as f:
            best = json.load(f)
    if eval_cfg.get("test_only") and ckpt.latest_step() is None:
        raise FileNotFoundError(f"test_only requested but no eval checkpoint under {eval_dir}")
    restored = (bool(eval_cfg.get("resume") or eval_cfg.get("test_only"))
                and ckpt.latest_step() is not None)
    start_epoch = 0
    if restored:
        state.optimizer, state.scheduler = build_from_config(opt_cfg, model.parameters())
        ckpt.restore(state)
        start_epoch = state.epoch
        logger.add_line(f"restored eval checkpoint @ step {state.step} (epoch {start_epoch})")
    elif opt_cfg.get("warmup_classifier"):
        # the classifier alone first (eval-action-recg.py:74-84), with its
        # own checkpoints, so a preempted warmup resumes where it was
        warmup_epochs = 1 if debug else int(opt_cfg.get("warmup_epochs", 5))
        state.optimizer, state.scheduler = build_from_config(opt_cfg,
                                                             classifier_parameters(model))
        warm_ckpt = CheckpointManager(os.path.join(eval_dir, "checkpoints_warmup"))
        warm_start = 0
        if eval_cfg.get("resume") and warm_ckpt.latest_step() is not None:
            warm_ckpt.restore(state)
            warm_start = state.epoch
            logger.add_line(f"restored warmup checkpoint @ step {state.step} "
                            f"(epoch {warm_start})")

        def on_warmup_epoch_end(st: TrainState, epoch: int) -> None:
            clip_test(epoch, "warmup")
            warm_ckpt.save(max(st.step, 1), st, {"epoch": st.epoch, "batch": 0})

        with frozen(model.feature_extractor):
            _train_epochs(state, step_fn, train_loader, warmup_epochs, logger, "warmup", debug,
                          dev, start_epoch=warm_start,
                          on_epoch_end=on_warmup_epoch_end)

    if not restored:
        # a fresh optimizer and schedule: the milestones count finetune
        # epochs only (eval_loop.py:478-481)
        state.optimizer, state.scheduler = build_from_config(opt_cfg, model.parameters())
        state.epoch = 0

    if not eval_cfg.get("test_only"):

        def on_epoch_end(st: TrainState, epoch: int) -> None:
            t1 = clip_test(epoch, "finetune")
            ckpt.save(st.step, st, {"epoch": st.epoch, "batch": 0})
            if t1 > best["top1"]:
                best.update(top1=t1, step=st.step)
                best_ckpt.save(st.step, st, {"epoch": st.epoch, "batch": 0})
                with open(best_path, "w") as f:
                    json.dump(best, f)
                logger.add_line(f"new best Acc@1 {t1:6.2f} @ step {st.step}")

        _train_epochs(state, step_fn, train_loader, num_epochs, logger, "finetune", debug,
                      dev, start_epoch=start_epoch, on_epoch_end=on_epoch_end)

    # the final clip test at 25 clips a video (eval-action-recg.py:102)
    final_cfg = Config(dict(db.test))
    final_cfg["clips_per_video"] = 5 if debug else 25
    final_ds = builders.build_dataset(db, final_cfg, return_audio=False, return_labels=True,
                                      fold=fold)
    final_loader = builders.build_dataloader(final_ds, db, final_cfg, workers)
    clip1, clip5 = _clip_eval(logits_fn, final_loader, pp_cfg, dev)
    results = {"clip@1": clip1, "clip@5": clip5}
    if dense_ds is not None:
        video1, video5 = _dense_eval(logits_fn, dense_ds, pp_cfg, int(db["batch_size"]), dev,
                                     workers=workers)
        results.update({"video@1": video1, "video@5": video5})
    logger.add_line(f"RESULTS {results}")
    logger.close()
    return results


def run_linear_probe(eval_cfg: Config, model_cfg: Config, fold: int = 1, debug: bool = False,
                     device: str | torch.device = "cuda") -> Dict[str, Dict[str, float]]:
    """The frozen multi-tap linear probe (eval_loop.py:805-946; reference
    eval-action-recg-linear.py) on ``device``: {tap: {clip@1, clip@5[,
    video@1, video@5]}}."""
    dev, db, eval_dir, logger = _setup(eval_cfg, model_cfg, fold, debug, device)
    seed = int(eval_cfg.get("seed", 0))

    train_ds = builders.build_dataset(db, db.train, return_audio=False, return_labels=True,
                                      fold=fold)
    test_ds = builders.build_dataset(db, db.test, return_audio=False, return_labels=True,
                                     fold=fold)
    workers = 1 if debug else int(eval_cfg.get("num_workers", 4))
    train_loader = builders.build_dataloader(train_ds, db, db.train, workers)
    test_loader = builders.build_dataloader(test_ds, db, db.test, workers)
    pp_cfg = builders.build_preprocess_config(db, model_cfg.get("dtype"))

    backbone, source = load_backbone(model_cfg, dev)
    margs = eval_cfg.model["args"]
    model = MOSTModel(
        backbone, int(margs["n_classes"]), list(margs["feat_names"]),
        list(margs["pooling_ops"]), _clip_shape(train_ds, pp_cfg),
        l2_norm=margs.get("l2_norm"), use_bn=bool(margs.get("use_bn", True)),
        use_dropout=bool(margs.get("use_dropout", False)), seed=seed).to(dev)
    logger.add_line(f"loaded pretrained backbone (frozen) from {source}" if source else
                    "warning: no pretrain checkpoint found; random backbone")

    opt_cfg = eval_cfg.optimizer
    optimizer, scheduler = build_from_config(opt_cfg, classifier_parameters(model))
    num_epochs = 1 if debug else int(opt_cfg["num_epochs"])
    state = TrainState(model=model, optimizer=optimizer, scheduler=scheduler, bank=None,
                       generator=torch.Generator(device=dev))

    ckpt = CheckpointManager(os.path.join(eval_dir, "checkpoints"))
    if eval_cfg.get("test_only") and ckpt.latest_step() is None:
        raise FileNotFoundError(f"test_only requested but no probe checkpoint under {eval_dir}")
    if (eval_cfg.get("resume") or eval_cfg.get("test_only")) and ckpt.latest_step() is not None:
        ckpt.restore(state)
        logger.add_line(f"restored probe checkpoint @ step {state.step}")
    if eval_cfg.get("test_only"):
        num_epochs = 0

    _train_epochs(state, make_fused_supervised_step(pp_cfg, PROBE_SEED, True, seed),
                  train_loader, num_epochs, logger, "probe", debug, dev,
                  start_epoch=state.epoch, track_accuracy=False,
                  on_epoch_end=lambda st, ep: ckpt.save(max(st.step, 1), st,
                                                        {"epoch": st.epoch, "batch": 0}))

    logits_fn = make_logits_fn(model)
    clip = _clip_eval(logits_fn, test_loader, pp_cfg, dev)
    results = {ft: {"clip@1": clip[ft][0], "clip@5": clip[ft][1]} for ft in model.feat_names}
    if "test_dense" in db:
        dense_ds = builders.build_dataset(db, db.test_dense, mode="video", return_audio=False,
                                          return_labels=True, fold=fold)
        dense = _dense_eval(logits_fn, dense_ds, pp_cfg, int(db["batch_size"]), dev,
                            workers=workers,
                            max_videos=min(4, len(dense_ds)) if debug else None)
        for ft in model.feat_names:
            results[ft]["video@1"], results[ft]["video@5"] = dense[ft]
    logger.add_line(f"RESULTS {results}")
    logger.close()
    return results
