"""Pretraining orchestration: the epoch/step loop (counterpart of
avid_cma_tpu/train/loop.py).

Capability reference: main-avid.py:84-201 (main_worker + run_phase):
build everything from the YAML, restore, loop epochs calling the fused
step, checkpoint each epoch (+ milestone copies and every
``save_freq_steps``), meters + TensorBoard, and the held-out test phase
every ``test_freq`` epochs through the fused eval step. For AVID-CMA
(avid_cma_tpu/train/loop.py:169-241, 414-498): the model and the banks +
Z warm-start from the AVID run (a ``.pth.tar`` or a port run's
directory), the positive set is mined after the restore unless the run
resumes, and re-mined at the start of each epoch where
``should_resample``, if this run trains that epoch's first batch.

The host loop only feeds raw batches (host decode -> ``device_prefetch``)
and drains metrics: the per-step losses stay on the device and are
fetched once per ``print_freq`` window.

Over several processes (a process group up, ``parallel.mesh``; one
process per GPU under torchrun) each rank loads its shard of every
global batch (``num_shards``, ``shard_index``), the step averages the
gradients, the BN running stats and the metrics, and
``loss.bank_sharding: sharded`` keeps the banks and the positive set
row-sharded (``parallel.sharding``): each rank initializes, warm-starts
and restores its own rows of the full banks, and mines its own rows of
the positive set. Rank 0 alone writes the log, TensorBoard, the config
and the checkpoints (which hold the full banks).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import torch

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.config import Config
from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.criterions.avid_cma import (
    AVIDCMAConfig,
    CMAState,
    cma_state_from_bank,
    should_resample,
)
from avid_cma_tpu_torch.criterions.mining import (
    mine_positives,
    mine_positives_mesh,
    mine_positives_sharded,
)
from avid_cma_tpu_torch.data.prefetch import device_prefetch
from avid_cma_tpu_torch.parallel.mesh import current_world, process_batch_slice
from avid_cma_tpu_torch.parallel.sharding import BankLayout, parse_bank_sharding, shard_bank
from avid_cma_tpu_torch.train import builders
from avid_cma_tpu_torch.train.checkpoint import (
    CheckpointManager,
    import_criterion_pth_tar,
    import_criterion_run,
    import_model_pth_tar,
    import_model_run,
)
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import make_fused_eval_step
from avid_cma_tpu_torch.utils.logger import (
    AverageMeter,
    Logger,
    ProgressMeter,
    TensorBoardWriter,
    parameter_description,
)
from avid_cma_tpu_torch.utils.profiling import StepWindowTracer


def check_ported(cfg: Config) -> None:
    """Raise for what the port cannot run yet, naming the setting and its
    ROADMAP item: approximate CMA mining, ``sampling_args.exact: false``
    (A8.5). An unknown ``loss.bank_sharding`` raises too."""
    parse_bank_sharding(cfg.loss.get("bank_sharding"))
    sampling = cfg.loss.get("args", {}).get("sampling_args", {}) or {}
    if not sampling.get("exact", True):
        raise NotImplementedError(
            "loss.args.sampling_args.exact: false (approximate top-k mining, "
            "lax.approx_max_k) has no torch counterpart (ROADMAP A8.5); set exact: true")


def _warm_start_bank(path: str, num_data: int, dev: torch.device, logger: Logger
                     ) -> BankState:
    """Banks + Z from the AVID run (avid_cma_tpu/train/loop.py:414-466): a
    port run's directory or a ``.pth.tar``; banks with more rows than
    ``num_data`` (a sharded run's pad) are trimmed, fewer raise."""
    if os.path.isdir(path):
        bank = import_criterion_run(path, dev)
        logger.add_line(f"restored banks from port run {path} (z={float(bank.z):.4f})")
    else:
        bank = import_criterion_pth_tar(path, dev)
        logger.add_line(f"restored banks from {path} (z={float(bank.z):.4f})")
    rows = bank.view1_mem.shape[0]
    if rows < num_data:
        raise ValueError(f"checkpoint banks have {rows} rows; this run's num_data={num_data}")
    if rows > num_data:
        logger.add_line(f"trimming restored banks {rows} -> {num_data} rows "
                        "(source run's sharding pad)")
        bank = BankState(view1_mem=bank.view1_mem[:num_data].contiguous(),
                         view2_mem=bank.view2_mem[:num_data].contiguous(), z=bank.z)
    return bank


def _mine(state: TrainState, crit: AVIDCMAConfig, dev: torch.device) -> float:
    """Mine the positive set of the state's banks into the state, routed
    by the layout as the JAX ``_mine`` (avid_cma_tpu/train/loop.py:481-498):
    row-sharded banks through the row-sharded sweep (at one rank the same
    sweep as ``mine_positives``), replicated banks over several ranks
    through the query-sharded one, else ``mine_positives``. Returns the
    sweep's seconds (the card synchronized)."""
    t0 = time.perf_counter()
    bank, layout = state.bank, state.layout
    args = dict(kind=crit.sampling_type, exact=crit.mining_exact)
    if layout.sharded:
        pos = mine_positives_sharded(bank.view1_mem, bank.view2_mem, layout, crit.pos_k,
                                     **args)
    elif layout.world.size > 1:
        pos = mine_positives_mesh(bank.view1_mem, bank.view2_mem, crit.pos_k, layout.world,
                                  **args)
    else:
        pos = mine_positives(bank.view1_mem, bank.view2_mem, crit.pos_k, **args)
    _sync(dev)
    state.bank = cma_state_from_bank(state.bank, pos)
    return time.perf_counter() - t0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_pretraining(cfg: Config, debug: bool = False, device: str | torch.device = "cuda",
                    on_epoch: Optional[Callable[[Dict], None]] = None) -> TrainState:
    """``python main_avid_torch.py <cfg.yaml>`` body (reference:
    main-avid.py). Runs on ``device`` (raises when it names CUDA and no
    card is present), as one rank of the process group when one is up
    (on its ``cuda:LOCAL_RANK``). ``steps_per_epoch`` (top-level config
    key, optional) trains at most that many batches an epoch: a smoke
    run of a full-size corpus. ``on_epoch``, when given, gets one dict a
    train epoch: epoch, start_step, steps, clips (this rank's), loss
    (the epoch's mean train loss over the ranks), step_losses (each
    step's), train_s (host clock, the card synchronized at the end),
    loader_wait_s (time the loop waited for the next batch), test_loss,
    mine_s (seconds of the AVID-CMA mining before the epoch's first batch:
    the first mining of a run counts for the first epoch it trains; None
    when the epoch mined nothing)."""
    check_ported(cfg)
    world = current_world(device)
    dev = world.device
    builders.check_model_dtype(cfg.model.get("dtype"), dev)
    seed = int(cfg.get("seed", 0))
    model_dir = os.path.join(cfg.model["model_dir"], cfg.model["name"])
    logger = Logger(path=os.path.join(model_dir, "train.log"), quiet=bool(cfg.get("quiet")),
                    rank=world.rank)
    tb = TensorBoardWriter(os.path.join(model_dir, "tb"), enabled=bool(cfg.get("log2tb", False)),
                           rank=world.rank)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    logger.add_line(f"device={dev} ({card}) rank {world.rank} of {world.size} seed={seed}")
    logger.log_config(cfg)
    os.makedirs(model_dir, exist_ok=True)
    if world.is_main:  # the resolved config, read back by the export tooling
        config_lib.dump(cfg, os.path.join(model_dir, "config.yaml"))

    db_cfg = cfg.dataset
    if debug:
        db_cfg = Config(dict(db_cfg))
        db_cfg["batch_size"] = max(2 * world.size, 4)  # the JAX loop's max(2 * devices, 4)
    process_batch_slice(int(db_cfg["batch_size"]), world)
    shards = dict(num_shards=world.size, shard_index=world.rank)

    # --- data -------------------------------------------------------------
    train_ds = builders.build_dataset(db_cfg, db_cfg.train, mode="clip")
    num_workers = 1 if debug else int(cfg.get("num_workers", 4))
    loader_kind = str(cfg.get("loader", "threaded"))
    loader = builders.build_dataloader(train_ds, db_cfg, db_cfg.train, num_workers=num_workers,
                                       seed=seed, kind=loader_kind, **shards)
    test_loader = None
    if not cfg.get("no_test", False) and "test" in db_cfg:
        try:
            test_ds = builders.build_dataset(db_cfg, db_cfg.test, mode="clip")
            test_loader = builders.build_dataloader(
                test_ds, db_cfg, db_cfg.test, num_workers=num_workers, seed=seed,
                kind=loader_kind, **shards)
        except (FileNotFoundError, ValueError) as e:
            # missing split files OR a split too small for one batch: the
            # test phase is optional either way
            logger.add_line(f"no usable test split ({e}); skipping test phases")
    logger.add_line(f"train dataset: {train_ds.name} n={train_ds.num_samples} "
                    f"batches/epoch={len(loader)}")

    # --- model / criterion / optimizer / state ------------------------------
    num_data = int(cfg.loss.get("args", {}).get("num_data", train_ds.num_samples))
    if num_data != train_ds.num_samples:
        logger.add_line(f"note: loss.num_data={num_data} != dataset size "
                        f"{train_ds.num_samples}; using dataset size")
    pcfg = builders.pretrain_config(cfg, num_data=train_ds.num_samples)
    layout = BankLayout(n=pcfg.num_data, world=world,
                        sharded=parse_bank_sharding(cfg.loss.get("bank_sharding")))
    state, train_step = builders.build_pretrain(pcfg, dev, layout)
    if layout.sharded:
        logger.add_line(f"banks row-sharded: {layout.n_local} of {layout.n} rows a rank")
    logger.add_line(parameter_description(state.model))
    epochs = 2 if debug else int(cfg.optimizer["num_epochs"])
    milestones = set(int(m) for m in cfg.optimizer["lr"].get("milestones", []))
    # rank 0 traces: the ranks would write one file
    tracer = StepWindowTracer(cfg.get("profile_steps") if world.is_main else None,
                              os.path.join(model_dir, "profile"), dev)

    ckpt = CheckpointManager(os.path.join(model_dir, "checkpoints"), world=world)
    resuming = bool(cfg.get("resume")) and ckpt.latest_step() is not None
    position = {"epoch": 0, "batch": 0}
    if resuming:
        position = ckpt.restore(state)
        logger.add_line(f"resumed from step {state.step} (epoch {state.epoch}, "
                        f"batch {position['batch']})")
    else:
        # warm start from the AVID run (the AVID-CMA configs point
        # model.args.checkpoint and loss.args.checkpoint at it): a
        # reference-layout .pth.tar or a port run's directory
        model_ck = cfg.model.get("args", {}).get("checkpoint")
        if model_ck and os.path.exists(model_ck):
            sd = (import_model_run(model_ck) if os.path.isdir(model_ck)
                  else import_model_pth_tar(model_ck))
            state.model.load_state_dict(sd, strict=True)
            logger.add_line(f"warm-started model from {model_ck}")
        elif model_ck:
            logger.add_line(f"model.args.checkpoint {model_ck} not found; random weights")
        bank_ck = cfg.loss.get("args", {}).get("checkpoint")
        if bank_ck and os.path.exists(bank_ck):
            bank = shard_bank(_warm_start_bank(bank_ck, pcfg.num_data, dev, logger), layout)
            if bank.view1_mem.shape != state.bank.view1_mem.shape:
                raise ValueError(f"checkpoint banks {tuple(bank.view1_mem.shape)} != "
                                 f"{tuple(state.bank.view1_mem.shape)} of this run")
            state.bank = (cma_state_from_bank(bank, state.bank.positive_set)
                          if isinstance(state.bank, CMAState) else bank)
        elif bank_ck and isinstance(state.bank, CMAState):
            logger.add_line(f"warning: CMA checkpoint {bank_ck} missing; random banks")

    crit = pcfg.criterion(state.model.out_dim)
    cma = isinstance(crit, AVIDCMAConfig)
    mine_s = None
    if cma and not resuming:
        logger.add_line(f"mining CMA positives: N={crit.num_data} pos_k={crit.pos_k} "
                        f"type={crit.sampling_type}")
        mine_s = _mine(state, crit, dev)
        logger.add_line(f"mined the positive set in {mine_s:.3f} s")

    eval_step = None
    start_epoch = state.epoch
    print_freq = int(cfg.get("print_freq", 100))
    save_freq_steps = int(cfg.get("save_freq_steps", 0))
    test_freq = int(cfg.get("test_freq", 1))
    n_batches = len(loader)
    if cfg.get("steps_per_epoch") is not None:
        n_batches = min(n_batches, int(cfg["steps_per_epoch"]))
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        state.epoch = epoch
        meters = {
            "loss": AverageMeter("Loss", ":.4e"),
            "batch_t": AverageMeter("Time", ":.3f", window_size=100),
            "data_t": AverageMeter("Data", ":.3f", window_size=100),
        }
        progress = ProgressMeter(n_batches, meters.values(), phase="pretrain",
                                 epoch=epoch, logger=logger)
        # mid-epoch resume: skip, at the index level, the batches the
        # checkpoint had trained (the sampler repeats an epoch's order).
        # Not in debug mode: debug shrinks the batch, so the position no
        # longer matches the run being resumed.
        start_it = 0
        if resuming and not debug and epoch == start_epoch and position["epoch"] == epoch:
            start_it = int(position["batch"])
            if start_it:
                logger.add_line(f"mid-epoch resume: skipping {start_it} already-trained "
                                f"batches of epoch {epoch}")
                loader.set_start_batch(start_it)
        # re-mine only at an epoch whose first batch this run trains: a
        # mid-epoch resume keeps the checkpoint's set, so that it repeats
        # the straight run (the JAX loop re-mines there too)
        if cma and start_it == 0 and should_resample(epoch, crit.resample_freq):
            logger.add_line(f"epoch {epoch}: re-mining CMA positive set")
            mine_s = _mine(state, crit, dev)
            logger.add_line(f"mined the positive set in {mine_s:.3f} s")
        pending = []  # (loss on the device, clips) until the next drain
        step_losses = []

        def drain_losses():
            # ONE device->host copy for the whole pending window
            if not pending:
                return
            vals = torch.stack([v for v, _ in pending]).tolist()
            for v, (_, n) in zip(vals, pending):
                meters["loss"].update(v, n=n)
            step_losses.extend(vals)
            pending.clear()

        clips = steps = 0
        wait_s = 0.0
        start_step = state.step
        t_epoch = t0 = time.perf_counter()
        batches = device_prefetch(loader, dev)
        for it in range(start_it, n_batches + 1):
            t_wait = time.perf_counter()
            batch = next(batches, None) if it < n_batches else None
            wait_s += time.perf_counter() - t_wait
            if batch is None:
                break
            meters["data_t"].update(time.perf_counter() - t0)
            tracer.before_step(state.step)
            metrics = train_step(state, batch, state.step)
            n = int(batch["index"].shape[0])
            pending.append((metrics["loss"], n))
            clips, steps = clips + n, steps + 1
            if tracer.after_step(state.step):
                logger.add_line(f"profiler: trace written to {tracer.path}")
            if save_freq_steps and state.step % save_freq_steps == 0:
                ckpt.save(state.step, state, {"epoch": epoch, "batch": it + 1})
            if it % print_freq == 0 or it == n_batches - 1:
                drain_losses()  # sync point
                meters["batch_t"].update(time.perf_counter() - t0)
                progress.display(it)
                names = list(metrics)
                vals = torch.stack([metrics[k].float() for k in names]).tolist()
                tb.add_scalars(dict(zip(names, vals)), state.step)
            else:
                meters["batch_t"].update(time.perf_counter() - t0)
            t0 = time.perf_counter()
        batches.close()  # a capped epoch leaves the loader mid-way: stop its workers
        drain_losses()
        _sync(dev)
        train_s = time.perf_counter() - t_epoch
        if world.distributed:
            # the loss is already averaged a step; this averages the
            # host-side timing meters for the epoch's summary line
            progress.synchronize_meters(world)
            progress.display(n_batches)

        state.scheduler.step()  # MultiStepLR: once an epoch
        state.epoch = epoch + 1
        ckpt.save(state.step, state, {"epoch": epoch + 1, "batch": 0},
                  milestone=(epoch + 1) in milestones)
        logger.add_line(f"epoch {epoch} done; checkpoint @ step {state.step}; "
                        f"{clips} clips in {train_s:.3f} s, loader wait {wait_s:.3f} s")

        # held-out criterion loss (reference: run_phase 'test' every
        # test_freq epochs AND on the final epoch, main-avid.py:132-137)
        test_loss = None
        if test_loader is not None and (epoch % max(test_freq, 1) == 0 or epoch == epochs - 1):
            if eval_step is None:
                eval_step = make_fused_eval_step(crit, pcfg.preprocess(), pcfg.seed)
            test_loader.set_epoch(epoch)
            losses = []
            for it, batch in enumerate(device_prefetch(test_loader, dev)):
                losses.append(eval_step(state, batch, it)["loss"])
                if debug and it >= 1:
                    break
            if losses:
                test_loss = float(torch.stack(losses).mean())  # one sync point
                logger.add_line(f"test[{epoch}] loss {test_loss:.4e}")
                tb.add_scalar("test/loss", test_loss, state.step)
        if on_epoch is not None:
            on_epoch({"epoch": epoch, "start_step": start_step, "steps": steps, "clips": clips,
                      "loss": meters["loss"].avg, "step_losses": step_losses, "train_s": train_s,
                      "loader_wait_s": wait_s, "test_loss": test_loss, "mine_s": mine_s})
        mine_s = None

    if tracer.active:  # the window's end lies beyond the run's last step
        tracer.close()
        logger.add_line(f"profiler: trace written to {tracer.path} (run ended inside the window)")
    tb.close()
    logger.close()
    return state
