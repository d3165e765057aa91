"""One rank of the port's real-rank CPU tests (tests/test_torch_dist.py).

    python tests/torch_dist_worker.py <case> <rank> <world> <store> <in_dir> <out_dir>

Joins a gloo world of ``world`` processes through a FileStore at
``<store>``, runs ``case`` and writes ``<out_dir>/rank<rank>.pt``; the
test that spawns it reads the files. It imports torch and the port only,
never JAX (the parent computes the JAX references and hands them over as
files in ``in_dir``). Cases:

- ``avid``: three AVID train steps, first with replicated then with
  row-sharded banks, from the parent's weights, banks, batches and
  negative table; each rank steps on its rows of every global batch.
- ``cma``: the positive set mined by the layout's sweep (query-sharded
  over replicated banks, row-sharded over sharded ones), then two
  AVID-CMA steps, in both layouts.
- ``loop``: ``run_pretraining`` from the parent's config for two epochs
  straight, then one epoch and a resume to two; and the host-scalar
  collectives.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from avid_cma_tpu_torch.config import from_dict  # noqa: E402
from avid_cma_tpu_torch.criterions.avid import AVIDConfig, BankState  # noqa: E402
from avid_cma_tpu_torch.criterions.avid_cma import AVIDCMAConfig, cma_state_from_bank  # noqa: E402
from avid_cma_tpu_torch.criterions.mining import (  # noqa: E402
    mine_positives_mesh,
    mine_positives_sharded,
)
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper  # noqa: E402
from avid_cma_tpu_torch.parallel import mesh, multihost  # noqa: E402
from avid_cma_tpu_torch.parallel.sharding import BankLayout, shard_bank, unshard_bank  # noqa: E402
from avid_cma_tpu_torch.train.loop import run_pretraining  # noqa: E402
from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler  # noqa: E402
from avid_cma_tpu_torch.train.state import TrainState  # noqa: E402
from avid_cma_tpu_torch.train.step import bn_running_stats, make_train_step  # noqa: E402

LR, WD = 2e-5, 1e-5


def _state(in_dir, data, layout, cma=False):
    model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                       proj_dim=[512, 512, 128], device="cpu")
    model.load_state_dict(torch.load(os.path.join(in_dir, "weights.pt")), strict=True)
    opt = build_optimizer(model.parameters(), "adam", LR, weight_decay=WD)
    banks = torch.from_numpy(data["banks"])
    bank = BankState(banks[0].clone(), banks[1].clone(), torch.tensor(-1.0))
    if cma:
        bank = cma_state_from_bank(bank, torch.zeros((layout.n, int(data["pos_k"])),
                                                     dtype=torch.int64))
    return TrainState(model=model, optimizer=opt, scheduler=multistep_scheduler(opt, [10], 1.0),
                      bank=shard_bank(bank, layout), generator=torch.Generator().manual_seed(0),
                      layout=layout)


def _steps(world, in_dir, data, cma):
    """Both layouts: per-step metrics and Z, the full banks after the first
    step and at the end, the final parameters and BN running stats."""
    n, b = int(data["n"]), int(data["b"])
    rows = slice(world.rank * b, (world.rank + 1) * b)
    table = torch.from_numpy(data["table"])
    out = {}
    for sharded in (False, True):
        layout = BankLayout(n=n, world=world, sharded=sharded)
        state = _state(in_dir, data, layout, cma)
        if cma:
            crit = AVIDCMAConfig(num_data=n, num_negatives=table.shape[1],
                                 num_negatives_within=int(data["within"]), momentum=0.5,
                                 pos_k=int(data["pos_k"]))
            bank = state.bank
            pos = (mine_positives_sharded(bank.view1_mem, bank.view2_mem, layout, crit.pos_k)
                   if sharded else
                   mine_positives_mesh(bank.view1_mem, bank.view2_mem, crit.pos_k, world))
            state.bank = cma_state_from_bank(bank, pos)
        else:
            crit = AVIDConfig(num_data=n, num_negatives=table.shape[1], momentum=0.5)
        step = make_train_step(crit)
        rec = {"metrics": [], "z": []}
        if cma:
            rec["positive_set"] = unshard_bank(state.bank, layout).positive_set
        for s in range(data["videos"].shape[0]):
            y = torch.from_numpy(data["ys"][s, rows])
            if cma:
                pos_rows = unshard_bank(state.bank, layout).positive_set[y]
                neg = table[pos_rows.sum(dim=1) % n]
            else:
                neg = table[y]
            m = step(state, {"frames": torch.from_numpy(data["videos"][s, rows]),
                             "audio": torch.from_numpy(data["audios"][s, rows]), "index": y},
                     neg_idx=neg)
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            rec["z"].append(state.bank.z.clone())
            if s == 0:
                first = unshard_bank(state.bank, layout)
                rec["banks_step1"] = (first.view1_mem, first.view2_mem)
                rec["bn_step1"] = {k: v.clone() for k, v in state.model.state_dict().items()
                                   if k.endswith(("running_mean", "running_var"))}
        full = unshard_bank(state.bank, layout)
        rec["banks"] = (full.view1_mem, full.view2_mem)
        rec["model"] = state.model.state_dict()
        rec["bn"] = [t.clone() for t in bn_running_stats(state.model)]
        out["sharded" if sharded else "replicated"] = rec
    return out


def _loop(world, in_dir, out_dir):
    with open(os.path.join(in_dir, "config.json")) as f:
        base = json.load(f)
    runs = {}
    for name, plan in (("straight", [2]), ("resumed", [1, 2])):
        for epochs in plan:
            cfg = from_dict(base)
            cfg.model["model_dir"] = os.path.join(out_dir, name)
            cfg.optimizer["num_epochs"] = epochs
            cfg["resume"] = epochs != plan[0]
            records = []
            state = run_pretraining(cfg, device="cpu", on_epoch=records.append)
        full = unshard_bank(state.bank, state.layout)
        runs[name] = {"step": state.step, "epoch": state.epoch,
                      "model": state.model.state_dict(),
                      "optimizer": state.optimizer.state_dict()["state"],
                      "banks": (full.view1_mem, full.view2_mem, full.z),
                      "shard_rows": state.bank.view1_mem.shape[0],
                      "records": records}
    runs["sync"] = {"mean": multihost.sync_float(world.rank + 1.5, world),
                    "sum": multihost.sync_float(world.rank + 1.5, world, reduce="sum"),
                    "any": multihost.sync_any(world.rank == 1, world),
                    "none": multihost.sync_any(False, world),
                    "counts": multihost.sync_counts(np.array([1, world.rank]), world)}
    return runs


def main():
    case, rank, size, store, in_dir, out_dir = sys.argv[1:7]
    torch.set_num_threads(1)
    world = mesh.initialize("cpu", int(rank), int(size),
                            torch.distributed.FileStore(store, int(size)))
    try:
        if case == "loop":
            out = _loop(world, in_dir, out_dir)
        else:
            data = dict(np.load(os.path.join(in_dir, "data.npz")))
            out = _steps(world, in_dir, data, cma=case == "cma")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
