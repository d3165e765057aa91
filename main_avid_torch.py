#!/usr/bin/env python
"""AVID and AVID-CMA pretraining on NVIDIA cards: the PyTorch/CUDA port's entry point.

Usage (the arguments of main_avid.py, plus --device):
    python main_avid_torch.py configs/main/avid/kinetics/Cross-N1024.yaml
    python main_avid_torch.py <cfg.yaml> --debug --set dataset.backend=synthetic
    python main_avid_torch.py configs/smoke/avid-synthetic.yaml --debug --device cpu
    python main_avid_torch.py configs/main/avid-cma/kinetics/InstX-N1024-PosW-N64-Top32.yaml \
        --set model.args.checkpoint=<AVID run dir or .pth.tar> \
        --set loss.args.checkpoint=<AVID run dir or .pth.tar>

Several GPUs, one process each (NCCL), or two CPU processes (gloo):
    torchrun --standalone --nproc-per-node=<gpus> main_avid_torch.py <cfg.yaml> --multihost
    torchrun --standalone --nproc-per-node=2 main_avid_torch.py <cfg.yaml> --device cpu --multihost

Runs on the card by default and raises when none is present; --device cpu
runs the plain PyTorch versions of the kernels. Checkpoints go to
<model.model_dir>/<model.name>/checkpoints; --set resume=true resumes from
the latest one.
"""

from avid_cma_tpu_torch.cli import pretrain_main

if __name__ == "__main__":
    pretrain_main()
