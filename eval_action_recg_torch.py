#!/usr/bin/env python
"""UCF-101 / HMDB-51 full finetune on one NVIDIA card: the PyTorch/CUDA port's eval entry point.

Usage (the arguments of eval_action_recg.py, plus --device):
    python eval_action_recg_torch.py configs/benchmark/ucf/8at16-fold1.yaml \
        configs/main/avid/kinetics/Cross-N1024.yaml [--fold N]
    python eval_action_recg_torch.py <eval.yaml> <model.yaml> --device cpu --debug

The backbone comes from <model.model_dir>/<model.name>: its
checkpoint.pth.tar, else the newest checkpoint of the port's pretraining
run there, else random weights (with a warning). Runs on the card by
default and raises when none is present; --device cpu runs the plain
PyTorch versions of the kernels. The run's directory is
<model.model_dir>/<model.name>/eval-<benchmark>/fold-NN.
"""

from avid_cma_tpu_torch.cli import finetune_main

if __name__ == "__main__":
    finetune_main()
