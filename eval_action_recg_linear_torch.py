#!/usr/bin/env python
"""Kinetics-400 multi-tap linear probe over frozen features on one NVIDIA card: the PyTorch/CUDA port's probe entry point.

Usage (the arguments of eval_action_recg_linear.py, plus --device; loops
over the folds):
    python eval_action_recg_linear_torch.py configs/benchmark/kinetics/8x224x224-linear.yaml \
        configs/main/avid/kinetics/Cross-N1024.yaml
    python eval_action_recg_linear_torch.py <eval.yaml> <model.yaml> --device cpu --debug

The backbone is found as for eval_action_recg_torch.py. Runs on the card
by default and raises when none is present.
"""

from avid_cma_tpu_torch.cli import linear_probe_main

if __name__ == "__main__":
    linear_probe_main()
