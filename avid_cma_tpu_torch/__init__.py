"""PyTorch/CUDA port of the AVID pretraining path for NVIDIA Hopper.

A second package beside ``avid_cma_tpu`` (the JAX reference, which this
package never imports). It holds AVID pretraining from a YAML config:
the config reader (``config``, ``yaml_lite``), the host data layer
(``data``: decode, datasets, loaders, device prefetch), device
preprocessing, R(2+1)D + Conv2D backbones with f32 heads, the AVID NCE
criterion with memory banks, Adam, the epoch loop with its checkpoints
(``train.loop``, ``train.checkpoint``) and the CLI (``cli``). Its hot
ops run as CUDA kernels written for ``sm_90a`` (``csrc/``):

  K1 ``ops.kernels.spectrogram``  log-power spectrogram
  K2 ``ops.kernels.stem_pool``    stem BN-apply -> ReLU -> 3x3/s2 max-pool
  K3 ``ops.kernels.stem_pool``    its backward
  K4 ``ops.kernels.nce_gather``   bank-row gather + NCE score
  K5 ``ops.kernels.r2p1d_pair``   fused (2+1)D conv pair (eval mode)

Every kernel wrapper follows the tensor's device: a CUDA tensor goes to
the kernel (or the wrapper raises), a CPU tensor to the kernel's plain
PyTorch version beside it. Entry points default to ``device="cuda"``
and raise when no card is present; only the tests pass ``"cpu"``.

Entry: ``python main_avid_torch.py <cfg.yaml>`` (``train.loop.
run_pretraining``); one step: ``train.builders.build_pretrain(
kinetics_cross_n1024())`` then ``fused_step(state, raw_batch, step_i)``.
"""
