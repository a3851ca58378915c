"""The port's example scripts (counterparts of the JAX package's
``examples/``): ``python -m torchmpi_tpu_torch.examples.<name> [flags]``,
or ``torchrun --nproc-per-node N -m torchmpi_tpu_torch.examples.<name>``.
Each ``main(argv)`` returns its losses and results, so tests drive it."""
