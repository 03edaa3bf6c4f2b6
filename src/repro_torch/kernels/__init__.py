"""Hand-written CUDA kernels for Hopper (``../csrc``), each beside its plain
PyTorch version; :mod:`repro_torch.kernels.dispatch` picks between them by
the device of the tensors a call is given."""
