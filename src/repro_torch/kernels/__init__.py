"""Hand-written CUDA kernels for Hopper, their plain torch versions, and
the device-dispatching wrappers (:mod:`repro_torch.kernels.ops`)."""
