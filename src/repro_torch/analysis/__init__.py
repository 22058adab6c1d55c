"""Runtime checks of the port (see :mod:`repro_torch.analysis.sanitize`)."""
