"""Trace sharding for the fleet (see :mod:`repro_torch.distributed.sharding`)."""
