"""The fleet replay (the device engine's transition over lanes): the CUDA
kernel, its loader, its wrapper (:mod:`.ops`) and its plain torch version
(:mod:`.ref`)."""
