"""Launchers of the port: batched serving (``python -m
repro_torch.launch.serve``), training (``launch.train``) and their step
functions (``launch.steps``); the production meshes (``launch.mesh``), the
roofline (``launch.roofline``), the dry run (``launch.dryrun``) and the
hill-climb driver (``launch.hillclimb``)."""
