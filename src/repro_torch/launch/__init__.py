"""The launchers (the port of ``repro.launch``): the serving and training
entry points (``python -m repro_torch.launch.serve`` / ``.train``), the
production mesh, the abstract inputs of every cell, and the dry run that
counts a step's roofline terms on one rank of a fake 256- or 512-rank
world (``.dryrun``, tabled by ``.report``)."""
